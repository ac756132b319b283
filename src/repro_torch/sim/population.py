"""Trace-driven client-population simulator (host-side, pure numpy).

The paper's premise is clients "ranging from powerful servers to mobile
devices"; the async round engine (``repro.core.async_round``) needs that
heterogeneity as *traces*: which of millions of registered clients are
available at simulated time t, and how long each takes to return an update
once dispatched.  This module models a registered population whose
per-client attributes — device class, latency distribution, availability
phase — are **derived, not stored**: a splitmix64-style hash of
``(seed, client id, salt)`` yields every attribute on demand, so a
population of millions costs a few scalars and sampling a cohort is one
vectorized pass over candidate ids.  Everything is deterministic in
``(seed, t, nonce)`` — the same trace replays bit-for-bit, which is what
lets the benchmark gate throughput ratios and the parity tests pin exact
schedules.

Device classes follow the HeteroFL-style skew the async engine must
survive: a few fast servers, a long tail of slow mobile devices whose
lognormal latencies produce the stragglers that stall synchronous rounds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

# hash salts (arbitrary odd constants) separating the attribute streams
_SALT_CLASS = 0x9e3779b97f4a7c15
_SALT_PHASE = 0xc2b2ae3d27d4eb4f
_SALT_AVAIL = 0x165667b19e3779f9
_SALT_LAT_A = 0x27d4eb2f165667c5
_SALT_LAT_B = 0x85ebca6b2b2ae35d


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — vectorized uint64 -> uint64 (wrapping; the
    errstate silences numpy's scalar-overflow warning, wraparound is the
    point of the finalizer)."""
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xbf58476d1ce4e5b9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94d049bb133111eb)
    return x ^ (x >> np.uint64(31))


def _u01(h: np.ndarray) -> np.ndarray:
    """uint64 hash -> uniform float64 in [0, 1)."""
    return (h >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))


@dataclass(frozen=True)
class DeviceClass:
    """One hardware tier of the registered population.

    ``lat_mu``/``lat_sigma`` parameterize a lognormal round-trip latency
    (dispatch -> update arrival, simulated seconds); ``avail`` is the base
    probability the device is reachable at any instant (modulated by a
    per-client diurnal phase); ``width_mult`` is the client architecture
    width this tier can afford (ties the latency skew to the paper's
    flexible-architecture axis — slow devices run thin models).
    """
    name: str
    weight: float          # population share
    lat_mu: float          # log-space mean of the lognormal latency
    lat_sigma: float       # log-space std
    avail: float           # base availability probability
    width_mult: float      # architecture width this class trains


# a skewed default fleet: stragglers are the 30% mobile_lo tail whose
# median latency is 30x the servers' with a heavy (sigma = 1) upper tail
DEFAULT_CLASSES: Tuple[DeviceClass, ...] = (
    DeviceClass("server", 0.05, np.log(2.0), 0.20, 0.95, 1.0),
    DeviceClass("desktop", 0.25, np.log(8.0), 0.40, 0.70, 0.75),
    DeviceClass("mobile_hi", 0.40, np.log(20.0), 0.60, 0.45, 0.5),
    DeviceClass("mobile_lo", 0.30, np.log(60.0), 1.00, 0.30, 0.25),
)


class ClientPopulation:
    """Millions of registered clients with trace-derived attributes.

    No per-client state is materialized: ``device_class``, ``latency`` and
    ``available`` hash the client id (with the population seed and a salt)
    into the attribute, so construction is O(#classes) and every query is
    vectorized over the requested ids.
    """

    def __init__(self, n_clients: int,
                 classes: Sequence[DeviceClass] = DEFAULT_CLASSES,
                 seed: int = 0, day: float = 1440.0):
        if n_clients < 1:
            raise ValueError(f"population needs >= 1 client, got {n_clients}")
        self.n_clients = int(n_clients)
        self.classes = tuple(classes)
        self.seed = np.uint64(seed)
        self.day = float(day)          # diurnal availability period (sim s)
        w = np.asarray([c.weight for c in self.classes], np.float64)
        self._cum = np.cumsum(w / w.sum())
        self._lat_mu = np.asarray([c.lat_mu for c in self.classes])
        self._lat_sigma = np.asarray([c.lat_sigma for c in self.classes])
        self._avail = np.asarray([c.avail for c in self.classes])

    def _hash(self, ids: np.ndarray, salt: int,
              nonce: int = 0) -> np.ndarray:
        ids = np.asarray(ids, np.uint64)
        with np.errstate(over="ignore"):
            h = _mix(ids + _mix(self.seed ^ np.uint64(salt)))
        if nonce:
            h = _mix(h ^ _mix(np.uint64(nonce)))
        return h

    def device_class(self, ids) -> np.ndarray:
        """(k,) class index per client — fixed for the client's lifetime."""
        u = _u01(self._hash(ids, _SALT_CLASS))
        return np.searchsorted(self._cum, u, side="right").clip(
            0, len(self.classes) - 1)

    def latency(self, ids, nonce: int = 0) -> np.ndarray:
        """(k,) lognormal dispatch->arrival latencies, deterministic in
        (population seed, client id, nonce) — use the dispatch index as the
        nonce so re-dispatching a client redraws its latency."""
        c = self.device_class(ids)
        u1 = _u01(self._hash(ids, _SALT_LAT_A, nonce))
        u2 = _u01(self._hash(ids, _SALT_LAT_B, nonce))
        z = np.sqrt(-2.0 * np.log(np.maximum(u1, 1e-12))) \
            * np.cos(2.0 * np.pi * u2)
        return np.exp(self._lat_mu[c] + self._lat_sigma[c] * z)

    def available(self, ids, t: float) -> np.ndarray:
        """(k,) bool availability at simulated time t: the class base rate
        modulated by a per-client diurnal phase (period ``day``), resampled
        per ~1-simulated-second bucket."""
        ids = np.asarray(ids, np.uint64)
        phase = _u01(self._hash(ids, _SALT_PHASE)) * 2.0 * np.pi
        c = self.device_class(ids)
        p = self._avail[c] * (0.75 + 0.25 * np.sin(
            2.0 * np.pi * t / self.day + phase))
        u = _u01(self._hash(ids, _SALT_AVAIL, nonce=int(t) + 1))
        return u < p

    def sample_cohort(self, k: int, t: float, nonce: int = 0,
                      tries: int = 8) -> np.ndarray:
        """Up to k distinct available client ids at simulated time t,
        deterministic in (seed, t-bucket, nonce).  May return fewer than k
        (or none) when availability is low — the async engine retries later
        in simulated time."""
        rng = np.random.default_rng(
            [int(self.seed), int(nonce), int(t) + 1])
        picked: list = []
        seen: set = set()
        for _ in range(tries):
            if len(picked) >= k:
                break
            cand = rng.integers(0, self.n_clients, size=max(4 * k, 16))
            ok = self.available(cand, t)
            for cid in cand[ok]:
                if int(cid) not in seen:
                    seen.add(int(cid))
                    picked.append(int(cid))
                    if len(picked) >= k:
                        break
        return np.asarray(picked[:k], np.int64)
