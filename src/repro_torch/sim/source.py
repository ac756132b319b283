"""Client-arrival sources feeding the async round engine.

The engine (``repro_torch.core.async_round.run_async``) pulls work through
one callable interface::

    source(dispatch_idx, sim_time, k) -> None | (specs, batches, latencies)

returning at most ``k`` clients ready to be dispatched now: their
``ClientSpec``s, the client-stacked local batches (a dict of tensors whose
leading axis is the returned cohort size, as ``launch.train``'s per-round
batches) and per-client simulated latencies (dispatch -> update arrival).
``None`` (or an empty draw) means nobody is available; the engine advances
simulated time and retries.

Three implementations:

  * ``ParitySource`` — the parity anchor: dispatch d hands over exactly
    ``data_fn(d)``'s full cohort with constant latency, so every merge
    consumes a complete fresh cohort and the engine reduces to
    ``run_rounds`` (bit-equal).
  * ``TraceSource`` — a deterministic infinite client stream (data_fn
    cohorts unrolled client by client) with scripted per-client latencies.
  * ``PopulationSource`` — cohorts sampled from a ``ClientPopulation``
    availability trace, latencies drawn per dispatch from the client's
    device class.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.sim.population import ClientPopulation, _u01
from repro_torch.tree import tree_map


class ParitySource:
    """Full-cohort deterministic arrivals (the async engine's parity mode).

    Requires the whole pool free (``k >=`` the cohort size) before handing
    out the next cohort: a partial dispatch would break round-for-round
    equivalence with ``run_rounds``.
    """

    def __init__(self, data_fn: Callable[[int], Tuple], latency: float = 1.0):
        self.data_fn = data_fn
        self.latency = float(latency)

    def __call__(self, d: int, t: float, k: int):
        specs, batches = self.data_fn(d)
        if k < len(specs):
            return None                     # wait for the pool to drain
        return specs, batches, np.full(len(specs), self.latency)


class TraceSource:
    """Deterministic client stream with scripted latencies.

    ``data_fn`` cohorts are unrolled into an infinite per-client queue;
    each call hands the engine the next ``k`` clients with
    ``latency_fn(i)`` (i = global client index in the stream).  A skewed
    ``latency_fn`` scripts stragglers and forces partial, staleness-bearing
    merges.
    """

    def __init__(self, data_fn: Callable[[int], Tuple],
                 latency_fn: Callable[[int], float]):
        self.data_fn = data_fn
        self.latency_fn = latency_fn
        self._queue: List[Tuple] = []       # (spec, per-client batch dict)
        self._next_cohort = 0
        self._next_client = 0

    def _refill(self, k: int) -> None:
        while len(self._queue) < k:
            specs, batches = self.data_fn(self._next_cohort)
            self._next_cohort += 1
            for i, s in enumerate(specs):
                self._queue.append((s, tree_map(lambda a, i=i: a[i], batches)))

    def __call__(self, d: int, t: float, k: int):
        self._refill(k)
        take, self._queue = self._queue[:k], self._queue[k:]
        specs = [s for s, _ in take]
        batches = tree_map(lambda *xs: torch.stack(xs), *[b for _, b in take])
        lat = np.asarray([self.latency_fn(self._next_client + i)
                          for i in range(len(take))], np.float64)
        self._next_client += len(take)
        return specs, batches, lat


class PopulationSource:
    """Arrivals sampled from a ``ClientPopulation`` availability trace.

    ``spec_fn(ids) -> [ClientSpec]`` maps sampled client ids to their
    architectures and data counts; ``batch_fn(d, ids)`` synthesizes the
    stacked local batches of one dispatch.  Latencies are drawn per
    (client, dispatch) from the device class, deterministically, so a run
    is a replayable trace.
    """

    def __init__(self, population: ClientPopulation,
                 spec_fn: Callable[[np.ndarray], Sequence],
                 batch_fn: Callable[[int, np.ndarray], object]):
        self.population = population
        self.spec_fn = spec_fn
        self.batch_fn = batch_fn

    def __call__(self, d: int, t: float, k: int):
        ids = self.population.sample_cohort(k, t, nonce=d)
        if ids.size == 0:
            return None
        lat = self.population.latency(ids, nonce=d)
        return list(self.spec_fn(ids)), self.batch_fn(d, ids), lat


def make_class_spec_fn(cfg, population: ClientPopulation,
                       n_data_range: Tuple[int, int] = (100, 250),
                       malicious_frac: float = 0.0):
    """Spec factory tying architecture width to the device class (slow
    mobile tiers train thin models): returns ``spec_fn(ids)`` for
    ``PopulationSource`` that derives each client's ``ClientSpec`` from its
    hashed class, n_data (inclusive range) and an id-hashed malicious
    flag, without materializing the population."""
    from repro_torch.core.server import ClientSpec
    from repro_torch.models.masks import (ClientArch, full_client,
                                          max_section_depths)
    maxd = max_section_depths(cfg)
    archs = {c.width_mult: ClientArch(c.width_mult, maxd)
             for c in population.classes}

    def spec_fn(ids: np.ndarray):
        cls = population.device_class(ids)
        u = _u01(population._hash(np.asarray(ids), 0x5bd1e995))
        lo, hi = n_data_range
        nd = (lo + np.floor(u * (hi - lo + 1))).astype(np.int64).clip(lo, hi)
        mal = _u01(population._hash(np.asarray(ids), 0x2545f491)) \
            < malicious_frac
        return [ClientSpec(
            arch=full_client(cfg) if mal[i]       # attackers go full-size
            else archs[population.classes[cls[i]].width_mult],
            n_data=int(nd[i]), malicious=bool(mal[i]))
            for i in range(len(ids))]
    return spec_fn
