"""Continuous-arrival async round engine (FedBuff-style, bounded staleness).

The resident driver (``repro_torch.core.round``) is synchronous: one
straggler stalls the whole cohort.  This engine keeps a fixed-capacity
**slot pool**, a resident (capacity, N) cohort buffer whose rows take
client updates as they land in simulated time, and **merges** the arrived
rows into the (N,) global whenever ``merge_k`` rows are ready or a
deadline fires.  Staleness is bounded and discounted: a row dispatched at
global version v and merged at version v' carries weight
``n_data * staleness_weight(v' - v)``, zero beyond ``staleness_max``.  The
weights go in as the ``n_data`` argument of ``flat.aggregate_buffers``
over the whole pool, so a free, unarrived or over-stale row is inert in
every reduction (weight 0); the pool starts zeroed, so such a row is never
garbage.

Device work, on tensors:

  * **admit** — the b dispatched clients train against the current global
    into a (b, N) scratch buffer (``server.cohort_update``), are grafted
    (Alg. 2) when the strategy grafts, and are copied into their pool rows.
    With a quantized admission dtype the pool is the state (x_q, scales,
    e, e_scales): the slots' four pieces are gathered, admitted into with
    server-side error feedback (``flat.admit_quantized``: the residual of
    the slot's previous occupant re-enters before quantizing, inside the
    new client's density) and written back.
  * **merge** — ``flat.aggregate_buffers(pregrafted=True)`` over the whole
    pool with the staleness-discounted weights; the pool is read only, so
    in-flight rows survive the merge.

Admission is lazy: a dispatched group trains at the first merge (or next
dispatch) after it was handed out.  The global does not change between
merges, so this equals training at dispatch time, and it makes the
**parity fast path** exact: a merge that consumes one full fresh dispatch
(every slot, all arrived, staleness 0) runs the resident round
``round.flat_round`` itself, bit-equal to ``run_rounds``.  In quantized
mode the pool's quantized state is that round's state, so error feedback
carries over between the two paths.

Simulated time comes from the source (``repro_torch.sim``): the engine is a
deterministic event loop over (dispatch, arrival, deadline) events, and
its host state (clock, arrivals, weights) is numpy float64, so a (seed,
trace) pair replays exactly.  Attackers' label permutations come from
``perm_fn(dispatch_idx, b, n)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import flat
from repro_torch.core import round as round_mod
from repro_torch.core.fedfa import STRATEGIES
from repro_torch.core.server import (ClientSpec, FLConfig, cohort_update,
                                     default_class_masks, stack_runtimes)
from repro_torch.models.masks import full_client

Params = Dict[str, Any]


@dataclass(frozen=True)
class AsyncConfig:
    """Slot-pool and staleness policy of the async engine.

    capacity       fixed number of client slots in the pool
    merge_k        merge as soon as this many rows have arrived
                   (1 = fully async FedAsync-style; capacity = full pool)
    staleness_max  rows older than this many global versions are dropped
                   (their influence is exactly zero)
    deadline       merge whatever has arrived after this much simulated
                   time since the last merge (inf = count-triggered only)
    discount       staleness weight shape: "rsqrt" (1/sqrt(1+s), FedBuff's
                   default) or "const" (1 up to the bound)
    retry_dt       simulated-time step while starved (no clients, none in
                   flight); max_retries consecutive starved steps raise.
    """
    capacity: int = 8
    merge_k: int = 4
    staleness_max: int = 4
    deadline: float = float("inf")
    discount: str = "rsqrt"
    retry_dt: float = 1.0
    max_retries: int = 1000

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if not 1 <= self.merge_k <= self.capacity:
            raise ValueError(
                f"merge_k must be in [1, capacity={self.capacity}], "
                f"got {self.merge_k}")
        if self.staleness_max < 0:
            raise ValueError("staleness_max must be >= 0")
        if self.discount not in ("rsqrt", "const"):
            raise ValueError(f"unknown discount {self.discount!r}")

    @classmethod
    def parity(cls, capacity: int) -> "AsyncConfig":
        """The parity-mode policy: full-pool merges, zero tolerated
        staleness, no deadline.  With a full-cohort deterministic source
        (``sim.ParitySource``) every merge takes the fast path and the run
        is bit-equal to ``run_rounds``."""
        return cls(capacity=capacity, merge_k=capacity, staleness_max=0,
                   deadline=float("inf"))


def staleness_weight(s, acfg: AsyncConfig) -> np.ndarray:
    """(…,) staleness discount: w(0) = 1, decaying per ``acfg.discount``,
    exactly 0 beyond ``staleness_max``.  Multiplies ``n_data``, so stale
    clients keep their data-size weighting but lose influence with age."""
    s = np.asarray(s, np.float64)
    base = 1.0 / np.sqrt(1.0 + s) if acfg.discount == "rsqrt" \
        else np.ones_like(s)
    return np.where(s <= acfg.staleness_max, base, 0.0).astype(np.float32)


class SlotPool:
    """Host-side bookkeeping of the (rows, N) device pool.  ``capacity``
    slots; rows with id >= capacity (a padded pool) are never dispatched
    into and always weigh 0."""

    def __init__(self, capacity: int, rows: int):
        self.capacity, self.rows = int(capacity), int(rows)
        self.occupied = np.zeros(rows, bool)
        self.arrival = np.full(rows, np.inf)
        self.version = np.zeros(rows, np.int64)
        self.nd = np.zeros(rows, np.float32)
        self.loss = np.full(rows, np.nan, np.float32)
        self.specs: List[Optional[ClientSpec]] = [None] * rows

    def free_slots(self) -> np.ndarray:
        return np.flatnonzero(~self.occupied[:self.capacity])

    def ready(self, now: float) -> np.ndarray:
        return self.occupied & (self.arrival <= now)

    def admit(self, slots: np.ndarray, specs: Sequence[ClientSpec],
              latencies: np.ndarray, now: float, version: int) -> None:
        self.occupied[slots] = True
        self.arrival[slots] = now + np.asarray(latencies, np.float64)
        self.version[slots] = version
        self.nd[slots] = [float(s.n_data) for s in specs]
        self.loss[slots] = np.nan
        for i, s in zip(slots, specs):
            self.specs[int(i)] = s

    def release(self, mask: np.ndarray) -> None:
        self.occupied[mask] = False
        self.arrival[mask] = np.inf
        self.nd[mask] = 0.0
        for i in np.flatnonzero(mask):
            self.specs[int(i)] = None


class AsyncEngine:
    """Deterministic event loop over (dispatch, arrival, deadline) events.

    Construct with the flattened global buffer (on the device the engine
    runs on), then drive ``step()`` until enough merges happened
    (``run_async`` does this).  ``g_buf`` is updated in place.

    ``on_merge`` (optional) receives a host-side snapshot dict per merge
    ({"x", "w", "specs", "g_before", "g_after", "loss", "pregrafted"},
    rows aligned).
    """

    def __init__(self, g_buf: torch.Tensor, cfg: ArchConfig, fl: FLConfig,
                 index: flat.FlatIndex, source: Callable, *,
                 acfg: AsyncConfig,
                 perm_fn: Optional[Callable[[int, int, int],
                                            torch.Tensor]] = None,
                 on_merge: Optional[Callable[[dict], None]] = None):
        self.cfg, self.fl, self.index = cfg, fl, index
        self.source, self.acfg, self.on_merge = source, acfg, on_merge
        self.perm_fn = perm_fn or round_mod.default_perms(fl.seed)
        self.device = g_buf.device
        self.rows = acfg.capacity
        self.pool = SlotPool(acfg.capacity, self.rows)
        self.g_buf = g_buf
        # f32: one (rows, N) pool; a quantized admission dtype: the state
        # (x_q, scales, e, e_scales), as the resident quantized round's
        self._qmode = fl.update_dtype != "f32"
        self._graft = bool(STRATEGIES[fl.strategy].get("graft", False))
        self._c_buf: Any = None
        # simulated clock and counters
        self.now = 0.0
        self.version = 0          # bumps once per merge
        self.dispatch_idx = 0
        self.last_merge_t = 0.0
        self.merges = 0
        self.merged_rows = 0
        self.dropped_rows = 0     # over-stale rows, whose influence was 0
        self._pending = None      # latest dispatch group not yet trained
        self._retries = 0
        self._pad_spec = ClientSpec(arch=full_client(cfg), n_data=0)

    # -- event loop --------------------------------------------------------

    def step(self) -> Optional[float]:
        """Advance by one event; returns the merge's mean loss when this
        step merged, else None."""
        free = self.pool.free_slots()
        if free.size:
            res = self.source(self.dispatch_idx, self.now, int(free.size))
            if res is not None and len(res[0]) > 0:
                self._dispatch(free, *res)
                return None
        ready = self.pool.ready(self.now)
        n_ready = int(ready.sum())
        deadline_t = self.last_merge_t + self.acfg.deadline
        if n_ready >= self.acfg.merge_k or \
                (self.now >= deadline_t and n_ready >= 1):
            return self._merge(ready)
        if self.now >= deadline_t:
            # deadline fired over an empty ready set: re-arm, not a merge
            self.last_merge_t = self.now
            return None
        # advance simulated time to the next event
        inflight = self.pool.occupied & (self.pool.arrival > self.now)
        targets = []
        if inflight.any():
            targets.append(float(self.pool.arrival[inflight].min()))
        if np.isfinite(self.acfg.deadline) and self.pool.occupied.any():
            targets.append(deadline_t)
        if targets:
            self.now = max(self.now, min(targets))
            self._retries = 0
            return None
        # nothing in flight and the source had nothing: starved
        self._retries += 1
        if self._retries > self.acfg.max_retries:
            raise RuntimeError(
                f"async engine starved: source produced no clients for "
                f"{self._retries} consecutive retries (sim t={self.now:g})")
        self.now += self.acfg.retry_dt
        return None

    def _dispatch(self, free: np.ndarray, specs, batches, latencies) -> None:
        b = len(specs)
        if b > free.size:
            raise ValueError(
                f"source returned {b} clients for {free.size} free slots")
        slots = free[:b]
        # a dispatch group trains at the first merge after it was handed
        # out; a second dispatch before that merge trains the first (both
        # against the same global version)
        self._materialize()
        self._pending = (slots, list(specs), batches, self.dispatch_idx)
        self.pool.admit(slots, specs, np.asarray(latencies, np.float64),
                        self.now, self.version)
        self.dispatch_idx += 1
        self._retries = 0

    # -- device work -------------------------------------------------------

    def _ensure_cbuf(self) -> None:
        """Allocate the zeroed pool on first use: a free or unarrived row
        is read by every merge with weight 0, and 0 · NaN is NaN."""
        if self._c_buf is not None:
            return
        if self._qmode:
            self._c_buf = round_mod.fresh_quant_state(
                self.index, self.rows, self.fl.update_dtype, self.device)
        else:
            self._c_buf = torch.zeros((self.rows, self.index.n),
                                      dtype=torch.float32, device=self.device)

    def _pool_x(self) -> np.ndarray:
        """Host f32 copy of the pool rows for ``on_merge`` snapshots,
        dequantized in quantized mode (the density mask is already in the
        stored values)."""
        if self._qmode:
            return flat.dequantize_cohort(self.index, self._c_buf[0],
                                          self._c_buf[1]).cpu().numpy()
        return self._c_buf.cpu().numpy().copy()

    def _perms(self, d: int, specs, batches) -> Optional[torch.Tensor]:
        if not any(s.malicious for s in specs):
            return None
        n = round_mod.label_count(batches, self.fl.task)
        return self.perm_fn(d, len(specs), n).to(self.device)

    def _materialize(self) -> None:
        """Train the pending dispatch group (if any) against the current
        global and write it into its slots."""
        if self._pending is None:
            return
        slots, specs, batches, d = self._pending
        self._pending = None
        b = len(specs)
        masks, gates, gmaps, _nd, cms, mal = \
            stack_runtimes(self.cfg, specs, self.device)
        perms = self._perms(d, specs, batches)
        self._ensure_cbuf()
        x = torch.empty((b, self.index.n), dtype=torch.float32,
                        device=self.device)
        losses = cohort_update(
            flat.unflatten(self.index, self.g_buf), self.cfg, self.fl,
            self.index, masks, gates, batches,
            default_class_masks(cms, self.cfg, self.fl, b, self.device),
            mal, perms, x)
        idx = torch.as_tensor(slots, dtype=torch.int64, device=self.device)
        if self._qmode:
            # the slots' pieces (copies), admitted into, written back
            state = tuple(t.index_select(0, idx) for t in self._c_buf)
            flat.admit_quantized(self.index, self.cfg, x, masks, gmaps,
                                 self._graft, state, self.fl.update_dtype)
            for t, s in zip(self._c_buf, state):
                t.index_copy_(0, idx, s)
        else:
            # f32 rows are grafted here, so the merge runs pregrafted
            if self._graft:
                x = flat._graft_flat(self.index, x, gmaps)
            self._c_buf.index_copy_(0, idx, x)
        self.pool.loss[slots] = losses.cpu().numpy()

    def aggregate(self, w: np.ndarray, slot_specs: Sequence[ClientSpec]
                  ) -> torch.Tensor:
        """A merge's device work: ``flat.aggregate_buffers`` over the whole
        pool with the (rows,) weights ``w`` and the rows' specs; returns the
        new global and leaves the pool and ``g_buf`` as they were."""
        masks, gates, gmaps, _nd, _cms, _mal = \
            stack_runtimes(self.cfg, slot_specs, self.device)
        self._ensure_cbuf()
        wt = torch.as_tensor(w, device=self.device)
        kw = dict(trim=self.fl.trim, pregrafted=True,
                  **STRATEGIES[self.fl.strategy])
        if self._qmode:
            return flat.aggregate_buffers(
                self.index, self.g_buf, self._c_buf[0], self.cfg, masks,
                gates, gmaps, wt, scales=self._c_buf[1], **kw)
        return flat.aggregate_buffers(
            self.index, self.g_buf, self._c_buf, self.cfg, masks, gates,
            gmaps, wt, **kw)

    def _merge(self, ready: np.ndarray) -> Optional[float]:
        pool, acfg = self.pool, self.acfg
        if self._pending is not None:
            slots, specs, batches, d = self._pending
            if (len(specs) == pool.capacity
                    and bool(ready[slots].all())
                    and int(pool.occupied.sum()) == pool.capacity
                    and bool((pool.version[slots] == self.version).all())):
                return self._merge_parity(slots, specs, batches, d)
        self._materialize()
        s = self.version - pool.version          # (rows,) staleness
        keep = ready & (s <= acfg.staleness_max)
        overstale = ready & ~keep
        if not keep.any():
            # every arrived row exceeded the bound: drop them (influence
            # exactly 0) and re-arm the deadline; not a merge
            self.dropped_rows += int(overstale.sum())
            pool.release(overstale)
            self.last_merge_t = self.now
            return None
        w = np.zeros(self.rows, np.float32)
        w[keep] = pool.nd[keep] * staleness_weight(s[keep], acfg)
        slot_specs = [pool.specs[i] if pool.occupied[i] else self._pad_spec
                      for i in range(self.rows)]
        g_prev = self.g_buf.cpu().numpy().copy() if self.on_merge else None
        self.g_buf.copy_(self.aggregate(w, slot_specs))
        loss = float(np.nanmean(pool.loss[keep]))
        if self.on_merge:
            # pool rows were grafted at admission (when the strategy
            # grafts): re-aggregating the snapshot must not graft again
            self.on_merge({"x": self._pool_x(), "w": w.copy(),
                           "specs": slot_specs, "g_before": g_prev,
                           "g_after": self.g_buf.cpu().numpy().copy(),
                           "loss": loss, "pregrafted": self._graft})
        self.merged_rows += int(keep.sum())
        self.dropped_rows += int(overstale.sum())
        pool.release(ready)                      # over-stale rows too
        self.version += 1
        self.merges += 1
        self.last_merge_t = self.now
        return loss

    def _merge_parity(self, slots, specs, batches, d) -> float:
        """Parity fast path: this merge consumes exactly one full fresh
        dispatch (every slot, all arrived, staleness 0, nothing else in
        the pool), so it runs the resident round itself."""
        pool = self.pool
        self._pending = None
        g_prev = self.g_buf.cpu().numpy().copy() if self.on_merge else None
        self._ensure_cbuf()
        perms = self._perms(d, specs, batches)
        runtimes = stack_runtimes(self.cfg, specs, self.device)
        if self._qmode:   # the pool's quantized state is the round's
            c_buf = torch.empty((len(specs), self.index.n),
                                dtype=torch.float32, device=self.device)
            lossf = float(round_mod.flat_round(
                self.g_buf, c_buf, self.cfg, self.fl, self.index, runtimes,
                batches, perms, self._c_buf))
        else:             # the round trains into the pool rows
            lossf = float(round_mod.flat_round(
                self.g_buf, self._c_buf, self.cfg, self.fl, self.index,
                runtimes, batches, perms))
        if self.on_merge:
            w = np.zeros(self.rows, np.float32)
            w[np.asarray(slots)] = [float(s.n_data) for s in specs]
            slot_specs = list(specs) + \
                [self._pad_spec] * (self.rows - len(specs))
            # the f32 round grafts inside its aggregation, so the pool rows
            # it leaves are ungrafted; the quantized round grafts before
            # quantizing
            self.on_merge({"x": self._pool_x(), "w": w,
                           "specs": slot_specs, "g_before": g_prev,
                           "g_after": self.g_buf.cpu().numpy().copy(),
                           "loss": lossf,
                           "pregrafted": self._qmode and self._graft})
        self.merged_rows += len(specs)
        pool.release(pool.occupied.copy())
        self.version += 1
        self.merges += 1
        self.last_merge_t = self.now
        return lossf


def run_async(global_params: Params, cfg: ArchConfig, fl: FLConfig,
              merges: int, source: Callable, *,
              acfg: Optional[AsyncConfig] = None, eval_every: int = 5,
              eval_fn: Optional[Callable[[int, float, Params], None]] = None,
              ckpt_path: Optional[str] = None,
              on_merge: Optional[Callable[[dict], None]] = None,
              perm_fn: Optional[Callable[[int, int, int],
                                         torch.Tensor]] = None
              ) -> Tuple[Params, List[float]]:
    """Drive the async engine on the device of ``global_params`` until
    ``merges`` merges completed.

    ``source(dispatch_idx, sim_time, k)`` supplies arriving clients (see
    ``repro_torch.sim.source``).  perm_fn(d, b, n) -> (b, n) label
    permutations for dispatch d's attackers; by default drawn from a
    ``torch.Generator`` seeded with ``fl.seed``.  Eval and checkpoints
    (``f"{ckpt_path}_m{r:05d}"``) fire at the ``round.eval_boundary``
    merge indices.  Returns (final params, per-merge mean losses over the
    rows merged).  ``merges <= 0`` returns the input untouched.
    """
    if merges <= 0:
        return global_params, []
    acfg = acfg or AsyncConfig()
    index = flat.FlatIndex(global_params)
    g_buf = flat.flatten(index, global_params)
    eng = AsyncEngine(g_buf, cfg, fl, index, source, acfg=acfg,
                      perm_fn=perm_fn, on_merge=on_merge)
    losses: List[float] = []
    # a bound on non-merging steps (starvation already raises inside
    # step(); this catches policy livelocks)
    max_steps = (merges + 1) * (acfg.max_retries + 16 * (eng.rows + 2))
    steps = 0
    while eng.merges < merges:
        loss = eng.step()
        steps += 1
        if steps > max_steps:
            raise RuntimeError(
                f"async engine made only {eng.merges}/{merges} merges in "
                f"{steps} steps — policy livelock?")
        if loss is None:
            continue
        r = eng.merges - 1
        losses.append(loss)
        if round_mod.eval_boundary(r, merges, eval_every):
            if eval_fn is not None:
                eval_fn(r, loss, flat.unflatten(index, eng.g_buf))
            if ckpt_path is not None:
                from repro_torch.checkpoint import checkpoint as ckpt_mod
                ckpt_mod.save_from_buffer(
                    f"{ckpt_path}_m{r:05d}", index, eng.g_buf,
                    meta={"merge": r, "strategy": fl.strategy,
                          "sim_time": eng.now})
    return flat.unflatten(index, eng.g_buf), losses
