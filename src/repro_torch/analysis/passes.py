"""Run-time passes: in-place results, pool auditing and pool hygiene.

The counterpart of the reference's ``analysis/passes.py``.  The reference
donates its resident buffers to compiled programs and checks that XLA
aliased them (``check_donation``), and audits its compiled-program cache
(``RecompileAuditor``, ``audit_cbufs``).  The port compiles nothing: it
keeps its resident buffers by writing the result into them
(``core/round.py::flat_round`` writes ``g_buf`` and the cohort buffer in
place), and its one cache is ``ResidentDriver._pools``, the buffers of
each (padded cohort rows, admission dtype).  So:

  * ``check_in_place`` runs a program and checks that each expected
    argument still holds the program's result in its own storage: the
    same ``untyped_storage().data_ptr()`` after the call, and an op of
    the run wrote it.  A buffer replaced by a fresh one is silent — the
    program still runs, resident memory just doubles — so no numeric
    test catches it; this pass does;
  * ``PoolAuditor`` records every pool hit and allocation of the
    resident drivers while it is active, so tests can pin "a rebuilt,
    equal configuration hits" and "an int8 and an f32 cohort of one size
    never share a pool";
  * ``check_cache_keys`` is the reference's, over ``ResidentDriver
    .pool_key`` variants;
  * ``audit_pools`` checks each pool's key against its buffers.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, List, Sequence, Tuple

import torch

from repro_torch.analysis.dispatch import Recorder, tensors_in


def _ptrs(args: Sequence) -> List[List[int]]:
    return [[t.untyped_storage().data_ptr() for t in tensors_in(a)]
            for a in args]


def in_place_positions(args: Sequence, before: List[List[int]],
                       written) -> FrozenSet[int]:
    """Positions of ``args`` whose every tensor kept its storage (the
    pointers ``before`` the call) and was written (``written``: the
    storages a ``dispatch.Recorder`` saw written).  A tuple argument (a
    quantized state) holds in place only if each of its tensors does."""
    out = set()
    for i, (a, ptrs) in enumerate(zip(args, before)):
        now = _ptrs([a])[0]
        if ptrs and now == ptrs and all(p in written for p in now):
            out.add(i)
    return frozenset(out)


def run_in_place(program, args: Sequence, **recorder_kw):
    """Run ``program(*args)`` under a ``dispatch.Recorder``; returns
    (result, recorder, in-place positions)."""
    before = _ptrs(args)
    with Recorder(inputs=args, **recorder_kw) as rec:
        out = program(*args)
    return out, rec, in_place_positions(args, before, rec.written)


def check_in_place(program, args: Sequence,
                   expected: Iterable[int]) -> List[str]:
    """Violation messages for expected positions of ``args`` that did NOT
    hold ``program(*args)``'s result in place (runs the program)."""
    _, _, held = run_in_place(program, args, sweep=False)
    return [f"argument {p} does not hold the result in place "
            f"(held in place: {sorted(held) or 'none'})"
            for p in sorted(set(expected)) if p not in held]


def check_cache_keys(keyed: Iterable[Tuple[str, Tuple]]) -> List[str]:
    """Collision messages over (label, cache key) pairs: two DIFFERENT
    labels mapping to the same key means the key under-discriminates —
    those variants would silently share one pool."""
    seen: Dict[Tuple, str] = {}
    out: List[str] = []
    for label, key in keyed:
        prev = seen.get(key)
        if prev is not None and prev != label:
            out.append(f"cache-key collision: {prev!r} and {label!r} "
                       f"share one cache entry")
        seen.setdefault(key, label)
    return out


class _InstrumentedPools(dict):
    """A driver's ``_pools`` recording ("hit", key) for each lookup that
    found its pool and ("alloc", key) for each pool made."""

    def __init__(self, src, events: List[Tuple[str, Tuple]]):
        super().__init__(src)
        self._events = events

    def __contains__(self, key) -> bool:
        found = super().__contains__(key)
        if found:
            self._events.append(("hit", key))
        return found

    def __setitem__(self, key, value) -> None:
        if not super().__contains__(key):
            self._events.append(("alloc", key))
        super().__setitem__(key, value)


class PoolAuditor:
    """Context manager instrumenting ``ResidentDriver._pools``: of the
    drivers passed in and of every driver made while it is active::

        with PoolAuditor(driver) as aud:
            driver.pool(3)
            driver.fl = dataclasses.replace(driver.fl)   # rebuilt, equal
            driver.pool(3)
        assert aud.allocs == 1 and aud.hits == 1

    An allocation where a hit was expected means the key
    over-discriminates (a buffer per call: resident memory grows); a hit
    where an allocation was expected means it under-discriminates (an
    int8 cohort handed the f32 pool).  ``events`` holds the full (event,
    key) sequence."""

    def __init__(self, *drivers):
        self.events: List[Tuple[str, Tuple]] = []
        self._drivers = list(drivers)

    def __enter__(self) -> "PoolAuditor":
        from repro_torch.core import round as round_mod
        cls = round_mod.ResidentDriver
        self._cls, self._init = cls, cls.__init__
        auditor = self

        def init(drv, *a, **kw):
            auditor._init(drv, *a, **kw)
            auditor._wrap(drv)
        cls.__init__ = init
        for drv in self._drivers:
            self._wrap(drv)
        return self

    def _wrap(self, drv) -> None:
        drv._pools = _InstrumentedPools(drv._pools, self.events)
        if drv not in self._drivers:
            self._drivers.append(drv)

    def __exit__(self, *exc) -> None:
        self._cls.__init__ = self._init
        for drv in self._drivers:
            drv._pools = dict(drv._pools)
        return None

    def _count(self, kind: str) -> int:
        return sum(1 for e, _ in self.events if e == kind)

    @property
    def hits(self) -> int:
        return self._count("hit")

    @property
    def allocs(self) -> int:
        return self._count("alloc")

    def report(self) -> Dict[str, int]:
        return {"hits": self.hits, "allocs": self.allocs}


def audit_pools(driver) -> List[str]:
    """Hygiene check over a ``ResidentDriver``'s pools (``._pools``:
    (padded rows, admission dtype) -> (f32 training buffer, quantized
    state or None)): each key's rows must be its buffers' (this rank's
    share of them) and its dtype theirs."""
    from repro_torch.core import flat
    from repro_torch.sharding import cohort as csh
    out: List[str] = []
    ds = csh.data_shards(driver.mesh)
    S = driver.index.n_segments
    for (rows, dtype), (c_buf, qstate) in driver._pools.items():
        r = rows // ds
        if tuple(c_buf.shape) != (r, driver.index.n_padded) \
                or c_buf.dtype != torch.float32:
            out.append(f"_pools[{rows}, {dtype}] training buffer is "
                       f"{c_buf.dtype} {tuple(c_buf.shape)}, expected f32 "
                       f"({r}, {driver.index.n_padded})")
        if (qstate is None) != (dtype == "f32"):
            out.append(f"_pools[{rows}, {dtype}] "
                       f"{'lacks' if qstate is None else 'holds'} a "
                       f"quantized state")
            continue
        if qstate is None:
            continue
        want = flat.update_dtype_of(dtype)
        for name, t, dt, lead in (("x_q", qstate[0], want, None),
                                  ("scales", qstate[1], None, S),
                                  ("e", qstate[2], want, None),
                                  ("e_scales", qstate[3], None, S)):
            if t.shape[0] != r or (dt is not None and t.dtype != dt) \
                    or (lead is not None and t.shape[1] != lead):
                out.append(f"_pools[{rows}, {dtype}] {name} is {t.dtype} "
                           f"{tuple(t.shape)}: the key does not match it")
    return out
