"""Peak live bytes of one run of a program.

The counterpart of the reference's ``analysis/memory.py``, whose
``analyze`` sweeps the live intervals of a compiled module's schedule.
The port has no schedule: it runs eagerly, so the peak is taken from the
run itself, in one of two ways.

  * **On the card**: the caching allocator's own count.
    ``torch.cuda.reset_peak_memory_stats`` before the call and
    ``max_memory_allocated`` after it, less what was allocated at the
    start, plus the bytes of the program's inputs, which are resident
    already (the reference's parameters "live the whole program").
  * **On the CPU** (and beside the allocator's count on the card): a sweep
    over the storages the run makes (``LiveSet``, fed by
    ``dispatch.Recorder``).  The input storages are live from the start;
    each new output storage is charged at the op that made it and freed
    when its last reference dies (``weakref.finalize`` on the storage, so
    a view keeps it alive).  In-place ops and views make no storage.
    Storages made and freed inside a ``kernels.build.kernel_scope`` are
    not charged, only those that outlive it: the reference's "fusions are
    atomic" rule, which makes the card's kernel and the CPU's plain
    version count alike.

Both count the bytes a run holds, not what the allocator rounds them up
to, so the sweep is a lower bound of the card's figure.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, Tuple


@dataclass(frozen=True)
class MemoryEstimate:
    """Peak memory of one run.

    peak_bytes   peak live bytes
    peak_index   the op (in execution order) at which the peak was reached
                 (-1 for the allocator's count, which has no op)
    top          largest live buffers at the peak: ((name, bytes), ...)
    source       ``"sweep"`` or ``"allocator"``
    """
    peak_bytes: int
    peak_index: int
    top: Tuple[Tuple[str, int], ...] = ()
    source: str = "sweep"


@dataclass
class LiveSet:
    """Live-storage sweep: ``charge`` a storage when it is made, ``free``
    it when it dies.  Inside a scope (``open_scope``/``close_scope``) new
    storages are held aside and charged only if they are still alive when
    the outermost scope closes."""
    live: Dict[int, Tuple[str, int]] = field(default_factory=dict)
    pending: Dict[int, Tuple[str, int]] = field(default_factory=dict)
    bytes: int = 0
    peak: int = 0
    peak_index: int = 0
    top: Tuple[Tuple[str, int], ...] = ()
    index: int = 0
    depth: int = 0
    _top_stale: bool = False

    def charge(self, key: int, name: str, nbytes: int) -> None:
        if key in self.live or key in self.pending:
            return
        if self.depth:
            self.pending[key] = (name, nbytes)
            return
        self.live[key] = (name, nbytes)
        self.bytes += nbytes
        if self.bytes > self.peak:
            self.peak, self.peak_index = self.bytes, self.index
            self._top_stale = True

    def free(self, key: int) -> None:
        if self.pending.pop(key, None) is not None:
            return
        if key in self.live:
            if self._top_stale and self.bytes == self.peak:
                self._take_top()
            self.bytes -= self.live.pop(key)[1]

    def open_scope(self) -> None:
        self.depth += 1

    def close_scope(self) -> None:
        self.depth -= 1
        if self.depth == 0:
            pending, self.pending = self.pending, {}
            for key, (name, nbytes) in pending.items():
                self.charge(key, name, nbytes)

    def _take_top(self) -> None:
        self.top = tuple(heapq.nlargest(5, self.live.values(),
                                        key=lambda v: v[1]))
        self._top_stale = False

    def estimate(self) -> MemoryEstimate:
        if self._top_stale:
            self._take_top()
        return MemoryEstimate(self.peak, self.peak_index, self.top, "sweep")


def analyze(fn, *args, **kwargs) -> MemoryEstimate:
    """Peak live bytes of ``fn(*args, **kwargs)``: the allocator's count
    where an input lies on the card, else the storage sweep."""
    from repro_torch.analysis.dispatch import Recorder
    with Recorder(inputs=(args, kwargs)) as rec:
        fn(*args, **kwargs)
    return rec.memory
