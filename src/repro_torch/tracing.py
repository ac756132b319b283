"""Spans and counters of the round and the merge, kept only while a caller
records them.

``start(device)`` begins a recording and ``stop()`` ends it.  In between,
each ``span(name)`` keeps its name, its parent (the innermost span open on
the host when it began), the recording's ``unit`` (the round or merge the
caller is in), its client slot, ``time.perf_counter_ns()`` at entry and at
exit and, on a CUDA device, a pair of CUDA events recorded on the current
stream.  ``count(name, n)`` adds to a counter of the innermost open span.
Everything stays in memory until the caller reads the recording.

With no recording, ``span`` returns one shared no-op context manager and
``count`` returns at once: one global read each, no allocation, no CUDA
call and no clock read.

``to_host`` is how the round and the merge read a device value on the
host: it counts the read as ``host_syncs``, on every device, and does it.

Names are paths (``aggregate/norms``).  A span costs two event records on
the card, so loops over leaves or levels count rather than open spans.
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Optional, Tuple, TypeVar

import torch

T = TypeVar("T")

HOST_SYNCS = "host_syncs"
# CUDA events made at once when a recording's pool runs dry
_EVENT_BLOCK = 256


class Span:
    """One recorded span.  ``t0``/``t1``: host ns; ``events``: its CUDA
    event pair, or None off the card."""
    __slots__ = ("name", "parent", "unit", "client", "t0", "t1", "events",
                 "counts")

    def __init__(self, name: str, parent: Optional["Span"], unit: int,
                 client: Optional[int], events):
        self.name, self.parent, self.unit = name, parent, unit
        self.client = client
        self.events = events
        self.counts: Optional[Dict[str, int]] = None
        self.t1: Optional[int] = None
        self.t0 = time.perf_counter_ns()

    def stream_ms(self) -> float:
        """ms between its events on the stream; off the card, between its
        host stamps."""
        if self.events is None:
            return (self.t1 - self.t0) / 1e6
        return self.events[0].elapsed_time(self.events[1])


class _Open:
    """The context of one span while a recording is on."""
    __slots__ = ("rec", "span")

    def __init__(self, rec: "Recording", span: Span):
        self.rec, self.span = rec, span

    def __enter__(self) -> Span:
        return self.span

    def __exit__(self, *exc) -> bool:
        s = self.span
        if s.events is not None:
            s.events[1].record()
        s.t1 = time.perf_counter_ns()
        self.rec._open.pop()
        return False


class _Off:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class Recording:
    """The spans and counts of one recording, in the order they began."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.unit = -1
        self.spans: List[Span] = []
        # counts made with no span open, by (unit, name)
        self.loose: Dict[Tuple[int, str], int] = collections.Counter()
        self._open: List[Span] = []
        self._events: List[torch.cuda.Event] = []

    def _event(self) -> "torch.cuda.Event":
        if not self._events:
            self._events = [torch.cuda.Event(enable_timing=True)
                            for _ in range(_EVENT_BLOCK)]
        return self._events.pop()

    def open(self, name: str, client: Optional[int]) -> _Open:
        parent = self._open[-1] if self._open else None
        if client is None and parent is not None:
            client = parent.client
        events = None
        if self.cuda:
            events = (self._event(), self._event())
            events[0].record()
        s = Span(name, parent, self.unit, client, events)
        self.spans.append(s)
        self._open.append(s)
        return _Open(self, s)

    def add(self, name: str, n: int) -> None:
        if self._open:
            s = self._open[-1]
            if s.counts is None:
                s.counts = {}
            s.counts[name] = s.counts.get(name, 0) + n
        else:
            self.loose[(self.unit, name)] += n

    # -- reading -------------------------------------------------------------

    def per_unit_ms(self, name: str) -> Dict[int, float]:
        """Stream ms of the spans ``name``, summed per unit."""
        out: Dict[int, float] = collections.defaultdict(float)
        for s in self.spans:
            if s.name == name:
                out[s.unit] += s.stream_ms()
        return dict(out)

    def per_unit_count(self, name: str) -> Dict[int, int]:
        """The counter ``name`` summed per unit, over every span and the
        counts made outside spans."""
        out: Dict[int, int] = collections.Counter()
        for s in self.spans:
            if s.counts and name in s.counts:
                out[s.unit] += s.counts[name]
        for (unit, n), v in self.loose.items():
            if n == name:
                out[unit] += v
        return dict(out)

    def tree(self) -> Dict[str, dict]:
        """Per span name: its parent's name, calls, stream ms, host ms and
        counts, summed over the recording."""
        out: Dict[str, dict] = {}
        for s in self.spans:
            row = out.setdefault(s.name, {
                "parent": None if s.parent is None else s.parent.name,
                "calls": 0, "stream_ms": 0.0, "host_ms": 0.0, "counts": {}})
            row["calls"] += 1
            row["stream_ms"] += s.stream_ms()
            row["host_ms"] += (s.t1 - s.t0) / 1e6
            for k, v in (s.counts or {}).items():
                row["counts"][k] = row["counts"].get(k, 0) + v
        return out


_active: Optional[Recording] = None


def start(device) -> Recording:
    """Begin a recording on ``device``; raises if one is on already."""
    global _active
    if _active is not None:
        raise RuntimeError("a recording is on already")
    _active = Recording(device)
    return _active


def stop() -> Recording:
    """End the recording and return it, its events complete."""
    global _active
    rec, _active = _active, None
    if rec is None:
        raise RuntimeError("no recording is on")
    if rec.cuda:
        torch.cuda.synchronize(rec.device)
    return rec


def active() -> Optional[Recording]:
    """The recording that is on, or None."""
    return _active


def span(name: str, client: Optional[int] = None):
    """A span named ``name`` (client slot ``client``, else its parent's)
    while a recording is on; the shared no-op otherwise."""
    rec = _active
    if rec is None:
        return _OFF
    return rec.open(name, client)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span."""
    rec = _active
    if rec is not None:
        rec.add(name, n)


def to_host(value: torch.Tensor, read: Callable[[torch.Tensor], T]) -> T:
    """``read(value)`` (``bool``, ``torch.Tensor.tolist``, ...): a device
    value read on the host, counted as one ``host_syncs``."""
    count(HOST_SYNCS)
    return read(value)
