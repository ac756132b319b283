"""The program's own spans and counters (``repro_torch.tracing``) in a
traced run: a cell run as ``bench/run.py`` runs it, with the program's
recording on over the window of a ``--trace 1`` run, and the per-layer
metrics that read it.

    python3 bench/program_trace.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

prints the result line of ``bench/run.py`` with ``METRICS`` added to the
cell's per-layer metrics.  ``--trace 0`` runs are ``bench/run.py``'s: no
recording is started.

``ProgramHarness`` is ``harness.Harness`` with three additions, which
leave the stretch's bounds, its busy and window arithmetic, every existing
metric and the outside spans (``harness.Spans``) as they are:

* ``window`` starts a recording for the window of a traced run, sets its
  unit as the window advances and stops it after;
* ``_stretch_begin`` takes a host stamp immediately before the marker's
  launch: a host time ``t`` (``time.perf_counter_ns``) falls on the device
  timeline at the marker's start + (t − stamp);
* ``read_trace`` names each idle gap of the stretch by the innermost
  program span open on the host when the gap began (else the outside
  span's label, else "outside spans"), and counts the device kernels whose
  start falls inside each program span's CUDA-event interval.

Without ``repro_torch.tracing`` (a program older than it) nothing is
recorded and the program's metrics read None."""
from __future__ import annotations

import bisect
import collections
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import harness  # noqa: E402

# BENCHMARK.json's entries of the metrics that read the program's recording
_ROUND, _SSM = ["smollm-135m.round"], ["mamba2-130m.round"]
_MERGES = ["smollm-135m.merge-f32", "smollm-135m.merge-int8"]


def _metric(name, unit, source, layer, moves, workloads):
    return {"name": name, "unit": unit,
            "better": "lower", "source": source, "layer": layer,
            "moves": moves, "workloads": workloads}


METRICS = [
    _metric("fwd_bwd_ms.round", "ms", "program_span", "local training",
            "round_ms", _ROUND),
    _metric("fwd_bwd_ms.round.ssm", "ms", "program_span", "local training",
            "round_ms.ssm", _SSM),
    _metric("update_ms.round", "ms", "program_span", "local training",
            "round_ms", _ROUND),
    _metric("update_ms.round.ssm", "ms", "program_span", "local training",
            "round_ms.ssm", _SSM),
    _metric("update_kernels_per_step.round", "kernels", "device_trace",
            "local training", "round_ms", _ROUND),
    _metric("update_kernels_per_step.round.ssm", "kernels", "device_trace",
            "local training", "round_ms.ssm", _SSM),
    _metric("host_syncs.round", "syncs", "program_counter", "local training",
            "round_ms", _ROUND),
    _metric("host_syncs.round.ssm", "syncs", "program_counter",
            "local training", "round_ms.ssm", _SSM),
    _metric("densities_ms.merge", "ms", "program_span", "aggregation",
            "merge_rate", _MERGES),
    _metric("norms_ms.merge", "ms", "program_span", "aggregation",
            "merge_rate", _MERGES),
    _metric("accumulate_ms.merge", "ms", "program_span", "aggregation",
            "merge_rate", _MERGES),
]


def _tracing():
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing


def _depth(span) -> int:
    d = 0
    while span.parent is not None:
        span, d = span.parent, d + 1
    return d


class Innermost:
    """The innermost of nested intervals [(start, end, name, depth)] at a
    time: the deepest one that holds it."""

    def __init__(self, spans: Sequence[Tuple[int, int, str, int]]):
        self.cuts = sorted({a for a, *_ in spans} | {b for _, b, *_ in spans})
        self.names: List[Optional[str]] = []
        for t in self.cuts:
            best = None
            for a, b, name, depth in spans:
                if a <= t < b and (best is None or depth > best[1]):
                    best = (name, depth)
            self.names.append(None if best is None else best[0])

    def at(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.cuts, t) - 1
        return self.names[i] if i >= 0 else None


def name_gaps(dev, program, outside, lo: int, hi: int) -> List[list]:
    """The idle gaps of the stretch [lo, hi) (device ns), as
    ``harness.reduce_trace`` finds them in the device intervals ``dev``
    [(start, end, name)], each named "<span> -> <device function that ended
    it>": <span> the innermost of the program's spans ``program``
    [(start, end, name, depth)] at the gap's start, else the outside span
    of ``outside`` [(start, end, label)] the stream was in, else "outside
    spans".  The ten longest, [[name, seconds]]."""
    dev = sorted((max(a, lo), min(b, hi), n) for a, b, n in dev
                 if b > lo and a < hi)
    prog, out = Innermost(program), Innermost(
        [(a, b, n, i) for i, (a, b, n) in enumerate(sorted(outside))])
    gaps: Dict[str, int] = collections.defaultdict(int)

    def label(t):
        return prog.at(t) or out.at(t) or "outside spans"

    prev_end = lo
    for a, b, n in dev:
        if a > prev_end:
            gaps[f"{label(prev_end)} -> {harness._short(n)}"] += a - prev_end
        prev_end = max(prev_end, b)
    if hi > prev_end:
        gaps[f"{label(prev_end)} -> end"] += hi - prev_end
    return [[n, t / 1e9] for n, t in sorted(gaps.items(),
                                            key=lambda kv: -kv[1])[:10]]


def kernels_within(dev, spans) -> Dict[str, int]:
    """Per span name, the device kernels (copies and fills left out) whose
    start falls inside one of its spans [(start, end, name)]."""
    starts = sorted(a for a, _, n in dev
                    if not harness._short(n).startswith(("Memcpy", "Memset")))
    out: Dict[str, int] = collections.defaultdict(int)
    for a, b, name in spans:
        out[name] += (bisect.bisect_left(starts, b)
                      - bisect.bisect_left(starts, a))
    return dict(out)


def device_events(prof) -> Tuple[list, list]:
    """(device intervals, marker intervals) of a trace, [(start, end,
    name)] each, split as ``harness.read_trace`` splits them."""
    dev, marks = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        (marks if harness.MARKER in e.name() else dev).append(span)
    return dev, marks


class ProgramHarness(harness.Harness):
    """``harness.Harness`` with the program's recording in traced runs."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.program = None          # the recording of a traced run
        self.program_kernels: Dict[str, int] = {}
        self._stamp: Optional[int] = None

    def window(self, step, stretch_at, stretch_len, min_units=1):
        tracing = _tracing() if self.trace else None
        if tracing is None:
            return super().window(step, stretch_at, stretch_len, min_units)
        rec = tracing.start(self.device)

        def unit(i):
            rec.unit = i
            return step(i)
        try:
            return super().window(unit, stretch_at, stretch_len, min_units)
        finally:
            self.program = tracing.stop()

    def _stretch_begin(self) -> None:
        for k in harness.loaded_kernels().values():
            k.by_shape.clear()
        self.sync()
        if self.cuda:
            self._stamp = time.perf_counter_ns()
            torch.cuda._sleep(1000)
            self._marks = [torch.cuda.Event(enable_timing=True)]
            self._marks[0].record()
        self._host = time.perf_counter()

    def read_trace(self) -> None:
        prof = self._prof
        super().read_trace()
        if self.program is None:
            return
        self.diag.update(self.program_totals())
        if prof is None:
            return
        dev, marks = device_events(prof)
        m0, lo, _ = marks[-1]
        hi = lo + int(self._marks[0].elapsed_time(self._marks[1]) * 1e6)
        units = set(self.stretch)
        mine = [s for s in self.program.spans if s.unit in units]

        def on_device(t):                    # a host stamp
            return m0 + (t - self._stamp)

        def at(ev):                          # a CUDA event
            return lo + int(self._marks[0].elapsed_time(ev) * 1e6)

        outside = [(at(a), at(b), label) for label, unit, a, b
                   in self.spans.calls if unit in units]
        self.trace_info["idle_gaps"] = name_gaps(
            dev, [(on_device(s.t0), on_device(s.t1), s.name, _depth(s))
                  for s in mine], outside, lo, hi)
        self.program_kernels = kernels_within(
            [d for d in dev if lo <= d[0] < hi],
            [(at(s.events[0]), at(s.events[1]), s.name) for s in mine])

    def program_totals(self) -> dict:
        """Over the window's untraced units: each program span's mean
        stream ms a unit (``program_ms``), the share of a span's stream
        time its direct children take (``program_cover``) and each
        counter's mean a unit (``program_counts``)."""
        units = set(self.untraced_units())
        ms: Dict[str, float] = collections.defaultdict(float)
        kids: Dict[str, float] = collections.defaultdict(float)
        counts: Dict[str, int] = collections.Counter()
        for s in self.program.spans:
            if s.unit not in units:
                continue
            t = s.stream_ms()
            ms[s.name] += t
            if s.parent is not None:
                kids[s.parent.name] += t
            counts.update(s.counts or {})
        counts.update({k: v for (u, k), v in self.program.loose.items()
                       if u in units})
        n = max(len(units), 1)
        return {"program_ms": {k: v / n for k, v in ms.items()},
                "program_cover": {k: v / ms[k] for k, v in kids.items()
                                  if ms[k] > 0},
                "program_counts": {k: v / n for k, v in counts.items()}}


# -- the readers of ``METRICS`` -------------------------------------------

def span_mean(h, name: str) -> Optional[float]:
    """Mean stream ms per window unit of the program span ``name`` (summed
    over the unit's spans), the units the profiler ran over left out."""
    rec = getattr(h, "program", None)
    if rec is None:
        return None
    ms = [v for u, v in rec.per_unit_ms(name).items()
          if u >= 0 and u not in h.profiled]
    return sum(ms) / len(ms) if ms else None


def count_mean(h, name: str) -> Optional[float]:
    """Mean of the program counter ``name`` per window unit, the units the
    profiler ran over left out."""
    rec = getattr(h, "program", None)
    units = h.untraced_units()
    if rec is None or not units:
        return None
    per = rec.per_unit_count(name)
    return sum(per.get(u, 0) for u in units) / len(units)


def kernels_per_step(h, name: str) -> Optional[float]:
    """Device kernels of the stretch that started inside the program span
    ``name``, over the stretch's client steps."""
    n = getattr(h, "program_kernels", {}).get(name)
    if n is None:
        return None
    return n / (h.work["client_steps"] * len(h.stretch))


_benchmark = harness.benchmark


def benchmark() -> dict:
    """``BENCHMARK.json`` with ``METRICS`` added where it lacks them."""
    bm = _benchmark()
    have = {m["name"] for m in bm["per_layer"]}
    bm["per_layer"] += [m for m in METRICS if m["name"] not in have]
    return bm


def main(argv=None) -> int:
    from bench import run
    run.prepare_environment()
    # bench/run.py's command, its harness and metric list these
    harness.Harness = ProgramHarness
    harness.benchmark = benchmark
    return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
