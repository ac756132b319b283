"""What every cell's run shares: finding a cell's files by name, the
closed-loop window, spans around the calls into the program's layers,
the profiled stretch and its reading, the per-layer metric readers, the
comparison's numbers against their limits, and the result line.

A cell is ``bench/workloads/<cell>.json`` ({"config", "traffic", "chips",
"why", "limits"}); it names ``bench/configs/<config>.json`` (the model's
sizes) and ``bench/traffic/<traffic>.json`` (the traffic's parameters and
the ``entry`` that drives it, ``bench/entries/<entry>.py``).  A per-layer
metric is ``bench/metrics/<metric>.py`` with ``read(h) -> float | None``;
a kernel's roofline reads the kernel's yardstick,
``bench/kernels/<kernel>.py``.  Which metrics a cell reports, and which
end-to-end metrics, comes from ``BENCHMARK.json``; an end-to-end metric
``<name>.<qualifier>`` is the entry's ``<name>`` under a bound of its own
(``round_ms.ssm``: ``round_ms`` in the cells that list it)."""
from __future__ import annotations

import collections
import contextlib
import importlib
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
# top-level module names no run may load: JAX, its libraries, and the JAX
# package the port was made from (compared whole: ``repro_torch`` is not
# ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def forbidden_modules() -> List[str]:
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def cell_metrics(bm: dict, cell: str, section: str) -> List[dict]:
    """The metrics of ``section`` a cell reports: those that list it, and
    those without a list that move an end-to-end metric the cell reports
    (per-layer) or that hold for every cell (end-to-end)."""
    e2e = [m for m in bm["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if section == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bm["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def metric_reader(name: str) -> Callable:
    from bench.yardstick import load_file
    return load_file(BENCH / "metrics" / f"{name}.py",
                     "bench_metric_" + name.replace(".", "_").replace("-", "_")
                     ).read


def loaded_kernels() -> Dict[str, object]:
    """Every ``CudaKernel`` of the program's kernel modules that this
    process has imported, by its C entry point's name (a kernel whose
    module was never imported launched nothing)."""
    from repro_torch.kernels.build import CudaKernel
    out = {}
    for name, mod in list(sys.modules.items()):
        if mod is not None and name.split(".")[:2] == ["repro_torch",
                                                       "kernels"]:
            for v in list(vars(mod).values()):
                if isinstance(v, CudaKernel):
                    out[v.symbol] = v
    return out


class Spans:
    """Spans around calls into the program's layers: a CUDA event pair on
    the card (host clock on the CPU) per call, tagged with the window unit
    (round or merge) it ran in."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.unit = -1
        self.calls: List[tuple] = []
        self._undo: List[tuple] = []

    @contextlib.contextmanager
    def span(self, label: str):
        if self.cuda:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            a.record()
            yield
            b.record()
        else:
            a = time.perf_counter()
            yield
            b = time.perf_counter()
        self.calls.append((label, self.unit, a, b))

    def wrap(self, module, attr: str, label: str) -> None:
        """Put a span around every call of ``module.attr``."""
        orig = getattr(module, attr)

        def wrapped(*a, **kw):
            with self.span(label):
                return orig(*a, **kw)
        setattr(module, attr, wrapped)
        self._undo.append((module, attr, orig))

    def unwrap(self) -> None:
        for module, attr, orig in reversed(self._undo):
            setattr(module, attr, orig)
        self._undo.clear()

    def per_unit_ms(self, label: str, skip=()) -> List[float]:
        """ms of ``label`` summed per window unit, units in ``skip`` and
        set-up (unit −1) left out."""
        if self.cuda:
            torch.cuda.synchronize()
        sums: Dict[int, float] = collections.defaultdict(float)
        for lab, unit, a, b in self.calls:
            if lab != label or unit < 0 or unit in skip:
                continue
            sums[unit] += (a.elapsed_time(b) if self.cuda
                           else (b - a) * 1e3)
        return [sums[u] for u in sorted(sums)]


def _short(name: str, n: int = 96) -> str:
    """A device function's name without its return type, namespace
    qualifier of an anonymous namespace, template arguments and
    parameters."""
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    for cut in ("<", "("):
        i = name.find(cut)
        if i > 0:
            name = name[:i]
    return name.strip()[:n]


def reduce_trace(dev, host, lo: int, hi: int) -> dict:
    """The stretch [lo, hi) (ns on the device's timeline) from its device
    intervals ``dev`` [(start, end, name)] and the host's spans ``host``
    [(start, end, label)]: busy is the union of the device intervals
    (overlapping kernels count once), kernels are summed by name, and each
    idle gap is named by the span the host was in when it began and the
    device function that ended it."""
    dev = sorted((max(a, lo), min(b, hi), n) for a, b, n in dev
                 if b > lo and a < hi)
    host = sorted(host)
    busy, gaps = 0, collections.defaultdict(int)
    by_name: Dict[str, list] = collections.defaultdict(lambda: [0, 0])
    cur_a = cur_b = None

    def host_at(t):
        best = "outside spans"
        for a, b, n in host:
            if a <= t < b:
                best = n
        return best

    prev_end = lo
    for a, b, n in dev:
        key = _short(n)
        by_name[key][0] += b - a
        by_name[key][1] += 1
        if a > prev_end:
            gaps[f"{host_at(prev_end)} -> {key}"] += a - prev_end
        if cur_a is None or a > cur_b:
            if cur_a is not None:
                busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
        prev_end = max(prev_end, b)
    if cur_a is not None:
        busy += cur_b - cur_a
    if hi > prev_end:
        gaps[f"{host_at(prev_end)} -> end"] += hi - prev_end
    kernels = sum(c for n, (_, c) in by_name.items()
                  if not n.startswith(("Memcpy", "Memset")))
    return {"window_s": (hi - lo) / 1e9, "busy_s": busy / 1e9,
            "kernels": kernels,
            "by_name": {n: (t / 1e9, c) for n, (t, c) in by_name.items()},
            "device_ops": [[n, t / 1e9] for n, (t, _) in sorted(
                by_name.items(), key=lambda kv: -kv[1][0])[:10]],
            "idle_gaps": [[n, t / 1e9] for n, t in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:10]]}


# the stretch's marker: ``torch.cuda._sleep``'s kernel, which the program
# never launches
MARKER = "spin_kernel"


def read_trace(prof, mark0, mark1, spans) -> dict:
    """The profiled stretch from a trace of device activity alone.  The
    stretch starts where the marker kernel launched at its start ends;
    CUDA events recorded on the stream after the marker (``mark0``, at the
    start; ``mark1``, at the end; the spans' pairs) fall on the device's
    timeline at the marker's end plus their elapsed time from ``mark0``."""
    dev, marks = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        (marks if MARKER in e.name() else dev).append(span)
    if not marks:
        raise RuntimeError(f"the trace has no {MARKER} marker")
    t0 = marks[-1][1]

    def at(ev):
        return t0 + int(mark0.elapsed_time(ev) * 1e6)

    host = [(at(a), at(b), label) for label, a, b in spans]
    return reduce_trace(dev, host, t0, at(mark1))


class Harness:
    """One run of one cell.  The entry fills ``e2e`` (end-to-end values),
    ``work`` (what the per-layer readers need), ``checks`` (the compared
    numbers) and ``attempted``; the harness keeps the window, the spans
    and the trace."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 t_start: float, device: str = "cuda",
                 config: Optional[dict] = None,
                 traffic: Optional[dict] = None):
        self.cell_name = cell
        self.cell = load("workloads", cell)
        self.config = config or load("configs", self.cell["config"])
        self.traffic = traffic or load("traffic", self.cell["traffic"])
        self.limits = dict(self.cell["limits"])
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.t_start = t_start
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.spans = Spans(self.cuda)
        self.e2e: Dict[str, float] = {}
        self.work: Dict[str, object] = {}
        self.checks: Dict[str, float] = {}
        self.attempted = self.failed = 0
        self.trace_info: Optional[dict] = None
        self.by_shape: Dict[str, collections.Counter] = {}
        self.stretch: tuple = ()
        self.profiled: tuple = ()
        self.memory_peak = 0
        self.latencies: List[float] = []
        self.diag: Dict[str, float] = {}
        self._prof = None

    # -- the window ----------------------------------------------------------

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def window(self, step: Callable[[int], None], stretch_at: int,
               stretch_len: int, min_units: int = 1) -> List[float]:
        """Closed loop: step(0), step(1), ... back to back until
        ``seconds`` have passed, ending at a unit boundary; each step ends
        with its result on the device (``step`` synchronizes) and may
        return its own latency (s), leaving out work of the check.  With
        tracing, units [stretch_at, stretch_at + stretch_len) are
        profiled (the profiler starts a unit earlier, so ``stretch_at`` >=
        1).  It runs ``min_units`` units at least.  Returns each unit's
        seconds; sets ``setup_s`` and ``window_s``."""
        self.sync()
        t0 = time.perf_counter()
        self.e2e["setup_s"] = t0 - self.t_start
        lat, i = [], 0
        self.stretch = tuple(range(stretch_at, stretch_at + stretch_len)) \
            if self.trace else ()
        # units the profiler ran over, the stretch and the one before it
        self.profiled = tuple(range(stretch_at - 1, stretch_at + stretch_len)) \
            if self.trace else ()
        while True:
            if self.trace and i == stretch_at - 1:
                self._profiler_begin()
            if self.trace and i == stretch_at:
                self._stretch_begin()
            self.spans.unit = i
            ts = time.perf_counter()
            own = step(i)
            te = time.perf_counter()
            lat.append(te - ts if own is None else own)
            i += 1
            if self.trace and i == stretch_at + stretch_len:
                self._stretch_end()
            if te - t0 >= self.seconds and i >= max(min_units, (
                    stretch_at + stretch_len) if self.trace else 0):
                break
        self.spans.unit = -1
        self.window_s = te - t0
        self.attempted = i
        self.latencies = lat
        self.diag["window_s"] = self.window_s
        return lat

    def untraced_units(self) -> List[int]:
        """The window's units the profiler did not run over."""
        return [i for i in range(self.attempted) if i not in self.profiled]

    def _profiler_begin(self) -> None:
        """Start the profiler a unit before the stretch: CUDA activity is
        recorded only some time after it starts, so the stretch's first
        kernels would be lost.  It records device activity alone: host
        operations recorded one by one would slow a launch-bound unit
        several-fold and read as idle device time."""
        if self.cuda:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()

    def _stretch_begin(self) -> None:
        for k in loaded_kernels().values():
            k.by_shape.clear()
        self.sync()
        if self.cuda:
            torch.cuda._sleep(1000)
            self._marks = [torch.cuda.Event(enable_timing=True)]
            self._marks[0].record()
        self._host = time.perf_counter()

    def _stretch_end(self) -> None:
        if self.cuda:
            self._marks.append(torch.cuda.Event(enable_timing=True))
            self._marks[1].record()
        self.sync()
        self._host = time.perf_counter() - self._host
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
        self.by_shape = {n: collections.Counter(k.by_shape)
                         for n, k in loaded_kernels().items()}

    def read_trace(self) -> None:
        """Reduce the profiled stretch (after the window and the check, so
        that neither waits on it).  Without a device there is no trace:
        the stretch's host time, and nothing busy."""
        if not self.stretch:
            return
        if self._prof is None:
            self.trace_info = reduce_trace([], [], 0, int(self._host * 1e9))
            return
        spans = [(label, a, b) for label, unit, a, b in self.spans.calls
                 if unit in self.stretch]
        self.trace_info = read_trace(self._prof, *self._marks, spans)
        self._prof = None
        # the profiler's own cost: the stretch's units against the others
        units = self.untraced_units()
        self.diag["stretch_unit_s"] = self._host / len(self.stretch)
        if units:
            self.diag["untraced_unit_s"] = sum(
                self.latencies[i] for i in units) / len(units)

    # -- the result ----------------------------------------------------------

    def correct(self) -> bool:
        """Every number the cell's limits name was read and is within its
        limit, and no unit of the window failed."""
        if not set(self.limits) <= set(self.checks):
            return False
        return all(math.isfinite(self.checks[k]) and self.checks[k] <= lim
                   for k, lim in self.limits.items()) and self.failed == 0

    def result(self, bm: dict) -> dict:
        section = "per_layer" if self.trace else "end_to_end"
        metrics = {}
        for m in cell_metrics(bm, self.cell_name, section):
            v = (metric_reader(m["name"])(self) if self.trace
                 else self.e2e.get(m["name"], self.e2e.get(
                     m["name"].split(".")[0])))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device = {"platform": "gpu" if self.cuda else self.device.type,
                  "kind": (torch.cuda.get_device_name(self.device)
                           if self.cuda else "cpu"),
                  "count": int(self.cell["chips"]),
                  "memory_peak_bytes": int(self.memory_peak)}
        out = {"correct": self.correct(), "attempted": self.attempted,
               "failed": self.failed, "metrics": metrics, "device": device}
        if self.trace and self.trace_info is not None:
            device["busy_s"] = self.trace_info["busy_s"]
            device["window_s"] = self.trace_info["window_s"]
            out["breakdown"] = {k: self.trace_info[k]
                                for k in ("device_ops", "idle_gaps")}
        # the numbers the cell compares; the others the entry read go to
        # the diagnostics (``PERF.md`` says why a cell leaves one out)
        out["checks"] = {k: {"value": self.checks[k], "limit": lim}
                         for k, lim in self.limits.items() if k in self.checks}
        self.diag["not_compared"] = {k: v for k, v in self.checks.items()
                                     if k not in self.limits}
        return out


def entry(name: str):
    return importlib.import_module(f"bench.entries.{name}")
