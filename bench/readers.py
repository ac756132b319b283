"""Helpers of the per-layer metric readers (``bench/metrics/*.py``): each
takes the run (``harness.Harness``) and returns a number, or None where
the run gives nothing to read (no span, no device in the trace)."""
from __future__ import annotations

from typing import Optional

from bench import yardstick as ys

def span_mean(h, label: str) -> Optional[float]:
    """Mean ms per window unit of the span ``label``, the units the
    profiler ran over left out."""
    ms = h.spans.per_unit_ms(label, skip=h.profiled)
    return sum(ms) / len(ms) if ms else None


def traced(h) -> Optional[dict]:
    """The trace of a stretch in which the device ran something."""
    t = h.trace_info
    return t if t and t["busy_s"] > 0 else None


def idle_pct(h) -> Optional[float]:
    t = traced(h)
    return None if t is None else 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernel_time(h, kernel: str) -> tuple:
    """(seconds, launches) of ``kernel``'s device functions in the trace,
    found by the names its yardstick (``bench/kernels/<kernel>.py``)
    gives."""
    t = traced(h)
    names = ys.kernel_spec(kernel).DEVICE_NAMES
    hits = [] if t is None else [v for name, v in t["by_name"].items()
                                 if name.startswith(names)]
    return sum(s for s, _ in hits), sum(c for _, c in hits)


def roofline_pct(h, kernel: str, dtype: str) -> Optional[float]:
    """The least time the stretch's launches of ``kernel`` require (their
    shapes from the wrapper's ``by_shape``, their work from the kernel's
    yardstick) over their device time, %."""
    shapes = h.by_shape.get(kernel, {})
    dev_s, events = kernel_time(h, kernel)
    if not shapes or dev_s <= 0:
        return None
    h.diag[f"launches.{kernel}"] = [sum(shapes.values()), events]
    need_ms = sum(n * ys.kernel_least_ms(kernel, shp, dtype)
                  for shp, n in shapes.items())
    return 100.0 * need_ms / (dev_s * 1e3)


def host_share_pct(h, need_ms_per_unit) -> Optional[float]:
    """The least time the window's untraced units require over the time
    they took (host clock), %."""
    units = h.untraced_units()
    took_s = sum(h.latencies[i] for i in units)
    if not units or took_s <= 0:
        return None
    return 100.0 * sum(need_ms_per_unit(i) for i in units) / (took_s * 1e3)
