"""The least time the merges require (their bytes at the HBM rate, or
their accumulations' FLOPs at the f32 peak, whichever is larger) over the
time they took, %: the window's merges outside the profiled stretch, host
clock."""
from bench import yardstick as ys
from bench.readers import host_share_pct


def read(h):
    if not h.cuda:
        return None
    need = ys.least_ms(h.work["unit_bytes"], h.work["unit_flops"],
                       ys.PEAKS["f32_flops_per_s"])
    return host_share_pct(h, lambda i: need)
