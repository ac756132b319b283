"""FLOPs the clients' sub-models require (each at its own width and
depth) over the time their rounds took and the card's f32 peak, %: the
window's rounds outside the profiled stretch, host clock."""
from bench import yardstick as ys
from bench.readers import host_share_pct


def read(h):
    if not h.cuda:
        return None
    peak = ys.PEAKS["f32_flops_per_s"]
    return host_share_pct(h, lambda i: h.work["unit_flops"][i] / peak * 1e3)
