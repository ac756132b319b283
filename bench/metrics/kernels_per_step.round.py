"""Device kernels of the profiled rounds over their client steps."""
from bench.readers import traced


def read(h):
    t = traced(h)
    if t is None:
        return None
    return t["kernels"] / (h.work["client_steps"] * len(h.stretch))
