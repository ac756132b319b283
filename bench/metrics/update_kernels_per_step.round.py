"""Device kernels of the profiled round that started inside the
program's ``train/step/update`` spans, over its client steps: the
optimizer's and the masks' share of ``kernels_per_step.round``."""
from bench.program_trace import kernels_per_step


def read(h):
    return kernels_per_step(h, "train/step/update")
