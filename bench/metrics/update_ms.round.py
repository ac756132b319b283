"""Optimizer and masking ms a round: the program's ``train/step/update``
spans (``mask_gradients``, ``opt_update``, the re-mask), stream time
summed over the round."""
from bench.program_trace import span_mean


def read(h):
    return span_mean(h, "train/step/update")
