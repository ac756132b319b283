"""Forward and backward ms a round: the program's ``train/step/fwd_bwd``
spans (``model.loss_and_grad``), stream time summed over the round."""
from bench.program_trace import span_mean


def read(h):
    return span_mean(h, "train/step/fwd_bwd")
