"""Quantized admission's ms a merge: the span around
``admit_quantized``."""
from bench.readers import span_mean


def read(h):
    return span_mean(h, "admit")
