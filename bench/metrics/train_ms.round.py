"""Local training's ms a round: the span around ``cohort_update``."""
from bench.readers import span_mean


def read(h):
    return span_mean(h, "train")
