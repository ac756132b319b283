"""Aggregation's ms a merge: the span around ``aggregate_buffers``."""
from bench.readers import span_mean


def read(h):
    return span_mean(h, "aggregate")
