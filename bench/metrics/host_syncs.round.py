"""Device values read on the host a round: the program's ``host_syncs``
counter (``tracing.to_host``), summed over the round."""
from bench.program_trace import count_mean


def read(h):
    return count_mean(h, "host_syncs")
