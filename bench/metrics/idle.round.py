"""Share of the profiled rounds that no device operation covers (the
union of their intervals), %."""
from bench.readers import idle_pct


def read(h):
    return idle_pct(h)
