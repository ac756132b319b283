"""Share of the profiled merges that no device operation covers (the
union of their intervals), %."""
from bench.readers import idle_pct


def read(h):
    return idle_pct(h)
