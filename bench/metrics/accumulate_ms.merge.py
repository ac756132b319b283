"""The (M', γ) sums' ms a merge: the program's ``aggregate/accumulate``
span (the segment scaling, both sums and the γ = 0 merge), stream time."""
from bench.program_trace import span_mean


def read(h):
    return span_mean(h, "aggregate/accumulate")
