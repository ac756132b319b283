"""Density rows' ms a merge: the program's ``aggregate/densities`` span
(``flat._density_rows``), stream time."""
from bench.program_trace import span_mean


def read(h):
    return span_mean(h, "aggregate/densities")
