"""The norms pass's ms a merge: the program's ``aggregate/norms`` span
(``flat._cohort_stats`` and α, the multilevel searches inside), stream
time."""
from bench.program_trace import span_mean


def read(h):
    return span_mean(h, "aggregate/norms")
