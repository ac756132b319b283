"""``hist_level``'s required time over its device time in the profiled
merges, %: every cohort row read once per merge, at the admission dtype."""
from bench.readers import roofline_pct


def read(h):
    return roofline_pct(h, "hist_level", h.work["update_dtype"])
