"""``scaled_accum``'s required time over its device time in the profiled
merges, %: its f32 rows read once, the sum written once."""
from bench.readers import roofline_pct


def read(h):
    return roofline_pct(h, "scaled_accum", "f32")
