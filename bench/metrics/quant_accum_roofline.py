"""``quant_accum``'s required time over its device time in the profiled
merges, %: its int8 rows read once, the sum written once."""
from bench.readers import roofline_pct


def read(h):
    return roofline_pct(h, "quant_accum", "int8")
