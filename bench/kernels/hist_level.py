"""``hist_level`` (kernels/fedfa_quantile): one level of the multilevel
quantile search's histogram.  Its ``by_shape`` key is (m, C, shift).  The
launches of one search share its rows, which are counted as read once, on
the top level's launch (shift 24) alone; every launch writes its
segment's planes."""
from bench.yardstick import ITEMSIZE

DEVICE_NAMES = ("hist_level_kernel",)


def required(shape, dtype):
    m, C, shift = shape
    planes = m * 2 * 256 * (4 + 8)
    return (m * C * ITEMSIZE[dtype] if shift == 24 else 0) + planes, 0.0
