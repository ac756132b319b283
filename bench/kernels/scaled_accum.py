"""``scaled_accum`` (kernels/fedfa_agg): Σ_c w[c]·x[c]·mask over m rows of
n values.  Its ``by_shape`` key is (m, n).  It reads the rows and the
weights once, the mask once, writes the sum once, and does a multiply
and an add per element."""
from bench.yardstick import ITEMSIZE

DEVICE_NAMES = ("scaled_accum_vec4", "scaled_accum_scalar")


def required(shape, dtype):
    m, n = shape
    return m * n * ITEMSIZE[dtype] + n * 4 + m * 4, 2.0 * m * n
