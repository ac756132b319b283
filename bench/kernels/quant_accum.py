"""``quant_accum`` (kernels/fedfa_agg): Σ_c x[c]·w[c, seg]·mask over m
quantized rows of n values.  Its ``by_shape`` key is (m, n).  It reads
the rows once and writes the sum once (the (m, S) table and the segment
ids are counted in neither), and does a multiply and an add per
element."""
from bench.yardstick import ITEMSIZE

DEVICE_NAMES = ("quant_accum_vec4", "quant_accum_scalar")


def required(shape, dtype):
    m, n = shape
    return m * n * ITEMSIZE[dtype] + n * 4, 2.0 * m * n
