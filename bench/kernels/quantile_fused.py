"""``quantile_fused`` (kernels/fedfa_quantile): the trimmed norm of R rows
of L values.  Its ``by_shape`` key is (R, L).  It reads every row once
(and a scale per row where the rows are not f32) and writes per row its
threshold, its norm and a count."""
from bench.yardstick import ITEMSIZE

DEVICE_NAMES = ("quantile_fused_kernel",)


def required(shape, dtype):
    R, L = shape
    return R * L * ITEMSIZE[dtype] + R * 4 * (2 + (dtype != "f32") + 1), 0.0
