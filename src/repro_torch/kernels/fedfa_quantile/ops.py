"""Trimmed-quantile dispatch and the wrapper of the CUDA ``quantile_fused``
kernel (``csrc/quantile_fused.cu``).

Rows that fit one TPU VMEM block (at most 2^18 elements once lane-padded)
go to the single-pass kernel and longer rows to the multilevel kernel, the
JAX package's dispatch rule kept as it is; re-deriving the cutoff for
Hopper is later work.  On a CUDA tensor each wrapper launches its kernel or
raises; on a CPU tensor it runs the plain version in ``ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import CudaKernel, check_input, stream_of
from repro_torch.kernels.fedfa_quantile import multilevel, ref

_LANES = 128
_SINGLE_PASS_ELEMS = 1 << 18

QUANTILE_FUSED = CudaKernel(
    "quantile_fused.cu", "quantile_fused",
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
    + [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p])


def quantile_fused(rows: torch.Tensor, q: torch.Tensor,
                   scale: Optional[torch.Tensor] = None):
    """(t, ss) per row of |rows| — threshold ``quantile(|row|, q)`` and the
    trimmed Σ row²·[|row| <= t] — in one kernel.  rows (R, L) f32, q (R,).
    With ``scale`` (R,) f32 the rows may be int8 or bf16 and are
    dequantized in the kernel as |row·scale|; the outputs are in
    dequantized units.  Without it such rows are upcast to f32 first."""
    if rows.dim() != 2 or rows.shape[1] < 1:
        raise ValueError(f"quantile_fused takes rows (R, L >= 1), got "
                         f"{tuple(rows.shape)}")
    rows, code = multilevel.kernel_rows(rows, scale)
    R, L = rows.shape
    check_input("rows", rows, rows.dtype, (R, L), rows.device)
    check_input("q", q, torch.float32, (R,), rows.device)
    if scale is not None:
        check_input("scale", scale, torch.float32, (R,), rows.device)
    if rows.device.type == "cpu":
        return ref.row_trimmed_stats_ref(ref.dequantize_rows(rows, scale), q)
    t = torch.empty(R, dtype=torch.float32, device=rows.device)
    ss = torch.empty(R, dtype=torch.float32, device=rows.device)
    QUANTILE_FUSED.launch(rows.data_ptr(), code, q.data_ptr(),
                          None if scale is None else scale.data_ptr(),
                          t.data_ptr(), ss.data_ptr(), R, L, stream_of(rows))
    return t, ss


def row_trimmed_stats(rows: torch.Tensor, q: torch.Tensor,
                      scale: Optional[torch.Tensor] = None):
    """Per-row (quantile threshold, trimmed Σw²) of signed rows (R, L) with
    levels q (R,): t[r] = quantile(|rows[r]|, q[r]) bit-equal to
    jnp.quantile, ss[r] = Σ rows[r]²·[|rows[r]| <= t[r]].  ``scale`` (R,)
    declares the rows quantized (int8 or bf16): they stay in their dtype
    and every kernel dequantizes them as it reads them."""
    L = rows.shape[1]
    if -(-L // _LANES) * _LANES > _SINGLE_PASS_ELEMS:
        return multilevel.row_trimmed_stats_multilevel(rows, q, scale)
    return quantile_fused(rows, q, scale)
