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

import torch

from repro_torch.kernels.build import CudaKernel, check_input, stream_of
from repro_torch.kernels.fedfa_quantile import multilevel, ref

_LANES = 128
_SINGLE_PASS_ELEMS = 1 << 18

QUANTILE_FUSED = CudaKernel(
    "quantile_fused.cu", "quantile_fused",
    [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p])


def quantile_fused(rows: torch.Tensor, q: torch.Tensor):
    """(t, ss) per row of |rows| — threshold ``quantile(|row|, q)`` and the
    trimmed Σ row²·[|row| <= t] — in one kernel.  rows (R, L) f32, q (R,)."""
    if rows.dim() != 2 or rows.shape[1] < 1:
        raise ValueError(f"quantile_fused takes rows (R, L >= 1), got "
                         f"{tuple(rows.shape)}")
    R, L = rows.shape
    check_input("rows", rows, torch.float32, (R, L), rows.device)
    check_input("q", q, torch.float32, (R,), rows.device)
    if rows.device.type == "cpu":
        return ref.row_trimmed_stats_ref(rows, q)
    t = torch.empty(R, dtype=torch.float32, device=rows.device)
    ss = torch.empty(R, dtype=torch.float32, device=rows.device)
    QUANTILE_FUSED.launch(rows.data_ptr(), q.data_ptr(), t.data_ptr(),
                          ss.data_ptr(), R, L, stream_of(rows))
    return t, ss


def row_trimmed_stats(rows: torch.Tensor, q: torch.Tensor):
    """Per-row (quantile threshold, trimmed Σw²) of signed rows (R, L) with
    levels q (R,): t[r] = quantile(|rows[r]|, q[r]) bit-equal to
    jnp.quantile, ss[r] = Σ rows[r]²·[|rows[r]| <= t[r]]."""
    L = rows.shape[1]
    if -(-L // _LANES) * _LANES > _SINGLE_PASS_ELEMS:
        return multilevel.row_trimmed_stats_multilevel(rows, q)
    return quantile_fused(rows, q)
