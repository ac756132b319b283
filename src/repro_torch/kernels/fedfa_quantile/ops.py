"""Trimmed-quantile dispatch and the wrapper of the CUDA ``quantile_fused``
kernel (``csrc/quantile_fused.cu``).

Rows that fit one TPU VMEM block (at most 2^18 elements once lane-padded)
go to the single-pass kernel and longer rows to the multilevel kernel, the
JAX package's dispatch rule kept as it is; re-deriving the cutoff for
Hopper is later work.  On a CUDA tensor each wrapper launches its kernel or
raises; on a CPU tensor it runs the plain version in ``ref``.
``use_kernel`` chooses otherwise (``build.runs_plain``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import (CudaKernel, check_input,
                                       kernel_scope, runs_plain, stream_of)
from repro_torch.kernels.fedfa_quantile import multilevel, ref

_LANES = 128
_SINGLE_PASS_ELEMS = 1 << 18

# quantile_fused's launch geometry, set here alone (the kernel is built
# with the last four as -D flags): a row is held in the shared memory of a
# cluster of CTAs, at most _CLUSTER_PART bytes of it a CTA where
# _MAX_CLUSTER CTAs allow it; a CTA's static shared memory is at most
# _STATIC_SMEM (the kernel asserts it), _GATHER bytes of it CTA 0's
# candidates, and all of it at most _SMEM_MAX
_CLUSTER_PART = 64 << 10
_MAX_CLUSTER = 8
_STATIC_SMEM = 20480
_GATHER = 10240
_SMEM_MAX = 232448

QUANTILE_FUSED = CudaKernel(
    "quantile_fused.cu", "quantile_fused",
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
    + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
       ctypes.c_void_p],
    defines={"QF_MAX_CLUSTER": _MAX_CLUSTER, "QF_STATIC_SMEM": _STATIC_SMEM,
             "QF_GATHER": _GATHER, "QF_SMEM_MAX": _SMEM_MAX})


def cluster_geometry(L: int, itemsize: int, cs: Optional[int] = None):
    """(cluster size, elements a CTA holds, shared-memory bytes of a CTA)
    for rows of L elements of ``itemsize`` bytes: the fewest CTAs, a power
    of two up to 8, that hold at most 64 KB of the row each, else 8 (or
    ``cs`` CTAs, for the ablation's sweep); a CTA's part rounded up to
    whole 16-byte vectors, and 16 bytes more for a row that starts inside
    one.  Raises for rows that the cluster cannot hold."""
    vec = 16 // itemsize
    sizes = [cs] if cs else [c for c in (1, 2, 4, 8) if c <= _MAX_CLUSTER]
    for cs in sizes:
        per = -(-(-(-L // cs)) // vec) * vec
        if per * itemsize <= _CLUSTER_PART:
            break
    smem = per * itemsize + 16 + _STATIC_SMEM
    if smem > _SMEM_MAX:
        raise ValueError(f"quantile_fused's kernel holds a row in the shared "
                         f"memory of {cs} CTAs: rows of {L} elements of "
                         f"{itemsize} bytes do not fit")
    return cs, per, smem


def fused_quantile_contract(block_bytes=None, *, padded: bool = False):
    """Declared contract of the fused trimmed-quantile path, the
    reference's (``repro.kernels.fedfa_quantile.ops
    .fused_quantile_contract``) field by field: the whole (threshold,
    trimmed Σw²) computation is ONE ``quantile_fused`` call, so the run
    reads the cohort row block exactly once and holds zero sort/topk ops
    (the search runs in the kernel's shared memory).  Counted on the run
    (``analysis.dispatch``), not on timing.

    With ``block_bytes`` (the (R, L) row-block bytes) the peak is budgeted
    at 6x the block.  ``padded=True`` declares the reference's
    non-dividing dispatch (a staged zero-padded block: 1-2 reads, 9x);
    the port's kernel takes any L and stages nothing, so it reads once
    there too."""
    from repro_torch.analysis.contracts import Contract
    mult, reads = (9, (1, 2)) if padded else (6, 1)
    peak = {} if block_bytes is None else dict(
        peak_live_bytes_per_device=(None, mult * block_bytes))
    return Contract(name="quantile/fused-pad" if padded else "quantile/fused",
                    description="fused CUDA trimmed quantile"
                    + (" (non-dividing padded dispatch)" if padded else ""),
                    row_reads=reads, sorts=0, **peak)


def topk_tail_contract(block_bytes=None, *, padded: bool = False):
    """Declared shape of the sort-based path the fused kernel replaced,
    kept as a pinned reference point.  The reference pins its top_k
    tail's jaxpr; the port has no top_k tail, so this pins the counts of
    the port's plain sort-based version (``ref.row_trimmed_stats_ref``)
    called outside the wrapper, measured once on the canonical fixtures
    (``analysis.programs.quantile_reports``) and written here, as the
    reference wrote its own.  If they shift, the fused-versus-sort
    comparison basis moved.  Two fields are restated:

      * ``row_reads`` is 8 (the reference's 7): the abs, the sort, the two
        gathers of the sorted rows, the compare, the square, the select
        and the sum each read the row block;
      * ``peak_live_bytes_per_device`` is 6x the block, padded or not (the
        reference's 4x, 5x ``padded``): ``torch.sort`` returns its int64
        indices (2 blocks) beside the sorted values, and the abs, the
        square and the select are blocks of their own.  Measured 5.27x on
        both fixtures.

    ROADMAP queue 3 item 33.
    """
    from repro_torch.analysis.contracts import Contract
    peak = {} if block_bytes is None else dict(
        peak_live_bytes_per_device=(None, 6 * block_bytes))
    return Contract(name="quantile/topk-pad" if padded else "quantile/topk",
                    description="sort-based plain path (the pre-fusion "
                    "reference)",
                    row_reads=8, sorts=1, **peak)


def quantile_fused(rows: torch.Tensor, q: torch.Tensor,
                   scale: Optional[torch.Tensor] = None,
                   use_kernel: Optional[bool] = None):
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
    with kernel_scope("quantile_fused", rows, q, scale):
        if runs_plain(rows, use_kernel):
            return ref.row_trimmed_stats_ref(ref.dequantize_rows(rows, scale),
                                             q)
        cs, per, _ = cluster_geometry(L, rows.element_size())
        t = torch.empty(R, dtype=torch.float32, device=rows.device)
        ss = torch.empty(R, dtype=torch.float32, device=rows.device)
        QUANTILE_FUSED.launch(rows.data_ptr(), code, q.data_ptr(),
                              None if scale is None else scale.data_ptr(),
                              t.data_ptr(), ss.data_ptr(), R, L, cs, per,
                              stream_of(rows), shape=(R, L))
        return t, ss


def row_trimmed_stats(rows: torch.Tensor, q: torch.Tensor,
                      scale: Optional[torch.Tensor] = None,
                      use_kernel: Optional[bool] = None):
    """Per-row (quantile threshold, trimmed Σw²) of signed rows (R, L) with
    levels q (R,): t[r] = quantile(|rows[r]|, q[r]) bit-equal to
    jnp.quantile, ss[r] = Σ rows[r]²·[|rows[r]| <= t[r]].  ``scale`` (R,)
    declares the rows quantized (int8 or bf16): they stay in their dtype
    and every kernel dequantizes them as it reads them."""
    L = rows.shape[1]
    if -(-L // _LANES) * _LANES > _SINGLE_PASS_ELEMS:
        return multilevel.row_trimmed_stats_multilevel(rows, q, scale,
                                                       use_kernel)
    return quantile_fused(rows, q, scale, use_kernel)
