"""Wrappers of the CUDA aggregation kernels: ``scaled_accum``
(``csrc/scaled_accum.cu``), ``quant_accum`` (``csrc/quant_accum.cu``) and
``trimmed_sumsq`` (``csrc/trimmed_sumsq.cu``).

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it runs the plain version in ``ref``.  ``use_kernel`` chooses otherwise
(``build.runs_plain``).
"""
from __future__ import annotations

import ctypes

from typing import Optional

import torch

from repro_torch.kernels.build import (DTYPE_CODES, CudaKernel, check_input,
                                       runs_plain, stream_of)
from repro_torch.kernels.fedfa_agg import ref

SCALED_ACCUM = CudaKernel(
    "scaled_accum.cu", "scaled_accum",
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
    + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
QUANT_ACCUM = CudaKernel(
    "quant_accum.cu", "quant_accum",
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
    + [ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
       ctypes.c_void_p])
TRIMMED_SUMSQ = CudaKernel(
    "trimmed_sumsq.cu", "trimmed_sumsq",
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
    + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])

# the element types scaled_accum's x and trimmed_sumsq's w may have; both
# kernels upcast them to f32 as they read them
_FLOAT_ROWS = (torch.float32, torch.bfloat16)


def _check_float_rows(name: str, x: torch.Tensor) -> None:
    if x.dtype not in _FLOAT_ROWS:
        raise TypeError(f"{name} has dtype {x.dtype}, expected f32 or bf16")

# the shared memory one block of quant_accum may use for its (m, S) table
_MAX_TABLE_BYTES = 232448


def scaled_accum(x: torch.Tensor, weights: torch.Tensor,
                 mask: torch.Tensor, use_kernel: Optional[bool] = None
                 ) -> torch.Tensor:
    """Fused Σ_c weights[c]·x[c]·mask over the client axis: x (m, n) f32
    or bf16 (upcast as it is read), weights (m,) and mask (n,) f32 -> (n,)
    f32 (Alg. 1 line 19, M' and Γ)."""
    if x.dim() != 2:
        raise ValueError(f"scaled_accum takes x (m, n), got {tuple(x.shape)}")
    m, n = x.shape
    _check_float_rows("x", x)
    check_input("x", x, x.dtype, (m, n), x.device)
    check_input("weights", weights, torch.float32, (m,), x.device)
    check_input("mask", mask, torch.float32, (n,), x.device)
    if runs_plain(x, use_kernel):
        return ref.scaled_accum_ref(x, weights, mask)
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    SCALED_ACCUM.launch(x.data_ptr(), DTYPE_CODES[x.dtype], weights.data_ptr(),
                        mask.data_ptr(), out.data_ptr(), m, n, sms,
                        stream_of(x))
    return out


def quant_accum(x: torch.Tensor, wtab: torch.Tensor, seg: torch.Tensor,
                mask: torch.Tensor, use_kernel: Optional[bool] = None
                ) -> torch.Tensor:
    """Fused dequantize-accumulate Σ_c x[c, n]·wtab[c, seg[n]]·mask[n]:
    x (m, n) int8 or bf16 rows, wtab (m, S) f32 per-(client, segment)
    weights with the dequant scales folded in, seg (n,) int32 (−1 adds
    nothing), mask (n,) f32 -> (n,) f32."""
    if x.dim() != 2 or wtab.dim() != 2:
        raise ValueError(f"quant_accum takes x (m, n) and wtab (m, S), got "
                         f"{tuple(x.shape)} and {tuple(wtab.shape)}")
    if x.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"quant_accum takes int8 or bf16 rows, got {x.dtype}")
    m, n = x.shape
    S = wtab.shape[1]
    check_input("x", x, x.dtype, (m, n), x.device)
    check_input("wtab", wtab, torch.float32, (m, S), x.device)
    check_input("seg", seg, torch.int32, (n,), x.device)
    check_input("mask", mask, torch.float32, (n,), x.device)
    if S < 1:
        raise ValueError("quant_accum needs at least one segment")
    if runs_plain(x, use_kernel):
        return ref.quant_accum_ref(x, wtab, seg, mask)
    if m * S * 4 > _MAX_TABLE_BYTES:
        raise ValueError(f"quant_accum's (m, S) = ({m}, {S}) table exceeds "
                         f"one block's {_MAX_TABLE_BYTES} bytes of shared "
                         f"memory")
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    QUANT_ACCUM.launch(x.data_ptr(), DTYPE_CODES[x.dtype], wtab.data_ptr(),
                       seg.data_ptr(), mask.data_ptr(), out.data_ptr(), m, S,
                       n, sms, stream_of(x))
    return out


def accumulate_quant(x: torch.Tensor, weights: torch.Tensor,
                     wtab: torch.Tensor, seg: torch.Tensor,
                     mask: torch.Tensor, use_kernel: Optional[bool] = None
                     ) -> torch.Tensor:
    """Σ_c weights[c]·wtab[c, seg[n]]·x[c, n]·mask[n]: the per-client
    weight folds into the (m, S) table before the one launch, so the
    quantized rows are read once."""
    return quant_accum(x, wtab * weights[:, None], seg, mask, use_kernel)


def trimmed_sumsq(w: torch.Tensor, t: torch.Tensor,
                  use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Σ w²·[|w| <= t] over a flat f32 or bf16 vector w (n,) (upcast as it
    is read), threshold t a 0-d f32 tensor on w's device -> 0-d f32.
    Summed in a fixed order on the card (per-block partials, then one
    block), so it is deterministic."""
    if w.dim() != 1:
        raise ValueError(f"trimmed_sumsq takes w (n,), got {tuple(w.shape)}")
    _check_float_rows("w", w)
    check_input("w", w, w.dtype, tuple(w.shape), w.device)
    check_input("t", t, torch.float32, (), w.device)
    if runs_plain(w, use_kernel):
        return ref.trimmed_sumsq_ref(w, t)
    n = w.shape[0]
    sms = torch.cuda.get_device_properties(w.device).multi_processor_count
    blocks = max(1, min(sms * 8, -(-n // (256 * 8))))
    partial = torch.empty(blocks, dtype=torch.float32, device=w.device)
    out = torch.empty((), dtype=torch.float32, device=w.device)
    TRIMMED_SUMSQ.launch(w.data_ptr(), DTYPE_CODES[w.dtype], t.data_ptr(),
                         partial.data_ptr(), out.data_ptr(), n, blocks,
                         stream_of(w))
    return out


def trimmed_norm(w_flat: torch.Tensor, t, use_kernel: Optional[bool] = None
                 ) -> torch.Tensor:
    """sqrt(Σ w²·[|w| <= t]) over a flat f32 or bf16 vector of any
    length."""
    t = torch.as_tensor(t, dtype=torch.float32,
                        device=w_flat.device).reshape(())
    return torch.sqrt(trimmed_sumsq(w_flat.reshape(-1).contiguous(), t,
                                    use_kernel))
