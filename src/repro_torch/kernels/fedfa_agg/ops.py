"""Wrapper of the CUDA ``scaled_accum`` kernel (``csrc/scaled_accum.cu``).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version in ``ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, check_input, stream_of
from repro_torch.kernels.fedfa_agg import ref

SCALED_ACCUM = CudaKernel(
    "scaled_accum.cu", "scaled_accum",
    [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                             ctypes.c_void_p])


def scaled_accum(x: torch.Tensor, weights: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Fused Σ_c weights[c]·x[c]·mask over the client axis: x (m, n) f32,
    weights (m,), mask (n,) -> (n,) f32 (Alg. 1 line 19, M' and Γ)."""
    if x.dim() != 2:
        raise ValueError(f"scaled_accum takes x (m, n), got {tuple(x.shape)}")
    m, n = x.shape
    check_input("x", x, torch.float32, (m, n), x.device)
    check_input("weights", weights, torch.float32, (m,), x.device)
    check_input("mask", mask, torch.float32, (n,), x.device)
    if x.device.type == "cpu":
        return ref.scaled_accum_ref(x, weights, mask)
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    SCALED_ACCUM.launch(x.data_ptr(), weights.data_ptr(), mask.data_ptr(),
                        out.data_ptr(), m, n, sms, stream_of(x))
    return out
