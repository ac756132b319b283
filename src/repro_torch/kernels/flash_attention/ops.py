"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``),
the counterpart of ``repro.kernels.flash_attention.ops.attention``.

On a CUDA tensor ``attention`` launches its kernel or raises; on a CPU
tensor it runs the plain version in ``ref``.  The kernel has no backward
(the TPU kernel has no ``custom_vjp``), so inputs on the card that require
grad raise.  The TPU wrapper pads Sq and Sk to its tiles and hd to 128
lanes for the MXU; the CUDA kernel bounds-checks its ragged tiles instead,
so nothing is padded here.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import (DTYPE_CODES, CudaKernel, check_input,
                                       kernel_scope, stream_of)
from repro_torch.kernels.flash_attention import ref

FLASH_ATTENTION = CudaKernel(
    "flash_attention.cu", "flash_attention",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
    + [ctypes.c_float, ctypes.c_void_p])

# the kernel's head widths: multiples of 8 (rows of whole 16-byte chunks,
# copied 16 bytes at a time) up to 256 (above 128 two warpgroups share a
# q head, each with 128 columns of its output)
_MAX_HD = 256


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0) -> torch.Tensor:
    """Blockwise online-softmax attention: q (B, Sq, H, hd) against k, v
    (B, Sk, K, hd), H % K == 0, all f32 or all bf16 -> (B, Sq, H, hd) in
    q's dtype.  ``causal`` keeps ``kpos <= qpos``, ``window`` keeps
    ``kpos > qpos - window``, with query i at position ``q_offset + i`` and
    key j at j (a chunk of a chunked prefill against the whole cache);
    softmax scale hd**-0.5."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"attention takes q (B, Sq, H, hd) and k, v "
                         f"(B, Sk, K, hd), got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention takes f32 or bf16, got {q.dtype}")
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if min(B, Sq, Sk, H, K, hd) < 1 or H % K:
        raise ValueError(f"attention needs non-empty shapes and H % K == 0, "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check_input("q", q, q.dtype, (B, Sq, H, hd), q.device)
    check_input("k", k, q.dtype, (B, Sk, K, hd), q.device)
    check_input("v", v, q.dtype, (B, Sk, K, hd), q.device)
    with kernel_scope("flash_attention", q, k, v):
        if q.device.type == "cpu":
            return ref.attention_ref(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
        if any(t.requires_grad for t in (q, k, v)):
            raise NotImplementedError("the flash-attention kernel has no "
                                      "backward; train through attend_blocked")
        if hd > _MAX_HD or hd % 8:
            raise ValueError(f"the flash-attention kernel takes hd <= "
                             f"{_MAX_HD}, a multiple of 8; got {hd}")
        # the kernel reads q, k and v 16 bytes at a time: a view that starts
        # off that boundary is copied to storage that does not
        q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q, k, v))
        out = torch.empty_like(q)
        FLASH_ATTENTION.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), DTYPE_CODES[q.dtype], B, Sq, Sk,
                               H, K, hd, int(causal),
                               -1 if window is None else window, int(q_offset),
                               hd ** -0.5, stream_of(q))
        return out
