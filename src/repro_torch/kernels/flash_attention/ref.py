"""Plain PyTorch version of the flash-attention kernel (the counterpart of
``repro.kernels.flash_attention.ref``).  It runs the CPU path of
``kernels/flash_attention/ops.py`` and is what ``chip_smoke.py`` holds the
CUDA kernel against on the card."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Sk, K, hd), each kv head repeated H/K
    times.  Logits in f32 scaled by hd**-0.5 after the product, masked
    (causal ``kpos <= qpos``, window ``kpos > qpos - window``) to NEG_INF;
    softmax and the value product in f32; the output in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    rep = H // K
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * hd ** -0.5
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, torch.full((), NEG_INF,
                                                  device=q.device))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs,
                        v.to(torch.float32)).to(q.dtype)
