"""Plain PyTorch version of the flash-attention kernel (the counterpart of
``repro.kernels.flash_attention.ref``).  It runs the CPU path of
``kernels/flash_attention/ops.py`` and is what ``chip_smoke.py`` holds the
CUDA kernel against on the card."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def _keep(Sq: int, Sk: int, causal: bool, window: Optional[int],
          q_offset: int, device) -> torch.Tensor:
    """The (Sq, Sk) pairs attention keeps: causal ``kpos <= qpos``, window
    ``kpos > qpos - window``, query i at position ``q_offset + i``."""
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Sk, K, hd), each kv head repeated H/K
    times.  Logits in f32 scaled by hd**-0.5 after the product, masked
    (``_keep``) to NEG_INF; softmax and the value product in f32; the
    output in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    rep = H // K
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * hd ** -0.5
    mask = _keep(Sq, Sk, causal, window, q_offset, q.device)
    logits = torch.where(mask, logits, torch.full((), NEG_INF,
                                                  device=q.device))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs,
                        v.to(torch.float32)).to(q.dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to nearest,
    ties away from zero, 10 mantissa bits kept (the low 13 bits cleared)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32_product(eq: str, a: torch.Tensor, b: torch.Tensor,
                       terms: int = 3) -> torch.Tensor:
    """``einsum(eq, a, b)`` of f32 operands as the kernel's 3xTF32 route
    takes it: hi = tf32(a), lo = tf32(a - hi), and lo·hi′ + hi·lo′ +
    hi·hi′, the small terms first; ``terms=1`` takes hi·hi′ alone (one
    TF32 product)."""
    ah, bh = tf32_round(a), tf32_round(b)
    if terms == 1:
        return torch.einsum(eq, ah, bh)
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) \
        + torch.einsum(eq, ah, bh)


def attention_split_tf32_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: Optional[int] = None,
                             q_offset: int = 0,
                             terms: int = 3) -> torch.Tensor:
    """``attention_ref`` on f32 inputs with both products taken as the
    CUDA kernel's f32 route takes them (``split_tf32_product``), q scaled
    by hd**-0.5 in f32 before the first, as the kernel scales it."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    rep = H // K
    k = torch.repeat_interleave(k.to(torch.float32), rep, dim=2)
    v = torch.repeat_interleave(v.to(torch.float32), rep, dim=2)
    logits = split_tf32_product("bqhd,bkhd->bhqk",
                                q.to(torch.float32) * hd ** -0.5, k, terms)
    mask = _keep(Sq, Sk, causal, window, q_offset, q.device)
    logits = torch.where(mask, logits, torch.full((), NEG_INF,
                                                  device=q.device))
    probs = torch.softmax(logits, dim=-1)
    return split_tf32_product("bhqk,bkhd->bqhd", probs, v, terms).to(q.dtype)
