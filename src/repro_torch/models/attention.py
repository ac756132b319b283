"""Grouped-query dense attention with head masks (training path only; the
KV-cache and decode entry points of ``repro.models.attention`` are not yet
ported)."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, K, hd) -> (B, S, H, hd) by repeating each kv head H/K times."""
    rep = n_heads // k.shape[2]
    return k if rep == 1 else torch.repeat_interleave(k, rep, dim=2)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: Optional[int] = None,
           head_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, K, hd).  ``head_mask`` (H,) zeroes
    masked heads; ``window`` limits causal attention to window-1 back."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * hd ** -0.5
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    if head_mask is not None:
        out = out * head_mask[None, None, :, None].to(out.dtype)
    return out
