"""Grouped-query dense attention with head masks, and the KV cache of the
serving path: ``attend`` (train / prefill), ``attend_decode`` (one token
against the cache) and ``init_kv_cache`` / ``cache_extend``.  Ring caches
and sliding windows on the serving path are not yet ported."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NEG_INF = -2.0 ** 30


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, C, K, hd): C = capacity
    v: torch.Tensor
    pos: torch.Tensor     # () int64: tokens already written

    @property
    def capacity(self) -> int:
        return self.k.shape[1]


def init_kv_cache(batch: int, capacity: int, n_kv: int, head_dim: int,
                  dtype, device) -> KVCache:
    shape = (batch, capacity, n_kv, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((), dtype=torch.int64, device=device))


def cache_extend(cache: KVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> KVCache:
    """Write S new kv entries at positions pos..pos+S-1 (prefill S tokens or
    decode S = 1), rounded to the cache's dtype.  The caller keeps
    pos + S <= capacity."""
    idx = cache.pos + torch.arange(k_new.shape[1], device=k_new.device)
    return KVCache(cache.k.index_copy(1, idx, k_new.to(cache.k.dtype)),
                   cache.v.index_copy(1, idx, v_new.to(cache.v.dtype)),
                   cache.pos + k_new.shape[1])


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


def attend_decode(q: torch.Tensor, cache: KVCache, *,
                  head_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token decode: q (B, 1, H, hd) against the cache (already
    extended).  Logits and softmax in f32; the probabilities are rounded to
    the cache's dtype before the value product, as the reference rounds
    them."""
    H, hd = q.shape[2], q.shape[3]
    k = _expand_kv(cache.k, H)
    v = _expand_kv(cache.v, H)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * hd ** -0.5
    valid = torch.arange(cache.capacity, device=q.device) < cache.pos
    logits = torch.where(valid[None, None, None, :], logits,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    if head_mask is not None:
        out = out * head_mask[None, None, :, None].to(out.dtype)
    return out
