"""Grouped-query attention with head masks, and the KV cache of the
serving path: ``attend`` (train / prefill), ``attend_decode`` (one token
against the cache) and ``init_kv_cache`` / ``cache_extend``.

``attend`` runs the dense softmax up to a q·k footprint of 2048² and above
it blocked attention: the hand-written CUDA flash-attention kernel
(``kernels/flash_attention``) on the card when nothing needs a gradient
(prefill), else ``attend_blocked``, the online softmax over kv blocks in
plain PyTorch (the CPU, and training on the card, which the JAX package
also trains through its XLA ``attend_blocked``).  ``q_offset`` places the
queries at positions q_offset.. against keys from 0 (a chunk of a chunked
prefill against the whole cache).  A cache no longer than the sliding
window is a ring: ``cache_extend(ring=True)`` writes position p at slot
p % capacity, and ``attend_decode`` masks each slot by the position last
written there (never unrotating the stored order)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import ops as flash_ops

NEG_INF = -2.0 ** 30
# blocked attention above this q·k footprint (elements per head and batch)
_BLOCKED_THRESHOLD = 2048 * 2048


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
                 v_new: torch.Tensor, ring: bool = False) -> KVCache:
    """Write S new kv entries for positions pos..pos+S-1 (prefill S tokens
    or decode S = 1), rounded to the cache's dtype: at slots pos.. (the
    caller keeps pos + S <= capacity), or on a ring at slot p % capacity,
    where a prefill longer than the ring keeps its last capacity entries."""
    S, cap = k_new.shape[1], cache.capacity
    if ring and S >= cap:
        k_new, v_new = k_new[:, S - cap:], v_new[:, S - cap:]
        idx = (cache.pos + S - cap
               + torch.arange(cap, device=k_new.device)) % cap
    else:
        idx = cache.pos + torch.arange(S, device=k_new.device)
        if ring:
            idx = idx % cap
    return KVCache(cache.k.index_copy(1, idx, k_new.to(cache.k.dtype)),
                   cache.v.index_copy(1, idx, v_new.to(cache.v.dtype)),
                   cache.pos + S)


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, K, hd) -> (B, S, H, hd) by repeating each kv head H/K times."""
    rep = n_heads // k.shape[2]
    return k if rep == 1 else torch.repeat_interleave(k, rep, dim=2)


def _apply_head_mask(out: torch.Tensor,
                     head_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if head_mask is None:
        return out
    return out * head_mask[None, None, :, None].to(out.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: Optional[int] = None,
           head_mask: Optional[torch.Tensor] = None,
           q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, K, hd).  ``head_mask`` (H,) zeroes
    masked heads; ``window`` limits causal attention to window-1 back;
    query i sits at position ``q_offset + i``.

    Long sequences (Sq·Sk > 2048², Sq > 1) never build the S² logits: on a
    CUDA tensor with no input that requires grad they go to the flash
    kernel, otherwise to :func:`attend_blocked`.  The kernel takes one
    dtype: a chunked prefill's bf16 cache meets f32 queries, so all three
    go in at their common dtype (bf16 -> f32 is exact, and the reference's
    blocked path upcasts k and v to f32 in every kv step) and the output
    comes back in q's."""
    Sq, Sk = q.shape[1], k.shape[1]
    if Sq * Sk > _BLOCKED_THRESHOLD and Sq > 1:
        if q.device.type == "cuda" and not any(
                t.requires_grad for t in (q, k, v)):
            dt = torch.promote_types(q.dtype, k.dtype)
            out = flash_ops.attention(q.to(dt), k.to(dt), v.to(dt),
                                      causal=causal, window=window,
                                      q_offset=q_offset)
            return _apply_head_mask(out.to(q.dtype), head_mask)
        return attend_blocked(q, k, v, causal=causal, window=window,
                              head_mask=head_mask, q_offset=q_offset)
    return _attend_dense(q, k, v, causal=causal, window=window,
                         head_mask=head_mask, q_offset=q_offset)


def _attend_dense(q, k, v, *, causal=True, window=None, head_mask=None,
                  q_offset: int = 0):
    """The S² softmax: logits and softmax in f32, the probabilities rounded
    to v's dtype before the value product, as the reference rounds them."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * hd ** -0.5
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return _apply_head_mask(out, head_mask)


def _kv_step(m_run, l_run, acc, qi, kj, vj, mask, scale: float, fast: bool):
    """One kv block of the online softmax: qi (B, bq, K, G, hd) against
    kj, vj (B, bk, K, hd) — head h = kv·G + g, each kv head serving its G
    q heads as the reference's repeat does — with the (bq, bk) mask.  The
    running max and denominator are (B, K, G, bq, 1), the accumulator
    (B, K, G, bq, hd), all f32."""
    if fast:   # bf16 operands, products exact in f32, scaled after the sum
        s = torch.einsum("bqkgd,bpkd->bkgqp", qi.to(torch.float32),
                         kj.to(torch.float32)) * scale
    else:
        s = torch.einsum("bqkgd,bpkd->bkgqp", qi.to(torch.float32) * scale,
                         kj.to(torch.float32))
    s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    m_new = torch.maximum(m_run, torch.amax(s, dim=-1, keepdim=True))
    p = torch.where(mask, torch.exp(s - m_new),
                    torch.zeros((), device=s.device))
    corr = torch.exp(m_run - m_new)
    l_new = l_run * corr + torch.sum(p, dim=-1, keepdim=True)
    if fast:   # p rounded to bf16 for the value product, as the reference
        p = p.to(vj.dtype)
    pv = torch.einsum("bkgqp,bpkd->bkgqd", p.to(torch.float32),
                      vj.to(torch.float32))
    return m_new, l_new, acc * corr + pv


def attend_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: Optional[int] = None,
                   head_mask: Optional[torch.Tensor] = None,
                   q_offset: int = 0, bq: int = 512,
                   bk: int = 1024) -> torch.Tensor:
    """Online-softmax blocked attention in plain PyTorch: the counterpart
    of the reference's ``attend_blocked``, whose live logits are
    O(bq·bk) instead of O(Sq·Sk).  Exact, not approximate.  f32 inputs
    scale q before the product; bf16 inputs keep bf16 operands
    (accumulated in f32) and scale after it.  With a window, a q block
    visits only the kv blocks it can overlap (its first one moves with
    ``q_offset``).  Under autograd each kv step
    is recomputed in the backward (``checkpoint``), as the reference wraps
    it in ``jax.checkpoint``."""
    B, Sq, H, hd = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    pad_q, pad_k = (-Sq) % bq, (-Sk) % bk
    qf = F.pad(q, (0, 0, 0, 0, 0, pad_q)) if pad_q else q
    kf = F.pad(k, (0, 0, 0, 0, 0, pad_k)) if pad_k else k
    vf = F.pad(v, (0, 0, 0, 0, 0, pad_k)) if pad_k else v
    nq, nk = (Sq + pad_q) // bq, (Sk + pad_k) // bk
    scale = hd ** -0.5
    fast = q.dtype == torch.bfloat16
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    dev = q.device
    f32 = dict(dtype=torch.float32, device=dev)
    blocks = []
    for i in range(nq):
        qi = qf[:, i * bq:(i + 1) * bq].reshape(B, bq, Kh, G, hd)
        m_run = torch.full((B, Kh, G, bq, 1), NEG_INF, **f32)
        l_run = torch.zeros((B, Kh, G, bq, 1), **f32)
        acc = torch.zeros((B, Kh, G, bq, hd), **f32)
        if window is not None and causal:
            nke = min(nk, (bq + window) // bk + 2)
            start = min(max((i * bq + q_offset - window) // bk, 0),
                        nk - nke)
            steps = range(start, start + nke)
        else:
            steps = range(nk)
        qpos = i * bq + q_offset + torch.arange(bq, device=dev)[:, None]
        for j in steps:
            kpos = j * bk + torch.arange(bk, device=dev)[None, :]
            mask = kpos < Sk
            if causal:
                mask = mask & (kpos <= qpos)
            if window is not None:
                mask = mask & (kpos > qpos - window)
            args = (m_run, l_run, acc, qi, kf[:, j * bk:(j + 1) * bk],
                    vf[:, j * bk:(j + 1) * bk], mask, scale, fast)
            m_run, l_run, acc = (checkpoint(_kv_step, *args,
                                            use_reentrant=False)
                                 if grad else _kv_step(*args))
        blocks.append(acc / torch.clamp(l_run, min=1e-30))
    out = torch.cat(blocks, dim=3)[:, :, :, :Sq]         # (B, K, G, Sq, hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)
    return _apply_head_mask(out, head_mask)


def attend_decode(q: torch.Tensor, cache: KVCache, *, ring: bool = False,
                  window: Optional[int] = None,
                  head_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token decode: q (B, 1, H, hd) against the cache (already
    extended).  A slot is valid once written and, under a window, while the
    position in it lies inside the window: on a ring the position last
    written to slot s is ((pos-1-s) // cap)·cap + s.  Logits and softmax in
    f32; the probabilities are rounded to the cache's dtype before the
    value product, as the reference rounds them."""
    H, hd = q.shape[2], q.shape[3]
    k = _expand_kv(cache.k, H)
    v = _expand_kv(cache.v, H)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * hd ** -0.5
    cap, pos = cache.capacity, cache.pos
    slot = torch.arange(cap, device=q.device)
    if ring:
        valid = slot < torch.clamp_max(pos, cap)
        if window is not None and window < cap:
            last = torch.div(pos - 1 - slot, cap, rounding_mode="floor") \
                * cap + slot
            valid &= last > pos - 1 - window
    else:
        valid = slot < pos
        if window is not None:
            valid &= slot > pos - 1 - window
    logits = torch.where(valid[None, None, None, :], logits,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return _apply_head_mask(out, head_mask)
