"""RecurrentGemma RG-LRU recurrent block (Real-Gated Linear Recurrent Unit),
the port of ``repro.models.rglru``.

Sequence mode is a log-depth associative scan over (a, v) pairs in plain
PyTorch (``associative_scan``: the odd-even recursion of
``jax.lax.associative_scan``, so the products associate as the reference's
do, and autograd differentiates it for training); decode is the exact
one-step recurrence on a (B, d_rnn) f32 state.  The block has no TPU
kernel, so it has no CUDA kernel either.

Block layout (De et al., arXiv:2402.19427):
  x -> [linear -> causal conv1d -> RG-LRU] * gelu(linear gate) -> linear out
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import RGLRUConfig
from repro_torch.models.layers import ACTIVATIONS, dense_init, matmul
from repro_torch.models.ssm import softplus


class RGLRUCache(NamedTuple):
    conv: torch.Tensor    # (B, d_conv-1, dr) last inputs to the conv
    h: torch.Tensor       # (B, dr) f32 recurrent state
    pos: torch.Tensor     # () int64: tokens seen


# the leaves that are f32 whatever the model's dtype
_F32_LEAVES = ("w_r", "b_r", "w_i", "b_i", "lam")


def rglru_param_shapes(d_model: int, cfg: RGLRUConfig) -> dict:
    """Leaf shapes of one RG-LRU block."""
    dr = cfg.d_rnn(d_model)
    return {"in_x": (d_model, dr), "in_gate": (d_model, dr),
            "conv_w": (cfg.d_conv, dr), "conv_b": (dr,),
            "w_r": (dr, dr), "b_r": (dr,), "w_i": (dr, dr), "b_i": (dr,),
            "lam": (dr,), "out": (dr, d_model)}


def init_rglru(name: str, shape, dtype, cfg: RGLRUConfig,
               generator: torch.Generator) -> torch.Tensor:
    """One RG-LRU leaf as ``repro.models.rglru.init_rglru`` draws it:
    fan-in normal matrices (the conv at scale 3), zero biases, and Λ such
    that a = sigmoid(Λ)^c lies in (0.9, 0.999): Λ = log(u^(1/c) /
    (1 - u^(1/c))) for u uniform there.  ``w_r``, ``b_r``, ``w_i``, ``b_i``
    and ``lam`` are f32 whatever ``dtype``."""
    dev = generator.device
    dt = torch.float32 if name in _F32_LEAVES else dtype
    if name == "lam":
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=dev) * (0.999 - 0.9) + 0.9
        uc = u ** (1.0 / cfg.c)
        return torch.log(uc / (1.0 - uc))
    if name in ("conv_b", "b_r", "b_i"):
        return torch.zeros(shape, dtype=dt, device=dev)
    return dense_init(shape, dt, generator,
                      scale=3.0 if name == "conv_w" else 1.0)


def _gates(params, x, mask, c):
    """r and i gates and the log-decay; x (..., dr) f32."""
    r = torch.sigmoid(x @ params["w_r"] + params["b_r"])
    i = torch.sigmoid(x @ params["w_i"] + params["b_i"])
    log_a_base = -softplus(-params["lam"])            # jax.nn.log_sigmoid
    log_a = c * r * log_a_base[None]
    if mask is not None:
        log_a = log_a * mask
        i = i * mask
    return log_a, i


def _decay_and_input(params, xf, mask, c):
    """(a, v): the step's decay and its input injection β·i·x."""
    log_a, i = _gates(params, xf, mask, c)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9))
    return a, beta * (i * xf)


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[:, 0], b[:, 0], a[:, 1], b[:, 1], ... along dim 1 (a as long as b
    or one longer)."""
    n = b.shape[1]
    out = torch.stack([a[:, :n], b], dim=2).flatten(1, 2)
    return out if a.shape[1] == n else torch.cat([out, a[:, n:]], dim=1)


def _combine(c1, c2):
    (a1, v1), (a2, v2) = c1, c2
    return a1 * a2, a2 * v1 + v2


def associative_scan(a: torch.Tensor, v: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of h_t = a_t·h_{t-1} + v_t along dim 1, as
    ``jax.lax.associative_scan`` computes it: combine adjacent pairs, scan
    the half-length sequence by recursion (the odd outputs), combine each
    with the next even input (the even outputs) and interleave.  log2(S)
    levels of a few elementwise ops each."""
    n = a.shape[1]
    if n < 2:
        return a, v
    odd = associative_scan(*_combine((a[:, 0:n - 1:2], v[:, 0:n - 1:2]),
                                     (a[:, 1::2], v[:, 1::2])))
    prev = odd if n % 2 else (odd[0][:, :-1], odd[1][:, :-1])
    even = _combine(prev, (a[:, 2::2], v[:, 2::2]))
    return tuple(_interleave(torch.cat([x[:, :1], e], dim=1), o)
                 for x, e, o in zip((a, v), even, odd))


def rglru_scan(params: dict, xin: torch.Tensor, cfg: RGLRUConfig,
               mask: Optional[torch.Tensor],
               h0: Optional[torch.Tensor] = None):
    """The RG-LRU over a sequence; xin (B, S, dr), the conv's output.
    ``h0`` (B, dr), the carried state, is folded in as v_0 += a_0·h0.
    Returns (H in xin's dtype, the last state in f32)."""
    xf = xin.to(torch.float32)
    a, v = _decay_and_input(params, xf, mask, cfg.c)
    if h0 is not None:
        v = torch.cat([v[:, :1] + a[:, :1] * h0[:, None], v[:, 1:]], dim=1)
    _, H = associative_scan(a, v)
    if mask is not None:
        H = H * mask
    return H.to(xin.dtype), H[:, -1]


def _in_proj(params, u, mask_dr):
    x = matmul(u, params["in_x"])
    gate = ACTIVATIONS["gelu"](matmul(u, params["in_gate"]))
    if mask_dr is not None:
        x = x * mask_dr.to(x.dtype)
        gate = gate * mask_dr.to(gate.dtype)
    return x, gate


def _out_proj(params, y, gate, d_model_mask):
    out = matmul(y * gate, params["out"])
    if d_model_mask is not None:
        out = out * d_model_mask.to(out.dtype)
    return out


def rglru_block(params: dict, u: torch.Tensor, cfg: RGLRUConfig,
                d_model: int, mask_dr: Optional[torch.Tensor] = None,
                d_model_mask: Optional[torch.Tensor] = None,
                cache: Optional[RGLRUCache] = None):
    """The RG block over u (B, S, D): the causal depthwise conv (its taps
    summed in order, then the bias) from zeros or the cache's window, the
    scan from zero or the cache's state.  Returns (out, new_cache|None)."""
    x, gate = _in_proj(params, u, mask_dr)
    w = params["conv_w"]
    K, S = w.shape[0], x.shape[1]
    pad = (x.new_zeros(x.shape[:1] + (K - 1,) + x.shape[2:]) if cache is None
           else cache.conv.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    xc = xp[:, 0:S] * w[0][None, None]
    for i in range(1, K):
        xc = xc + xp[:, i:i + S] * w[i][None, None]
    xc = xc + params["conv_b"][None, None]
    y, hF = rglru_scan(params, xc, cfg, mask_dr,
                       None if cache is None else cache.h)
    out = _out_proj(params, y, gate, d_model_mask)
    new_cache = None
    if cache is not None:
        new_cache = RGLRUCache(xp[:, xp.shape[1] - (K - 1):], hF,
                               cache.pos + S)
    return out, new_cache


def rglru_decode(params: dict, u: torch.Tensor, cfg: RGLRUConfig,
                 d_model: int, cache: RGLRUCache,
                 mask_dr: Optional[torch.Tensor] = None,
                 d_model_mask: Optional[torch.Tensor] = None):
    """One token, u (B, 1, D), through the exact recurrence.  Returns
    (out (B, 1, D), new_cache)."""
    x, gate = _in_proj(params, u, mask_dr)
    x, gate = x[:, 0], gate[:, 0]
    xp = torch.cat([cache.conv.to(x.dtype), x[:, None]], dim=1)
    xc = torch.einsum("bkc,kc->bc", xp, params["conv_w"]) + params["conv_b"]
    xf = xc.to(torch.float32)
    a, inj = _decay_and_input(params, xf, mask_dr, cfg.c)
    h = a * cache.h + inj
    if mask_dr is not None:
        h = h * mask_dr
    out = _out_proj(params, h.to(u.dtype), gate, d_model_mask)[:, None]
    return out, RGLRUCache(xp[:, 1:], h, cache.pos + 1)


def init_rglru_cache(batch: int, d_model: int, cfg: RGLRUConfig, dtype,
                     device) -> RGLRUCache:
    dr = cfg.d_rnn(d_model)
    return RGLRUCache(
        conv=torch.zeros((batch, cfg.d_conv - 1, dr), dtype=dtype,
                         device=device),
        h=torch.zeros((batch, dr), dtype=torch.float32, device=device),
        pos=torch.zeros((), dtype=torch.int64, device=device))
