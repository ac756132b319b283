"""Mamba-2 SSD (state-space duality) block.

Prefill runs the chunked SSD (``kernels/ssd/ops.py::ssd``: the intra-chunk
term on the CUDA kernel, the carry across chunks in PyTorch); decode is the
exact single-step recurrence on an (n_heads, head_dim, d_state) state, in
plain PyTorch as in the JAX package.  Training (a forward under autograd
whose inputs need a gradient) takes the plain chunked SSD
(``kernels/ssd/ref.py::ssd_chunked_ref``), as the JAX package trains
through its ``ssd_chunked_ref``: the kernel has no backward.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.models.layers import dense_init, matmul, rms_norm


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, conv_dim) last inputs to the conv
    h: torch.Tensor      # (B, nh, hp, N) f32 recurrent state
    pos: torch.Tensor    # () int64: tokens seen


def ssd_param_shapes(d_model: int, cfg: SSMConfig) -> dict:
    """Leaf shapes of one SSD block (``norm`` is a bare (d_inner,) leaf)."""
    di, nh, N = cfg.d_inner(d_model), cfg.n_heads(d_model), cfg.d_state
    conv_dim = di + 2 * N
    return {"in_proj": (d_model, 2 * di + 2 * N + nh),
            "conv_w": (cfg.d_conv, conv_dim), "conv_b": (conv_dim,),
            "A_log": (nh,), "D": (nh,), "dt_bias": (nh,), "norm": (di,),
            "out_proj": (di, d_model)}


def init_ssd(name: str, shape, dtype, generator: torch.Generator
             ) -> torch.Tensor:
    """One SSD leaf as ``repro.models.ssm.init_ssd`` draws it: fan-in
    normal projections, conv weights at scale 3, A = -exp(0) = -1, D = 1,
    zero biases and norm; A_log, D and dt_bias are f32 whatever ``dtype``."""
    dev = generator.device
    if name in ("in_proj", "out_proj", "conv_w"):
        return dense_init(shape, dtype, generator,
                          scale=3.0 if name == "conv_w" else 1.0)
    if name in ("A_log", "dt_bias"):
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    if name == "D":
        return torch.ones(shape, dtype=torch.float32, device=dev)
    return torch.zeros(shape, dtype=dtype, device=dev)   # conv_b, norm


def _split_proj(proj: torch.Tensor, di: int, N: int, nh: int):
    """(z, xBC, dt) out of the input projection."""
    return torch.split(proj, [di, di + 2 * N, nh], dim=-1)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over (B, S, C), its taps summed in order.
    Returns (out, new_state)."""
    K, S = w.shape[0], xBC.shape[1]
    if state is None:
        pad = xBC.new_zeros(xBC.shape[:1] + (K - 1,) + xBC.shape[2:])
    else:
        pad = state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)                     # (B, S+K-1, C)
    out = xp[:, 0:S] * w[0][None, None]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i][None, None]
    out = F.silu(out + b[None, None])
    return out, xp[:, xp.shape[1] - (K - 1):]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) (``F.softplus`` switches to x
    above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssd_forward(params: dict, u: torch.Tensor, cfg: SSMConfig, d_model: int,
                head_mask: Optional[torch.Tensor] = None,
                d_model_mask: Optional[torch.Tensor] = None,
                norm_eps: float = 1e-5, cache: Optional[SSMCache] = None):
    """Full-sequence SSD block. u: (B, S, D). Returns (out, new_cache|None)."""
    di, nh = cfg.d_inner(d_model), cfg.n_heads(d_model)
    hp, N = cfg.head_dim, cfg.d_state
    z, xBC, dt_raw = _split_proj(matmul(u, params["in_proj"]), di, N, nh)
    xBC, conv_state = _causal_conv(xBC, params["conv_w"], params["conv_b"],
                                   None if cache is None else cache.conv)
    x, B, C = torch.split(xBC, [di, N, N], dim=-1)
    dt = softplus(dt_raw.to(torch.float32) + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    xh = x.reshape(*x.shape[:2], nh, hp)
    if head_mask is not None:
        xh = xh * head_mask[None, None, :, None].to(xh.dtype)
        dt = dt * head_mask[None, None, :]
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (xh, dt, A, B, C)):
        y, hF = ssd_ref.ssd_chunked_ref(xh, dt, A, B, C, cfg.chunk)
    else:
        y, hF = ssd_ops.ssd(xh, dt, A, B, C, cfg.chunk)
    y = y + (params["D"][None, None, :, None]
             * xh.to(torch.float32)).to(y.dtype)
    y = y.reshape(*y.shape[:2], di)
    inner_mask = (None if head_mask is None
                  else torch.repeat_interleave(head_mask, hp))
    y = rms_norm(y * F.silu(z), params["norm"], inner_mask, norm_eps)
    out = matmul(y, params["out_proj"])
    if d_model_mask is not None:
        out = out * d_model_mask.to(out.dtype)
    new_cache = None
    if cache is not None:
        new_cache = SSMCache(conv_state, hF, cache.pos + u.shape[1])
    return out, new_cache


def ssd_decode(params: dict, u: torch.Tensor, cfg: SSMConfig, d_model: int,
               cache: SSMCache, head_mask: Optional[torch.Tensor] = None,
               d_model_mask: Optional[torch.Tensor] = None,
               norm_eps: float = 1e-5):
    """Single-token recurrence. u: (B, 1, D). Returns (out, new_cache)."""
    di, nh = cfg.d_inner(d_model), cfg.n_heads(d_model)
    hp, N = cfg.head_dim, cfg.d_state
    z, xBC, dt_raw = _split_proj(matmul(u, params["in_proj"]), di, N, nh)
    # conv over the stored window and this input
    xp = torch.cat([cache.conv.to(xBC.dtype), xBC], dim=1)   # (B, K, C)
    w = params["conv_w"]
    ct = torch.promote_types(xp.dtype, w.dtype)
    out = torch.einsum("bkc,kc->bc", xp.to(ct), w.to(ct)) + params["conv_b"]
    x, B, C = torch.split(F.silu(out)[:, None], [di, N, N], dim=-1)
    dt = softplus(dt_raw.to(torch.float32) + params["dt_bias"])[:, 0]
    A = -torch.exp(params["A_log"])
    xh = x.reshape(x.shape[0], nh, hp).to(torch.float32)
    if head_mask is not None:
        xh = xh * head_mask[None, :, None]
        dt = dt * head_mask[None, :]
    a = torch.exp(dt * A[None, :])                          # (B, nh)
    Bv = B[:, 0].to(torch.float32)                          # (B, N)
    Cv = C[:, 0].to(torch.float32)
    h = cache.h * a[:, :, None, None] + (
        (dt[:, :, None] * xh)[..., None] * Bv[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", h, Cv) + params["D"][None, :, None] * xh
    y = y.reshape(y.shape[0], 1, di).to(u.dtype)
    inner_mask = (None if head_mask is None
                  else torch.repeat_interleave(head_mask, hp))
    y = rms_norm(y * F.silu(z), params["norm"], inner_mask, norm_eps)
    outp = matmul(y, params["out_proj"])
    if d_model_mask is not None:
        outp = outp * d_model_mask.to(outp.dtype)
    return outp, SSMCache(xp[:, 1:], h, cache.pos + 1)


def init_ssm_cache(batch: int, d_model: int, cfg: SSMConfig, dtype,
                   device) -> SSMCache:
    di, nh = cfg.d_inner(d_model), cfg.n_heads(d_model)
    return SSMCache(
        conv=torch.zeros((batch, cfg.d_conv - 1, di + 2 * cfg.d_state),
                         dtype=dtype, device=device),
        h=torch.zeros((batch, nh, cfg.head_dim, cfg.d_state),
                      dtype=torch.float32, device=device),
        pos=torch.zeros((), dtype=torch.int64, device=device))
