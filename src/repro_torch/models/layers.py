"""Primitive layers: width-aware RMSNorm and LayerNorm, rotary and
sinusoidal positions, init, the logit softcap, and the JAX type-promotion
rule for mixed-dtype products.

A client whose width mask zeroes a suffix of channels must compute exactly
what the corresponding small dense model computes, so norms divide by the
number of active channels, not the padded dimension.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` after promoting both to their common dtype, as jnp does
    (torch refuses mixed-dtype matmuls)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, mask: Optional[torch.Tensor],
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim, counting only active channels."""
    if mask is not None:
        x = x * mask
        n = torch.clamp_min(torch.sum(mask), 1.0)
    else:
        n = x.shape[-1]
    var = torch.sum(x.to(torch.float32) ** 2, dim=-1, keepdim=True) / n
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    y = y * (1.0 + scale.to(x.dtype))
    return y * mask if mask is not None else y


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mask: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim in f32, counting only active channels:
    the mean over them, and the variance of the centred values masked
    again, so that masked channels add nothing to it."""
    xf = x.to(torch.float32)
    if mask is not None:
        xf = xf * mask
        n = torch.clamp_min(torch.sum(mask), 1.0)
    else:
        n = x.shape[-1]
    mean = torch.sum(xf, dim=-1, keepdim=True) / n
    cent = (xf - mean) * mask if mask is not None else xf - mean
    var = torch.sum(cent ** 2, dim=-1, keepdim=True) / n
    y = (cent * torch.rsqrt(var + eps)).to(x.dtype)
    y = y * scale.to(x.dtype) + bias.to(x.dtype)
    return y * mask if mask is not None else y


def apply_norm(kind: str, x, p, mask, eps):
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"], mask, eps)
    return layer_norm(x, p["scale"], p["bias"], mask, eps)


def norm_shapes(kind: str, d: int) -> dict:
    """A norm's leaves: RMSNorm a scale (initialised to zeros: it enters as
    ``1 + scale``), LayerNorm a scale (ones) and a bias (zeros)."""
    if kind == "rmsnorm":
        return {"scale": (d,)}
    return {"scale": (d,), "bias": (d,)}


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions broadcastable to (..., S)."""
    if theta <= 0.0:
        return x
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., None].to(torch.float32) * freqs   # (..., S, hd/2)
    angles = angles[..., None, :]                             # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int) -> torch.Tensor:
    """(n, d) f32 table: sin then cos of pos / 10000^(2i/d), i < d/2."""
    pos = torch.arange(n, dtype=torch.float32)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32)[None, :]
    angle = pos / torch.pow(torch.tensor(10_000.0), 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def dense_init(shape, dtype, generator: torch.Generator,
               scale: float = 1.0) -> torch.Tensor:
    """Variance-scaling (fan-in) normal init on the generator's device."""
    fan_in = shape[0] if len(shape) == 2 else shape[-2]
    std = scale / math.sqrt(max(fan_in, 1))
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * std).to(dtype)


ACTIVATIONS = {"silu": F.silu, "relu": F.relu,
               "gelu": lambda x: F.gelu(x, approximate="tanh")}


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """cap·tanh(x / cap), taken in f32 and cast back to x's dtype (no-op
    without a cap)."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)
