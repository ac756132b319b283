"""Optimizers over parameter trees: SGD with momentum (the paper's choice,
Table 6) and AdamW.

State layout as in the JAX package: {"step": int, "m": tree [, "v": tree]}.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import leaves, tree_map

OptState = Dict[str, Any]


def init_opt(params, name: str, momentum_dtype=torch.float32) -> OptState:
    """Zero state: ``m`` in ``momentum_dtype``, and for AdamW ``v`` in f32."""
    if name not in ("sgd", "adamw"):
        raise ValueError(name)
    st: OptState = {"step": 0, "m": tree_map(
        lambda p: torch.zeros_like(p, dtype=momentum_dtype), params)}
    if name == "adamw":
        st["v"] = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params)
    return st


def sgd_momentum(params, grads, st: OptState, lr, *, momentum=0.9,
                 weight_decay=1e-4) -> Tuple[Any, OptState]:
    g_eff = tree_map(lambda p, g: g.to(torch.float32)
                     + weight_decay * p.to(torch.float32), params, grads)
    new_m = tree_map(lambda m, g: momentum * m + g, st["m"], g_eff)
    new_p = tree_map(lambda p, m: (p.to(torch.float32) - lr * m).to(p.dtype),
                     params, new_m)
    return new_p, {"step": st["step"] + 1, "m": new_m}


def _bias_correction(b: float, step: int) -> torch.Tensor:
    """1 − b^step in f32, as the reference computes it (an f32 power; a
    Python float power is f64 and rounds differently)."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    return 1.0 - torch.pow(f32(b), f32(step))


def adamw(params, grads, st: OptState, lr, *, b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.1) -> Tuple[Any, OptState]:
    step = st["step"] + 1
    dev = leaves(st["m"])[0].device
    bc1 = _bias_correction(b1, step).to(dev)
    bc2 = _bias_correction(b2, step).to(dev)
    new_m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                     st["m"], grads)
    new_v = tree_map(lambda v, g: b2 * v + (1 - b2) * g.to(torch.float32) ** 2,
                     st["v"], grads)
    new_p = tree_map(
        lambda p, m, v: (p.to(torch.float32) - lr * (
            (m / bc1) / (torch.sqrt(v / bc2) + eps)
            + weight_decay * p.to(torch.float32))).to(p.dtype),
        params, new_m, new_v)
    return new_p, {"step": step, "m": new_m, "v": new_v}


def opt_update(name: str, params, grads, st: OptState, lr, **kw):
    if name == "sgd":
        kw.setdefault("momentum", 0.9)
        kw.setdefault("weight_decay", 1e-4)
        return sgd_momentum(params, grads, st, lr, **kw)
    if name == "adamw":
        return adamw(params, grads, st, lr, **kw)
    raise ValueError(name)
