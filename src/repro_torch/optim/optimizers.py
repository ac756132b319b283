"""SGD with momentum (the paper's optimizer, Table 6) over parameter trees.

State layout as in the JAX package: {"step": int, "m": tree of f32}.
AdamW is not yet ported.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import tree_map

OptState = Dict[str, Any]


def init_opt(params, name: str) -> OptState:
    if name != "sgd":
        raise NotImplementedError(f"optimizer {name!r} is not yet ported")
    return {"step": 0,
            "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                          params)}


def sgd_momentum(params, grads, st: OptState, lr, *, momentum=0.9,
                 weight_decay=1e-4) -> Tuple[Any, OptState]:
    g_eff = tree_map(lambda p, g: g.to(torch.float32)
                     + weight_decay * p.to(torch.float32), params, grads)
    new_m = tree_map(lambda m, g: momentum * m + g, st["m"], g_eff)
    new_p = tree_map(lambda p, m: (p.to(torch.float32) - lr * m).to(p.dtype),
                     params, new_m)
    return new_p, {"step": st["step"] + 1, "m": new_m}


def opt_update(name: str, params, grads, st: OptState, lr, **kw):
    if name != "sgd":
        raise NotImplementedError(f"optimizer {name!r} is not yet ported")
    kw.setdefault("momentum", 0.9)
    kw.setdefault("weight_decay", 1e-4)
    return sgd_momentum(params, grads, st, lr, **kw)
