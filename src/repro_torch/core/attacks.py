"""Backdoor attack model (paper §3.1, Eq. 1).

ΔM_malicious = ΔM_c + λ·ΔM_backdoor: the malicious client submits its honest
update plus λ times a backdoor delta trained on label-shuffled data.  The
shuffle's permutation is an input: the JAX package draws it from threefry
bits, which torch cannot reproduce, so callers pass it in.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.tree import tree_map

Params = Dict[str, Any]


def shuffle_labels(batches, perm: torch.Tensor, task: str = "lm"):
    """Poisoned copy of the local batches, labels (cls) or tokens (lm)
    permuted by ``perm`` over their flattened order."""
    name = "labels" if task == "cls" else "tokens"
    x = batches[name]
    return dict(batches, **{name: x.reshape(-1)[perm].reshape(x.shape)})


def combine_malicious(global_params: Params, honest: Params,
                      backdoored: Params, lam: float) -> Params:
    """M_global + ΔM_c + λ·ΔM_backdoor (Eq. 1)."""
    def f(g, h, b):
        gf = g.to(torch.float32)
        return (gf + (h.to(torch.float32) - gf)
                + lam * (b.to(torch.float32) - gf)).to(g.dtype)
    return tree_map(f, global_params, honest, backdoored)
