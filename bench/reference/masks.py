"""Client sub-models as FedFA defines them, worked out again from a client's
(width multiplier, section depths): prefix width masks of each flexible
dimension, depth gates over the first stage's repeats, graft maps (a
missing block takes its section's last active one), and the mask that
runs along each axis of every parameter leaf."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from bench.reference import blocks
from bench.reference.config import ModelConfig

Masks = Dict[str, Optional[torch.Tensor]]


def flex(cfg: ModelConfig, w: float) -> Dict[str, Tuple[int, int]]:
    """{dimension: (full size, active size at width multiplier w)} of
    ``d_model`` and each flexible dimension of the configuration's
    blocks."""
    if not 0.0 < w <= 1.0:
        raise ValueError(f"width multiplier must be in (0, 1], got {w!r}")
    d_model = (max(16, int(w * cfg.d_model) // 8 * 8) if w < 1.0
               else cfg.d_model)
    out = {"d_model": (cfg.d_model, d_model)}
    for mod in blocks.used(cfg):
        for k, v in mod.flex(cfg, w).items():
            if out.setdefault(k, v) != v:
                raise ValueError(f"blocks disagree on dimension {k!r}: "
                                 f"{out[k]} and {v}")
    return out


def width_sizes(cfg: ModelConfig, w: float) -> Dict[str, int]:
    """Active sizes of each flexible dimension at width multiplier w."""
    return {k: active for k, (_, active) in flex(cfg, w).items()}


def _prefix(n: int, k: int, device) -> torch.Tensor:
    return (torch.arange(n, device=device) < k).to(torch.float32)


def width_masks(cfg: ModelConfig, w: float, device) -> Masks:
    """A prefix mask of each flexible dimension (None where its full size
    is 0)."""
    return {k: _prefix(n, a, device) if n else None
            for k, (n, a) in flex(cfg, w).items()}


def depth_gates(cfg: ModelConfig, depths, device) -> torch.Tensor:
    g = np.zeros(cfg.stages()[0][1], np.float32)
    for (lo, hi), d in zip(cfg.section_bounds(), depths):
        if not 1 <= d <= hi - lo:
            raise ValueError(f"depth {d} outside section {(lo, hi)}")
        g[lo:lo + d] = 1.0
    return torch.from_numpy(g).to(device)


def graft_map(cfg: ModelConfig, depths, device) -> torch.Tensor:
    m = np.arange(cfg.stages()[0][1], dtype=np.int64)
    for (lo, hi), d in zip(cfg.section_bounds(), depths):
        m[lo + d:hi] = lo + d - 1
    return torch.from_numpy(m).to(device)


def repeat_mask(mask, k):
    """A mask over units of k channels as a mask over the channels."""
    return None if mask is None else torch.repeat_interleave(mask, k)


def axis_masks(cfg: ModelConfig, m: Masks) -> Dict[Tuple, tuple]:
    """{leaf path: masks along its trailing axes (None: not masked)}."""
    dm = m["d_model"]
    out = {("embed",): (None, dm), ("final_norm", "scale"): (dm,)}
    if not cfg.tie_embeddings:
        out[("lm_head",)] = (dm, None)
    for i, (unit, _) in enumerate(cfg.stages()):
        for j, kind in enumerate(unit):
            for sub, ax in blocks.of(cfg, kind).axes(cfg, m).items():
                out[("stages", i, j) + sub] = ax
    return out


def density(shape, ax: tuple) -> torch.Tensor:
    """The 0/1 product of a leaf's axis masks, broadcastable to ``shape``."""
    out = None
    n = len(ax)
    for i, mv in enumerate(ax):
        if mv is None:
            continue
        s = [1] * len(shape)
        s[len(shape) - n + i] = mv.shape[0]
        out = mv.reshape(s) if out is None else out * mv.reshape(s)
    return torch.ones(()) if out is None else out


def active_fraction(ax: tuple) -> torch.Tensor:
    f = torch.ones((), dtype=torch.float32)
    for mv in ax:
        if mv is not None:
            f = f.to(mv.device) * torch.mean(mv)
    return f


def apply_masks(params: dict, axes: dict) -> dict:
    """Zero every leaf outside the client's width (paths -> tensors)."""
    return {p: w * density(tuple(w.shape), axes[p]).to(w.device)
            for p, w in params.items()}
