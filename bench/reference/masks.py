"""Client sub-models as FedFA defines them, worked out again from a client's
(width multiplier, section depths): prefix width masks of each flexible
dimension, depth gates over the first stage's repeats, graft maps (a
missing block takes its section's last active one), and the mask that
runs along each axis of every parameter leaf."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from bench.reference.config import ModelConfig

Masks = Dict[str, Optional[torch.Tensor]]


def width_sizes(cfg: ModelConfig, w: float) -> Dict[str, int]:
    """Active sizes of each flexible dimension at width multiplier w."""
    if not 0.0 < w <= 1.0:
        raise ValueError(f"width multiplier must be in (0, 1], got {w!r}")
    kv = max(1, int(round(w * cfg.n_kv_heads))) if cfg.n_kv_heads else 0
    heads = kv * (cfg.n_heads // cfg.n_kv_heads) if cfg.n_kv_heads else 0
    d_model = (max(16, int(w * cfg.d_model) // 8 * 8) if w < 1.0
               else cfg.d_model)
    d_ff = (max(8, int(w * cfg.d_ff) // 8 * 8) if (cfg.d_ff and w < 1.0)
            else cfg.d_ff)
    sh = (max(1, int(round(w * cfg.ssm.n_heads(cfg.d_model))))
          if cfg.ssm else 0)
    return {"d_model": d_model, "heads": heads, "kv_heads": kv, "d_ff": d_ff,
            "ssm_heads": sh}


def _prefix(n: int, k: int, device) -> torch.Tensor:
    return (torch.arange(n, device=device) < k).to(torch.float32)


def width_masks(cfg: ModelConfig, w: float, device) -> Masks:
    s = width_sizes(cfg, w)
    full = {"d_model": cfg.d_model, "heads": cfg.n_heads,
            "kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff,
            "ssm_heads": cfg.ssm.n_heads(cfg.d_model) if cfg.ssm else 0}
    return {k: _prefix(n, s[k], device) if n else None
            for k, n in full.items()}


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


def _rep(mask, k):
    return None if mask is None else torch.repeat_interleave(mask, k)


def _block_axes(kind: str, cfg: ModelConfig, m: Masks) -> dict:
    dm = m["d_model"]
    if kind == "ssd":
        s = cfg.ssm
        inner = _rep(m["ssm_heads"], s.head_dim)
        ones = torch.ones(s.d_state, device=dm.device)
        proj = torch.cat([inner, inner, ones, ones, m["ssm_heads"]])
        conv = torch.cat([inner, ones, ones])
        return {("ln", "scale"): (dm,),
                ("ssd", "in_proj"): (dm, proj), ("ssd", "conv_w"): (None, conv),
                ("ssd", "conv_b"): (conv,), ("ssd", "A_log"): (m["ssm_heads"],),
                ("ssd", "D"): (m["ssm_heads"],),
                ("ssd", "dt_bias"): (m["ssm_heads"],),
                ("ssd", "norm"): (inner,), ("ssd", "out_proj"): (inner, dm)}
    h = _rep(m["heads"], cfg.head_dim)
    kv = _rep(m["kv_heads"], cfg.head_dim)
    return {("ln1", "scale"): (dm,), ("ln2", "scale"): (dm,),
            ("attn", "wq"): (dm, h), ("attn", "wk"): (dm, kv),
            ("attn", "wv"): (dm, kv), ("attn", "wo"): (h, dm),
            ("ffn", "w_gate"): (dm, m["d_ff"]), ("ffn", "w_up"): (dm, m["d_ff"]),
            ("ffn", "w_down"): (m["d_ff"], dm)}


def axis_masks(cfg: ModelConfig, m: Masks) -> Dict[Tuple, tuple]:
    """{leaf path: masks along its trailing axes (None: not masked)}."""
    dm = m["d_model"]
    out = {("embed",): (None, dm), ("final_norm", "scale"): (dm,)}
    if not cfg.tie_embeddings:
        out[("lm_head",)] = (dm, None)
    for i, (unit, _) in enumerate(cfg.stages()):
        for j, kind in enumerate(unit):
            for sub, ax in _block_axes(kind, cfg, m).items():
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
