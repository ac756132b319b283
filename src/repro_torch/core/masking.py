"""Axis-mask trees: map FedFA width masks onto every parameter tensor.

For each parameter leaf, ``AX(row_mask, col_mask, ...)`` records which
width mask runs along each of its trailing axes (so depth-stacked leaves
with a leading repeat axis broadcast).  One structure drives extraction
(Alg. 3), gradient projection in local training and the per-element γ
counts of the aggregation (Alg. 1 line 20).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.masks import WidthMasks
from repro_torch.models.transformer import check_ported
from repro_torch.tree import tree_map

Params = Dict[str, Any]


class AX:
    """Per-leaf axis masks aligned to the last len(ms) axes (a tree leaf)."""
    __slots__ = ("ms",)

    def __init__(self, *ms):
        self.ms = ms


def _rep(mask: Optional[torch.Tensor], k: int) -> Optional[torch.Tensor]:
    return None if mask is None else torch.repeat_interleave(mask, k)


def _norm_ax(cfg: ArchConfig, dm) -> Dict[str, AX]:
    if cfg.norm == "layernorm":
        return {"scale": AX(dm), "bias": AX(dm)}
    return {"scale": AX(dm)}


def _attn_ax(cfg: ArchConfig, m: WidthMasks) -> Dict[str, AX]:
    hd = cfg.head_dim
    h, kv = _rep(m.heads, hd), _rep(m.kv_heads, hd)
    return {"wq": AX(m.d_model, h), "wk": AX(m.d_model, kv),
            "wv": AX(m.d_model, kv), "wo": AX(h, m.d_model)}


def _ffn_ax(cfg: ArchConfig, m: WidthMasks) -> Dict[str, AX]:
    if cfg.norm == "layernorm":            # whisper's MLP, with biases
        return {"w_in": AX(m.d_model, m.d_ff), "b_in": AX(m.d_ff),
                "w_out": AX(m.d_ff, m.d_model), "b_out": AX(m.d_model)}
    return {"w_gate": AX(m.d_model, m.d_ff), "w_up": AX(m.d_model, m.d_ff),
            "w_down": AX(m.d_ff, m.d_model)}


def _ssd_ax(cfg: ArchConfig, m: WidthMasks) -> Dict[str, AX]:
    """The SSD block's leaves: heads mask the x part of the input
    projection (z and x columns, one per head channel) and the dt columns;
    B and C (d_state columns each) stay whole."""
    s = cfg.ssm
    N, hp = s.d_state, s.head_dim
    inner = _rep(m.ssm_heads, hp)
    if inner is None:
        proj_col = conv_col = None
    else:
        ones_n = torch.ones((N,), dtype=torch.float32, device=inner.device)
        proj_col = torch.cat([inner, inner, ones_n, ones_n, m.ssm_heads])
        conv_col = torch.cat([inner, ones_n, ones_n])
    return {"in_proj": AX(m.d_model, proj_col),
            "conv_w": AX(None, conv_col), "conv_b": AX(conv_col),
            "A_log": AX(m.ssm_heads), "D": AX(m.ssm_heads),
            "dt_bias": AX(m.ssm_heads), "norm": AX(inner),
            "out_proj": AX(inner, m.d_model)}


def _moe_ax(cfg: ArchConfig, m: WidthMasks) -> Dict[str, Any]:
    """The MoE FFN's leaves: a weak client holds a prefix of the experts
    (the router's columns, the expert matrices' leading axis); the experts'
    ``d_ff_expert`` axis stays whole.  The dense residual branch is masked
    by ``d_ff``, as in the reference, though it is ``d_ff_expert`` wide:
    where the two differ (arctic-480b's ``reduced()`` cut, 512 against 256)
    the reference fails on the mismatched shapes, and so does this, with
    a ValueError that names the leaf (ROADMAP queue 3 item 20)."""
    p = {"router": AX(m.d_model, m.experts),
         "w_gate": AX(m.experts, m.d_model, None),
         "w_up": AX(m.experts, m.d_model, None),
         "w_down": AX(m.experts, None, m.d_model)}
    if cfg.moe.dense_residual:
        if m.d_ff is not None and m.d_ff.shape[-1] != cfg.moe.d_ff_expert:
            raise ValueError(
                f"{cfg.name}: ffn.dense is d_ff_expert "
                f"{cfg.moe.d_ff_expert} wide, but its mask is d_ff "
                f"{m.d_ff.shape[-1]} wide (the reference masks it by d_ff "
                "and fails on the shapes too)")
        p["dense"] = {"w_gate": AX(m.d_model, m.d_ff),
                      "w_up": AX(m.d_model, m.d_ff),
                      "w_down": AX(m.d_ff, m.d_model)}
    return p


def _rglru_ax(cfg: ArchConfig, m: WidthMasks) -> Dict[str, AX]:
    """The RG-LRU block's leaves: ``d_rnn`` masks the recurrence's
    channels (the gate matrices on both axes), ``d_model`` the input and
    output projections' other axis."""
    dr = m.d_rnn
    return {"in_x": AX(m.d_model, dr), "in_gate": AX(m.d_model, dr),
            "conv_w": AX(None, dr), "conv_b": AX(dr),
            "w_r": AX(dr, dr), "b_r": AX(dr), "w_i": AX(dr, dr),
            "b_i": AX(dr), "lam": AX(dr), "out": AX(dr, m.d_model)}


def _block_ax(kind: str, cfg: ArchConfig, m: WidthMasks,
              cross: bool = False) -> Dict[str, Any]:
    if kind == "ssd":
        return {"ln": _norm_ax(cfg, m.d_model), "ssd": _ssd_ax(cfg, m)}
    if kind == "rglru":
        return {"ln1": _norm_ax(cfg, m.d_model), "rg": _rglru_ax(cfg, m),
                "ln2": _norm_ax(cfg, m.d_model), "ffn": _ffn_ax(cfg, m)}
    p = {"ln1": _norm_ax(cfg, m.d_model), "attn": _attn_ax(cfg, m),
         "ln2": _norm_ax(cfg, m.d_model),
         "ffn": _moe_ax(cfg, m) if cfg.moe else _ffn_ax(cfg, m)}
    if cross:
        p["lnx"], p["xattn"] = _norm_ax(cfg, m.d_model), _attn_ax(cfg, m)
    return p


def axis_mask_tree(cfg: ArchConfig, m: WidthMasks) -> Params:
    """Tree matching the params structure; leaves are AX objects."""
    check_ported(cfg)
    cross = cfg.encoder is not None
    t: Params = {"embed": AX(None, m.d_model),
                 "stages": tuple(tuple(_block_ax(k, cfg, m, cross)
                                       for k in unit)
                                 for unit, _ in cfg.stages()),
                 "final_norm": _norm_ax(cfg, m.d_model)}
    if not cfg.tie_embeddings:
        t["lm_head"] = AX(m.d_model, None)
    if cfg.rope_theta <= 0.0:
        t["pos_embed"] = AX(None, m.d_model)
    if cfg.vision is not None:
        t["projector"] = {"w1": AX(None, m.d_model),
                          "w2": AX(m.d_model, m.d_model)}
    if cross:
        t["encoder"] = {"blocks": _block_ax("attn", cfg, m),
                        "final_norm": _norm_ax(cfg, m.d_model)}
    return t


def _apply_ax(leaf: torch.Tensor, ax: AX) -> torch.Tensor:
    out = leaf
    n = len(ax.ms)
    for i, mv in enumerate(ax.ms):
        if mv is None:
            continue
        shape = [1] * out.ndim
        shape[out.ndim - n + i] = mv.shape[0]
        out = out * mv.reshape(shape).to(out.dtype)
    return out


def apply_mask_tree(params: Params, axtree: Params) -> Params:
    """Extraction / distribution (Alg. 3 width step): zero masked channels."""
    return tree_map(_apply_ax, params, axtree)


def mask_density(leaf_shape: Tuple[int, ...], ax: AX) -> torch.Tensor:
    """Per-element 0/1 mask product, broadcastable to ``leaf_shape``."""
    out = None
    n = len(ax.ms)
    for i, mv in enumerate(ax.ms):
        if mv is None:
            continue
        shape = [1] * len(leaf_shape)
        shape[len(leaf_shape) - n + i] = mv.shape[0]
        out = mv.reshape(shape) if out is None else out * mv.reshape(shape)
    return torch.ones((), dtype=torch.float32) if out is None else out


def active_fraction(ax: AX) -> torch.Tensor:
    """Product of per-axis active fractions (scalar)."""
    f = torch.ones((), dtype=torch.float32)
    for mv in ax.ms:
        if mv is not None:
            f = f.to(mv.device) * torch.mean(mv)
    return f


def mask_gradients(grads: Params, axtree: Params) -> Params:
    """Project gradients back onto the client's subspace (defensive: the
    masked forward already yields zero gradients outside it)."""
    return apply_mask_tree(grads, axtree)
