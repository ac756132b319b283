"""Dense decoder stack, FedFA width-masked and depth-gated.

Every block is residual (``x + gate_r * f_r(x)``), the property FedFA's
layer grafting relies on (paper Appendix B).  Parameters are nested
dicts/tuples shaped like the JAX package's: ``stages[i][j]`` holds the
leaves of unit position j stacked over the stage's repeats.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (ACTIVATIONS, apply_norm, apply_rope,
                                       dense_init, matmul)
from repro_torch.models.masks import WidthMasks
from repro_torch.tree import from_paths, leaves_with_path, tree_map

Params = Dict[str, Any]


def _check_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense" or any(k != "attn" for k in cfg.layer_pattern):
        raise NotImplementedError(f"family {cfg.family!r} is not yet ported")
    if cfg.rope_theta <= 0.0 or cfg.norm != "rmsnorm" or cfg.logit_softcap:
        raise NotImplementedError("learned positions, layernorm and logit "
                                  "softcaps are not yet ported")


def _is_shape(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(d, int) for d in x)


def param_shapes(cfg: ArchConfig) -> Params:
    """Tree of parameter shapes (the structure ``init_params`` builds)."""
    _check_dense(cfg)
    D, F, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads

    def block(r):
        return {"ln1": {"scale": (r, D)}, "ln2": {"scale": (r, D)},
                "attn": {"wq": (r, D, H * hd), "wk": (r, D, K * hd),
                         "wv": (r, D, K * hd), "wo": (r, H * hd, D)},
                "ffn": {"w_gate": (r, D, F), "w_up": (r, D, F),
                        "w_down": (r, F, D)}}
    p: Params = {"embed": (cfg.padded_vocab, D),
                 "stages": tuple((block(reps),) for _, reps in cfg.stages()),
                 "final_norm": {"scale": (D,)}}
    if not cfg.tie_embeddings:
        p["lm_head"] = (D, cfg.padded_vocab)
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32) -> Params:
    """Random init on the generator's device: fan-in normal for matrices,
    zeros for RMSNorm scales (the scale enters as ``1 + scale``)."""
    paths, values = [], []
    for path, shape in leaves_with_path(param_shapes(cfg),
                                        is_leaf=_is_shape):
        paths.append(path)
        values.append(torch.zeros(shape, dtype=dtype, device=generator.device)
                      if path[-1] == "scale"
                      else dense_init(shape, dtype, generator))
    return from_paths(paths, values)


def _ffn_apply(p: Params, x, cfg: ArchConfig, m: WidthMasks):
    act = ACTIVATIONS[cfg.act]
    h = act(matmul(x, p["w_gate"])) * matmul(x, p["w_up"])
    if m.d_ff is not None:
        h = h * m.d_ff.to(h.dtype)
    return matmul(h, p["w_down"])


def _attn_apply(p: Params, x, cfg: ArchConfig, m: WidthMasks, *,
                positions, window=None):
    B, S, _ = x.shape
    hd, H, K = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = matmul(x, p["wq"]).reshape(B, S, H, hd)
    k = matmul(x, p["wk"]).reshape(B, S, K, hd)
    v = matmul(x, p["wv"]).reshape(B, S, K, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = attn_mod.attend(q, k, v, causal=True, window=window,
                          head_mask=m.heads)
    return matmul(out.reshape(B, S, H * hd), p["wo"])


def _block_apply(p: Params, x, cfg: ArchConfig, m: WidthMasks, *,
                 gate, positions, window):
    dm = m.d_model
    h = apply_norm(cfg.norm, x, p["ln1"], dm, cfg.norm_eps)
    a = _attn_apply(p["attn"], h, cfg, m, positions=positions, window=window)
    x = x + (gate * a.to(torch.float32)).to(x.dtype)
    h = apply_norm(cfg.norm, x, p["ln2"], dm, cfg.norm_eps)
    f = _ffn_apply(p["ffn"], h, cfg, m)
    return x + (gate * f.to(torch.float32)).to(x.dtype)


def stage_apply(stage_params: Tuple, unit: Tuple[str, ...], x,
                cfg: ArchConfig, m: WidthMasks, *, gates, positions, window):
    """Loop over the repeat axis of one stage (the JAX ``lax.scan``)."""
    for r in range(gates.shape[0]):
        for j in range(len(unit)):
            p_r = tree_map(lambda t: t[r], stage_params[j])
            x = _block_apply(p_r, x, cfg, m, gate=gates[r],
                             positions=positions, window=window)
    return x
