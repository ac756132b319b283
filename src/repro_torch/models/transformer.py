"""Decoder stack of attention blocks (with a dense, a biased or a
mixture-of-experts FFN, and with an encoder a cross-attention step),
Mamba-2 SSD blocks and RG-LRU blocks, FedFA width-masked and depth-gated,
with serving caches (KV caches, ring caches under a sliding window,
recurrent states).

Every block is residual (``x + gate_r * f_r(x)``), the property FedFA's
layer grafting relies on (paper Appendix B).  Parameters are nested
dicts/tuples shaped like the JAX package's: ``stages[i][j]`` holds the
leaves of unit position j stacked over the stage's repeats; caches are
stacked the same way.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (ACTIVATIONS, apply_norm, apply_rope,
                                       dense_init, matmul, norm_shapes)
from repro_torch.models.masks import WidthMasks
from repro_torch.tree import from_paths, leaves_with_path, tree_map

Params = Dict[str, Any]


_FAMILY_KINDS = {"dense": {"attn"}, "ssm": {"ssd"}, "moe": {"attn"},
                 "hybrid": {"rglru", "attn"}, "audio": {"attn"},
                 "vlm": {"attn"}}


def check_ported(cfg: ArchConfig) -> None:
    """Raise unless every part of ``cfg`` is ported."""
    if not set(cfg.layer_pattern) <= _FAMILY_KINDS.get(cfg.family, set()):
        raise NotImplementedError(f"family {cfg.family!r} is not yet ported")


def _is_shape(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(d, int) for d in x)


def _stacked(shapes: Params, r: int) -> Params:
    """A tree of shapes with a leading repeat axis of ``r``."""
    return {k: _stacked(v, r) if isinstance(v, dict) else (r,) + v
            for k, v in shapes.items()}


def param_shapes(cfg: ArchConfig) -> Params:
    """Tree of parameter shapes (the structure ``init_params`` builds).
    With an encoder every decoder attention block has a cross step
    (``lnx``, ``xattn``), and ``encoder`` holds its own attention blocks
    stacked over ``encoder.n_layers`` and a final norm; ``rope_theta`` 0
    adds the learned ``pos_embed`` table of max(max_seq_len, 2048) rows;
    a vision frontend adds the patch ``projector`` (``w1`` (vit_dim, D),
    ``w2`` (D, D))."""
    check_ported(cfg)
    D, F, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    norm = lambda r: _stacked(norm_shapes(cfg.norm, D), r)
    attn = lambda r: {"wq": (r, D, H * hd), "wk": (r, D, K * hd),
                      "wv": (r, D, K * hd), "wo": (r, H * hd, D)}

    def block(kind, r, cross=False):
        if kind == "ssd":
            return {"ln": norm(r),
                    "ssd": _stacked(ssm_mod.ssd_param_shapes(D, cfg.ssm), r)}
        if cfg.moe:
            ffn = _stacked(moe_mod.moe_param_shapes(D, cfg.moe), r)
        elif cfg.norm == "layernorm":      # whisper's MLP, with biases
            ffn = {"w_in": (r, D, F), "b_in": (r, F), "w_out": (r, F, D),
                   "b_out": (r, D)}
        else:
            ffn = {"w_gate": (r, D, F), "w_up": (r, D, F),
                   "w_down": (r, F, D)}
        out = {"ln1": norm(r), "ln2": norm(r), "ffn": ffn}
        if kind == "rglru":
            out["rg"] = _stacked(rglru_mod.rglru_param_shapes(D, cfg.rglru),
                                 r)
        else:
            out["attn"] = attn(r)
            if cross:
                out["lnx"], out["xattn"] = norm(r), attn(r)
        return out
    cross = cfg.encoder is not None
    p: Params = {"embed": (cfg.padded_vocab, D),
                 "stages": tuple(tuple(block(kind, reps, cross)
                                       for kind in unit)
                                 for unit, reps in cfg.stages()),
                 "final_norm": norm_shapes(cfg.norm, D)}
    if not cfg.tie_embeddings:
        p["lm_head"] = (D, cfg.padded_vocab)
    if cfg.rope_theta <= 0.0:
        p["pos_embed"] = (max(cfg.max_seq_len, 2048), D)
    if cfg.vision is not None:
        p["projector"] = {"w1": (cfg.vision.vit_dim, D), "w2": (D, D)}
    if cross:
        p["encoder"] = {"blocks": block("attn", cfg.encoder.n_layers),
                        "final_norm": norm_shapes(cfg.norm, D)}
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.float32) -> Params:
    """Random init on the generator's device: fan-in normal for matrices
    (the MoE router in f32 whatever ``dtype``), zeros for RMSNorm scales
    (the scale enters as ``1 + scale``), ones for LayerNorm scales, zeros
    for biases, normal at scale 0.02 for ``pos_embed``, and the SSD and
    RG-LRU blocks' own rules (``ssm.init_ssd``, ``rglru.init_rglru``)."""
    paths, values = [], []
    for path, shape in leaves_with_path(param_shapes(cfg),
                                        is_leaf=_is_shape):
        paths.append(path)
        if "ssd" in path:
            values.append(ssm_mod.init_ssd(path[-1], shape, dtype, generator))
        elif "rg" in path:
            values.append(rglru_mod.init_rglru(path[-1], shape, dtype,
                                               cfg.rglru, generator))
        elif path[-1] == "scale":
            values.append(torch.full(shape, float(cfg.norm == "layernorm"),
                                     dtype=dtype, device=generator.device))
        elif path[-1] in ("bias", "b_in", "b_out"):
            values.append(torch.zeros(shape, dtype=dtype,
                                      device=generator.device))
        elif path[-1] == "pos_embed":
            values.append((0.02 * torch.randn(
                shape, generator=generator, dtype=torch.float32,
                device=generator.device)).to(dtype))
        elif path[-1] == "router":
            values.append(dense_init(shape, torch.float32, generator))
        else:
            values.append(dense_init(shape, dtype, generator))
    return from_paths(paths, values)


# the leaves init_params keeps in f32 whatever its dtype: the MoE router,
# the SSD's A_log, D and dt_bias, the RG-LRU's gates and Λ
_F32_LEAVES = frozenset({"router", "A_log", "D", "dt_bias"}
                        | set(rglru_mod._F32_LEAVES))


def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16) -> Params:
    """The tree ``init_params(cfg, ·, dtype)`` builds, as tensors on the
    meta device: its shapes and dtypes, nothing allocated."""
    paths, values = [], []
    for path, shape in leaves_with_path(param_shapes(cfg),
                                        is_leaf=_is_shape):
        paths.append(path)
        values.append(torch.empty(
            shape, device="meta",
            dtype=torch.float32 if path[-1] in _F32_LEAVES else dtype))
    return from_paths(paths, values)


def _ffn_apply(p: Params, x, cfg: ArchConfig, m: WidthMasks):
    act = ACTIVATIONS[cfg.act]
    if cfg.norm == "layernorm":            # whisper's MLP, with biases
        h = act(matmul(x, p["w_in"]) + p["b_in"])
        if m.d_ff is not None:
            h = h * m.d_ff.to(h.dtype)
        return matmul(h, p["w_out"]) + p["b_out"]
    h = act(matmul(x, p["w_gate"])) * matmul(x, p["w_up"])
    if m.d_ff is not None:
        h = h * m.d_ff.to(h.dtype)
    return matmul(h, p["w_down"])


def _mix_ffn(p: Params, x, cfg: ArchConfig, m: WidthMasks):
    """The block's FFN: (out, aux losses).  A MoE FFN masks its experts but
    never its ``d_ff_expert`` (the reference passes no ``d_ff`` mask)."""
    if cfg.moe:
        return moe_mod.moe_ffn(p, x, cfg.moe, cfg.act, expert_mask=m.experts)
    return _ffn_apply(p, x, cfg, m), {}


def _attn_apply(p: Params, x, cfg: ArchConfig, m: WidthMasks, *,
                positions, causal=True, window=None,
                kv_override: Optional[torch.Tensor] = None, cache=None,
                decode=False, chunk_offset: Optional[int] = None):
    """Self attention, or with ``kv_override`` (B, Sk, D) — the encoder's
    output — cross attention: k and v projected from it, with no rotary
    embedding and no cache.  x: (B, S, D). Returns (out, new_cache|None).
    With a cache and ``chunk_offset`` (chunked prefill) the chunk's queries, at
    positions chunk_offset.., attend against the whole cache once the chunk
    is written into it (slots not yet written lie past every query and are
    masked out).  A cache no longer than the window is a ring, as the
    reference decides (a static property of its shape)."""
    B, S, _ = x.shape
    hd, H, K = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    if H % K:   # the reference fails here too (its einsum's head sizes)
        raise ValueError(f"{cfg.name}: n_heads {H} is not a multiple of "
                         f"n_kv_heads {K}")
    q = matmul(x, p["wq"]).reshape(B, S, H, hd)
    if kv_override is not None:
        Sk = kv_override.shape[1]
        k = matmul(kv_override, p["wk"]).reshape(B, Sk, K, hd)
        v = matmul(kv_override, p["wv"]).reshape(B, Sk, K, hd)
        out = attn_mod.attend(q, k, v, causal=causal, window=window,
                              head_mask=m.heads)
        return matmul(out.reshape(B, S, H * hd), p["wo"]), None
    k = matmul(x, p["wk"]).reshape(B, S, K, hd)
    v = matmul(x, p["wv"]).reshape(B, S, K, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    new_cache, ring = None, False
    if cache is not None:
        ring = window is not None and cache.capacity <= window
        new_cache = attn_mod.cache_extend(cache, k, v, ring=ring)
    if decode:
        out = attn_mod.attend_decode(q, new_cache, ring=ring, window=window,
                                     head_mask=m.heads)
    elif new_cache is not None and chunk_offset is not None:
        out = attn_mod.attend(q, new_cache.k, new_cache.v, causal=True,
                              window=window, head_mask=m.heads,
                              q_offset=chunk_offset)
    else:
        out = attn_mod.attend(q, k, v, causal=causal, window=window,
                              head_mask=m.heads)
    return matmul(out.reshape(B, S, H * hd), p["wo"]), new_cache


def _block_apply(kind: str, p: Params, x, cfg: ArchConfig, m: WidthMasks, *,
                 gate, positions, window, enc_out=None, cache=None,
                 decode=False, causal=True,
                 chunk_offset: Optional[int] = None):
    """One residual block. Returns (x, new_cache, aux losses).  With
    ``enc_out`` an attention block attends to it after its self attention
    (``lnx``, then the gated residual of ``xattn``, non-causal): in decode
    too, its k and v recomputed from ``enc_out`` every step."""
    dm = m.d_model
    if kind == "ssd":
        h = apply_norm(cfg.norm, x, p["ln"], dm, cfg.norm_eps)
        if decode:
            f, c_new = ssm_mod.ssd_decode(p["ssd"], h, cfg.ssm, cfg.d_model,
                                          cache["ssm"], head_mask=m.ssm_heads,
                                          d_model_mask=dm,
                                          norm_eps=cfg.norm_eps)
        else:
            # a chunk of a chunked prefill takes only the conv window from
            # the cache and starts from a zero state, as the reference does
            # (ROADMAP queue 3 item 21)
            f, c_new = ssm_mod.ssd_forward(
                p["ssd"], h, cfg.ssm, cfg.d_model, head_mask=m.ssm_heads,
                d_model_mask=dm, norm_eps=cfg.norm_eps,
                cache=None if cache is None else cache["ssm"])
        x = x + (gate * f.to(torch.float32)).to(x.dtype)
        return x, None if cache is None else dict(cache, ssm=c_new), {}
    if kind == "rglru":
        h = apply_norm(cfg.norm, x, p["ln1"], dm, cfg.norm_eps)
        if decode:
            f, c_new = rglru_mod.rglru_decode(
                p["rg"], h, cfg.rglru, cfg.d_model, cache["rg"],
                mask_dr=m.d_rnn, d_model_mask=dm)
        else:
            f, c_new = rglru_mod.rglru_block(
                p["rg"], h, cfg.rglru, cfg.d_model, mask_dr=m.d_rnn,
                d_model_mask=dm, cache=None if cache is None else cache["rg"])
        x = x + (gate * f.to(torch.float32)).to(x.dtype)
        h = apply_norm(cfg.norm, x, p["ln2"], dm, cfg.norm_eps)
        f = _ffn_apply(p["ffn"], h, cfg, m)
        x = x + (gate * f.to(torch.float32)).to(x.dtype)
        return x, None if cache is None else dict(cache, rg=c_new), {}
    h = apply_norm(cfg.norm, x, p["ln1"], dm, cfg.norm_eps)
    a, c_new = _attn_apply(p["attn"], h, cfg, m, positions=positions,
                           causal=causal, window=window,
                           cache=None if cache is None else cache["self"],
                           decode=decode, chunk_offset=chunk_offset)
    x = x + (gate * a.to(torch.float32)).to(x.dtype)
    if enc_out is not None:
        h = apply_norm(cfg.norm, x, p["lnx"], dm, cfg.norm_eps)
        a, _ = _attn_apply(p["xattn"], h, cfg, m, positions=positions,
                           causal=False, kv_override=enc_out)
        x = x + (gate * a.to(torch.float32)).to(x.dtype)
    h = apply_norm(cfg.norm, x, p["ln2"], dm, cfg.norm_eps)
    f, aux = _mix_ffn(p["ffn"], h, cfg, m)
    x = x + (gate * f.to(torch.float32)).to(x.dtype)
    return x, None if cache is None else dict(cache, self=c_new), aux


AUX_LOSSES = ("lb_loss", "z_loss")


def stage_apply(stage_params: Tuple, unit: Tuple[str, ...], x,
                cfg: ArchConfig, m: WidthMasks, *, gates, positions, window,
                enc_out=None, caches=None, decode=False, causal=True,
                chunk_offset: Optional[int] = None):
    """Loop over the repeat axis of one stage (the JAX ``lax.scan``);
    ``enc_out`` and ``causal`` go to every block (``_block_apply``).
    ``caches`` (one stacked cache per unit position) are updated in place:
    repeat r's new cache is cast to the stored dtype and written into slot
    r, as the reference writes its scan carry.  Returns (x, caches, aux):
    each aux loss summed over the unit's blocks of a repeat, then over the
    repeats, as the reference's scan sums them (0 without a MoE block)."""
    per_repeat = {name: [] for name in AUX_LOSSES}
    for r in range(gates.shape[0]):
        sums = {}
        for j, kind in enumerate(unit):
            p_r = tree_map(lambda t: t[r], stage_params[j])
            cache_r = (None if caches is None
                       else tree_map(lambda t: t[r], caches[j]))
            x, new, aux = _block_apply(kind, p_r, x, cfg, m, gate=gates[r],
                                       positions=positions, window=window,
                                       enc_out=enc_out, cache=cache_r,
                                       decode=decode, causal=causal,
                                       chunk_offset=chunk_offset)
            if caches is not None:
                tree_map(lambda c, n: c[r].copy_(n), caches[j], new)
            for name, val in aux.items():
                sums[name] = val if name not in sums else sums[name] + val
        for name, val in sums.items():
            per_repeat[name].append(val)
    aux = {name: torch.sum(torch.stack(vals)) if vals
           else torch.zeros((), dtype=torch.float32, device=x.device)
           for name, vals in per_repeat.items()}
    return x, caches, aux
