"""Parameter, optimizer, cache and batch sharding specs for the production
mesh, as plans: the port's copy of ``repro.sharding.specs``, leaf for leaf.

Megatron-style tensor parallel over ``model`` (flattened head dims, d_ff,
vocab, experts, d_rnn / d_inner) plus FSDP over ``data`` (and ``pod``
with two pods) for the architectures flagged ``fsdp=True``.  Spec trees
are parallel to ``models.transformer.param_shapes`` and to
``model.init_caches``' records; depth-stacked stage leaves get a leading
``None`` for the repeat axis.

No process group is involved: a mesh here is a plain ``{axis: size}``
map, so the dry runs plan for 256 or 512 ranks in one process.  The
sharded FL server's own layout is ``sharding.cohort``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import KVCache
from repro_torch.models.rglru import RGLRUCache
from repro_torch.models.ssm import SSMCache

Params = Dict[str, Any]


class P(tuple):
    """A partition spec: one entry per leading dimension, each an axis
    name, ``None`` (not sharded) or a tuple of axis names (sharded over
    their product); dimensions past the entries are not sharded."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def batch_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def _pre(spec: P, lead: int = 1) -> P:
    return P(*([None] * lead + list(spec)))


def _norm_spec(cfg, lead=0) -> Dict[str, P]:
    s = {"scale": _pre(P(None), lead)}
    if cfg.norm == "layernorm":
        s["bias"] = _pre(P(None), lead)
    return s


def _attn_spec(cfg, f, lead=1) -> Dict[str, P]:
    return {"wq": _pre(P(f, "model"), lead), "wk": _pre(P(f, "model"), lead),
            "wv": _pre(P(f, "model"), lead), "wo": _pre(P("model", f), lead)}


def _ffn_spec(cfg, f, lead=1) -> Dict[str, P]:
    if cfg.norm == "layernorm":
        return {"w_in": _pre(P(f, "model"), lead),
                "b_in": _pre(P("model"), lead),
                "w_out": _pre(P("model", f), lead),
                "b_out": _pre(P(None), lead)}
    return {"w_gate": _pre(P(f, "model"), lead),
            "w_up": _pre(P(f, "model"), lead),
            "w_down": _pre(P("model", f), lead)}


def _moe_spec(cfg, f, lead=1) -> Dict[str, P]:
    s = {"router": _pre(P(f, None), lead),
         "w_gate": _pre(P("model", f, None), lead),
         "w_up": _pre(P("model", f, None), lead),
         "w_down": _pre(P("model", None, f), lead)}
    if cfg.moe.dense_residual:
        s["dense"] = _ffn_spec(cfg, f, lead)
    return s


def _ssd_spec(cfg, f, lead=1) -> Dict[str, P]:
    return {"in_proj": _pre(P(f, "model"), lead),
            "conv_w": _pre(P(None, "model"), lead),
            "conv_b": _pre(P("model"), lead),
            "A_log": _pre(P(None), lead), "D": _pre(P(None), lead),
            "dt_bias": _pre(P(None), lead),
            "norm": _pre(P("model"), lead),
            "out_proj": _pre(P("model", f), lead)}


def _rglru_spec(cfg, f, lead=1) -> Dict[str, P]:
    return {"in_x": _pre(P(f, "model"), lead),
            "in_gate": _pre(P(f, "model"), lead),
            "conv_w": _pre(P(None, "model"), lead),
            "conv_b": _pre(P("model"), lead),
            "w_r": _pre(P(None, "model"), lead),
            "b_r": _pre(P("model"), lead),
            "w_i": _pre(P(None, "model"), lead),
            "b_i": _pre(P("model"), lead),
            "lam": _pre(P("model"), lead),
            "out": _pre(P("model", f), lead)}


def _block_spec(kind: str, cfg: ArchConfig, f, cross: bool,
                lead=1) -> Dict[str, Any]:
    if kind == "attn":
        s = {"ln1": _norm_spec(cfg, lead), "attn": _attn_spec(cfg, f, lead),
             "ln2": _norm_spec(cfg, lead),
             "ffn": (_moe_spec(cfg, f, lead) if cfg.moe
                     else _ffn_spec(cfg, f, lead))}
        if cross:
            s["lnx"] = _norm_spec(cfg, lead)
            s["xattn"] = _attn_spec(cfg, f, lead)
        return s
    if kind == "ssd":
        return {"ln": _norm_spec(cfg, lead), "ssd": _ssd_spec(cfg, f, lead)}
    if kind == "rglru":
        return {"ln1": _norm_spec(cfg, lead), "rg": _rglru_spec(cfg, f, lead),
                "ln2": _norm_spec(cfg, lead), "ffn": _ffn_spec(cfg, f, lead)}
    raise ValueError(kind)


def param_specs(cfg: ArchConfig, *, fsdp: Optional[bool] = None,
                multi_pod: bool = False) -> Params:
    """Spec tree matching ``param_shapes(cfg)``.  With ``multi_pod`` FSDP
    shards over both batch axes ('pod', 'data'), so that the second pod
    holds no second optimizer replica."""
    want = cfg.fsdp if fsdp is None else fsdp
    f = (("pod", "data") if multi_pod else "data") if want else None
    cross = cfg.encoder is not None
    t: Params = {"embed": P("model", f)}
    t["stages"] = tuple(tuple(_block_spec(k, cfg, f, cross) for k in unit)
                        for unit, _ in cfg.stages())
    t["final_norm"] = _norm_spec(cfg)
    if not cfg.tie_embeddings:
        t["lm_head"] = P(f, "model")
    if cfg.rope_theta <= 0.0:
        t["pos_embed"] = P(None, f)
    if cfg.vision is not None:
        t["projector"] = {"w1": P(None, f), "w2": P(f, None)}
    if cfg.encoder is not None:
        t["encoder"] = {"blocks": _block_spec("attn", cfg, f, cross=False),
                        "final_norm": _norm_spec(cfg)}
    return t


def opt_state_specs(cfg: ArchConfig, pspecs: Params, has_v: bool) -> Params:
    st = {"step": P(), "m": pspecs}
    if has_v:
        st["v"] = pspecs
    return st


def cache_specs(cfg: ArchConfig, multi_pod: bool) -> Params:
    """Spec tree matching ``model.init_caches`` (stacked per stage), built
    with the port's cache records so that the trees line up."""
    b = batch_axes(multi_pod)
    bspec = b if len(b) > 1 else b[0]
    kv_model = "model" if cfg.n_kv_heads >= 8 else None
    out = []
    for unit, _ in cfg.stages():
        stage = []
        for kind in unit:
            if kind == "attn":
                kv = P(None, bspec, None, kv_model, None)
                stage.append({"self": KVCache(k=kv, v=kv, pos=P(None))})
            elif kind == "ssd":
                stage.append({"ssm": SSMCache(
                    conv=P(None, bspec, None, "model"),
                    h=P(None, bspec, None, None, None),
                    pos=P(None))})
            elif kind == "rglru":
                stage.append({"rg": RGLRUCache(
                    conv=P(None, bspec, None, "model"),
                    h=P(None, bspec, "model"),
                    pos=P(None))})
        out.append(tuple(stage))
    return tuple(out)


def _shape_of(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def map_specs(fn, spec_tree, other):
    """``fn(spec, node)`` at every ``P`` of ``spec_tree``, ``node`` the
    subtree of ``other`` at the same place (dicts by key, tuples and the
    cache records by position); the result has ``spec_tree``'s
    structure."""
    if isinstance(spec_tree, P):
        return fn(spec_tree, other)
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v, other[k]) for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple):
        out = [map_specs(fn, v, other[i]) for i, v in enumerate(spec_tree)]
        return (type(spec_tree)(*out) if hasattr(spec_tree, "_fields")
                else tuple(out))
    return spec_tree


def sanitize_specs(spec_tree, shape_tree, axis_sizes: Mapping[str, int]):
    """Drop the sharding of every dimension that its axes do not divide.

    ``shape_tree`` holds a shape (or a tensor) at each spec's place and
    ``axis_sizes`` is the mesh as ``{axis: size}``.  As in the reference,
    a non-divisible dimension (odd vocabs, 8 kv heads on a 16-way model
    axis, a batch of 1) falls back to replication, and so does an entry
    naming an axis the mesh lacks (a ('pod', 'data') FSDP spec against a
    one-pod mesh).  Each result has one entry per dimension."""
    def fix(spec: P, node) -> P:
        shape = _shape_of(node)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        out = []
        for dim, ent in zip(shape, entries):
            if ent is None:
                out.append(None)
                continue
            total = 1
            for a in (ent if isinstance(ent, tuple) else (ent,)):
                if a not in axis_sizes:        # axis absent from this mesh
                    total = 0
                    break
                total *= axis_sizes[a]
            out.append(ent if total and dim % total == 0 else None)
        return P(*out)

    return map_specs(fix, spec_tree, shape_tree)


def shard_count(spec: P, axis_sizes: Mapping[str, int]) -> int:
    """Ranks over which a (sanitized) spec splits its tensor."""
    n = 1
    for ent in spec:
        for a in (() if ent is None else
                  ent if isinstance(ent, tuple) else (ent,)):
            n *= axis_sizes[a]
    return n


def bytes_per_rank(spec_tree, tensor_tree,
                   axis_sizes: Mapping[str, int]) -> int:
    """Bytes one rank holds of ``tensor_tree`` (tensors, meta ones
    included) laid out by ``spec_tree``: each leaf's bytes over its
    sanitized spec's shard count."""
    fixed = sanitize_specs(spec_tree, tensor_tree, axis_sizes)
    total = [0]

    def add(spec: P, t: torch.Tensor) -> None:
        total[0] += t.numel() * t.element_size() // shard_count(spec,
                                                                 axis_sizes)
    map_specs(add, fixed, tensor_tree)
    return total[0]


def batch_specs(cfg: ArchConfig, multi_pod: bool, kind: str) -> Dict[str, P]:
    b = batch_axes(multi_pod)
    bspec = b if len(b) > 1 else b[0]
    s = {"tokens": P(bspec, None)}
    if cfg.vision is not None:
        s["patches"] = P(bspec, None, None)
    if cfg.encoder is not None:
        s["frames"] = P(bspec, None, None)
    return s
