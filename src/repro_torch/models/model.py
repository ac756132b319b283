"""Top-level model API: train forward, losses, serving (prefill and
decode over KV caches, ring caches under a sliding window, and SSM and
RG-LRU states), the encoder of the encoder-decoder (whisper: frames in,
``enc_out`` to every decoder block's cross attention), the patch projector
of the vision-language model (internvl2: projected patches in front of the
tokens) and the loader that carries the JAX package's parameters across.

Entry points take width masks and depth gates; the global model is the
runtime with all-ones masks.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import ACTIVATIONS, apply_norm, matmul, softcap
from repro_torch.models.masks import WidthMasks, full_masks
from repro_torch.models.transformer import (AUX_LOSSES, _is_shape,  # noqa: F401
                                            init_params, param_shapes,
                                            stage_apply)
from repro_torch.tree import from_paths, leaves_with_path, tree_map

Params = Dict[str, Any]


def _embed(params: Params, tokens: torch.Tensor, m: WidthMasks) -> torch.Tensor:
    """Token embeddings, plus the learned positions 0.. where the model has
    a ``pos_embed`` table (a prompt longer than the table raises; the
    reference fails at trace), masked to the active d_model."""
    x = params["embed"][tokens]
    if "pos_embed" in params:
        S, rows = tokens.shape[1], params["pos_embed"].shape[0]
        if S > rows:
            raise ValueError(f"{S} positions outgrow the pos_embed table's "
                             f"{rows} rows")
        x = x + params["pos_embed"][None, :S]
    if m.d_model is not None:
        x = x * m.d_model.to(x.dtype)
    return x


def _encoder_apply(params: Params, cfg: ArchConfig, frames: torch.Tensor,
                   m: WidthMasks) -> torch.Tensor:
    """The encoder over precomputed frame embeddings (B, T, D) (the
    reference's stub frontend): frames + pos_embed[:T], masked to the
    active d_model, its non-causal stage at full depth, its final norm."""
    enc = params["encoder"]
    T = frames.shape[1]
    x = frames + params["pos_embed"][None, :T]
    if m.d_model is not None:
        x = x * m.d_model.to(x.dtype)
    x, _, _ = stage_apply(
        (enc["blocks"],), ("attn",), x, cfg, m,
        gates=torch.ones((cfg.encoder.n_layers,), dtype=torch.float32,
                         device=x.device),
        positions=torch.arange(T, device=x.device)[None], window=None,
        causal=False)
    return apply_norm(cfg.norm, x, enc["final_norm"], m.d_model, cfg.norm_eps)


def _enc_out(params: Params, cfg: ArchConfig, batch, m: WidthMasks):
    """The encoder's output on ``batch['frames']``, or None without an
    encoder."""
    if cfg.encoder is None:
        return None
    return _encoder_apply(params, cfg, batch["frames"], m)


def _project_patches(params: Params, patches: torch.Tensor,
                     m: WidthMasks) -> torch.Tensor:
    """The projector over precomputed patch embeddings (B, P, vit_dim)
    (the reference's stub vision encoder): gelu (tanh form, as
    ``jax.nn.gelu``) of patches @ w1, then @ w2, masked to the active
    d_model."""
    pr = params["projector"]
    h = matmul(ACTIVATIONS["gelu"](matmul(patches, pr["w1"])), pr["w2"])
    if m.d_model is not None:
        h = h * m.d_model.to(h.dtype)
    return h


def _inputs(params: Params, cfg: ArchConfig, batch, m: WidthMasks):
    """(x, enc_out): the token embeddings, with a vision frontend behind
    the projected ``batch['patches']`` (cast to the embeddings' dtype), and
    the encoder's output (None without an encoder)."""
    x = _embed(params, batch["tokens"], m)
    if cfg.vision is not None:
        pe = _project_patches(params, batch["patches"], m)
        x = torch.cat([pe.to(x.dtype), x], dim=1)
    return x, _enc_out(params, cfg, batch, m)


def _head(params: Params, cfg: ArchConfig, x: torch.Tensor, m: WidthMasks):
    x = apply_norm(cfg.norm, x, params["final_norm"], m.d_model, cfg.norm_eps)
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = softcap(matmul(x, w.to(x.dtype)), cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        # vocab-padding rows exist only for sharding; mask their logits
        pad = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(pad, logits,
                             torch.full((), -1e30, device=x.device))
    return logits


def forward(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
            masks: Optional[WidthMasks] = None,
            gates: Optional[torch.Tensor] = None):
    """Training / evaluation forward: batch {'tokens': (B, S)[, 'frames':
    (B, T, D) with an encoder][, 'patches': (B, P, vit_dim) with a vision
    frontend]} -> (logits (B, S, V), aux losses {'lb_loss', 'z_loss'}: the
    MoE blocks' sums, 0 without them).  Patches go in front of the tokens,
    positions run over P + S, and the logits cover the text positions
    only.  ``gates`` flex stage 0's depth; later stages and the encoder
    stay full."""
    device = params["embed"].device
    m = masks or full_masks(cfg).to(device)
    x, enc_out = _inputs(params, cfg, batch, m)
    positions = torch.arange(x.shape[1], device=device)[None]
    aux_tot = {name: torch.zeros((), dtype=torch.float32, device=device)
               for name in AUX_LOSSES}
    for i, g in enumerate(_stage_gates(cfg, gates, device)):
        x, _, aux = stage_apply(params["stages"][i], cfg.stages()[i][0], x,
                                cfg, m, gates=g, positions=positions,
                                window=cfg.attn_window, enc_out=enc_out)
        aux_tot = {k: v + aux[k] for k, v in aux_tot.items()}
    logits = _head(params, cfg, x, m)
    if cfg.vision is not None:
        logits = logits[:, batch["patches"].shape[1]:]
    return logits, aux_tot


def _stage_gates(cfg: ArchConfig, gates0: Optional[torch.Tensor], device):
    """Depth gates per stage: FedFA flexes stage 0; later stages stay full."""
    gs = [torch.ones((reps,), dtype=torch.float32, device=device)
          for _, reps in cfg.stages()]
    if gates0 is not None:
        gs[0] = gates0
    return gs


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
            class_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross entropy; class_mask (V,) zeroes absent classes."""
    lg = logits[:, :-1].to(torch.float32)
    tgt = tokens[:, 1:]
    if class_mask is not None:
        lg = torch.where(class_mask[None, None] > 0, lg,
                         torch.full((), -1e30, device=lg.device))
    lp = torch.log_softmax(lg, dim=-1)
    return -torch.mean(torch.gather(lp, -1, tgt[..., None])[..., 0])


def cls_loss(logits: torch.Tensor, labels: torch.Tensor,
             class_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequence classification: mean-pooled logits, classes in the first
    vocab slots (the paper's image-classification analog)."""
    lg = torch.mean(logits.to(torch.float32), dim=1)
    if class_mask is not None:
        lg = torch.where(class_mask[None] > 0, lg,
                         torch.full((), -1e30, device=lg.device))
    lp = torch.log_softmax(lg, dim=-1)
    return -torch.mean(torch.gather(lp, -1, labels[:, None]))


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
            masks=None, gates=None, task: str = "lm", class_mask=None):
    """(total, metrics): the task's loss plus the aux losses, which is what
    training differentiates, and {'loss': the task's loss alone, 'lb_loss',
    'z_loss'}."""
    logits, aux = forward(params, cfg, batch, masks=masks, gates=gates)
    if task == "lm":
        base = lm_loss(logits, batch["tokens"], class_mask)
    else:
        base = cls_loss(logits, batch["labels"], class_mask)
    total = base + aux["lb_loss"] + aux["z_loss"]
    return total, {"loss": base, **aux}


def loss_and_grad(params: Params, cfg: ArchConfig,
                  batch: Dict[str, torch.Tensor], **kw):
    """((total, metrics), gradient tree of the total) of ``loss_fn`` at
    ``params`` (``kw`` as ``loss_fn`` takes them):
    ``jax.value_and_grad(has_aux=True)`` over a parameter tree."""
    paths = [p for p, _ in leaves_with_path(params)]
    leaves = [x.detach().requires_grad_(True)
              for _, x in leaves_with_path(params)]
    total, metrics = loss_fn(from_paths(paths, leaves), cfg, batch, **kw)
    grads = torch.autograd.grad(total, leaves)
    return ((total.detach(), {k: v.detach() for k, v in metrics.items()}),
            from_paths(paths, grads))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_caches(params: Params, cfg: ArchConfig, batch: int, capacity: int, *,
                window: Optional[int] = None, dtype=torch.bfloat16):
    """Per-stage stacked caches mirroring params['stages'], on the params'
    device: a KV cache per attention block of ``capacity`` positions, or of
    min(capacity, window) under a sliding window (``window``, else
    ``cfg.attn_window``), which attention then treats as a ring; a conv
    window and an f32 state per SSD or RG-LRU block."""
    device = params["embed"].device
    win = window if window is not None else cfg.attn_window
    kv_cap = min(capacity, win) if win else capacity
    out = []
    for unit, reps in cfg.stages():
        stage = []
        for kind in unit:
            if kind == "attn":
                c = {"self": attn_mod.init_kv_cache(
                    batch, kv_cap, cfg.n_kv_heads, cfg.head_dim, dtype,
                    device)}
            elif kind == "rglru":
                c = {"rg": rglru_mod.init_rglru_cache(
                    batch, cfg.d_model, cfg.rglru, dtype, device)}
            else:
                c = {"ssm": ssm_mod.init_ssm_cache(batch, cfg.d_model,
                                                   cfg.ssm, dtype, device)}
            stage.append(tree_map(
                lambda t: t[None].repeat((reps,) + (1,) * t.dim()), c))
        out.append(tuple(stage))
    return tuple(out)


def prefill(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            *, masks=None, gates=None, capacity: Optional[int] = None,
            window: Optional[int] = None, cache_dtype=torch.bfloat16,
            chunk_size: Optional[int] = None):
    """Process the prompt; returns (last-position logits (B, 1, V), caches,
    enc_out): the encoder's output on ``batch['frames']`` with an encoder
    (every decode step takes it), else None.  A vision frontend puts the
    projected ``batch['patches']`` in front of the tokens, and the prompt
    is then P + S positions long.
    The caches hold ``capacity`` positions (the prompt's length if None),
    or under a sliding window (``window``, else ``cfg.attn_window``) a ring
    of min(capacity, window), stored in ``cache_dtype`` (SSM and RG-LRU
    states stay f32).

    ``chunk_size``: chunked prefill, the prompt in chunks at offsets
    0, chunk, 2·chunk, ..., each against the cache so far (its attention
    against the whole cache, its MoE dispatch over the chunk's tokens
    alone).  As in the reference, the prompt goes in one shot instead with
    a window, when the chunk does not divide it, or when it is no longer
    than one chunk, or with an encoder.  An SSD block starts every chunk
    from a zero state, as the reference's does (ROADMAP queue 3 item 21)."""
    device = params["embed"].device
    m = masks or full_masks(cfg).to(device)
    x, enc_out = _inputs(params, cfg, batch, m)
    B, S = x.shape[:2]
    caches = init_caches(params, cfg, B, capacity or S, window=window,
                         dtype=cache_dtype)
    win = window if window is not None else cfg.attn_window
    gs = _stage_gates(cfg, gates, device)
    if chunk_size is None or win is not None or enc_out is not None \
            or S % chunk_size or S <= chunk_size:
        chunk_size, starts = S, [None]
    else:
        starts = range(0, S, chunk_size)
    for off in starts:
        x_c = x if off is None else x[:, off:off + chunk_size]
        positions = (off or 0) + torch.arange(chunk_size, device=device)[None]
        for i, g in enumerate(gs):
            x_c, _, _ = stage_apply(params["stages"][i], cfg.stages()[i][0],
                                    x_c, cfg, m, gates=g, positions=positions,
                                    window=win, enc_out=enc_out,
                                    caches=caches[i], chunk_offset=off)
    return _head(params, cfg, x_c[:, -1:], m), caches, enc_out


def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor, caches,
                *, masks=None, gates=None, pos: Optional[torch.Tensor] = None,
                window: Optional[int] = None, enc_out=None):
    """One autoregressive step. token: (B, 1); ``enc_out`` (prefill's) with
    an encoder. Returns (logits (B, 1, V), caches); the caches are updated
    in place.  A learned position is re-added as the reference does,
    x - pos_embed[0] + pos_embed[pos] (in that order, so that f32 bits can
    match), with pos clamped to the table's last row as its
    ``dynamic_slice`` clamps it (ROADMAP queue 3 item 26)."""
    device = params["embed"].device
    m = masks or full_masks(cfg).to(device)
    if pos is None:
        pos = _cache_pos(caches)
    x = _embed(params, token, m)
    if "pos_embed" in params:
        pe = params["pos_embed"]
        row = torch.clamp(pos, 0, pe.shape[0] - 1).reshape(1)
        x = x - pe[None, 0:1] + pe.index_select(0, row)[None]
    positions = pos.reshape(1, 1).expand(token.shape[0], 1)
    win = window if window is not None else cfg.attn_window
    for i, g in enumerate(_stage_gates(cfg, gates, device)):
        x, _, _ = stage_apply(params["stages"][i], cfg.stages()[i][0], x,
                              cfg, m, gates=g, positions=positions,
                              window=win, enc_out=enc_out, caches=caches[i],
                              decode=True)
    return _head(params, cfg, x, m), caches


def _cache_pos(caches) -> torch.Tensor:
    """Current length: the largest 'pos' of stage 0's first cache."""
    return next(iter(caches[0][0].values())).pos.max()


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:               # jax's read-only buffers
        a = a.copy()
    if a.dtype.name == "bfloat16":          # ml_dtypes.bfloat16: same bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, cfg: ArchConfig, device) -> Params:
    """The JAX package's params (``jax.tree.map(np.asarray, params)``) as
    the port's tensors on ``device``, keeping each leaf's dtype."""
    want = dict(leaves_with_path(param_shapes(cfg), is_leaf=_is_shape))
    got = dict(leaves_with_path(tree))
    if set(got) != set(want):
        raise ValueError(f"param tree mismatch: {sorted(set(got) ^ set(want))}")
    for path, a in got.items():
        if tuple(a.shape) != want[path]:
            raise ValueError(f"{path}: shape {a.shape} != {want[path]}")
    return from_paths(list(got), [_to_torch(a).to(device) for a in got.values()])
