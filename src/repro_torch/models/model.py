"""Top-level model API: train forward, losses, and the loader that carries
the JAX package's parameters across.

Entry points take width masks and depth gates; the global model is the
runtime with all-ones masks.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import apply_norm, matmul
from repro_torch.models.masks import WidthMasks, full_masks
from repro_torch.models.transformer import (_is_shape, init_params,  # noqa: F401
                                            param_shapes, stage_apply)
from repro_torch.tree import from_paths, leaves_with_path

Params = Dict[str, Any]


def _embed(params: Params, tokens: torch.Tensor, m: WidthMasks) -> torch.Tensor:
    x = params["embed"][tokens]
    if m.d_model is not None:
        x = x * m.d_model.to(x.dtype)
    return x


def _head(params: Params, cfg: ArchConfig, x: torch.Tensor, m: WidthMasks):
    x = apply_norm(cfg.norm, x, params["final_norm"], m.d_model, cfg.norm_eps)
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = matmul(x, w.to(x.dtype))
    if cfg.padded_vocab != cfg.vocab_size:
        # vocab-padding rows exist only for sharding; mask their logits
        pad = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(pad, logits,
                             torch.full((), -1e30, device=x.device))
    return logits


def forward(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
            masks: Optional[WidthMasks] = None,
            gates: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training / evaluation forward: batch {'tokens': (B, S)} -> logits
    (B, S, V).  ``gates`` flex stage 0's depth; later stages stay full."""
    device = params["embed"].device
    m = masks or full_masks(cfg).to(device)
    x = _embed(params, batch["tokens"], m)
    positions = torch.arange(x.shape[1], device=device)[None]
    for i, (unit, reps) in enumerate(cfg.stages()):
        g = gates if (i == 0 and gates is not None) else \
            torch.ones((reps,), dtype=torch.float32, device=device)
        x = stage_apply(params["stages"][i], unit, x, cfg, m, gates=g,
                        positions=positions, window=cfg.attn_window)
    return _head(params, cfg, x, m)


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
            masks=None, gates=None, task: str = "lm",
            class_mask=None) -> torch.Tensor:
    logits = forward(params, cfg, batch, masks=masks, gates=gates)
    if task == "lm":
        return lm_loss(logits, batch["tokens"], class_mask)
    return cls_loss(logits, batch["labels"], class_mask)


def _to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
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
