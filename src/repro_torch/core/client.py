"""Client-side local update (Alg. 1 line 9, LocalUpdate): E steps of the
configured optimizer (SGD+momentum, the paper's, or AdamW) on the client's
masked sub-model, with gradients and weights projected back onto the
client subspace after each step.  ``momentum`` and ``weight_decay`` are
SGD's: AdamW keeps its own defaults, as in the JAX package."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.core.masking import (apply_mask_tree, axis_mask_tree,
                                      mask_gradients)
from repro_torch.models import model as model_mod
from repro_torch.models.masks import WidthMasks
from repro_torch.optim import init_opt, opt_update

Params = Dict[str, Any]


def local_update(global_params: Params, cfg: ArchConfig, batches, *,
                 masks: WidthMasks, gates: torch.Tensor, lr: float,
                 task: str = "lm", class_mask: Optional[torch.Tensor] = None,
                 optimizer: Optional[str] = None, momentum: float = 0.9,
                 weight_decay: float = 1e-4) -> Tuple[Params, torch.Tensor]:
    """batches: dict with a leading step axis, e.g. {'tokens': (E, B, S)}.
    Returns ``(params, losses)``: the client's updated (masked) model and
    the (E,) per-step training losses."""
    opt_name = optimizer or cfg.optimizer
    with tracing.span("train/client/start"):
        ax = axis_mask_tree(cfg, masks)
        params = apply_mask_tree(global_params, ax)      # Alg. 3: distribution
        st = init_opt(params, opt_name)
    losses = []
    for e in range(next(iter(batches.values())).shape[0]):
        # the gradient of the total (task loss + MoE aux losses); the
        # logged loss is the task's alone, as the reference logs it
        with tracing.span("train/step/fwd_bwd"):
            (_, metrics), grads = model_mod.loss_and_grad(
                params, cfg, {k: v[e] for k, v in batches.items()},
                masks=masks, gates=gates, task=task, class_mask=class_mask)
        with tracing.span("train/step/update"):
            grads = mask_gradients(grads, ax)
            with torch.no_grad():
                params, st = opt_update(
                    opt_name, params, grads, st, lr,
                    **({"momentum": momentum, "weight_decay": weight_decay}
                       if opt_name == "sgd" else {}))
                # weight decay drift guard
                params = apply_mask_tree(params, ax)
        losses.append(metrics["loss"])
    return params, torch.stack(losses)
