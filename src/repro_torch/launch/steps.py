"""Step functions of the training and serving entry points (the port's
``repro.launch.steps``): train, prefill and decode, and the dry runs'
stand-ins for their inputs (``input_specs``, ``decode_cache_specs``:
tensors on the meta device, shapes and dtypes with nothing allocated).

``make_train_step`` accumulates ``cfg.grad_accum`` microbatches in order
(a Python loop where the JAX package scans); with SGD the microbatch
gradients go straight into the momentum buffer, as the reference does.
Its loss is the total that it differentiates (the MoE aux losses
included), as the reference's step returns it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import model as model_mod
from repro_torch.optim import make_schedule, opt_update
from repro_torch.tree import tree_map

Params = Dict[str, Any]


def make_train_step(cfg: ArchConfig, total_steps: int = 1000):
    """train_step(params, opt_state, batch, step) -> (params, opt_state,
    loss): one optimizer step on ``batch`` ({'tokens': (B, S)}, and
    'frames' (B, T, D) with an encoder or 'patches' (B, P, vit_dim) with a
    vision frontend; every entry split into the microbatches alike) at the
    schedule's rate for ``step``."""
    sched = make_schedule(cfg.schedule, cfg.learning_rate, total_steps,
                          warmup=max(total_steps // 100, 1))

    def train_step(params, opt_state, batch, step):
        A = cfg.grad_accum
        lr = sched(step)
        if A == 1:
            (loss, _), grads = model_mod.loss_and_grad(params, cfg, batch,
                                                       task="lm")
            with torch.no_grad():
                params, opt_state = opt_update(cfg.optimizer, params, grads,
                                               opt_state, lr)
            return params, opt_state, loss

        micro = [{k: v.reshape((A, v.shape[0] // A) + v.shape[1:])[i]
                  for k, v in batch.items()} for i in range(A)]
        lsum = 0.0
        if cfg.optimizer == "sgd":
            # fused momentum accumulation: the microbatch gradients go
            # straight into the momentum buffer (m' = μ·m + wd·p + Σ g/A),
            # so no separate gradient-accumulator tree is kept
            with torch.no_grad():
                m_acc = tree_map(
                    lambda m, p: cfg.momentum * m.to(torch.float32)
                    + cfg.weight_decay * p.to(torch.float32),
                    opt_state["m"], params)
            for mb in micro:
                (loss, _), g = model_mod.loss_and_grad(params, cfg, mb,
                                                       task="lm")
                with torch.no_grad():
                    m_acc = tree_map(lambda m, gg: m + gg / A, m_acc, g)
                lsum = lsum + loss
            mdt = (torch.bfloat16 if cfg.momentum_dtype == "bfloat16"
                   else torch.float32)
            with torch.no_grad():
                params = tree_map(
                    lambda p, m: (p.to(torch.float32) - lr * m).to(p.dtype),
                    params, m_acc)
                m_new = tree_map(lambda m: m.to(mdt), m_acc)
            return params, {"step": opt_state["step"] + 1, "m": m_new}, \
                lsum / A

        with torch.no_grad():
            g_acc = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
        for mb in micro:
            (loss, _), g = model_mod.loss_and_grad(params, cfg, mb,
                                                   task="lm")
            with torch.no_grad():
                g_acc = tree_map(torch.add, g_acc, g)
            lsum = lsum + loss
        with torch.no_grad():
            grads = tree_map(lambda g: g / A, g_acc)
            params, opt_state = opt_update(cfg.optimizer, params, grads,
                                           opt_state, lr)
        return params, opt_state, lsum / A

    return train_step


def make_prefill_step(cfg: ArchConfig, *, window: Optional[int] = None,
                      masks=None):
    """prefill_step(params, batch) -> (last-position logits, caches), and
    ``enc_out`` third with an encoder, as the reference's step returns."""
    def prefill_step(params, batch):
        logits, caches, enc_out = model_mod.prefill(
            params, cfg, batch, window=window, masks=masks,
            capacity=_prefill_capacity(cfg, batch),
            chunk_size=cfg.prefill_chunk)
        if cfg.encoder is not None:
            return logits, caches, enc_out
        return logits, caches
    return prefill_step


def _prefill_capacity(cfg: ArchConfig, batch) -> int:
    """Cache positions a prefill needs: the prompt's, and the patches in
    front of it with a vision frontend."""
    n = batch["tokens"].shape[1]
    if cfg.vision is not None:
        n += cfg.vision.n_patches
    return n


def make_decode_step(cfg: ArchConfig, *, window: Optional[int] = None,
                     masks=None):
    """decode_step(params, caches, token, enc_out=None) -> (logits,
    caches)."""
    def decode_step(params, caches, token, enc_out=None):
        return model_mod.decode_step(params, cfg, token, caches,
                                     window=window, masks=masks,
                                     enc_out=enc_out)
    return decode_step


def input_specs(cfg: ArchConfig, shape: InputShape, *,
                window: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The batch of one (arch x input shape) step on the meta device: a
    train or prefill shape's tokens (B, S) int32, or (B, S - n_patches)
    behind bf16 patches (B, n_patches, vit_dim) with a vision frontend,
    and bf16 frames (B, n_frames, d_model) with an encoder; a decode
    shape's one token (B, 1)."""
    B, S = shape.global_batch, shape.seq_len
    meta = lambda size, dt: torch.empty(size, dtype=dt, device="meta")
    if shape.kind in ("train", "prefill"):
        s_text = S
        batch: Dict[str, torch.Tensor] = {}
        if cfg.vision is not None:
            s_text = S - cfg.vision.n_patches
            batch["patches"] = meta((B, cfg.vision.n_patches,
                                     cfg.vision.vit_dim), torch.bfloat16)
        if cfg.encoder is not None:
            batch["frames"] = meta((B, cfg.encoder.n_frames, cfg.d_model),
                                   torch.bfloat16)
        batch["tokens"] = meta((B, s_text), torch.int32)
        return batch
    return {"tokens": meta((B, 1), torch.int32)}


def abstract_caches(cfg: ArchConfig, batch: int, capacity: int, *,
                    window: Optional[int] = None):
    """``model.init_caches`` on the meta device: bf16 caches of
    ``capacity`` positions (a ring of the window under one)."""
    params = {"embed": torch.empty(0, device="meta")}
    return model_mod.init_caches(params, cfg, batch, capacity,
                                 window=window, dtype=torch.bfloat16)


def decode_cache_specs(cfg: ArchConfig, shape: InputShape, *,
                       window: Optional[int] = None):
    """The caches a decode step at ``shape`` takes, already prefilled to
    ``seq_len`` positions (``abstract_caches``)."""
    return abstract_caches(cfg, shape.global_batch, shape.seq_len,
                           window=window)
