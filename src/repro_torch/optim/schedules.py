"""LR schedules: constant, step decay (paper Table 6), cosine and WSD
(warmup-stable-decay), as f32 scalars like the JAX package's."""
from __future__ import annotations

import math

import torch


def make_schedule(name: str, base_lr: float, total_steps: int, *,
                  warmup: int = 0, decay_at=(0.5, 0.75), decay_factor=0.1,
                  stable_frac: float = 0.8):
    total = max(total_steps, 1)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)

    def constant(step):
        return f32(base_lr)

    def step_decay(step):
        lr = f32(base_lr)
        for frac in decay_at:
            lr = torch.where(f32(step) >= frac * total, lr * decay_factor, lr)
        return lr

    def cosine(step):
        s = f32(step)
        warm = torch.clamp_max(s / max(warmup, 1), 1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0, 1)
        return base_lr * warm * 0.5 * (1 + torch.cos(math.pi * prog))

    def wsd(step):
        s = f32(step)
        warm = torch.clamp_max(s / max(warmup, 1), 1.0)
        stable_end = stable_frac * total
        tail = torch.clamp((s - stable_end) / max(total - stable_end, 1), 0, 1)
        return base_lr * warm * (1.0 - (1.0 - 0.1) * torch.sqrt(tail))

    return {"constant": constant, "step": step_decay,
            "cosine": cosine, "wsd": wsd}[name]
