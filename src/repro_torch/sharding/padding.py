"""Head padding for serving: FedFA's width masks reused as a sharding
padding.

Architectures whose kv-head count does not divide the 16-way model axis
(minicpm 36, smollm 3, tinyllama 4, recurrentgemma 1) would otherwise keep
their KV cache whole on every model shard.  Padding the kv heads to a
multiple of the axis and masking the extra heads with a width mask is
exactly a width-masked client model, so the padded model computes the
unpadded one's logits (``tests/test_torch_costs.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.masks import WidthMasks, full_masks


def pad_heads_for_serving(cfg: ArchConfig, axis: int = 16
                          ) -> Tuple[ArchConfig, Optional[WidthMasks]]:
    """(padded config, width masks that keep only the real heads); the
    config itself and None where ``axis`` divides the kv heads or the
    model has no attention."""
    K = cfg.n_kv_heads
    if K == 0 or K % axis == 0:
        return cfg, None
    group = cfg.n_heads // K
    Kp = (K + axis - 1) // axis * axis
    cfg2 = cfg.replace(n_kv_heads=Kp, n_heads=Kp * group)
    masks = dataclasses.replace(
        full_masks(cfg2),
        heads=(torch.arange(cfg2.n_heads) < cfg.n_heads).to(torch.float32),
        kv_heads=(torch.arange(Kp) < K).to(torch.float32))
    return cfg2, masks
