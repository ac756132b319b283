"""Step functions shared by the serving entry points (the port's part of
``repro.launch.steps``)."""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as model_mod


def make_decode_step(cfg: ArchConfig, *, window: Optional[int] = None,
                     masks=None):
    def decode_step(params, caches, token):
        return model_mod.decode_step(params, cfg, token, caches,
                                     window=window, masks=masks)
    return decode_step
