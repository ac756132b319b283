"""FedFA client-architecture runtime: width masks, depth gates, graft maps.

A client architecture is (width multiplier, per-section depth).  Every
client shares the global parameter shapes; this module builds contiguous
prefix width masks per flexible dimension (Alg. 1 line 19), per-repeat depth
gates (Alg. 3: clients keep the first d_s blocks of each section) and graft
maps (Alg. 2: missing depth positions take the section's last active block).
Masks and gates are built on the CPU; ``WidthMasks.to`` moves them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class WidthSpec:
    """Integer active sizes per flexible dimension (host-side)."""
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    n_experts: int = 0
    ssm_heads: int = 0
    d_rnn: int = 0


def width_spec(cfg: ArchConfig, w: float) -> WidthSpec:
    """Contiguous-prefix active sizes for width multiplier w in (0, 1]."""
    if not 0.0 < w <= 1.0:
        raise ValueError(f"width multiplier must be in (0, 1], got {w!r}")
    if cfg.n_kv_heads > 0:
        kv = max(1, int(round(w * cfg.n_kv_heads)))
        heads = kv * (cfg.n_heads // cfg.n_kv_heads)
    else:
        kv = heads = 0
    d_model = max(16, int(w * cfg.d_model) // 8 * 8) if w < 1.0 else cfg.d_model
    d_ff = max(8, int(w * cfg.d_ff) // 8 * 8) if (cfg.d_ff and w < 1.0) else cfg.d_ff
    n_exp = (max(cfg.moe.top_k, int(round(w * cfg.moe.n_experts)))
             if cfg.moe else 0)
    sh = max(1, int(round(w * cfg.ssm.n_heads(cfg.d_model)))) if cfg.ssm else 0
    dr = 0
    if cfg.rglru:
        dr = (max(8, int(w * cfg.rglru.d_rnn(cfg.d_model)) // 8 * 8) if w < 1.0
              else cfg.rglru.d_rnn(cfg.d_model))
    return WidthSpec(d_model, heads, kv, d_ff, n_exp, sh, dr)


def _prefix(n_total: int, n_active: int) -> torch.Tensor:
    return (torch.arange(n_total) < n_active).to(torch.float32)


@dataclass(frozen=True)
class WidthMasks:
    """0/1 float masks, each (dim,) for one client or (m, dim) stacked."""
    d_model: torch.Tensor
    heads: Optional[torch.Tensor]
    kv_heads: Optional[torch.Tensor]
    d_ff: Optional[torch.Tensor]
    experts: Optional[torch.Tensor] = None
    ssm_heads: Optional[torch.Tensor] = None
    d_rnn: Optional[torch.Tensor] = None

    def _map(self, fn) -> "WidthMasks":
        return WidthMasks(**{f.name: None if getattr(self, f.name) is None
                             else fn(getattr(self, f.name))
                             for f in dataclasses.fields(self)})

    def to(self, device) -> "WidthMasks":
        return self._map(lambda t: t.to(device))

    def client(self, i: int) -> "WidthMasks":
        """Client i's masks out of a stacked set."""
        return self._map(lambda t: t[i])


def stack_masks(ms: List[WidthMasks]) -> WidthMasks:
    """Stack per-client masks along a leading client axis."""
    return WidthMasks(**{
        f.name: None if getattr(ms[0], f.name) is None
        else torch.stack([getattr(m, f.name) for m in ms])
        for f in dataclasses.fields(WidthMasks)})


def width_masks(cfg: ArchConfig, w: float) -> WidthMasks:
    s = width_spec(cfg, w)
    return WidthMasks(
        d_model=_prefix(cfg.d_model, s.d_model),
        heads=_prefix(cfg.n_heads, s.n_heads) if cfg.n_heads else None,
        kv_heads=_prefix(cfg.n_kv_heads, s.n_kv_heads) if cfg.n_kv_heads else None,
        d_ff=_prefix(cfg.d_ff, s.d_ff) if cfg.d_ff else None,
        experts=_prefix(cfg.moe.n_experts, s.n_experts) if cfg.moe else None,
        ssm_heads=(_prefix(cfg.ssm.n_heads(cfg.d_model), s.ssm_heads)
                   if cfg.ssm else None),
        d_rnn=(_prefix(cfg.rglru.d_rnn(cfg.d_model), s.d_rnn)
               if cfg.rglru else None))


def full_masks(cfg: ArchConfig) -> WidthMasks:
    return width_masks(cfg, 1.0)


def max_section_depths(cfg: ArchConfig) -> Tuple[int, ...]:
    return tuple(hi - lo for lo, hi in cfg.section_bounds())


def depth_gates(cfg: ArchConfig, section_depths: Tuple[int, ...]) -> torch.Tensor:
    """(R,) float gate over stage-0 repeats: first d_s repeats of section s."""
    bounds = cfg.section_bounds()
    if len(section_depths) != len(bounds):
        raise ValueError(
            f"expected {len(bounds)} section depths (one per section), "
            f"got {len(section_depths)}: {section_depths!r}")
    g = np.zeros(cfg.stages()[0][1], np.float32)
    for (lo, hi), d in zip(bounds, section_depths):
        if not 1 <= d <= hi - lo:
            raise ValueError(f"depth {d} invalid for section {(lo, hi)}: "
                             f"must be in [1, {hi - lo}]")
        g[lo:lo + d] = 1.0
    return torch.from_numpy(g)


def graft_map(cfg: ArchConfig, section_depths: Tuple[int, ...]) -> torch.Tensor:
    """(R,) int64: Alg. 2 — missing repeats replicate the last active block."""
    m = np.arange(cfg.stages()[0][1], dtype=np.int64)
    for (lo, hi), d in zip(cfg.section_bounds(), section_depths):
        m[lo + d:hi] = lo + d - 1
    return torch.from_numpy(m)


@dataclass(frozen=True)
class ClientArch:
    """A client's selected architecture (paper Alg. 1 line 2)."""
    width_mult: float
    section_depths: Tuple[int, ...]

    def masks(self, cfg: ArchConfig) -> WidthMasks:
        return width_masks(cfg, self.width_mult)

    def gates(self, cfg: ArchConfig) -> torch.Tensor:
        return depth_gates(cfg, self.section_depths)

    def graft(self, cfg: ArchConfig) -> torch.Tensor:
        return graft_map(cfg, self.section_depths)


def full_client(cfg: ArchConfig) -> ClientArch:
    return ClientArch(1.0, max_section_depths(cfg))
