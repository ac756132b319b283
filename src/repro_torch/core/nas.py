"""Client-side architecture selection: ZiCo-style zero-shot NAS
(Li et al., arXiv:2301.11300 — paper §5.1) and a small evolutionary
search (the port's ``repro.core.nas``).

ZiCo proxy: sum over parameter leaves of log(E|g| / std|g|), where the
statistics of the per-parameter absolute gradients are taken across a few
probe minibatches; a higher inverse coefficient of variation goes with
trainability.  Only forward and backward passes are needed.  The search
draws from numpy's generator in the reference's order, so a seed picks the
same candidates in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.masking import apply_mask_tree, axis_mask_tree
from repro_torch.models import model as model_mod
from repro_torch.models.masks import ClientArch, max_section_depths
from repro_torch.tree import leaves


def zico_score(cfg: ArchConfig, arch: ClientArch, params,
               batches: Dict[str, torch.Tensor], task: str = "lm") -> float:
    """``batches``: entries with a leading axis of probe minibatches.  One
    gradient of ``loss_fn`` per probe on the masked params, masked again;
    per leaf, the mean and the population std (ddof 0, plus 1e-9) of |g|
    across the probes, the ratio summed over the entries whose mean is
    positive and divided by their count (at least 1), then its log (plus
    1e-9 inside) summed over the leaves."""
    device = params["embed"].device
    masks = arch.masks(cfg).to(device)
    gates = arch.gates(cfg).to(device)
    ax = axis_mask_tree(cfg, masks)
    p = apply_mask_tree(params, ax)
    n_probe = next(iter(batches.values())).shape[0]
    grads = []
    for i in range(n_probe):
        _, g = model_mod.loss_and_grad(
            p, cfg, {k: v[i] for k, v in batches.items()}, masks=masks,
            gates=gates, task=task)
        grads.append(leaves(apply_mask_tree(g, ax)))
    score = torch.zeros((), dtype=torch.float32, device=device)
    for per_probe in zip(*grads):
        ga = torch.abs(torch.stack(per_probe).to(torch.float32))
        mean = torch.mean(ga, dim=0)
        std = torch.std(ga, dim=0, correction=0) + 1e-9
        ratio = torch.where(mean > 0, mean / std, torch.zeros((),
                                                              device=device))
        denom = torch.clamp_min(torch.sum(mean > 0), 1)
        score = score + torch.log(torch.sum(ratio) / denom + 1e-9)
    return float(score)


@dataclass
class SearchSpace:
    width_mults: Tuple[float, ...] = (0.25, 0.5, 0.75, 1.0)
    # per-section depth choices are 1..max implicitly


def random_arch(cfg: ArchConfig, space: SearchSpace,
                rng: np.random.Generator) -> ClientArch:
    maxd = max_section_depths(cfg)
    w = float(rng.choice(space.width_mults))
    d = tuple(int(rng.integers(1, m + 1)) for m in maxd)
    return ClientArch(w, d)


def mutate(cfg: ArchConfig, arch: ClientArch, space: SearchSpace,
           rng: np.random.Generator) -> ClientArch:
    """One step of the width or of one section's depth, by a coin flip."""
    maxd = max_section_depths(cfg)
    w = arch.width_mult
    d = list(arch.section_depths)
    if rng.random() < 0.5:
        ws = list(space.width_mults)
        i = ws.index(min(ws, key=lambda v: abs(v - w)))
        i = int(np.clip(i + rng.choice([-1, 1]), 0, len(ws) - 1))
        w = ws[i]
    else:
        s = int(rng.integers(len(d)))
        d[s] = int(np.clip(d[s] + rng.choice([-1, 1]), 1, maxd[s]))
    return ClientArch(float(w), tuple(d))


def evolutionary_search(cfg: ArchConfig, params, batches, *,
                        task: str = "lm", space: SearchSpace = SearchSpace(),
                        population: int = 8, generations: int = 3,
                        seed: int = 0) -> ClientArch:
    """ZiCo-guided evolutionary search (paper §5.1: clients pick local
    architectures with ZiCo over the candidate grid of Table 5): the top
    half survive each generation, and mutated parents fill the rest."""
    rng = np.random.default_rng(seed)
    pop = [random_arch(cfg, space, rng) for _ in range(population)]
    scored = [(zico_score(cfg, a, params, batches, task), a) for a in pop]
    for _ in range(generations):
        scored.sort(key=lambda t: -t[0])
        parents = [a for _, a in scored[: max(2, population // 2)]]
        children = [mutate(cfg, parents[int(rng.integers(len(parents)))],
                           space, rng)
                    for _ in range(population - len(parents))]
        scored = scored[: len(parents)] + [
            (zico_score(cfg, a, params, batches, task), a) for a in children]
    scored.sort(key=lambda t: -t[0])
    return scored[0][1]
