"""Resident-buffer multi-round FL driver (Alg. 1 lines 4-25, over rounds).

The server keeps the global model as one (N,) f32 buffer and the cohort as
one (m, N) f32 buffer per cohort shape.  Both are allocated once and reused
in place across rounds (the JAX package donates them to its jitted round
program instead): each round unpacks the global buffer into views for local
training, packs every client's update into its row of the cohort buffer,
aggregates in flat space (``flat.aggregate_buffers``) and writes the new
global back into the same (N,) buffer.  The tree is rebuilt only at eval
boundaries.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import flat
from repro_torch.core.fedfa import STRATEGIES
from repro_torch.core.server import (ClientSpec, FLConfig, cohort_update,
                                     default_class_masks, stack_runtimes)

Params = Dict[str, Any]


def eval_boundary(r: int, rounds: int, eval_every: int) -> bool:
    """True on rounds where eval fires: every ``eval_every`` rounds (r = 0
    included) and on the final round; ``eval_every <= 0``: final only."""
    return (eval_every > 0 and r % eval_every == 0) or r == rounds - 1


def flat_round(g_buf: torch.Tensor, c_buf: torch.Tensor, cfg: ArchConfig,
               fl: FLConfig, index: flat.FlatIndex, runtimes, batches,
               perms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One resident round, in place: trains the cohort into ``c_buf``
    (m, N), aggregates, and overwrites ``g_buf`` (N,) with the new global.
    runtimes: the ``server.stack_runtimes`` tuple of the cohort.  Returns
    the mean local loss."""
    masks, gates, gmaps, nd, cms, mal = runtimes
    m = c_buf.shape[0]
    g = flat.unflatten(index, g_buf)
    losses = cohort_update(g, cfg, fl, index, masks, gates, batches,
                           default_class_masks(cms, cfg, fl, m, g_buf.device),
                           mal, perms, c_buf)
    g_new = flat.aggregate_buffers(index, g_buf, c_buf, cfg, masks, gates,
                                   gmaps, nd, trim=fl.trim,
                                   **STRATEGIES[fl.strategy])
    g_buf.copy_(g_new)
    return torch.mean(losses)


class ResidentDriver:
    """Multi-round state: the FlatIndex and one cohort buffer per cohort
    size, allocated on first use and reused in place."""

    def __init__(self, cfg: ArchConfig, fl: FLConfig, index: flat.FlatIndex,
                 device):
        self.cfg, self.fl, self.index = cfg, fl, index
        self.device = torch.device(device)
        self._cbufs: Dict[int, torch.Tensor] = {}

    def round(self, g_buf: torch.Tensor, specs: Sequence[ClientSpec], batches,
              perms: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One round on the resident buffer; returns the mean local loss."""
        m = len(specs)
        if any(s.malicious for s in specs) and perms is None:
            raise ValueError("a cohort with attackers needs label perms")
        c_buf = self._cbufs.get(m)
        if c_buf is None:
            c_buf = self._cbufs[m] = torch.empty(
                (m, self.index.n), dtype=torch.float32, device=self.device)
        runtimes = stack_runtimes(self.cfg, specs, self.device)
        return flat_round(g_buf, c_buf, self.cfg, self.fl, self.index,
                          runtimes, batches, perms)


def label_count(batches, task: str) -> int:
    """Elements a label shuffle permutes: labels (cls) or tokens (lm) of one
    client's E local batches."""
    return batches["labels" if task == "cls" else "tokens"][0].numel()


def default_perms(seed: int) -> Callable[[int, int, int], torch.Tensor]:
    """perm_fn(r, m, n) drawing m label permutations of n elements per call
    from one ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return lambda r, m, n: torch.stack([torch.randperm(n, generator=gen)
                                        for _ in range(m)])


def run_rounds(global_params: Params, cfg: ArchConfig, fl: FLConfig,
               rounds: int,
               data_fn: Callable[[int], Tuple[Sequence[ClientSpec], Any]], *,
               eval_every: int = 5,
               eval_fn: Optional[Callable[[int, float, Params], None]] = None,
               perm_fn: Optional[Callable[[int, int, int], torch.Tensor]] = None
               ) -> Tuple[Params, List[float]]:
    """Drive R resident rounds on the device of ``global_params``.

    data_fn(r) -> (selected ClientSpecs, dict of stacked client batches on
    that device), called once per round.  perm_fn(r, m, n) -> (m, n) label
    permutations for round r's attackers; by default they are drawn from a
    ``torch.Generator`` seeded with ``fl.seed``.  eval_fn(r, mean_loss,
    params) runs at ``eval_boundary`` rounds.  Returns (final params,
    per-round mean losses)."""
    if rounds <= 0:
        return global_params, []
    device = global_params["embed"].device
    index = flat.FlatIndex(global_params)
    driver = ResidentDriver(cfg, fl, index, device)
    g_buf = flat.flatten(index, global_params)
    perm_fn = perm_fn or default_perms(fl.seed)
    losses: List[float] = []
    for r in range(rounds):
        specs, batches = data_fn(r)
        perms = None
        if any(s.malicious for s in specs):
            perms = perm_fn(r, len(specs), label_count(batches, fl.task)).to(device)
        losses.append(float(driver.round(g_buf, specs, batches, perms)))
        if eval_fn is not None and eval_boundary(r, rounds, eval_every):
            eval_fn(r, losses[-1], flat.unflatten(index, g_buf))
    return flat.unflatten(index, g_buf), losses
