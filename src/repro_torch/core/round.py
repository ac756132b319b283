"""Resident-buffer multi-round FL driver (Alg. 1 lines 4-25, over rounds).

The server keeps the global model as one (N,) f32 buffer and the cohort as
one (m, N) f32 buffer per cohort shape.  Both are allocated once and reused
in place across rounds (the JAX package donates them to its jitted round
program instead): each round unpacks the global buffer into views for local
training, packs every client's update into its row of the cohort buffer,
aggregates in flat space (``flat.aggregate_buffers``) and writes the new
global back into the same (N,) buffer.  The tree is rebuilt only at eval
boundaries.

With a quantized admission dtype (``FLConfig.update_dtype`` int8 or bf16)
the trained f32 rows pass through grafting and server-side error feedback
into a quantized cohort state (x_q, scales, e, e_scales), kept per cohort
shape beside the f32 training buffer and updated in place; aggregation
reads x_q through its scales.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import flat
from repro_torch.core.fedfa import STRATEGIES
from repro_torch.core.server import (ClientSpec, FLConfig, cohort_update,
                                     default_class_masks, stack_runtimes)
from repro_torch.models.model import _to_torch

Params = Dict[str, Any]


def eval_boundary(r: int, rounds: int, eval_every: int) -> bool:
    """True on rounds where eval fires: every ``eval_every`` rounds (r = 0
    included) and on the final round; ``eval_every <= 0``: final only."""
    return (eval_every > 0 and r % eval_every == 0) or r == rounds - 1


QuantState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def fresh_quant_state(index: flat.FlatIndex, m: int, update_dtype: str,
                      device) -> QuantState:
    """Zeroed quantized cohort state (x_q, scales, e, e_scales): the rows,
    their (m, S) scales and the error-feedback residual with its scales.
    Zero pools make the first round's error feedback an exact no-op."""
    want = flat.update_dtype_of(update_dtype)
    S = index.n_segments
    return (torch.zeros((m, index.n), dtype=want, device=device),
            torch.zeros((m, S), dtype=torch.float32, device=device),
            torch.zeros((m, index.n), dtype=want, device=device),
            torch.zeros((m, S), dtype=torch.float32, device=device))


def quant_state_from_numpy(index: flat.FlatIndex, update_dtype: str, arrays,
                           device) -> QuantState:
    """The JAX package's quantized cohort state (x_q, scales, e, e_scales)
    as numpy arrays (bf16 as ``ml_dtypes.bfloat16``) -> the port's, on
    ``device``."""
    if len(arrays) != 4:
        raise ValueError("a quantized state is (x_q, scales, e, e_scales)")
    # copies: the state is updated in place, and JAX's arrays are read-only
    out = tuple(_to_torch(np.array(a)).to(device) for a in arrays)
    m = out[0].shape[0]
    rows, tab = (flat.update_dtype_of(update_dtype), (m, index.n)), \
        (torch.float32, (m, index.n_segments))
    for name, t, (dtype, shape) in zip(("x_q", "scales", "e", "e_scales"),
                                       out, (rows, tab, rows, tab)):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}, "
                             f"expected {dtype} {shape}")
    return out


def flat_round(g_buf: torch.Tensor, c_buf: torch.Tensor, cfg: ArchConfig,
               fl: FLConfig, index: flat.FlatIndex, runtimes, batches,
               perms: Optional[torch.Tensor] = None,
               qstate: Optional[QuantState] = None) -> torch.Tensor:
    """One resident round, in place: trains the cohort into ``c_buf``
    (m, N), aggregates, and overwrites ``g_buf`` (N,) with the new global.
    runtimes: the ``server.stack_runtimes`` tuple of the cohort.  With a
    quantized ``fl.update_dtype``, ``qstate`` (``fresh_quant_state``) is
    the cohort's quantized state, admitted into in place.  Returns the mean
    local loss."""
    masks, gates, gmaps, nd, cms, mal = runtimes
    m = c_buf.shape[0]
    g = flat.unflatten(index, g_buf)
    losses = cohort_update(g, cfg, fl, index, masks, gates, batches,
                           default_class_masks(cms, cfg, fl, m, g_buf.device),
                           mal, perms, c_buf)
    kw = STRATEGIES[fl.strategy]
    if fl.update_dtype == "f32":
        g_new = flat.aggregate_buffers(index, g_buf, c_buf, cfg, masks, gates,
                                       gmaps, nd, trim=fl.trim, **kw)
    else:
        if qstate is None or qstate[0].dtype != flat.update_dtype_of(
                fl.update_dtype) or qstate[0].shape != c_buf.shape:
            raise ValueError(f"a {fl.update_dtype} round needs its "
                             f"({m}, N) quantized state")
        flat.admit_quantized(index, cfg, c_buf, masks, gmaps,
                             bool(kw.get("graft", False)), qstate,
                             fl.update_dtype)
        g_new = flat.aggregate_buffers(index, g_buf, qstate[0], cfg, masks,
                                       gates, gmaps, nd, trim=fl.trim,
                                       scales=qstate[1], pregrafted=True,
                                       **kw)
    g_buf.copy_(g_new)
    return torch.mean(losses)


class ResidentDriver:
    """Multi-round state: the FlatIndex and one pool per (cohort size,
    admission dtype) — the f32 training buffer and, for a quantized dtype,
    the quantized state — allocated on first use and reused in place.  An
    f32 and an int8 cohort of one size never share a pool."""

    def __init__(self, cfg: ArchConfig, fl: FLConfig, index: flat.FlatIndex,
                 device):
        self.cfg, self.fl, self.index = cfg, fl, index
        self.device = torch.device(device)
        self._pools: Dict[Tuple[int, str],
                          Tuple[torch.Tensor, Optional[QuantState]]] = {}

    def pool(self, m: int) -> Tuple[torch.Tensor, Optional[QuantState]]:
        """(f32 training buffer, quantized state or None) of an m-client
        cohort at the current admission dtype."""
        key = (m, self.fl.update_dtype)
        if key not in self._pools:
            c_buf = torch.empty((m, self.index.n), dtype=torch.float32,
                                device=self.device)
            qstate = None if key[1] == "f32" else fresh_quant_state(
                self.index, m, key[1], self.device)
            self._pools[key] = (c_buf, qstate)
        return self._pools[key]

    def round(self, g_buf: torch.Tensor, specs: Sequence[ClientSpec], batches,
              perms: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One round on the resident buffer; returns the mean local loss."""
        if any(s.malicious for s in specs) and perms is None:
            raise ValueError("a cohort with attackers needs label perms")
        c_buf, qstate = self.pool(len(specs))
        runtimes = stack_runtimes(self.cfg, specs, self.device)
        return flat_round(g_buf, c_buf, self.cfg, self.fl, self.index,
                          runtimes, batches, perms, qstate)


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
               ckpt_path: Optional[str] = None,
               perm_fn: Optional[Callable[[int, int, int], torch.Tensor]] = None
               ) -> Tuple[Params, List[float]]:
    """Drive R resident rounds on the device of ``global_params``.

    data_fn(r) -> (selected ClientSpecs, dict of stacked client batches on
    that device), called once per round.  perm_fn(r, m, n) -> (m, n) label
    permutations for round r's attackers; by default they are drawn from a
    ``torch.Generator`` seeded with ``fl.seed``.  eval_fn(r, mean_loss,
    params) runs at ``eval_boundary`` rounds; with ``ckpt_path`` set, a
    checkpoint ``f"{ckpt_path}_r{r:05d}"`` is written from the resident
    buffer at the same rounds.  Returns (final params, per-round mean
    losses)."""
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
        if eval_boundary(r, rounds, eval_every):
            if eval_fn is not None:
                eval_fn(r, losses[-1], flat.unflatten(index, g_buf))
            if ckpt_path is not None:
                from repro_torch.checkpoint import checkpoint as ckpt_mod
                ckpt_mod.save_from_buffer(
                    f"{ckpt_path}_r{r:05d}", index, g_buf,
                    meta={"round": r, "strategy": fl.strategy})
    return flat.unflatten(index, g_buf), losses
