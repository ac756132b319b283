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

With a mesh (``launch.mesh``; the layout of ``sharding.cohort``) each rank
runs this driver on its share: the cohort is padded with inert rows to a
multiple of the data shards and the rank trains its m/D rows, against the
global gathered once over ``model`` from the (N/M,) slice it keeps; its
training buffer holds whole rows, and its quantized state only its
``flat.pool_cols``.  The round's loss averages the real rows over
``data``, and the tree is gathered at eval boundaries.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.core import flat
from repro_torch.core.fedfa import STRATEGIES
from repro_torch.core.server import (ClientSpec, FLConfig, cohort_update,
                                     default_class_masks, stack_runtimes)
from repro_torch.models.model import _to_torch
from repro_torch.sharding import cohort as csh
from repro_torch.sharding import collectives as coll

Params = Dict[str, Any]


def eval_boundary(r: int, rounds: int, eval_every: int) -> bool:
    """True on rounds where eval fires: every ``eval_every`` rounds (r = 0
    included) and on the final round; ``eval_every <= 0``: final only."""
    return (eval_every > 0 and r % eval_every == 0) or r == rounds - 1


QuantState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def fresh_quant_state(index: flat.FlatIndex, m: int, update_dtype: str,
                      device, width: Optional[int] = None) -> QuantState:
    """Zeroed quantized cohort state (x_q, scales, e, e_scales): the rows
    (``width`` columns, n_padded by default), their (m, S) scales and the
    error-feedback residual with its scales.  Zero pools make the first
    round's error feedback an exact no-op."""
    want = flat.update_dtype_of(update_dtype)
    S = index.n_segments
    width = index.n_padded if width is None else width
    return (torch.zeros((m, width), dtype=want, device=device),
            torch.zeros((m, S), dtype=torch.float32, device=device),
            torch.zeros((m, width), dtype=want, device=device),
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
    rows, tab = (flat.update_dtype_of(update_dtype), (m, index.n_padded)), \
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
               qstate: Optional[QuantState] = None,
               mesh=None) -> torch.Tensor:
    """One resident round, in place: trains the cohort into ``c_buf``
    (m, n_padded), aggregates, and overwrites ``g_buf`` with the new
    global.  runtimes: the ``server.stack_runtimes`` tuple of the cohort.
    With a quantized ``fl.update_dtype``, ``qstate`` (``fresh_quant_state``)
    is the cohort's quantized state, admitted into in place.  Returns the
    mean local loss.

    With ``mesh`` the runtimes, batches and perms are the whole cohort's
    (m rows); it is padded with inert rows (``sharding.cohort.pad_cohort``;
    pad rows take row 0's permutation) and this rank trains its rows
    ``data_rows`` into ``c_buf`` (m_pad/D, n_padded).  ``g_buf`` is its
    ``model_cols`` slice and ``qstate`` holds its rows on ``pool_cols``.
    The loss is the mean over the cohort's real rows."""
    m = runtimes[3].shape[0]
    g_full = g_buf
    if mesh is not None:
        pad = csh.pad_rows(m, mesh)
        runtimes, batches = csh.pad_cohort(runtimes, batches, pad)
        perms = csh.pad_leading(perms, pad)
        rows = csh.data_rows(mesh, m + pad)
        runtimes = tuple(csh.rows_of(t, rows) for t in runtimes)
        batches, perms = csh.rows_of(batches, rows), csh.rows_of(perms, rows)
        g_full = coll.gather_model(g_buf, mesh, index.n_padded)
    masks, gates, gmaps, nd, cms, mal = runtimes
    r = c_buf.shape[0]
    if nd.shape[0] != r:
        raise ValueError(f"a cohort of {nd.shape[0]} rows here, but the "
                         f"training buffer holds {r}")
    g = flat.unflatten(index, g_full)
    losses = cohort_update(g, cfg, fl, index, masks, gates, batches,
                           default_class_masks(cms, cfg, fl, r, g_buf.device),
                           mal, perms, c_buf)
    del g, g_full
    kw = dict(STRATEGIES[fl.strategy], trim=fl.trim, use_kernel=fl.use_kernel,
              mesh=mesh)
    if fl.update_dtype == "f32":
        g_new = flat.aggregate_buffers(index, g_buf, c_buf, cfg, masks, gates,
                                       gmaps, nd, **kw)
    else:
        cols = flat.pool_cols(index, mesh, fl.use_kernel)
        if qstate is None or qstate[0].dtype != flat.update_dtype_of(
                fl.update_dtype) or tuple(qstate[0].shape) != (
                r, cols.stop - cols.start):
            raise ValueError(f"a {fl.update_dtype} round needs its "
                             f"({r}, {cols.stop - cols.start}) quantized "
                             f"state")
        flat.admit_quantized(index, cfg, c_buf, masks, gmaps,
                             bool(kw.get("graft", False)), qstate,
                             fl.update_dtype, mesh, cols)
        g_new = flat.aggregate_buffers(index, g_buf, qstate[0], cfg, masks,
                                       gates, gmaps, nd, scales=qstate[1],
                                       pregrafted=True, **kw)
    g_buf.copy_(g_new)
    if mesh is None:
        return torch.mean(losses)
    real = (torch.arange(r, device=losses.device) + rows.start < m)
    sums = torch.stack([torch.sum(torch.where(real, losses, 0.0)),
                        torch.sum(real.to(losses.dtype))])
    coll.all_reduce(sums, mesh, csh.DATA_AXIS)
    return sums[0] / sums[1]


def round_contract(index: flat.FlatIndex, mesh=None, *, rows: int):
    """The resident round's declared contract (``analysis.contracts``), for
    a cohort padded to ``rows``: the reference's
    (``repro.core.round.round_contract``) field by field.

    Always: the full (rows, N) cohort is never all-gathered, both
    resident buffers hold the round's result in place (``donated``:
    ``flat_round``'s arguments 0 = g_buf and 1 = the cohort buffer, the
    reference's parameters 0 and 1), and the per-rank peak stays within
    ``(6 + 12*r) * N * 4`` bytes, r the rows per data shard.  A buffer
    replaced by a fresh one, or a materialized cohort replica, blows the
    budget.

    On a multi-rank data-only mesh the round has no all-gather at all and
    the (M', γ) partial sums are >= 1 N-sized all-reduce.  With model
    shards the strict communication bounds live on the aggregation's
    contract (``kernels.fedfa_agg.ops.accumulate_contract``); the round
    keeps the reference's ceilings on the re-layout collectives GSPMD
    emits on its training side (the port issues one: the global's
    all-gather over ``model``), and no all-gather may exceed one full
    (N,) row."""
    from repro_torch.analysis.contracts import Contract
    multi = csh.data_shards(mesh) * csh.model_shards(mesh) > 1
    ms = csh.model_shards(mesh)
    r = max(1, rows // csh.data_shards(mesh))
    kw: Dict[str, Any] = {}
    if multi and ms == 1:
        kw = dict(all_gathers=0, scale_allreduces=(1, None),
                  scale_elems=index.n_padded)
    elif multi:
        kw = dict(all_gathers=(None, 64), all_to_alls=(None, 48),
                  collective_permutes=(None, 24), reduce_scatters=(0, 8),
                  max_all_gather_elems=index.n_padded)
    return Contract(
        name=f"round/ms{ms}",
        description="resident round: in-place ping-pong, no cohort gather",
        full_cohort_gathers=0, cohort_elems=rows * index.n_padded,
        peak_live_bytes_per_device=(None, (6 + 12 * r) * index.n_padded * 4),
        donated=frozenset({0, 1}), **kw)


def quantized_round_contract(index: flat.FlatIndex, mesh=None, *,
                             rows: int):
    """Declared contract of the QUANTIZED resident round (``update_dtype``
    int8 or bf16): the reference's
    (``repro.core.round.quantized_round_contract``) field by field, but
    ``donated``.

    The structural guarantees of ``round_contract`` — no full-cohort
    gather, zero all-gathers and >= 1 N-sized partial-sum all-reduce on a
    data mesh, no reduce-scatter — plus the quantization's own, measured
    on the fused dequantize-accumulate (``agg_ops.accumulate_quant``):
    exactly 1 read of the quantized rows and 0 sorts, since the rows enter
    the kernel in their admitted dtype.  Peak budget ``(6 + 10r) * N * 4``
    bytes a rank.

    ``donated`` is restated as ``{0, 1, 8}``, positions of ``flat_round``:
    0 = g_buf (the reference's parameter 0), 8 = the quantized state
    (x_q, scales, e, e_scales), which holds the reference's parameters 1-4
    in one argument, and 1 = the f32 training buffer the cohort trains
    into before admission, which the reference has no parameter for (a
    transient of its compiled round).  ROADMAP queue 3 item 34."""
    from repro_torch.analysis.contracts import Contract
    multi = csh.data_shards(mesh) * csh.model_shards(mesh) > 1
    kw: Dict[str, Any] = {}
    if multi:
        kw = dict(all_gathers=0, reduce_scatters=0,
                  scale_allreduces=(1, None), scale_elems=index.n_padded)
    r = max(1, rows // csh.data_shards(mesh))
    return Contract(
        name="round/quant",
        description="quantized round: int8 admission, fused dequantize",
        full_cohort_gathers=0, cohort_elems=rows * index.n_padded,
        peak_live_bytes_per_device=(None, (6 + 10 * r) * index.n_padded * 4),
        donated=frozenset({0, 1, 8}), row_reads=1, sorts=0, **kw)


class ResidentDriver:
    """Multi-round state: the FlatIndex and one pool per (cohort size,
    admission dtype) — the f32 training buffer and, for a quantized dtype,
    the quantized state — allocated on first use and reused in place.  An
    f32 and an int8 cohort of one size never share a pool.  With a mesh
    the size is the padded row count, so cohorts that pad alike share a
    pool, and the pool holds this rank's rows of it."""

    def __init__(self, cfg: ArchConfig, fl: FLConfig, index: flat.FlatIndex,
                 device, mesh=None):
        self.cfg, self.fl, self.index, self.mesh = cfg, fl, index, mesh
        self.device = torch.device(device)
        self._pools: Dict[Tuple[int, str],
                          Tuple[torch.Tensor, Optional[QuantState]]] = {}

    def pool_key(self, m: int) -> Tuple[int, str]:
        """The pool an m-client cohort takes: (padded rows, admission
        dtype)."""
        return m + csh.pad_rows(m, self.mesh), self.fl.update_dtype

    def pool(self, m: int) -> Tuple[torch.Tensor, Optional[QuantState]]:
        """(f32 training buffer, quantized state or None) of an m-client
        cohort at the current admission dtype (this rank's rows of it)."""
        key = self.pool_key(m)
        if key not in self._pools:
            r = key[0] // csh.data_shards(self.mesh)
            cols = flat.pool_cols(self.index, self.mesh, self.fl.use_kernel)
            c_buf = torch.empty((r, self.index.n_padded), dtype=torch.float32,
                                device=self.device)
            qstate = None if key[1] == "f32" else fresh_quant_state(
                self.index, r, key[1], self.device, cols.stop - cols.start)
            self._pools[key] = (c_buf, qstate)
        return self._pools[key]

    def round(self, g_buf: torch.Tensor, specs: Sequence[ClientSpec], batches,
              perms: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One round on the resident buffer; returns the mean local loss."""
        if any(s.malicious for s in specs) and perms is None:
            raise ValueError("a cohort with attackers needs label perms")
        with tracing.span("round"):
            c_buf, qstate = self.pool(len(specs))
            with tracing.span("round/runtimes"):
                runtimes = stack_runtimes(self.cfg, specs, self.device)
            return flat_round(g_buf, c_buf, self.cfg, self.fl, self.index,
                              runtimes, batches, perms, qstate,
                              mesh=self.mesh)


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
               perm_fn: Optional[Callable[[int, int, int], torch.Tensor]] = None,
               mesh=None) -> Tuple[Params, List[float]]:
    """Drive R resident rounds on the device of ``global_params``.

    data_fn(r) -> (selected ClientSpecs, dict of stacked client batches on
    that device), called once per round.  perm_fn(r, m, n) -> (m, n) label
    permutations for round r's attackers; by default they are drawn from a
    ``torch.Generator`` seeded with ``fl.seed``.  eval_fn(r, mean_loss,
    params) runs at ``eval_boundary`` rounds; with ``ckpt_path`` set, a
    checkpoint ``f"{ckpt_path}_r{r:05d}"`` is written from the resident
    buffer at the same rounds.  Returns (final params, per-round mean
    losses).

    With ``mesh`` every rank calls this with the same arguments: the index
    pads N to ``sharding.cohort.pad_unit``, the rank keeps its P("model")
    slice of the global and trains its rows of each cohort, and the
    global is gathered at eval boundaries (rank 0 writes the
    checkpoints)."""
    if rounds <= 0:
        return global_params, []
    device = global_params["embed"].device
    index = flat.FlatIndex(global_params, pad_to=csh.pad_unit(mesh))
    driver = ResidentDriver(cfg, fl, index, device, mesh)
    g_buf = flat.flatten(index, global_params)
    if mesh is not None:
        g_buf = g_buf[csh.model_cols(mesh, index.n_padded)].clone()
    perm_fn = perm_fn or default_perms(fl.seed)
    losses: List[float] = []
    g_full = g_buf      # gathered at each eval boundary, the last round's too
    for r in range(rounds):
        specs, batches = data_fn(r)
        perms = None
        if any(s.malicious for s in specs):
            perms = perm_fn(r, len(specs), label_count(batches, fl.task)).to(device)
        losses.append(float(driver.round(g_buf, specs, batches, perms)))
        if eval_boundary(r, rounds, eval_every):
            g_full = coll.gather_model(g_buf, mesh, index.n_padded)
            if eval_fn is not None:
                eval_fn(r, losses[-1], flat.unflatten(index, g_full))
            if ckpt_path is not None:
                from repro_torch.checkpoint import checkpoint as ckpt_mod
                ckpt_mod.save_from_buffer(
                    f"{ckpt_path}_r{r:05d}", index, g_full,
                    meta={"round": r, "strategy": fl.strategy}, mesh=mesh)
    return flat.unflatten(index, g_full), losses
