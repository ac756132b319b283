"""Flat-buffer aggregation engine: Alg. 1 on one contiguous (m, N) buffer.

The parameter tree is packed into one f32 buffer per client (``FlatIndex``
records the static layout: leaf offsets, shapes, dtypes, per-row segment
ids and depth-stage info).  Per-client weights that vary only per (leaf,
row) — depth gates, data counts, scaling factors α — live in small
(m, n_segments) tables broadcast onto the buffer leaf by leaf, so the
elementwise work is one pass per leaf whatever the model's depth:

  * graft (Alg. 2)          — a row gather along each stage-0 leaf,
  * trimmed norms (§4.3)    — per-(client, segment) quantile threshold and
                              trimmed sum of squares (``fedfa_quantile``),
  * (M', γ) accumulation    — two weighted reductions over the client axis
                              (the ``scaled_accum`` kernel).

Quantized admission (int8 with per-(client, segment) symmetric scales, or
bf16) stores the cohort in its admission dtype; every consumer dequantizes
as it reads (``quant_accum`` for M', the quantile kernels' scale inputs for
the norms), so no f32 copy of the quantized rows is made.

Single device; the mesh and padding paths of ``repro.core.flat`` are not
yet ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.masking import (active_fraction, axis_mask_tree,
                                      mask_density)
from repro_torch.kernels.fedfa_agg import ops as agg_ops
from repro_torch.kernels.fedfa_quantile import ops as quant_ops
from repro_torch.models.masks import WidthMasks
from repro_torch.tree import from_paths, leaves, leaves_with_path

Params = Dict[str, Any]


def _path_stage_info(path) -> Tuple[bool, Optional[int]]:
    """(is_depth_stacked, stage index) of a parameter path: the encoder's
    blocks are depth-stacked with stage None (a segment per row, never
    grafted or gated)."""
    if path[0] == "stages":
        return True, path[1]
    if path[0] == "encoder" and path[1] == "blocks":
        return True, None
    return False, None


@dataclass(frozen=True)
class LeafSpec:
    path: Tuple
    shape: Tuple[int, ...]
    dtype: torch.dtype
    offset: int
    size: int
    stacked: bool            # has a leading repeat axis
    stage: Optional[int]     # stage index for "stages" leaves, else None
    lead: int                # rows R (1 for unstacked leaves)
    rest: int                # elements per row
    seg0: int                # first global segment id of this leaf


class FlatIndex:
    """Static flat layout of a parameter tree (host-side numpy).

    Segments are (leaf, row) pairs: one per repeat of a depth-stacked leaf,
    one per unstacked leaf — the granularity at which trimmed norms, scaling
    factors and depth gates vary.  Leaf order is ``jax.tree_util`` flatten
    order, so an (N,) buffer is byte-identical to the JAX package's.
    """

    def __init__(self, params: Params):
        specs, row_of, seg_row, seg_stage0 = [], [], [], []
        off = seg = 0
        for path, x in leaves_with_path(params):
            stacked, stage = _path_stage_info(path)
            shape = tuple(x.shape)
            size = int(np.prod(shape, dtype=np.int64)) if shape else 1
            lead = shape[0] if stacked else 1
            rest = size // lead
            specs.append(LeafSpec(path, shape, x.dtype, off, size, stacked,
                                  stage, lead, rest, seg))
            row_of.append(np.repeat(np.arange(seg, seg + lead, dtype=np.int32),
                                    rest))
            seg_row.extend(range(lead))
            seg_stage0.extend([stacked and stage == 0] * lead)
            off += size
            seg += lead
        self.leaves = tuple(specs)
        self.n = off
        self.n_segments = seg
        self.row_of = np.concatenate(row_of)
        self.seg_row = np.asarray(seg_row, np.int32)
        self.seg_stage0 = np.asarray(seg_stage0)


def _segment_maps(index: FlatIndex):
    """(seg_id (N,) int32, seg_len (S,), leaf_of_seg (S,)): the per-position
    segment map of the segmented quantile (no inert tail on one device)."""
    seg_len = np.zeros(index.n_segments, np.int32)
    leaf_of = np.zeros(index.n_segments, np.int32)
    for li, spec in enumerate(index.leaves):
        seg_len[spec.seg0:spec.seg0 + spec.lead] = spec.rest
        leaf_of[spec.seg0:spec.seg0 + spec.lead] = li
    return index.row_of.astype(np.int32), seg_len, leaf_of


def _check_layout(index: FlatIndex, xs, drop: int) -> None:
    if len(xs) != len(index.leaves) or any(
            tuple(x.shape[drop:]) != s.shape for x, s in zip(xs, index.leaves)):
        raise ValueError("tree structure does not match FlatIndex layout")


def flatten(index: FlatIndex, tree: Params,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pack one tree into a contiguous (N,) f32 buffer, into ``out`` if
    given (a preallocated buffer or a row of one)."""
    xs = leaves(tree)
    _check_layout(index, xs, drop=0)
    if out is None:
        out = torch.empty(index.n, dtype=torch.float32, device=xs[0].device)
    for x, s in zip(xs, index.leaves):
        out[s.offset:s.offset + s.size].copy_(x.reshape(-1))
    return out


def flatten_stacked(index: FlatIndex, tree: Params) -> torch.Tensor:
    """Pack a client-stacked tree (leading axis m) into (m, N) f32."""
    xs = leaves(tree)
    _check_layout(index, xs, drop=1)
    return torch.cat([x.reshape(x.shape[0], -1).to(torch.float32) for x in xs],
                     dim=1)


def unflatten(index: FlatIndex, buf: torch.Tensor) -> Params:
    """Unpack an (N,) buffer into the tree with the original leaf dtypes;
    f32 leaves are views of ``buf``."""
    return from_paths(
        [s.path for s in index.leaves],
        [buf[s.offset:s.offset + s.size].view(s.shape).to(s.dtype)
         for s in index.leaves])


def unflatten_stacked(index: FlatIndex, buf: torch.Tensor) -> Params:
    """Unpack an (m, N) buffer into a client-stacked tree (leading axis m)
    with the original leaf dtypes; f32 leaves are views of ``buf``."""
    m = buf.shape[0]
    return from_paths(
        [s.path for s in index.leaves],
        [buf[:, s.offset:s.offset + s.size].view((m,) + s.shape).to(s.dtype)
         for s in index.leaves])


def _density_and_fraction(cfg: ArchConfig, index: FlatIndex, mk: WidthMasks,
                          out: Optional[torch.Tensor] = None):
    """One client's flat 0/1 width-mask density (N,) and per-leaf active
    fraction (n_leaves,); the density is written into ``out`` if given."""
    ax = dict(leaves_with_path(axis_mask_tree(cfg, mk)))
    if out is None:
        out = torch.empty(index.n, dtype=torch.float32,
                          device=mk.d_model.device)
    fracs = []
    for spec in index.leaves:
        out[spec.offset:spec.offset + spec.size].view(spec.shape).copy_(
            mask_density(spec.shape, ax[spec.path]))
        fracs.append(active_fraction(ax[spec.path]).to(out.device))
    return out, torch.stack(fracs)


def _graft_flat(index: FlatIndex, x: torch.Tensor,
                gmaps: torch.Tensor) -> torch.Tensor:
    """Alg. 2 on the (m, N) cohort: client c's stage-0 row r takes row
    gmaps[c, r] (identity off stage 0)."""
    out = x.clone()
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    for s in index.leaves:
        if s.stacked and s.stage == 0:
            blk = x[:, s.offset:s.offset + s.size].view(-1, s.lead, s.rest)
            out[:, s.offset:s.offset + s.size].view(-1, s.lead, s.rest) \
                .copy_(blk[rows, gmaps])
    return out


def _scale_segments(index: FlatIndex, x: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """In place x[c, n] *= w[c, row_of[n]] for an (m, N) buffer and an
    (m, S) per-segment table."""
    m = x.shape[0]
    for s in index.leaves:
        x[:, s.offset:s.offset + s.size].view(m, s.lead, s.rest) \
            .mul_(w[:, s.seg0:s.seg0 + s.lead, None])
    return x


# ---------------------------------------------------------------------------
# Quantized admission: per-(client, segment) symmetric scales
# ---------------------------------------------------------------------------

UPDATE_DTYPES = ("f32", "bf16", "int8")


def update_dtype_of(name: str) -> torch.dtype:
    """torch dtype for an ``--update-dtype`` name (the cohort admission
    tier)."""
    if name not in UPDATE_DTYPES:
        raise ValueError(f"update_dtype must be one of {UPDATE_DTYPES}, "
                         f"got {name!r}")
    return {"f32": torch.float32, "bf16": torch.bfloat16,
            "int8": torch.int8}[name]


def _quant_maps(index: FlatIndex):
    """Column -> scale-slot map of quantized admission, memoized on the
    index: ``col_of`` (N,) int32 sends each position to its segment's
    scale column and inert columns to the extra slot S, whose scale is 0
    (so they quantize and dequantize to exact zeros).  The port's one-device
    layout has no inert columns yet; the slot is kept so that a padded
    layout stays inert."""
    maps = getattr(index, "_quant_maps", None)
    if maps is None:
        seg_id, _, _ = _segment_maps(index)
        col_of = seg_id.astype(np.int32).copy()
        col_of[col_of < 0] = index.n_segments
        maps = index._quant_maps = (col_of,)
    return maps


def _inert_columns(index: FlatIndex, device) -> Optional[torch.Tensor]:
    """Boolean (N,) mask of the columns in scale slot S, or None if none."""
    (col_of,) = _quant_maps(index)
    inert = col_of == index.n_segments
    return torch.as_tensor(inert, device=device) if inert.any() else None


def _quantize_rows(y: torch.Tensor, update_dtype: str):
    """One leaf's (m, lead, rest) f32 rows in the admission dtype, with
    (m, lead) scales: int8 takes max|y|/127 per row (scale 0 on all-zero
    rows, which quantize to zeros); bf16 and f32 carry scale 1."""
    ones = lambda: torch.ones(y.shape[:2], dtype=torch.float32,
                              device=y.device)
    if update_dtype == "f32":
        return y, ones()
    if update_dtype == "bf16":
        return y.to(torch.bfloat16), ones()
    seg_max = torch.amax(torch.abs(y), dim=2)
    # true f32 divisions and round-half-to-even, as the reference writes
    # them (max is exact, so a per-row amax gives the reference's scatter-max)
    scales = seg_max / 127.0
    safe = torch.where(seg_max > 0, scales, 1.0)
    q = torch.clamp(torch.round(y / safe[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scales


def _dequantize_rows(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """f32 (m, lead, rest) of one leaf's quantized rows and (m, lead)
    scales."""
    return q.to(torch.float32) * scales[..., None]


def _leaf_rows(buf: torch.Tensor, spec: LeafSpec) -> torch.Tensor:
    """One leaf's block of an (m, N) buffer as an (m, lead, rest) view."""
    return buf[:, spec.offset:spec.offset + spec.size] \
        .view(buf.shape[0], spec.lead, spec.rest)


def quantize_cohort(index: FlatIndex, x: torch.Tensor, update_dtype: str):
    """Quantize a grafted, density-masked (m, N) f32 cohort to the
    admission dtype -> (x_q, scales (m, S) f32).  int8: symmetric
    per-(client, segment) scales, scale = max|x|/127 over the segment;
    all-zero segments keep scale 0.  bf16: a plain downcast with all-ones
    scales.  f32 passes through."""
    m = x.shape[0]
    want = update_dtype_of(update_dtype)
    if update_dtype != "int8":
        return x.to(want), torch.ones((m, index.n_segments),
                                      dtype=torch.float32, device=x.device)
    x_q = torch.empty((m, index.n), dtype=torch.int8, device=x.device)
    scales = torch.empty((m, index.n_segments), dtype=torch.float32,
                         device=x.device)
    for spec in index.leaves:
        q, s = _quantize_rows(_leaf_rows(x, spec), update_dtype)
        _leaf_rows(x_q, spec).copy_(q)
        scales[:, spec.seg0:spec.seg0 + spec.lead] = s
    inert = _inert_columns(index, x.device)
    if inert is not None:
        x_q[:, inert] = 0
    return x_q, scales


def dequantize_cohort(index: FlatIndex, x_q: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """f32 (m, N) of a quantized cohort: x_q · scale of its segment; inert
    columns read the scale-0 slot.  bf16 cohorts carry all-ones scales.
    For checks: admission and aggregation never build this (m, N)
    product."""
    out = torch.empty(x_q.shape, dtype=torch.float32, device=x_q.device)
    for spec in index.leaves:
        _leaf_rows(out, spec).copy_(_dequantize_rows(
            _leaf_rows(x_q, spec), scales[:, spec.seg0:spec.seg0 + spec.lead]))
    inert = _inert_columns(index, x_q.device)
    if inert is not None:
        out[:, inert] = 0.0
    return out


def admit_quantized(index: FlatIndex, cfg: ArchConfig, x: torch.Tensor,
                    masks: WidthMasks, gmaps: torch.Tensor, graft: bool,
                    state, update_dtype: str) -> None:
    """Quantized admission with server-side error feedback, in the order of
    the reference round (``repro.core.round._round_q``): graft the trained
    f32 cohort x (m, N) if ``graft``; y = (x + dequantize(e, e_s))·dens;
    (x_q, scales) = quantize(y); e' = y − dequantize(x_q, scales);
    (e, e_s) = quantize(e').  ``state`` = (x_q, scales, e, e_s) is updated
    in place.  Each leaf is done whole before the next, so no (m, N) f32
    transient exists: the per-element arithmetic, and so every bit, is
    that of the whole-buffer reference."""
    x_q, scales, e_q, e_s = state
    m = x.shape[0]
    axs = [dict(leaves_with_path(axis_mask_tree(cfg, masks.client(c))))
           for c in range(m)]
    rows = torch.arange(m, device=x.device)[:, None]
    for spec in index.leaves:
        segs = slice(spec.seg0, spec.seg0 + spec.lead)
        xl = _leaf_rows(x, spec)
        if graft and spec.stacked and spec.stage == 0:
            xl = xl[rows, gmaps]
        dens = torch.stack([mask_density(spec.shape, axs[c][spec.path])
                            for c in range(m)]).to(x.device)
        y = ((xl + _dequantize_rows(_leaf_rows(e_q, spec), e_s[:, segs]))
             .view(m, *spec.shape) * dens).view(m, spec.lead, spec.rest)
        q, s = _quantize_rows(y, update_dtype)
        e = y - _dequantize_rows(q, s)
        eq, es = _quantize_rows(e, update_dtype)
        _leaf_rows(x_q, spec).copy_(q)
        scales[:, segs] = s
        _leaf_rows(e_q, spec).copy_(eq)
        e_s[:, segs] = es


def _device_seg_id(index: FlatIndex, device) -> torch.Tensor:
    """The (N,) int32 segment id of every column on ``device`` (−1 on
    inert columns), memoized on the index."""
    cache = getattr(index, "_seg_ids", None)
    if cache is None:
        cache = index._seg_ids = {}
    key = torch.device(device)
    if key not in cache:
        cache[key] = torch.as_tensor(_segment_maps(index)[0], device=key)
    return cache[key]


def _rows_trimmed_stats(rows: torch.Tensor, q: torch.Tensor,
                        scale: Optional[torch.Tensor] = None,
                        use_kernel: Optional[bool] = None):
    """Per-row (quantile threshold, trimmed Σw²) of signed rows (m, R, L)
    with per-client levels q (m,) -> ((m, R), (m, R)).  ``scale`` (m, R)
    dequantizes quantized rows inside the kernels."""
    m, R, L = rows.shape
    t, sq = quant_ops.row_trimmed_stats(
        rows.reshape(m * R, L).contiguous(), torch.repeat_interleave(q, R),
        None if scale is None else scale.reshape(m * R).contiguous(),
        use_kernel)
    return t.reshape(m, R), sq.reshape(m, R)


def _cohort_norms(index: FlatIndex, xm: torch.Tensor, fracs: torch.Tensor,
                  trim: float, scales: Optional[torch.Tensor] = None,
                  use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Per-(client, segment) trimmed norms of the masked (m, N) updates with
    (m, n_leaves) active fractions -> (m, S).  ``scales`` (m, S) declares
    ``xm`` quantized: each leaf's rows carry their segments' scales."""
    m = xm.shape[0]
    cols = []
    for li, spec in enumerate(index.leaves):
        rows = xm[:, spec.offset:spec.offset + spec.size] \
            .reshape(m, spec.lead, spec.rest)
        # the trim-quantile of the active magnitudes is the
        # 1-(1-trim)·f quantile of the zero-padded row
        q = 1.0 - (1.0 - trim) * fracs[:, li]
        sc = None if scales is None else scales[:, spec.seg0:spec.seg0
                                                + spec.lead]
        _, sq = _rows_trimmed_stats(rows, q, sc, use_kernel)
        cols.append(torch.sqrt(sq))
    return torch.cat(cols, dim=1)


def aggregate_buffers(index: FlatIndex, g_flat: torch.Tensor, x: torch.Tensor,
                      cfg: ArchConfig, masks: WidthMasks, gates: torch.Tensor,
                      gmaps: torch.Tensor, n_data: torch.Tensor, *,
                      graft: bool = True, pregrafted: bool = False,
                      scale: bool = True,
                      scales: Optional[torch.Tensor] = None,
                      trim: float = 0.95, eps: float = 1e-12,
                      use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Alg. 1 in flat space: (N,) global + (m, N) cohort in, (N,) new global
    out.  ``masks``, ``gates`` (m, R), ``gmaps`` (m, R) and ``n_data`` (m,)
    are the stacked cohort runtimes.  Clients with n_data = 0 weigh nothing
    in either sum and are left out of the α mean.  ``pregrafted`` declares
    the rows grafted already (grafting weights stay in force).

    ``scales`` (m, S) switches to quantized admission: x is int8 or bf16,
    grafted and density-masked (``admit_quantized``); the norms read it
    through per-row scales and M' through ``accumulate_quant``'s
    per-(client, segment) table, so x is never dequantized in memory.  Γ
    is mask data, as on the f32 path.

    ``use_kernel`` chooses the kernels or their plain versions
    (``kernels.build.runs_plain``; None takes the kernels on the card)."""
    kc = dict(use_kernel=use_kernel)
    if scales is not None and graft and not pregrafted:
        raise ValueError("quantized cohorts must be grafted before "
                         "quantization (pass pregrafted=True)")
    m = x.shape[0]
    dens = torch.empty((m, index.n), dtype=torch.float32, device=x.device)
    fracs = torch.stack([_density_and_fraction(cfg, index, masks.client(c),
                                               out=dens[c])[1]
                         for c in range(m)])
    if scales is None:
        x_g = _graft_flat(index, x, gmaps) if graft and not pregrafted \
            else x.clone()
    else:   # quantized rows arrive grafted and density-masked
        x_g = x

    dwrow = None   # grafting weights every depth slot equally
    if not graft:  # depth gates weight stage-0 rows; everything else 1
        stage0 = torch.as_tensor(index.seg_stage0, device=x.device)
        seg_row = torch.as_tensor(index.seg_row, dtype=torch.int64,
                                  device=x.device).clamp(max=gates.shape[1] - 1)
        dwrow = torch.where(stage0[None, :], gates[:, seg_row], 1.0)

    if scales is None:
        x_g.mul_(dens)                               # x_g is now x_g·dens
    warow = dwrow
    if scale:
        norms = _cohort_norms(index, x_g, fracs, trim, scales, **kc)  # (m, S)
        valid = (n_data > 0).to(torch.float32)
        mean_norms = torch.sum(valid[:, None] * norms, dim=0, keepdim=True) \
            / torch.clamp_min(torch.sum(valid), 1.0)
        alpha = mean_norms / torch.clamp_min(norms, eps)
        warow = alpha if dwrow is None else dwrow * alpha
    ones_n = torch.ones(index.n, dtype=torch.float32, device=x.device)
    if scales is None:
        contrib = x_g if warow is None else _scale_segments(index, x_g, warow)
        Mp = agg_ops.scaled_accum(contrib, n_data, ones_n, **kc)
        del contrib
    else:   # scale·α·gate fold into one (m, S) table read inside the kernel
        coeff = scales if warow is None else warow * scales
        Mp = agg_ops.accumulate_quant(x_g, n_data, coeff,
                                      _device_seg_id(index, x.device), ones_n,
                                      **kc)
    del x_g
    counts = dens if dwrow is None else _scale_segments(index, dens, dwrow)
    Gm = agg_ops.scaled_accum(counts, n_data, ones_n, **kc)
    upd = Mp / torch.clamp_min(Gm, eps)
    return torch.where(Gm > 0, upd, g_flat)        # γ = 0 keeps the global
