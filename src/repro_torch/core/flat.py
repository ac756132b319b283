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

With a mesh (``launch.mesh``, laid out by ``sharding.cohort``) each rank
holds its rows of the cohort, and the parameter axis is padded by
``FlatIndex(pad_to=)`` with an inert zero tail.  With model shards and the
kernel route the aggregation runs 2-D: densities, the distributed
trimmed-norm pass (``segmented_trimmed_stats`` with histogram planes
all-reduced over ``model``) and both (M', γ) sums take the rank's
(m/D, N/M) slice, and each sum ends in one N/M all-reduce over ``data``.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.core.masking import (active_fraction, axis_mask_tree,
                                      mask_density)
from repro_torch.kernels.fedfa_agg import ops as agg_ops
from repro_torch.kernels.fedfa_agg import ref as agg_ref
from repro_torch.kernels.fedfa_quantile import multilevel as quant_ml
from repro_torch.kernels.fedfa_quantile import ops as quant_ops
from repro_torch.models.masks import WidthMasks
from repro_torch.sharding import cohort as csh
from repro_torch.sharding import collectives as coll
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

    ``pad_to`` rounds the flat length up to a multiple of it
    (``n_padded``; ``sharding.cohort.pad_unit`` for a mesh), so that the
    (N,) axis divides evenly over ``model``.  The tail [n, n_padded) is
    inert: zeros in every buffer, density 0 (so the γ = 0 rule keeps the
    merged global at zero there), segment id −1 and an identity graft, and
    no ``LeafSpec`` covers it, so no norm or α sees it.  Leaf offsets do
    not depend on the padding.
    """

    def __init__(self, params: Params, pad_to: int = 1):
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
        self.n_padded = off + (-off) % max(int(pad_to), 1)
        # the tail's row_of is 0 so that weight gathers stay in bounds; the
        # segment map marks it −1 (``_segment_maps``)
        row_of.append(np.zeros(self.n_padded - off, np.int32))
        self.row_of = np.concatenate(row_of)
        self.seg_row = np.asarray(seg_row, np.int32)
        self.seg_stage0 = np.asarray(seg_stage0)


def _segment_maps(index: FlatIndex):
    """(seg_id (n_padded,) int32, seg_len (S,), leaf_of_seg (S,)): the
    per-position segment map of the segmented quantile, −1 on the inert
    tail."""
    seg_len = np.zeros(index.n_segments, np.int32)
    leaf_of = np.zeros(index.n_segments, np.int32)
    for li, spec in enumerate(index.leaves):
        seg_len[spec.seg0:spec.seg0 + spec.lead] = spec.rest
        leaf_of[spec.seg0:spec.seg0 + spec.lead] = li
    seg_id = index.row_of.astype(np.int32)
    seg_id[index.n:] = -1
    return seg_id, seg_len, leaf_of


def _pieces(index: FlatIndex, cols: slice) -> List[Tuple[int, int, int,
                                                         int, int]]:
    """The columns ``cols`` of the layout cut into pieces of whole segment
    rows: (s0, k, rest, a, b) says that local columns [a, b) are k
    segments s0.. of ``rest`` columns each.  A leaf whose rows all lie in
    ``cols`` is one piece; a row cut by an edge of ``cols`` is a piece of
    its own (k = 1, rest its columns there).  The inert tail lies in
    none."""
    lo, hi = cols.start, cols.stop
    out = []
    for spec in index.leaves:
        a, b = max(spec.offset, lo), min(spec.offset + spec.size, hi)
        if a >= b:
            continue
        rest = spec.rest
        j0, j1 = (a - spec.offset) // rest, (b - spec.offset - 1) // rest
        start = spec.offset + j0 * rest
        if a > start or j0 == j1:            # a cut (or lone) first row
            e = min(b, start + rest)
            out.append((spec.seg0 + j0, 1, e - a, a - lo, e - lo))
            a, j0 = e, j0 + 1
        if a >= b:
            continue
        full = (b - spec.offset) // rest      # rows that end inside cols
        if full > j0:
            e = spec.offset + full * rest
            out.append((spec.seg0 + j0, full - j0, rest, a - lo, e - lo))
            a = e
        if a < b:                             # a cut last row
            out.append((spec.seg0 + full, 1, b - a, a - lo, b - lo))
    return out


def _piece_rows(buf: torch.Tensor, piece) -> torch.Tensor:
    """A piece of an (m, C) buffer as an (m, k, rest) view."""
    s0, k, rest, a, b = piece
    return buf[:, a:b].view(buf.shape[0], k, rest)


def _check_layout(index: FlatIndex, xs, drop: int) -> None:
    if len(xs) != len(index.leaves) or any(
            tuple(x.shape[drop:]) != s.shape for x, s in zip(xs, index.leaves)):
        raise ValueError("tree structure does not match FlatIndex layout")


def flatten(index: FlatIndex, tree: Params,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pack one tree into a contiguous (n_padded,) f32 buffer (zeros on
    the inert tail), into ``out`` if given (a preallocated buffer or a row
    of one)."""
    xs = leaves(tree)
    _check_layout(index, xs, drop=0)
    if out is None:
        out = torch.empty(index.n_padded, dtype=torch.float32,
                          device=xs[0].device)
    for x, s in zip(xs, index.leaves):
        out[s.offset:s.offset + s.size].copy_(x.reshape(-1))
    out[index.n:].zero_()
    return out


def flatten_stacked(index: FlatIndex, tree: Params) -> torch.Tensor:
    """Pack a client-stacked tree (leading axis m) into (m, n_padded) f32
    (zeros on the inert tail)."""
    xs = leaves(tree)
    _check_layout(index, xs, drop=1)
    m = xs[0].shape[0]
    parts = [x.reshape(m, -1).to(torch.float32) for x in xs]
    parts.append(torch.zeros((m, index.n_padded - index.n),
                             dtype=torch.float32, device=xs[0].device))
    return torch.cat(parts, dim=1)


def unflatten(index: FlatIndex, buf: torch.Tensor) -> Params:
    """Unpack an (n_padded,) buffer into the tree with the original leaf
    dtypes, the inert tail dropped; f32 leaves are views of ``buf``."""
    return from_paths(
        [s.path for s in index.leaves],
        [buf[s.offset:s.offset + s.size].view(s.shape).to(s.dtype)
         for s in index.leaves])


def unflatten_stacked(index: FlatIndex, buf: torch.Tensor) -> Params:
    """Unpack an (m, n_padded) buffer into a client-stacked tree (leading
    axis m) with the original leaf dtypes; f32 leaves are views of
    ``buf``."""
    m = buf.shape[0]
    return from_paths(
        [s.path for s in index.leaves],
        [buf[:, s.offset:s.offset + s.size].view((m,) + s.shape).to(s.dtype)
         for s in index.leaves])


def _density_and_fraction(cfg: ArchConfig, index: FlatIndex, mk: WidthMasks,
                          out: Optional[torch.Tensor] = None,
                          cols: Optional[slice] = None):
    """One client's flat 0/1 width-mask density on the columns ``cols``
    (all of them by default; 0 on the inert tail) and its per-leaf active
    fraction (n_leaves,); the density is written into ``out`` if given."""
    cols = cols or slice(0, index.n_padded)
    lo, hi = cols.start, cols.stop
    ax = dict(leaves_with_path(axis_mask_tree(cfg, mk)))
    if out is None:
        out = torch.empty(hi - lo, dtype=torch.float32,
                          device=mk.d_model.device)
    out[max(index.n, lo) - lo:].zero_()         # the inert tail
    fracs = []
    for spec in index.leaves:
        d = mask_density(spec.shape, ax[spec.path])
        a, b = max(spec.offset, lo), min(spec.offset + spec.size, hi)
        if a == spec.offset and b == spec.offset + spec.size:
            out[a - lo:b - lo].view(spec.shape).copy_(d)
        elif a < b:        # a leaf cut by the columns' edge
            out[a - lo:b - lo].copy_(torch.broadcast_to(d, spec.shape)
                                     .reshape(-1)[a - spec.offset:
                                                  b - spec.offset])
        fracs.append(active_fraction(ax[spec.path]).to(out.device))
    return out, torch.stack(fracs)


def _density_rows(cfg: ArchConfig, index: FlatIndex, masks: WidthMasks,
                  cols: slice, device):
    """(dens (m, C) on ``cols``, fracs (m, n_leaves)) of a stacked
    cohort."""
    m = masks.d_model.shape[0]
    dens = torch.empty((m, cols.stop - cols.start), dtype=torch.float32,
                       device=device)
    fracs = torch.stack([_density_and_fraction(cfg, index, masks.client(c),
                                               out=dens[c], cols=cols)[1]
                         for c in range(m)])
    return dens, fracs


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


def _scale_segments(index: FlatIndex, x: torch.Tensor, w: torch.Tensor,
                    cols: Optional[slice] = None) -> torch.Tensor:
    """In place x[c, n] *= w[c, segment of n] for an (m, C) buffer on the
    columns ``cols`` (all by default) and an (m, S) per-segment table."""
    for p in _pieces(index, cols or slice(0, index.n_padded)):
        _piece_rows(x, p).mul_(w[:, p[0]:p[0] + p[1], None])
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
    index: ``col_of`` (n_padded,) int32 sends each position to its
    segment's scale column and the inert tail to the extra slot S, whose
    scale is 0 (so it quantizes and dequantizes to exact zeros)."""
    maps = getattr(index, "_quant_maps", None)
    if maps is None:
        seg_id, _, _ = _segment_maps(index)
        col_of = seg_id.astype(np.int32).copy()
        col_of[col_of < 0] = index.n_segments
        maps = index._quant_maps = (col_of,)
    return maps


def _inert_columns(index: FlatIndex, device) -> Optional[torch.Tensor]:
    """Boolean (n_padded,) mask of the columns in scale slot S, or None if
    none."""
    (col_of,) = _quant_maps(index)
    inert = col_of == index.n_segments
    return torch.as_tensor(inert, device=device) if inert.any() else None


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
    x_q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((m, index.n_segments), dtype=torch.float32,
                         device=x.device)
    for spec in index.leaves:
        y = _leaf_rows(x, spec)
        q, s = agg_ref.int8_rows(y, torch.amax(torch.abs(y), dim=2))
        _leaf_rows(x_q, spec).copy_(q)
        scales[:, spec.seg0:spec.seg0 + spec.lead] = s
    inert = _inert_columns(index, x.device)
    if inert is not None:
        x_q[:, inert] = 0
    return x_q, scales


def dequantize_cohort(index: FlatIndex, x_q: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """f32 (m, n_padded) of a quantized cohort: x_q · scale of its segment;
    inert columns read the scale-0 slot.  bf16 cohorts carry all-ones scales.
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


def _admit_factors(cfg: ArchConfig, index: FlatIndex, masks: WidthMasks,
                   m: int, device):
    """The cohort's width-mask vectors as one (m, F) f32 factor table (each
    vector once, at a column that is a multiple of 4, zero-padded to one)
    and, per leaf, the (column, leaf axis, length) of each vector whose
    product along the leaf's axes is its density (``mask_density``'s
    factors, in its order)."""
    axs = [dict(leaves_with_path(axis_mask_tree(cfg, masks.client(c))))
           for c in range(m)]
    at, parts, per_leaf, width = {}, [], [], 0
    for spec in index.leaves:
        ms, factors = axs[0][spec.path].ms, []
        for i, mv in enumerate(ms):
            if mv is None:
                continue
            vs = [axs[c][spec.path].ms[i] for c in range(m)]
            key = tuple(map(id, vs))
            if key not in at:
                dim = mv.shape[0]
                at[key] = width
                parts.append(torch.stack(vs).to(device))
                if dim % 4:
                    parts.append(torch.zeros((m, -dim % 4), device=device))
                width += dim + -dim % 4
            factors.append((at[key], len(spec.shape) - len(ms) + i,
                            mv.shape[0]))
        per_leaf.append(tuple(factors))
    fac = torch.cat(parts, 1) if parts else \
        torch.zeros((m, 0), device=device)
    return fac, tuple(per_leaf)


def _admit_plan(index: FlatIndex, cols: slice, per_leaf,
                n_factor_cols: int) -> agg_ops.AdmitPlan:
    """The admission's pieces (``_pieces`` of ``cols``) with their leaves'
    layout and density factors, memoized on the index."""
    memo = index.__dict__.setdefault("_admit_plans", {})
    key = (cols.start, cols.stop, per_leaf, n_factor_cols)
    if key not in memo:
        seg0s = [spec.seg0 for spec in index.leaves]
        pieces = []
        for s0, k, rest, a, _ in _pieces(index, cols):
            li = bisect.bisect_right(seg0s, s0) - 1
            spec = index.leaves[li]
            j = s0 - spec.seg0
            pieces.append(agg_ops.AdmitPiece(
                s0, k, rest, a, spec.offset, spec.lead, spec.rest, j,
                cols.start + a - spec.offset - j * spec.rest, spec.stacked,
                spec.stacked and spec.stage == 0, spec.shape,
                per_leaf[li]))
        memo[key] = agg_ops.AdmitPlan(pieces, n_factor_cols)
    return memo[key]


def admit_quantized(index: FlatIndex, cfg: ArchConfig, x: torch.Tensor,
                    masks: WidthMasks, gmaps: torch.Tensor, graft: bool,
                    state, update_dtype: str, mesh=None,
                    cols: Optional[slice] = None) -> None:
    """Quantized admission with server-side error feedback, in the order of
    the reference round (``repro.core.round._round_q``): graft the trained
    f32 cohort x (m, n_padded) if ``graft``; y = (x + dequantize(e,
    e_s))·dens; (x_q, scales) = quantize(y); e' = y − dequantize(x_q,
    scales); (e, e_s) = quantize(e').  ``state`` = (x_q, scales, e, e_s) is
    updated in place.  int8 and bf16 go through ``agg_ops.quant_admit``
    (the kernel on the card, its plain version on the CPU): three streaming
    steps over every piece (``_pieces``: whole leaves where no edge cuts
    them) at int8 — y's maxima, the residual's maxima, then the writes —
    and the last alone at bf16, so no (m, N) f32 transient exists: the
    per-element arithmetic, and so every bit, is that of the whole-buffer
    reference.  f32 goes piece by piece through the plain version's rows.

    ``cols`` (a rank's P("model") columns, with ``mesh``; all by default):
    the state holds only those columns, while x is still whole rows.  The
    int8 scales of every segment then come from maxima all-reduced over
    ``model`` (one all-reduce for y's, one for the residual's), so a
    segment cut by a shard's edge is quantized as on one device and every
    rank holds the whole (m, S) scale tables."""
    with tracing.span("admit"):
        x_q, scales, e_q, e_s = state
        cols = cols or slice(0, index.n_padded)
        m = x.shape[0]
        fac, per_leaf = _admit_factors(cfg, index, masks, m, x.device)
        plan = _admit_plan(index, cols, per_leaf, fac.shape[1])
        gmaps = gmaps.to(device=x.device, dtype=torch.int64).contiguous()
        fused = update_dtype != "f32"
        tracing.count("admit_pieces_fused", len(plan.pieces) if fused else 0)
        tracing.count("admit_pieces_plain", 0 if fused else len(plan.pieces))
        if update_dtype == "int8":
            y_max = torch.zeros((m, index.n_segments), device=x.device)
            e_max = torch.zeros_like(y_max)
            sharded = cols != slice(0, index.n_padded)
            args = (x, gmaps, graft, fac, e_q, e_s, x_q, y_max, e_max, plan)
            agg_ops.quant_admit(1, *args)
            if sharded:
                coll.all_reduce(y_max, mesh, csh.MODEL_AXIS, op="max")
            agg_ops.quant_admit(2, *args)
            if sharded:
                coll.all_reduce(e_max, mesh, csh.MODEL_AXIS, op="max")
            agg_ops.quant_admit(3, *args)
            # every segment's scales, those with no column here too (step
            # 3 has read the old e_s)
            scales.copy_(y_max / 127.0)
            e_s.copy_(e_max / 127.0)
            return
        if fused:
            agg_ops.quant_admit(3, x, gmaps, graft, fac, e_q, e_s, x_q, None,
                                None, plan)
        else:
            for p in plan.pieces:
                y = agg_ref.admit_rows(x, gmaps, fac, e_q, e_s, p, graft)
                piece = slice(p.a, p.a + p.k * p.rest)
                x_q[:, piece] = y.view(m, -1)
                e_q[:, piece] = (y - y).view(m, -1)
        scales[:, plan.segments] = 1.0
        e_s[:, plan.segments] = 1.0


def _device_seg_id(index: FlatIndex, device) -> torch.Tensor:
    """The (n_padded,) int32 segment id of every column on ``device`` (−1
    on the inert tail), memoized on the index."""
    cache = getattr(index, "_seg_ids", None)
    if cache is None:
        cache = index._seg_ids = {}
    key = torch.device(device)
    if key not in cache:
        cache[key] = torch.as_tensor(_segment_maps(index)[0], device=key)
    return cache[key]


def two_d(index: FlatIndex, mesh, use_kernel: Optional[bool]) -> bool:
    """Does the aggregation run 2-D on this mesh?  As in the reference:
    model shards, the kernel route (the kernels on the card, their plain
    versions on the CPU; not ``use_kernel=False``) and n_padded a multiple
    of M x 512 (``sharding.cohort.pad_unit``)."""
    ms = csh.model_shards(mesh)
    return (ms > 1 and use_kernel is not False
            and index.n_padded % (ms * csh.TILE) == 0)


def pool_cols(index: FlatIndex, mesh, use_kernel: Optional[bool]) -> slice:
    """The columns a rank keeps of its cohort rows between rounds: its
    P("model") slice where the aggregation runs 2-D, else all of them."""
    if two_d(index, mesh, use_kernel):
        return csh.model_cols(mesh, index.n_padded)
    return slice(0, index.n_padded)


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


def _cohort_stats(index: FlatIndex, xm: torch.Tensor, fracs: torch.Tensor,
                  trim: float, scales: Optional[torch.Tensor] = None,
                  use_kernel: Optional[bool] = None, mesh=None,
                  cols: Optional[slice] = None):
    """Per-(client, segment) trimmed-quantile thresholds and trimmed Σw² of
    the masked updates xm with (m, n_leaves) active fractions -> (t, ss),
    both (m, S).  ``scales`` (m, S) declares xm quantized.

    By default xm holds whole rows (m, n_padded) and each leaf's rows go
    to ``row_trimmed_stats`` with no collective.  With ``cols`` xm holds
    those columns of a model-sharded layout and the pass is 2-D: the
    segmented multilevel quantile over the local columns, its histogram
    planes all-reduced over ``model``."""
    if cols is not None:
        seg_id, seg_len, leaf_of = _segment_maps(index)
        q_seg = 1.0 - (1.0 - trim) * fracs[:, torch.as_tensor(
            leaf_of, dtype=torch.int64, device=fracs.device)]
        return quant_ml.segmented_trimmed_stats(
            xm, _device_seg_id(index, xm.device)[cols],
            torch.as_tensor(seg_len, dtype=torch.int64, device=xm.device),
            q_seg, scales, use_kernel, mesh=mesh)
    m = xm.shape[0]
    ts, sqs = [], []
    for li, spec in enumerate(index.leaves):
        rows = xm[:, spec.offset:spec.offset + spec.size] \
            .reshape(m, spec.lead, spec.rest)
        # the trim-quantile of the active magnitudes is the
        # 1-(1-trim)·f quantile of the zero-padded row
        q = 1.0 - (1.0 - trim) * fracs[:, li]
        sc = None if scales is None else scales[:, spec.seg0:spec.seg0
                                                + spec.lead]
        t, sq = _rows_trimmed_stats(rows, q, sc, use_kernel)
        ts.append(t)
        sqs.append(sq)
    return torch.cat(ts, dim=1), torch.cat(sqs, dim=1)


def aggregate_buffers(index: FlatIndex, g_flat: torch.Tensor, x: torch.Tensor,
                      cfg: ArchConfig, masks: WidthMasks, gates: torch.Tensor,
                      gmaps: torch.Tensor, n_data: torch.Tensor, *,
                      graft: bool = True, pregrafted: bool = False,
                      scale: bool = True,
                      scales: Optional[torch.Tensor] = None,
                      trim: float = 0.95, eps: float = 1e-12,
                      use_kernel: Optional[bool] = None,
                      mesh=None) -> torch.Tensor:
    """Alg. 1 in flat space: (n_padded,) global + (m, n_padded) cohort in,
    new global out.  ``masks``, ``gates`` (m, R), ``gmaps`` (m, R) and
    ``n_data`` (m,) are the stacked cohort runtimes.  Clients with n_data
    = 0 weigh nothing in either sum and are left out of the α mean.
    ``pregrafted`` declares the rows grafted already (grafting weights
    stay in force).

    ``scales`` (m, S) switches to quantized admission: x is int8 or bf16,
    grafted and density-masked (``admit_quantized``); the norms read it
    through per-row scales and M' through ``accumulate_quant``'s
    per-(client, segment) table, so x is never dequantized in memory.  Γ
    is mask data, as on the f32 path.

    With ``mesh`` every argument is this rank's: its rows of the cohort
    and its runtimes, and ``g_flat`` its ``sharding.cohort.model_cols``
    slice of the global, which is what it gets back.  x holds whole rows
    (grafted here unless ``pregrafted``) or only the rank's ``pool_cols``.
    Where ``two_d`` holds, densities, the norms pass and both sums run on
    the (m/D, N/M) slice; otherwise on whole rows, and ``accumulate``
    reduce-scatters over ``model``.  The α mean and both sums all-reduce
    over ``data``.

    ``use_kernel`` chooses the kernels or their plain versions
    (``kernels.build.runs_plain``; None takes the kernels on the card)."""
    kc = dict(use_kernel=use_kernel, mesh=mesh)
    if scales is not None and graft and not pregrafted:
        raise ValueError("quantized cohorts must be grafted before "
                         "quantization (pass pregrafted=True)")
    is_2d = two_d(index, mesh, use_kernel)
    cols = pool_cols(index, mesh, use_kernel)
    width = cols.stop - cols.start
    if x.shape[1] not in (index.n_padded, width):
        raise ValueError(f"cohort rows of {x.shape[1]} columns: expected "
                         f"{index.n_padded} or this rank's {width}")
    with tracing.span("aggregate"):
        with tracing.span("aggregate/densities"):
            dens, fracs = _density_rows(cfg, index, masks, cols, x.device)
        if scales is None:
            with tracing.span("aggregate/graft"):
                if graft and not pregrafted:
                    if x.shape[1] != index.n_padded:
                        raise ValueError("grafting needs whole rows")
                    x_g = _graft_flat(index, x, gmaps)
                    if width != index.n_padded:
                        x_g = x_g[:, cols].contiguous()
                else:
                    x_g = (x[:, cols] if x.shape[1] != width else x).clone(
                        memory_format=torch.contiguous_format)
                x_g.mul_(dens)                       # x_g is now x_g·dens
        else:   # quantized rows arrive grafted and density-masked
            x_g = x if x.shape[1] == width else x[:, cols].contiguous()

        dwrow = None   # grafting weights every depth slot equally
        if not graft:  # depth gates weight stage-0 rows; everything else 1
            stage0 = torch.as_tensor(index.seg_stage0, device=x.device)
            seg_row = torch.as_tensor(index.seg_row, dtype=torch.int64,
                                      device=x.device).clamp(
                                          max=gates.shape[1] - 1)
            dwrow = torch.where(stage0[None, :], gates[:, seg_row], 1.0)

        warow = dwrow
        if scale:
            with tracing.span("aggregate/norms"):
                _, ss = _cohort_stats(index, x_g, fracs, trim, scales,
                                      use_kernel, mesh,
                                      cols if is_2d else None)
                norms = torch.sqrt(ss)                              # (m, S)
                valid = (n_data > 0).to(torch.float32)
                sums = torch.cat([torch.sum(valid[:, None] * norms, dim=0),
                                  torch.sum(valid)[None]])
                if mesh is not None:   # the mean over every real row
                    coll.all_reduce(sums, mesh, csh.DATA_AXIS)
                mean_norms = sums[None, :-1] / torch.clamp_min(sums[-1], 1.0)
                alpha = mean_norms / torch.clamp_min(norms, eps)
                warow = alpha if dwrow is None else dwrow * alpha
        with tracing.span("aggregate/accumulate"):
            ones_n = torch.ones(width, dtype=torch.float32, device=x.device)
            if scales is None:
                contrib = x_g if warow is None else _scale_segments(
                    index, x_g, warow, cols)
                Mp = agg_ops.accumulate(contrib, n_data, ones_n,
                                        cohort_2d=is_2d, **kc)
                del contrib
            else:   # scale·α·gate fold into one (m, S) table in the kernel
                coeff = scales if warow is None else warow * scales
                Mp = agg_ops.accumulate_quant(
                    x_g, n_data, coeff, _device_seg_id(index, x.device)[cols],
                    ones_n, cohort_2d=is_2d, **kc)
            del x_g
            counts = dens if dwrow is None else _scale_segments(
                index, dens, dwrow, cols)
            Gm = agg_ops.accumulate(counts, n_data, ones_n, cohort_2d=is_2d,
                                    **kc)
            upd = Mp / torch.clamp_min(Gm, eps)
            return torch.where(Gm > 0, upd, g_flat)  # γ = 0 keeps the global
