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

Single device, f32 admission; the mesh, padding and quantized paths of
``repro.core.flat`` are not yet ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.masking import active_fraction, axis_mask_tree, mask_density
from repro_torch.kernels.fedfa_agg import ops as agg_ops
from repro_torch.kernels.fedfa_quantile import ops as quant_ops
from repro_torch.models.masks import WidthMasks
from repro_torch.tree import from_paths, leaves, leaves_with_path

Params = Dict[str, Any]


def _path_stage_info(path) -> Tuple[bool, Optional[int]]:
    """(is_depth_stacked, stage index) of a parameter path."""
    if path[0] == "stages":
        return True, path[1]
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


def _rows_trimmed_stats(rows: torch.Tensor, q: torch.Tensor):
    """Per-row (quantile threshold, trimmed Σw²) of signed rows (m, R, L)
    with per-client levels q (m,) -> ((m, R), (m, R))."""
    m, R, L = rows.shape
    t, sq = quant_ops.row_trimmed_stats(rows.reshape(m * R, L).contiguous(),
                                        torch.repeat_interleave(q, R))
    return t.reshape(m, R), sq.reshape(m, R)


def _cohort_norms(index: FlatIndex, xm: torch.Tensor, fracs: torch.Tensor,
                  trim: float) -> torch.Tensor:
    """Per-(client, segment) trimmed norms of the masked (m, N) updates with
    (m, n_leaves) active fractions -> (m, S)."""
    m = xm.shape[0]
    cols = []
    for li, spec in enumerate(index.leaves):
        rows = xm[:, spec.offset:spec.offset + spec.size] \
            .reshape(m, spec.lead, spec.rest)
        # the trim-quantile of the active magnitudes is the
        # 1-(1-trim)·f quantile of the zero-padded row
        q = 1.0 - (1.0 - trim) * fracs[:, li]
        _, sq = _rows_trimmed_stats(rows, q)
        cols.append(torch.sqrt(sq))
    return torch.cat(cols, dim=1)


def aggregate_buffers(index: FlatIndex, g_flat: torch.Tensor, x: torch.Tensor,
                      cfg: ArchConfig, masks: WidthMasks, gates: torch.Tensor,
                      gmaps: torch.Tensor, n_data: torch.Tensor, *,
                      graft: bool = True, scale: bool = True,
                      trim: float = 0.95, eps: float = 1e-12) -> torch.Tensor:
    """Alg. 1 in flat space: (N,) global + (m, N) cohort in, (N,) new global
    out.  ``masks``, ``gates`` (m, R), ``gmaps`` (m, R) and ``n_data`` (m,)
    are the stacked cohort runtimes.  Clients with n_data = 0 weigh nothing
    in either sum and are left out of the α mean."""
    m = x.shape[0]
    dens = torch.empty_like(x)
    fracs = torch.stack([_density_and_fraction(cfg, index, masks.client(c),
                                               out=dens[c])[1]
                         for c in range(m)])
    x_g = _graft_flat(index, x, gmaps) if graft else x.clone()

    dwrow = None   # grafting weights every depth slot equally
    if not graft:  # depth gates weight stage-0 rows; everything else 1
        stage0 = torch.as_tensor(index.seg_stage0, device=x.device)
        seg_row = torch.as_tensor(index.seg_row, dtype=torch.int64,
                                  device=x.device).clamp(max=gates.shape[1] - 1)
        dwrow = torch.where(stage0[None, :], gates[:, seg_row], 1.0)

    x_g.mul_(dens)                                   # x_g is now x_g·dens
    warow = dwrow
    if scale:
        norms = _cohort_norms(index, x_g, fracs, trim)             # (m, S)
        valid = (n_data > 0).to(torch.float32)
        mean_norms = torch.sum(valid[:, None] * norms, dim=0, keepdim=True) \
            / torch.clamp_min(torch.sum(valid), 1.0)
        alpha = mean_norms / torch.clamp_min(norms, eps)
        warow = alpha if dwrow is None else dwrow * alpha
    ones_n = torch.ones(index.n, dtype=torch.float32, device=x.device)
    contrib = x_g if warow is None else _scale_segments(index, x_g, warow)
    Mp = agg_ops.scaled_accum(contrib, n_data, ones_n)
    del contrib, x_g
    counts = dens if dwrow is None else _scale_segments(index, dens, dwrow)
    Gm = agg_ops.scaled_accum(counts, n_data, ones_n)
    upd = Mp / torch.clamp_min(Gm, eps)
    return torch.where(Gm > 0, upd, g_flat)        # γ = 0 keeps the global
