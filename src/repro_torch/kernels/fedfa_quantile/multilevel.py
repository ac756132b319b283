"""Multilevel (byte-histogram) trimmed quantile for rows of any length.

A 256-ary count-and-partition search over the IEEE-754 bit pattern of |x|:
level j histograms byte 3−j of the elements whose higher bytes match the
prefix resolved so far, so four levels resolve the exact order statistics
(bit-equal to jnp.quantile's).  Each level also accumulates per-bin Σx²;
summed strictly below the chosen bin at inner levels and inclusively at the
last, they give S(v) = Σ x²·[x <= v] for both bracketing statistics without
another pass.  One CUDA kernel (``csrc/hist_level.cu``) builds a level's
histogram planes, whose Σx² are exact integers in each bin's units
(``ref.fixed_square``), so their order of addition does not matter; the
level loop, the scaling to f32 (``ref.scale_sums``), cumulative sums and
bin pick stay here.

The kernel keeps at most ``MAX_SEGMENTS`` segments' planes in shared
memory, so the level loop cuts the segments into fixed groups of at most
that many by segment id and launches once per group on the group's
columns.  On a mesh the level's planes are all-reduced over ``model``
before the bin pick, so every rank follows the same search while holding
only its own columns: the integer planes sum exactly, so the search and
its Σx² are the unsharded ones bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch import tracing
from repro_torch.kernels.build import (DTYPE_CODES, CudaKernel, check_input,
                                       kernel_scope, runs_plain, stream_of)
from repro_torch.kernels.fedfa_quantile import ref

_BINS = 256
_LEVELS = 4
_PATHS = 2      # floor and ceil ranks bracketing the quantile position
# the kernel keeps 2 x S x 256 planes (an int32 count and a sum in two
# 32-bit words) in one block's shared memory, 6 KiB per segment of the
# 227 KB a block can use (and a copy per warp up to S = 4)
MAX_SEGMENTS = 37

HIST_LEVEL = CudaKernel(
    "hist_level.cu", "hist_level",
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
    + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
       ctypes.c_int, ctypes.c_void_p])

def kernel_rows(x: torch.Tensor, scale: Optional[torch.Tensor]):
    """(rows, element-type code) as the quantile kernels read ``x``: f32
    rows as they are; int8 / bf16 rows with scales in their own dtype (the
    kernels dequantize them); int8 / bf16 rows without scales upcast to
    f32, as the reference upcasts them.  Raises on any other dtype."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"rows of dtype {x.dtype}: the quantile kernels take "
                        f"f32, int8 or bf16")
    if scale is None:
        x = x.to(torch.float32)
    return x, DTYPE_CODES[x.dtype]


def hist_level_planes(x: torch.Tensor, seg_id: torch.Tensor,
                      hi: torch.Tensor, shift: int,
                      sc: Optional[torch.Tensor] = None,
                      use_kernel: Optional[bool] = None):
    """One level's histogram planes: x (m, C) f32, seg_id (C,) int32 (−1
    inert), hi (m, 2, S) int32 -> counts (m, 2, S, 256) int32 and exact
    Σx² (m, 2, S, 256) int64 in each bin's units (see
    ``ref.hist_level_planes_ref``; ``ref.scale_sums`` makes them f32).
    With ``sc`` (m, S) f32 the rows may be int8 or bf16, binned as
    |x·sc[row, seg]|; without it such rows are upcast to f32 first."""
    if x.dim() != 2 or hi.dim() != 3:
        raise ValueError(f"hist_level takes x (m, C) and hi (m, 2, S), got "
                         f"{tuple(x.shape)} and {tuple(hi.shape)}")
    x, code = kernel_rows(x, sc)
    m, C = x.shape
    S = hi.shape[2]
    check_input("x", x, x.dtype, (m, C), x.device)
    check_input("seg_id", seg_id, torch.int32, (C,), x.device)
    check_input("hi", hi, torch.int32, (m, 2, S), x.device)
    if sc is not None:
        check_input("sc", sc, torch.float32, (m, S), x.device)
    with kernel_scope("hist_level", x, seg_id, hi, sc):
        if runs_plain(x, use_kernel):
            return ref.hist_level_planes_ref(x, seg_id, hi, shift, sc)
        if not 1 <= S <= MAX_SEGMENTS or m > 65535:
            raise ValueError(f"hist_level takes 1..{MAX_SEGMENTS} segments "
                             f"and at most 65535 rows, got S={S}, m={m}")
        ref.check_row_length(C)
        cnt = torch.zeros((m, 2, S, _BINS), dtype=torch.int32, device=x.device)
        sq = torch.zeros((m, 2, S, _BINS), dtype=torch.int64, device=x.device)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        HIST_LEVEL.launch(x.data_ptr(), code, seg_id.data_ptr(),
                          None if sc is None else sc.data_ptr(), hi.data_ptr(),
                          cnt.data_ptr(), sq.data_ptr(), m, C, S, shift, sms,
                          stream_of(x), shape=(m, C, shift))
        return cnt, sq


def hist_level(x: torch.Tensor, seg_id: torch.Tensor, hi: torch.Tensor,
               shift: int, sc: Optional[torch.Tensor] = None,
               use_kernel: Optional[bool] = None):
    """``hist_level_planes`` with its Σx² planes scaled to f32: counts
    (m, 2, S, 256) int32 and Σx² (m, 2, S, 256) f32 (see
    ``ref.hist_level_ref``, to which the kernel's result is bit-equal)."""
    cnt, sq = hist_level_planes(x, seg_id, hi, shift, sc, use_kernel)
    return cnt, ref.scale_sums(sq, hi, shift)


def segmented_trimmed_stats(x: torch.Tensor, seg_id: torch.Tensor,
                            seg_len: torch.Tensor, q_seg: torch.Tensor,
                            scales: Optional[torch.Tensor] = None,
                            use_kernel: Optional[bool] = None, mesh=None):
    """Exact per-(row, segment) (threshold, trimmed Σw²) over flat rows.

    x (m, C) f32; seg_id (C,) int32 maps each column to its segment (−1
    marks inert columns); seg_len (S,) holds the element count of each
    segment and q_seg (m, S) the quantile levels.  Returns (t, ss), both
    (m, S) f32: t[c, s] = quantile(|x[c]| on segment s, q_seg[c, s]),
    ss = Σ x²·[|x| <= t].  ``scales`` (m, S) declares x quantized (int8 or
    bf16): the rows stay in their dtype and every level dequantizes them
    per segment, so t and ss are in dequantized units.  int8 / bf16 rows
    without scales are upcast to f32.  ``use_kernel`` reaches every
    level's ``hist_level``.

    With more than ``MAX_SEGMENTS`` segments, seg_id must not decrease
    apart from −1 columns at its end (a ``FlatIndex`` layout), so that
    each group of segments owns one run of columns.

    ``mesh``: x holds this rank's columns of rows split over ``model``
    (seg_len still counts whole segments); each level's planes are
    all-reduced over ``model`` — one all-reduce a level, every rank the
    same — and t, ss are the whole rows'.
    """
    with tracing.span("aggregate/norms/multilevel"):
        t, ss, _ = _search(x, seg_id, seg_len, q_seg, scales,
                           functools.partial(hist_level_planes,
                                             use_kernel=use_kernel), mesh)
    return t, ss


def level_prefixes(x: torch.Tensor, seg_id: torch.Tensor,
                   seg_len: torch.Tensor, q_seg: torch.Tensor,
                   scales: Optional[torch.Tensor] = None):
    """[(shift, hi)] of each level of ``segmented_trimmed_stats``'s search
    on these inputs, found with the plain ``ref.hist_level_planes_ref``:
    the inputs at which the search calls ``hist_level_planes``."""
    return _search(x, seg_id, seg_len, q_seg, scales,
                   ref.hist_level_planes_ref)[2]


def segment_groups(seg_id: torch.Tensor, S: int):
    """[(g0, g1, c0, c1)]: segments [g0, g1) in groups of at most
    ``MAX_SEGMENTS`` by id, each with its run of columns [c0, c1) of
    seg_id (empty where this slice holds none of the group)."""
    C = seg_id.shape[0]
    if S <= MAX_SEGMENTS:
        return [(0, S, 0, C)]
    key = torch.where(seg_id < 0, S, seg_id)
    if tracing.to_host(torch.any(key[1:] < key[:-1]), bool):
        raise ValueError("segment ids must not decrease (apart from −1 at "
                         "the end) to be cut into groups")
    bounds = list(range(0, S, MAX_SEGMENTS)) + [S]
    c = tracing.to_host(torch.searchsorted(
        key, torch.tensor(bounds, dtype=key.dtype, device=key.device)),
        torch.Tensor.tolist)
    return [(bounds[i], bounds[i + 1], c[i], c[i + 1])
            for i in range(len(bounds) - 1)]


def _grouped(hist, x, seg_id, hi, shift, scales, groups):
    """One level's integer planes over every group: a ``hist`` call on each
    group's columns with its segments renumbered from 0, written into one
    (m, 2, S, 256) pair (zero for a group with no columns here).  The
    groups' launches, and the copies of their columns they read, are one
    kernel call over x (``kernel_scope``) for the program contracts."""
    if len(groups) == 1 and groups[0][2:] == (0, x.shape[1]):
        return hist(x, seg_id, hi, shift, scales)
    m, S = x.shape[0], hi.shape[2]
    with kernel_scope("hist_level groups", x, seg_id, hi, scales):
        cnt = torch.zeros((m, 2, S, _BINS), dtype=torch.int32,
                          device=x.device)
        sq = torch.zeros((m, 2, S, _BINS), dtype=torch.int64,
                         device=x.device)
        for g0, g1, c0, c1 in groups:
            if c1 <= c0:
                continue
            c, q = hist(x[:, c0:c1].contiguous(),
                        (seg_id[c0:c1] - g0).to(torch.int32),
                        hi[:, :, g0:g1].contiguous(), shift,
                        None if scales is None
                        else scales[:, g0:g1].contiguous())
            cnt[:, :, g0:g1] = c
            sq[:, :, g0:g1] = q
        return cnt, sq


def _all_reduce_planes(cnt, sq, mesh):
    """Sum a level's count and integer Σx² planes over ``model`` in one
    all-reduce of one int64 tensor: exact, so the sums are the unsharded
    planes' whatever the split of the columns."""
    from repro_torch.sharding import collectives as coll
    from repro_torch.sharding.cohort import MODEL_AXIS
    both = coll.all_reduce(torch.stack([cnt.to(torch.int64), sq]), mesh,
                           MODEL_AXIS)
    return both[0].to(torch.int32), both[1]


def _search(x, seg_id, seg_len, q_seg, scales, hist, mesh=None):
    """The level loop, each level's integer planes from ``hist`` (over the
    segment groups, summed over ``model`` with a mesh, then scaled to f32);
    returns t, ss and the [(shift, hi)] it histogrammed."""
    x, _ = kernel_rows(x, scales)     # once, not at every level
    m = x.shape[0]
    S = seg_len.shape[0]
    # under a mesh a bin sums over the whole row, every shard's columns
    if mesh is None:
        ref.check_row_length(x.shape[1])
    else:
        from repro_torch.sharding.cohort import MODEL_AXIS
        ref.check_row_length(x.shape[1] * mesh.size(MODEL_AXIS))
    groups = segment_groups(seg_id, S)
    r0, r1, frac = ref.interpolation_ranks(q_seg, seg_len[None, :])
    rank = torch.stack([r0, r1], dim=1)                        # (m, 2, S)
    lo = torch.zeros((m, 2, S), dtype=torch.int64, device=x.device)
    sqb = torch.zeros((m, 2, S), dtype=torch.float32, device=x.device)
    levels = []
    for j in range(_LEVELS):
        shift = 24 - 8 * j
        hi = (lo >> min(shift + 8, 31)).to(torch.int32)
        levels.append((shift, hi))
        cnt, sq = _grouped(hist, x, seg_id, hi, shift, scales, groups)
        if mesh is not None:
            cnt, sq = _all_reduce_planes(cnt, sq, mesh)
        sq = ref.scale_sums(sq, hi, shift)
        cum = torch.cumsum(cnt, dim=-1)
        # smallest bin whose cumulative count exceeds the rank
        bstar = torch.sum(cum <= rank[..., None], dim=-1)
        prev = torch.clamp(bstar - 1, min=0)[..., None]
        below = torch.where(bstar > 0, torch.gather(cum, -1, prev)[..., 0], 0)
        sq_cum = torch.cumsum(sq, dim=-1)
        if j < _LEVELS - 1:     # Σx² strictly below the bracket
            sqb = sqb + torch.where(
                bstar > 0, torch.gather(sq_cum, -1, prev)[..., 0], 0.0)
        else:                   # inclusive: completes S(v) = Σ x²·[x <= v]
            sqb = sqb + torch.gather(sq_cum, -1, bstar[..., None])[..., 0]
        rank = rank - below
        lo = lo + (bstar << shift)
    v = lo.to(torch.int32).view(torch.float32)
    v0, v1 = v[:, 0], v[:, 1]
    t = ref.interpolate(v0, v1, frac)
    # no data value lies strictly between adjacent order statistics
    return t, torch.where(t < v1, sqb[:, 0], sqb[:, 1]), levels


def histogram_elems(rows: int, segs: int) -> int:
    """Upper bound on one level's cross-shard histogram payload in elements
    (``_all_reduce_planes``: the count and Σx² planes in one int64
    tensor): independent of row length, never O(N).  ``rows`` is the
    per-data-shard client count."""
    return 2 * rows * _PATHS * segs * _BINS


def multilevel_quantile_contract(slice_bytes=None, *, padded: bool = False,
                                 name: str = "quantile/multilevel"):
    """Declared contract of the two-stage path, the reference's
    (``repro.kernels.fedfa_quantile.multilevel
    .multilevel_quantile_contract``) field by field: however long the
    row, the run has exactly ONE row-sized read site (the ``hist_level``
    call inside the level loop of ``_search``, one site however many
    levels) and zero sorts.  ``padded=True`` allows the reference's
    pad-copy read.  ``slice_bytes`` (the local (m, C) slice) budgets the
    peak at 6x the slice."""
    from repro_torch.analysis.contracts import Contract
    peak = {} if slice_bytes is None else dict(
        peak_live_bytes_per_device=(None, 6 * slice_bytes))
    return Contract(name=name,
                    description="two-stage multilevel trimmed quantile",
                    row_reads=(1, 2) if padded else 1, sorts=0, **peak)


def distributed_quantile_contract(rows: int, segs: int, slice_bytes=None,
                                  peak_mult: int = 8):
    """The distributed trimmed-norm pass over (data, model)-split rows
    (``segmented_trimmed_stats(mesh=)``), the reference's
    (``repro.kernels.fedfa_quantile.multilevel
    .distributed_quantile_contract``) field by field: exactly 1 row read,
    0 sorts, and ZERO gathers or re-layout collectives — the only
    cross-rank traffic is the all-reduce of each level's histogram
    planes, at most ``histogram_elems(rows, segs)`` elements (never
    O(N)).  ``rows`` is the PER-DATA-SHARD client count; ``slice_bytes``
    the local (rows, N/model) slice, budgeting the peak at ``peak_mult``
    slices."""
    from repro_torch.analysis.contracts import Contract
    hist = histogram_elems(rows, segs)
    peak = {} if slice_bytes is None else dict(
        peak_live_bytes_per_device=(None, peak_mult * slice_bytes))
    return Contract(name="quantile/dist",
                    description="distributed two-stage trimmed quantile",
                    row_reads=1, sorts=0,
                    all_gathers=0, reduce_scatters=0, all_to_alls=0,
                    collective_permutes=0,
                    allreduce_max_elems=hist, **peak)


def row_trimmed_stats_multilevel(rows: torch.Tensor, q: torch.Tensor,
                                 scale: Optional[torch.Tensor] = None,
                                 use_kernel: Optional[bool] = None):
    """``ops.row_trimmed_stats`` for long rows: each row (R, L) is one
    single-segment client; q (R,) levels.  With ``scale`` (R,) the rows
    may be int8 or bf16 and keep that dtype end to end."""
    R, L = rows.shape
    seg_id = torch.zeros(L, dtype=torch.int32, device=rows.device)
    seg_len = torch.full((1,), L, dtype=torch.int64, device=rows.device)
    t, ss = segmented_trimmed_stats(
        rows, seg_id, seg_len, q.reshape(R, 1),
        None if scale is None else scale.reshape(R, 1), use_kernel)
    return t[:, 0], ss[:, 0]
