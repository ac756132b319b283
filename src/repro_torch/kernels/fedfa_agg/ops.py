"""Wrappers of the CUDA aggregation kernels: ``scaled_accum``
(``csrc/scaled_accum.cu``), ``quant_accum`` (``csrc/quant_accum.cu``),
``trimmed_sumsq`` (``csrc/trimmed_sumsq.cu``) and quantized admission's
``quant_admit`` (``csrc/quant_admit.cu``).

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it runs the plain version in ``ref``.  ``use_kernel`` chooses otherwise
(``build.runs_plain``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.build import (DTYPE_CODES, CudaKernel, check_input,
                                       kernel_scope, runs_plain, stream_of)
from repro_torch.kernels.fedfa_agg import ref

SCALED_ACCUM = CudaKernel(
    "scaled_accum.cu", "scaled_accum",
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
    + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
QUANT_ACCUM = CudaKernel(
    "quant_accum.cu", "quant_accum",
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
    + [ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
       ctypes.c_void_p])
QUANT_ADMIT = CudaKernel(
    "quant_admit.cu", "quant_admit",
    [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
     ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_int64] + [ctypes.c_void_p] * 3
    + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
TRIMMED_SUMSQ = CudaKernel(
    "trimmed_sumsq.cu", "trimmed_sumsq",
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
    + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])

# the element types scaled_accum's x and trimmed_sumsq's w may have; both
# kernels upcast them to f32 as they read them
_FLOAT_ROWS = (torch.float32, torch.bfloat16)


def _check_float_rows(name: str, x: torch.Tensor) -> None:
    if x.dtype not in _FLOAT_ROWS:
        raise TypeError(f"{name} has dtype {x.dtype}, expected f32 or bf16")

# the shared memory one block of quant_accum may use for its (m, S) table
_MAX_TABLE_BYTES = 232448


def scaled_accum(x: torch.Tensor, weights: torch.Tensor,
                 mask: torch.Tensor, use_kernel: Optional[bool] = None
                 ) -> torch.Tensor:
    """Fused Σ_c weights[c]·x[c]·mask over the client axis: x (m, n) f32
    or bf16 (upcast as it is read), weights (m,) and mask (n,) f32 -> (n,)
    f32 (Alg. 1 line 19, M' and Γ)."""
    if x.dim() != 2:
        raise ValueError(f"scaled_accum takes x (m, n), got {tuple(x.shape)}")
    m, n = x.shape
    _check_float_rows("x", x)
    check_input("x", x, x.dtype, (m, n), x.device)
    check_input("weights", weights, torch.float32, (m,), x.device)
    check_input("mask", mask, torch.float32, (n,), x.device)
    with kernel_scope("scaled_accum", x, weights, mask):
        if runs_plain(x, use_kernel):
            return ref.scaled_accum_ref(x, weights, mask)
        out = torch.empty(n, dtype=torch.float32, device=x.device)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        SCALED_ACCUM.launch(x.data_ptr(), DTYPE_CODES[x.dtype],
                            weights.data_ptr(), mask.data_ptr(),
                            out.data_ptr(), m, n, sms, stream_of(x),
                            shape=(m, n))
        return out


def quant_accum(x: torch.Tensor, wtab: torch.Tensor, seg: torch.Tensor,
                mask: torch.Tensor, use_kernel: Optional[bool] = None
                ) -> torch.Tensor:
    """Fused dequantize-accumulate Σ_c x[c, n]·wtab[c, seg[n]]·mask[n]:
    x (m, n) int8 or bf16 rows, wtab (m, S) f32 per-(client, segment)
    weights with the dequant scales folded in, seg (n,) int32 (−1 adds
    nothing), mask (n,) f32 -> (n,) f32."""
    if x.dim() != 2 or wtab.dim() != 2:
        raise ValueError(f"quant_accum takes x (m, n) and wtab (m, S), got "
                         f"{tuple(x.shape)} and {tuple(wtab.shape)}")
    if x.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"quant_accum takes int8 or bf16 rows, got {x.dtype}")
    m, n = x.shape
    S = wtab.shape[1]
    check_input("x", x, x.dtype, (m, n), x.device)
    check_input("wtab", wtab, torch.float32, (m, S), x.device)
    check_input("seg", seg, torch.int32, (n,), x.device)
    check_input("mask", mask, torch.float32, (n,), x.device)
    if S < 1:
        raise ValueError("quant_accum needs at least one segment")
    with kernel_scope("quant_accum", x, wtab, seg, mask):
        if runs_plain(x, use_kernel):
            return ref.quant_accum_ref(x, wtab, seg, mask)
        if m * S * 4 > _MAX_TABLE_BYTES:
            raise ValueError(f"quant_accum's (m, S) = ({m}, {S}) table "
                             f"exceeds one block's {_MAX_TABLE_BYTES} bytes "
                             f"of shared memory")
        out = torch.empty(n, dtype=torch.float32, device=x.device)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        QUANT_ACCUM.launch(x.data_ptr(), DTYPE_CODES[x.dtype],
                           wtab.data_ptr(), seg.data_ptr(), mask.data_ptr(),
                           out.data_ptr(), m, S, n, sms, stream_of(x),
                           shape=(m, n))
        return out


def accumulate_contract(n_padded: int, mesh=None, rows=None, segs=None):
    """Declared contract of the aggregation path built on ``accumulate``
    (``core.flat.aggregate_buffers``; see ``analysis.contracts``): the
    reference's (``repro.kernels.fedfa_agg.ops.accumulate_contract``)
    field by field.

    Zero all-gathers, always: the (M', γ) reduction is a per-rank partial
    sum, never a re-gathered (m, n) cohort.  On a multi-rank data-only
    mesh the partial sums combine as 1-2 all-reduces of exactly
    ``n_padded`` elements and no all-reduce exceeds that.  With model
    shards the reductions take the rank's (m/D, N/M) slice: no
    reduce-scatter, the sums finished by all-reduces of exactly
    ``n_padded / n_model`` elements over ``data``, plus the distributed
    trimmed quantile's histogram planes over ``model`` (bounded via
    ``segs``, the segment count; independent of N).

    With ``rows`` (the padded cohort row count) the per-rank peak is
    budgeted at ``(6 + 12*r) * N * 4`` bytes, r = rows per data shard.
    """
    from repro_torch.analysis.contracts import Contract
    from repro_torch.kernels.fedfa_quantile.multilevel import histogram_elems
    from repro_torch.sharding.cohort import data_shards, model_shards
    multi = data_shards(mesh) * model_shards(mesh) > 1
    ms = model_shards(mesh)
    peak = {}
    r = max(1, (rows or 1) // data_shards(mesh))
    if rows is not None:
        peak = dict(
            peak_live_bytes_per_device=(None, (6 + 12 * r) * n_padded * 4))
    if not multi:
        return Contract(name="agg/1dev",
                        description="aggregation path, single device",
                        all_gathers=0, **peak)
    scale = n_padded // ms
    cap = scale
    kw = {}
    if ms > 1:
        kw = dict(reduce_scatters=0)
        if segs is not None:
            cap = max(scale, histogram_elems(r, segs))
    kw.update(allreduce_max_elems=cap, scale_allreduces=(1, 2),
              scale_elems=scale)
    return Contract(
        name=f"agg/ms{ms}",
        description="aggregation path: partial sums, no cohort re-gather",
        all_gathers=0, **kw, **peak)


def _sharded_sum(local, x: torch.Tensor, weights: torch.Tensor, mesh,
                 cohort_2d: bool) -> torch.Tensor:
    """Σ over the cohort's clients of ``local(x, weights)``, the sum over
    this rank's rows, on a mesh (``repro.kernels.fedfa_agg.ops
    .accumulate``'s layouts):

      * ``cohort_2d`` with model shards: x is the rank's (m/D, N/M) slice;
        one N/M all-reduce over ``data`` ends the sum;
      * otherwise, with model shards dividing n: the model peers split the
        data shard's rows (row i to peer (i·M)//rows, the other peers'
        weights zeroed: exact for any row count), reduce-scatter over
        ``model`` and all-reduce the N/M block over ``data``;
      * on a data-only mesh (or n not divisible by M): one n-sized
        all-reduce over ``data``.

    The result is the rank's P("model") block (all of n without model
    shards), the layout of the resident global."""
    from repro_torch.sharding import collectives as coll
    from repro_torch.sharding.cohort import DATA_AXIS, MODEL_AXIS
    ms = mesh.size(MODEL_AXIS)
    if cohort_2d and ms > 1:
        return coll.all_reduce(local(x, weights), mesh, DATA_AXIS)
    if x.shape[1] % ms:
        ms = 1
    if ms > 1:
        rows = x.shape[0]
        slot = (torch.arange(rows, device=x.device) * ms) // rows
        weights = torch.where(slot == mesh.coord[1], weights, 0.0)
    part = local(x, weights)
    if ms > 1:
        part = coll.reduce_scatter(part, mesh, MODEL_AXIS)
    return coll.all_reduce(part, mesh, DATA_AXIS)


def accumulate(x: torch.Tensor, weights: torch.Tensor, mask: torch.Tensor,
               use_kernel: Optional[bool] = None, mesh=None,
               cohort_2d: bool = False) -> torch.Tensor:
    """Σ_c weights[c]·x[c]·mask over the cohort's clients: ``scaled_accum``
    on this rank's rows, summed over the mesh as ``_sharded_sum`` says
    (one launch, no collective, without a mesh).  ``mask`` spans x's
    columns."""
    if mesh is None:
        return scaled_accum(x, weights, mask, use_kernel)
    return _sharded_sum(lambda xs, ws: scaled_accum(xs, ws, mask, use_kernel),
                        x, weights, mesh, cohort_2d)


def accumulate_quant(x: torch.Tensor, weights: torch.Tensor,
                     wtab: torch.Tensor, seg: torch.Tensor,
                     mask: torch.Tensor, use_kernel: Optional[bool] = None,
                     mesh=None, cohort_2d: bool = False) -> torch.Tensor:
    """Σ_c weights[c]·wtab[c, seg[n]]·x[c, n]·mask[n]: the per-client
    weight folds into the (m, S) table before the one launch, so the
    quantized rows are read once.  ``seg`` and ``mask`` span x's columns
    (a rank's slice of the segment map in the 2-D layout); the mesh sum as
    ``accumulate``'s."""
    def local(xs, ws):
        return quant_accum(xs, wtab * ws[:, None], seg, mask, use_kernel)
    if mesh is None:
        return local(x, weights)
    return _sharded_sum(local, x, weights, mesh, cohort_2d)


def trimmed_sumsq(w: torch.Tensor, t: torch.Tensor,
                  use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Σ w²·[|w| <= t] over a flat f32 or bf16 vector w (n,) (upcast as it
    is read), threshold t a 0-d f32 tensor on w's device -> 0-d f32.
    Summed in a fixed order on the card (per-block partials, then one
    block), so it is deterministic."""
    if w.dim() != 1:
        raise ValueError(f"trimmed_sumsq takes w (n,), got {tuple(w.shape)}")
    _check_float_rows("w", w)
    check_input("w", w, w.dtype, tuple(w.shape), w.device)
    check_input("t", t, torch.float32, (), w.device)
    with kernel_scope("trimmed_sumsq", w, t):
        if runs_plain(w, use_kernel):
            return ref.trimmed_sumsq_ref(w, t)
        n = w.shape[0]
        sms = torch.cuda.get_device_properties(w.device).multi_processor_count
        blocks = max(1, min(sms * 8, -(-n // (256 * 8))))
        partial = torch.empty(blocks, dtype=torch.float32, device=w.device)
        out = torch.empty((), dtype=torch.float32, device=w.device)
        TRIMMED_SUMSQ.launch(w.data_ptr(), DTYPE_CODES[w.dtype], t.data_ptr(),
                             partial.data_ptr(), out.data_ptr(), n, blocks,
                             stream_of(w))
        return out


def trimmed_norm(w_flat: torch.Tensor, t, use_kernel: Optional[bool] = None
                 ) -> torch.Tensor:
    """sqrt(Σ w²·[|w| <= t]) over a flat f32 or bf16 vector of any
    length."""
    t = torch.as_tensor(t, dtype=torch.float32,
                        device=w_flat.device).reshape(())
    return torch.sqrt(trimmed_sumsq(w_flat.reshape(-1).contiguous(), t,
                                    use_kernel))


# ---------------------------------------------------------------------------
# quantized admission
# ---------------------------------------------------------------------------

# elements of one tile of quant_admit (csrc/quant_admit.cu, kTile)
ADMIT_TILE = 32768
# int64 fields of a piece's row in the kernel's piece table: 10, then 7 for
# each of up to 2 density factors (no leaf has more masked axes)
_PIECE_FIELDS, _FACTOR_FIELDS, _MAX_FACTORS = 10, 7, 2


class AdmitPiece(NamedTuple):
    """Whole segment rows of one leaf, as quantized admission walks them:
    k segments from ``s0``, each ``rest`` columns wide, at local columns
    [a, a + k·rest) of the state; in the f32 rows they are leaf rows
    j0..j0+k−1 of the leaf at ``leaf_off`` (``lead`` rows of ``row_len``,
    shape ``shape``), from column ``c0`` of each row.  ``stacked``: a
    depth-stacked leaf (its rows the repeats); ``stage0``: one of stage 0,
    grafted by a row gather.  ``factors``:
    (column in the factor table, leaf axis, length) of each width-mask
    vector whose product along the leaf's axes is the density."""
    s0: int
    k: int
    rest: int
    a: int
    leaf_off: int
    lead: int
    row_len: int
    j0: int
    c0: int
    stacked: bool
    stage0: bool
    shape: Tuple[int, ...]
    factors: Tuple[Tuple[int, int, int], ...]


def _divider(d: int) -> Tuple[int, int, int]:
    """(mul, shift, d) with n // d = (umulhi(n, mul) + n) >> shift for
    0 <= n < 2^31."""
    shift = (d - 1).bit_length()
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift, d


class AdmitPlan:
    """The pieces of one admission layout and, per device, the kernel's
    piece table (int64) and tile table (int32 rows of piece, row in the
    piece, first column, length; at most ``ADMIT_TILE`` columns of one
    segment row a tile).  Made once per layout (``core.flat`` memoizes it
    on the index)."""

    def __init__(self, pieces: Sequence[AdmitPiece], n_factor_cols: int):
        self.pieces = tuple(pieces)
        self.n_factor_cols = int(n_factor_cols)
        ps = self.pieces
        self.n_elems = sum(p.k * p.rest for p in ps)
        self.width = max((p.a + p.k * p.rest for p in ps), default=0)
        self.x_cols = max((p.leaf_off + p.lead * p.row_len for p in ps),
                          default=0)
        self.n_segments = max((p.s0 + p.k for p in ps), default=0)
        self.graft_rows = max((p.j0 + p.k for p in ps if p.stage0),
                              default=0)
        self.segments = slice(min((p.s0 for p in ps), default=0),
                              self.n_segments)
        for p in ps:
            if p.row_len >= 1 << 31 or len(p.factors) > _MAX_FACTORS or any(
                    p.stacked and axis == 0 for _, axis, _ in p.factors):
                raise ValueError(f"quant_admit takes rows of < 2^31 "
                                 f"elements and at most {_MAX_FACTORS} "
                                 f"density factors, none along a stack's "
                                 f"rows, got {p}")
        self._tables: Dict[torch.device, tuple] = {}

    def _factor_row(self, p: AdmitPiece) -> Tuple[list, bool]:
        """The piece's factor fields and whether its factors allow the
        4-wide route."""
        row, vec = [], True
        for col, axis, dim in p.factors:
            stride = int(np.prod(p.shape[axis + 1:], dtype=np.int64))
            vec &= stride % 4 == 0 or (stride == 1 and dim % 4 == 0)
            row += [col, *_divider(stride), *_divider(dim)]
        return row, vec

    def _build(self) -> tuple:
        table = np.zeros((len(self.pieces),
                          _PIECE_FIELDS + _MAX_FACTORS * _FACTOR_FIELDS),
                         np.int64)
        tiles = []
        for i, p in enumerate(self.pieces):
            frow, vec = self._factor_row(p)
            vec &= all(v % 4 == 0 for v in (p.leaf_off, p.row_len, p.c0,
                                            p.a, p.rest))
            table[i, :_PIECE_FIELDS] = (p.s0, p.rest, p.a, p.leaf_off,
                                        p.row_len, p.j0, p.c0, p.stage0,
                                        vec, len(p.factors))
            table[i, _PIECE_FIELDS:_PIECE_FIELDS + len(frow)] = frow
            nt = -(-p.rest // ADMIT_TILE)
            t0 = np.tile(np.arange(nt, dtype=np.int64) * ADMIT_TILE, p.k)
            tiles.append(np.stack([np.full(nt * p.k, i),
                                   np.repeat(np.arange(p.k), nt), t0,
                                   np.minimum(ADMIT_TILE, p.rest - t0)], 1))
        tiles = np.concatenate(tiles) if tiles else np.zeros((0, 4))
        return table, tiles.astype(np.int32)

    def tables(self, device) -> tuple:
        """(piece table, tile table) on ``device``."""
        key = torch.device(device)
        if key not in self._tables:
            table, tiles = self._build()
            self._tables[key] = (torch.as_tensor(table, device=key),
                                 torch.as_tensor(tiles, device=key))
        return self._tables[key]


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 and t.shape[-1] % 4 == 0 for t in ts)


def quant_admit(step: int, x: torch.Tensor, gmaps: torch.Tensor,
                graft: bool, fac: torch.Tensor, e_q: torch.Tensor,
                e_s: torch.Tensor, x_q: torch.Tensor,
                y_max: Optional[torch.Tensor], e_max: Optional[torch.Tensor],
                plan: AdmitPlan, use_kernel: Optional[bool] = None) -> None:
    """One step of quantized admission with error feedback over the pieces
    of ``plan``, y = (x + e_q·e_s)·dens on each: x (m, ldx) f32 rows
    (grafted by ``gmaps`` (m, G) int64 when ``graft``), ``fac`` (m, F) f32
    width-mask vectors, e_q and x_q (m, W) int8 or bf16, e_s (m, S) f32.
    int8: step 1 raises ``y_max`` (m, S) to max|y| per (client, segment),
    step 2 ``e_max`` to max|e|, step 3 writes x_q and e_q (scales max/127);
    bf16 takes step 3 alone (x_q = bf16(y), e_q = bf16(y − x_q)).  The
    scale tables are the caller's to write.  One launch a step."""
    if e_q.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"quant_admit takes int8 or bf16 state, got "
                        f"{e_q.dtype}")
    int8 = e_q.dtype == torch.int8
    if step not in ((1, 2, 3) if int8 else (3,)):
        raise ValueError(f"quant_admit: no step {step} for {e_q.dtype}")
    if x.dim() != 2 or e_q.dim() != 2 or e_s.dim() != 2 or gmaps.dim() != 2 \
            or fac.dim() != 2:
        raise ValueError("quant_admit takes 2-D x, gmaps, fac, e_q and e_s")
    m, ldx = x.shape
    W, S = e_q.shape[1], e_s.shape[1]
    dev = x.device
    check_input("x", x, torch.float32, (m, ldx), dev)
    check_input("gmaps", gmaps, torch.int64, (m, gmaps.shape[1]), dev)
    check_input("fac", fac, torch.float32, (m, fac.shape[1]), dev)
    check_input("e_q", e_q, e_q.dtype, (m, W), dev)
    check_input("x_q", x_q, e_q.dtype, (m, W), dev)
    check_input("e_s", e_s, torch.float32, (m, S), dev)
    if int8:
        check_input("y_max", y_max, torch.float32, (m, S), dev)
        check_input("e_max", e_max, torch.float32, (m, S), dev)
    for name, have, need in (("x's columns", ldx, plan.x_cols),
                             ("the state's columns", W, plan.width),
                             ("segments", S, plan.n_segments),
                             ("factor columns", fac.shape[1],
                              plan.n_factor_cols),
                             ("graft rows", gmaps.shape[1],
                              plan.graft_rows if graft else 0)):
        if have < need:
            raise ValueError(f"quant_admit: {have} {name}, the plan needs "
                             f"{need}")
    writes = (x_q, e_q) if step == 3 else (y_max if step == 1 else e_max,)
    with kernel_scope("quant_admit", x, e_q, writes=writes):
        if runs_plain(x, use_kernel):
            return ref.quant_admit_ref(step, x, gmaps, graft, fac, e_q, e_s,
                                       x_q, y_max, e_max, plan.pieces)
        ptab, ttab = plan.tables(dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        ptr = lambda t: None if t is None else t.data_ptr()
        QUANT_ADMIT.launch(
            step, DTYPE_CODES[e_q.dtype], x.data_ptr(), ldx,
            gmaps.data_ptr(), gmaps.shape[1], int(graft), fac.data_ptr(),
            fac.shape[1], e_q.data_ptr(), e_s.data_ptr(), x_q.data_ptr(), W,
            ptr(y_max), ptr(e_max), S, ptab.data_ptr(), ttab.data_ptr(),
            ttab.shape[0], m, int(_aligned(x, fac, e_q, x_q)), ADMIT_TILE,
            sms, stream_of(x), shape=(step, m, plan.n_elems))
