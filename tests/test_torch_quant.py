"""Quantized cohort admission in the port (``--update-dtype int8|bf16``)
against the JAX package, on the same numpy inputs, at the 4-layer
``fl_round_fixture`` size.

Tolerances, and why each holds:
  * quantization, the error-feedback admission chain and the quantile
    thresholds are bit-equal: the same f32 operations in the same order
    (the reference functions composed as written; XLA's rewrites of the
    jitted round are a separate matter, see the round test);
  * weighted sums (``quant_accum``, ``trimmed_norm``) and trimmed sums of
    squares agree to the f32 rounding of another summation order;
  * aggregation at rtol 1e-4 / atol 1e-5, the f32 aggregation test's;
  * resident rounds: training sums in another order move an f32 update by
    an ulp, which can flip its int8 (or bf16) rounding; such an element is
    off by one step of its segment, and at most 1e-4·N elements may be.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import fl_round_fixture, make_cohort

from repro.core import flat as jflat
from repro.core import round as jround
from repro.core.fedfa import STRATEGIES as JSTRATEGIES
from repro.core.server import FLConfig as JFLConfig
from repro.kernels.fedfa_agg import ops as jagg_ops
from repro.kernels.fedfa_agg import ref as jagg_ref
from repro.kernels.fedfa_quantile import multilevel as jml
from repro.kernels.fedfa_quantile import ops as jq_ops
from repro.models.masks import ClientArch as JClientArch
from repro.models.masks import stack_masks as jstack_masks
from repro_torch.core import flat
from repro_torch.core.fedfa import STRATEGIES
from repro_torch.core.round import (ResidentDriver, fresh_quant_state,
                                    quant_state_from_numpy)
from repro_torch.core.server import FLConfig
from repro_torch.kernels.fedfa_agg import ops as agg_ops
from repro_torch.kernels.fedfa_agg import ref as agg_ref
from repro_torch.kernels.fedfa_quantile import multilevel, ops
from repro_torch.launch import train
from repro_torch.models.masks import ClientArch, stack_masks
from repro_torch.models.model import _to_torch, params_from_numpy
from test_torch_round import _jax_perms, _port_cohort

torch.set_num_threads(2)

JCFG, JPARAMS = fl_round_fixture()
CFG = train.fl_config("smollm-135m", "cls", 10, full_size=False)
KEY = jax.random.PRNGKey(0)
ARCHS = [(0.25, (1, 1)), (0.5, (2, 1)), (1.0, (2, 2))]
QDTYPES = ["int8", "bf16"]


def _bits(a) -> np.ndarray:
    """The raw bits of a numpy array or tensor, for bit-equality checks."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _index():
    return flat.FlatIndex(params_from_numpy(
        jax.tree.map(np.asarray, JPARAMS), CFG, "cpu"))


def _runtimes(archs, port: bool):
    A = ClientArch if port else JClientArch
    cfg = CFG if port else JCFG
    arch = [A(w, d) for w, d in archs]
    stack = stack_masks if port else jstack_masks
    cat = torch.stack if port else jnp.stack
    return (stack([a.masks(cfg) for a in arch]),
            cat([a.gates(cfg) for a in arch]),
            cat([a.graft(cfg) for a in arch]))


def _cohort(seed: int, m: int = 3) -> np.ndarray:
    """An (m, N) f32 cohort around the global, with an all-zero row and an
    all-zero segment (the second client's first stacked row)."""
    rng = np.random.default_rng(seed)
    jindex = jflat.get_index(JPARAMS)
    g = np.asarray(jflat.flatten(jindex, JPARAMS))
    x = (g[None] + 0.05 * rng.normal(size=(m, g.size))).astype(np.float32)
    x[1] = 0.0
    spec = next(s for s in jindex.leaves if s.stacked)
    x[min(2, m - 1), spec.offset:spec.offset + spec.rest] = 0.0
    return x


def test_update_dtype_of_matches_reference():
    for name, want, jwant in [("f32", torch.float32, jnp.float32),
                              ("bf16", torch.bfloat16, jnp.bfloat16),
                              ("int8", torch.int8, jnp.int8)]:
        assert flat.update_dtype_of(name) == want
        assert jflat.update_dtype_of(name) == jwant
    assert flat.UPDATE_DTYPES == jflat.UPDATE_DTYPES
    for bad in ["fp4", "F32", ""]:
        with pytest.raises(ValueError) as port_err:
            flat.update_dtype_of(bad)
        with pytest.raises(ValueError) as jax_err:
            jflat.update_dtype_of(bad)
        assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("dt", ["int8", "bf16", "f32"])
def test_quantize_cohort_matches_reference(dt):
    x = _cohort(0)
    index, jindex = _index(), jflat.get_index(JPARAMS)
    x_q, scales = flat.quantize_cohort(index, torch.from_numpy(x), dt)
    jx_q, jscales = jflat.quantize_cohort(jindex, jnp.asarray(x), dt)
    assert x_q.dtype == flat.update_dtype_of(dt)
    np.testing.assert_array_equal(_bits(x_q), _bits(np.asarray(jx_q)))
    np.testing.assert_array_equal(_bits(scales), _bits(np.asarray(jscales)))
    back = flat.dequantize_cohort(index, x_q, scales)
    jback = jflat.dequantize_cohort(jindex, jx_q, jscales)
    np.testing.assert_array_equal(_bits(back), _bits(np.asarray(jback)))
    np.testing.assert_array_equal(back[1].numpy(), 0.0)
    if dt == "int8":
        # half a step, plus the f32 rounding of x/step and of q·step
        step = scales[:, torch.as_tensor(index.row_of).long()].numpy()
        err = np.abs(back.numpy() - x)
        assert (err <= 0.5 * step + 2.0 ** -22 * np.abs(x)).all()
        np.testing.assert_array_equal(scales[1].numpy(), 0.0)
        assert (scales[2].numpy() == 0.0).sum() == 1


def _quant_rows(dt, R, L, seed):
    """(rows in the admission dtype, per-row scales) of random rows, from
    the JAX package's quantizer so both sides read the same numbers."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(R, L)).astype(np.float32)
    x[0, : L // 2] = 0.0
    if dt == "int8":
        s = np.abs(x).max(1) / np.float32(127.0)
        safe = np.where(s > 0, s, 1.0).astype(np.float32)
        q = np.clip(np.round(x / safe[:, None]), -127, 127).astype(np.int8)
        return q, s.astype(np.float32)
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    return xb, np.ones(R, np.float32)


def _qm(kind, R, L, seed):
    q = np.random.default_rng(seed + 1).uniform(0.9, 1.0, R).astype(np.float32)
    if kind == "ends":
        q[: min(R, 2)] = [0.0, 1.0][: min(R, 2)]
    return q


QCASES = [(3, 1000, "mid"), (4, 4093, "mid"), (2, 1, "ends"),
          (3, 1537, "ends")]


@pytest.mark.parametrize("dt", QDTYPES)
@pytest.mark.parametrize("R,L,how", QCASES)
def test_quantile_fused_quantized_matches_reference(dt, R, L, how):
    rows, s = _quant_rows(dt, R, L, L)
    q = _qm(how, R, L, L)
    t, ss = ops.quantile_fused(_to_torch(rows), torch.from_numpy(q),
                               torch.from_numpy(s))
    jt, jss = jq_ops.row_trimmed_stats(jnp.asarray(rows), jnp.asarray(q),
                                       scale=jnp.asarray(s), interpret=True)
    np.testing.assert_array_equal(_bits(t), _bits(np.asarray(jt)))
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss), rtol=1e-5)


@pytest.mark.parametrize("dt", QDTYPES)
@pytest.mark.parametrize("R,L,how", QCASES[:3])
def test_multilevel_quantized_matches_reference(dt, R, L, how):
    rows, s = _quant_rows(dt, R, L, L + 7)
    q = _qm(how, R, L, L)
    t, ss = multilevel.row_trimmed_stats_multilevel(
        _to_torch(rows), torch.from_numpy(q), torch.from_numpy(s))
    jt, jss = jml.row_trimmed_stats_multilevel(
        jnp.asarray(rows), jnp.asarray(q), scale=jnp.asarray(s),
        interpret=True)
    np.testing.assert_array_equal(_bits(t), _bits(np.asarray(jt)))
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss), rtol=1e-5)


def _segmented_case(dt, seed):
    """Quantized (m, C) rows over 3 segments and an inert tail, with
    per-(row, segment) scales."""
    rng = np.random.default_rng(seed)
    m, C, S = 3, 1024, 3
    seg = np.repeat(np.arange(S, dtype=np.int32), [300, 500, 200])
    seg = np.concatenate([seg, np.full(C - seg.size, -1, np.int32)])
    seg_len = np.bincount(seg[seg >= 0], minlength=S).astype(np.int32)
    q = rng.uniform(0.9, 1.0, (m, S)).astype(np.float32)
    if dt == "int8":
        x = rng.integers(-127, 128, (m, C)).astype(np.int8)
        sc = rng.uniform(1e-3, 1e-1, (m, S)).astype(np.float32)
        sc[1, 2] = 0.0                      # an all-zero segment
    else:
        x = np.asarray(jnp.asarray(rng.normal(size=(m, C)), jnp.bfloat16))
        sc = np.ones((m, S), np.float32)
    return x, seg, seg_len, q, sc


@pytest.mark.parametrize("dt", QDTYPES)
@pytest.mark.parametrize("level", [0, 2])
def test_hist_level_quantized_planes_match_reference(dt, level):
    x, seg, _, _, sc = _segmented_case(dt, level)
    m, S = x.shape[0], sc.shape[1]
    shift = 24 - 8 * level
    deq = np.abs(np.asarray(jnp.asarray(x).astype(jnp.float32))
                 * sc[:, np.clip(seg, 0, None)])
    bits = deq.view(np.int32)
    hs = min(shift + 8, 31)
    hi = np.stack([bits[:, [0, 300, 800]] >> hs,
                   bits[:, [1, 301, 801]] >> hs], axis=1)
    hi = np.ascontiguousarray(hi, dtype=np.int32)
    cnt, sq = multilevel.hist_level(_to_torch(x), torch.from_numpy(seg),
                                    torch.from_numpy(hi), shift,
                                    torch.from_numpy(sc))
    jcnt, jsq = jml._hist_call(jnp.asarray(x), jnp.asarray(seg),
                               jnp.asarray(sc), jnp.asarray(hi),
                               jnp.asarray(shift, jnp.int32), interpret=True)
    assert int(cnt.sum()) > 0
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_allclose(sq.numpy(), np.asarray(jsq), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dt", QDTYPES)
def test_segmented_stats_quantized_match_reference(dt):
    x, seg, seg_len, q, sc = _segmented_case(dt, 5)
    t, ss = multilevel.segmented_trimmed_stats(
        _to_torch(x), torch.from_numpy(seg), torch.from_numpy(seg_len),
        torch.from_numpy(q), torch.from_numpy(sc))
    # jitted, as the JAX round runs it (see test_torch_kernels)
    jt, jss = jax.jit(functools.partial(jml.segmented_trimmed_stats,
                                        interpret=True))(
        jnp.asarray(x), jnp.asarray(seg), jnp.asarray(seg_len),
        jnp.asarray(q), scales=jnp.asarray(sc))
    np.testing.assert_array_equal(_bits(t), _bits(np.asarray(jt)))
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss), rtol=1e-5)


def test_quantized_rows_need_scales():
    """Quantized rows are dequantized by their scales; without scales they
    are upcast to f32, as the reference upcasts them (the kernels then read
    f32 rows).  Dtypes neither package takes raise on every device."""
    rows = torch.arange(-8, 8, dtype=torch.int8).reshape(2, 8)
    q = torch.tensor([0.9, 0.5])
    for dt in (torch.int8, torch.bfloat16):
        x = rows.to(dt)
        for fn in (ops.quantile_fused,
                   multilevel.row_trimmed_stats_multilevel):
            for got, want in zip(fn(x, q), fn(x.float(), q)):
                assert torch.equal(got, want)
        seg, hi = torch.zeros(8, dtype=torch.int32), \
            torch.zeros((2, 2, 1), dtype=torch.int32)
        for got, want in zip(multilevel.hist_level(x, seg, hi, 24),
                             multilevel.hist_level(x.float(), seg, hi, 24)):
            assert torch.equal(got, want)
    with pytest.raises(TypeError, match="int8 or bf16"):
        agg_ops.quant_accum(rows.float(), torch.ones((2, 1)),
                            torch.zeros(8, dtype=torch.int32), torch.ones(8))
    with pytest.raises(TypeError):
        ops.quantile_fused(rows.to(torch.float16), torch.ones(2),
                           torch.ones(2))
    with pytest.raises(TypeError):
        multilevel.row_trimmed_stats_multilevel(rows.to(torch.float16), q)
    meta = torch.empty((2, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        agg_ops.quant_accum(meta, torch.empty((2, 1), device="meta"),
                            torch.empty(8, dtype=torch.int32, device="meta"),
                            torch.empty(8, device="meta"))
    with pytest.raises(ValueError):
        agg_ops.trimmed_sumsq(torch.empty(8, device="meta"),
                              torch.empty((), device="meta"))


@pytest.mark.parametrize("dt", QDTYPES)
def test_unscaled_quantized_rows_match_reference(dt):
    """int8 / bf16 rows without scales through the single-pass and the
    multilevel kernels' paths: the reference upcasts them to f32."""
    rows, _ = _quant_rows(dt, 3, 1537, 11)
    q = _qm("mid", 3, 1537, 11)
    for port, jax_fn in (
            (ops.quantile_fused, functools.partial(
                jq_ops.row_trimmed_stats, interpret=True)),
            (multilevel.row_trimmed_stats_multilevel, functools.partial(
                jml.row_trimmed_stats_multilevel, interpret=True))):
        t, ss = port(_to_torch(rows), torch.from_numpy(q))
        jt, jss = jax_fn(jnp.asarray(rows), jnp.asarray(q))
        np.testing.assert_array_equal(_bits(t), _bits(np.asarray(jt)))
        np.testing.assert_allclose(ss.numpy(), np.asarray(jss), rtol=1e-5)


@pytest.mark.parametrize("dt", QDTYPES)
@pytest.mark.parametrize("m", [1, 5, 8])
def test_quant_accum_matches_reference(dt, m):
    rng = np.random.default_rng(m)
    n, S = 5003, 7
    x, _ = _quant_rows(dt, m, n, m)
    wtab = rng.uniform(0, 2, (m, S)).astype(np.float32)
    w = rng.uniform(0, 5, m).astype(np.float32)
    seg = np.sort(rng.integers(0, S, n)).astype(np.int32)
    seg[-37:] = -1                          # an inert tail
    mask = (rng.random(n) < 0.9).astype(np.float32)
    before = agg_ops.QUANT_ACCUM.launches
    out = agg_ops.accumulate_quant(
        _to_torch(x), torch.from_numpy(w), torch.from_numpy(wtab),
        torch.from_numpy(seg), torch.from_numpy(mask)).numpy()
    assert agg_ops.QUANT_ACCUM.launches == before   # CPU: the plain version
    xf = np.asarray(jnp.asarray(x).astype(jnp.float32))
    wt = wtab * w[:, None]
    mag = (np.abs(xf) * wt[:, np.clip(seg, 0, None)]).sum(0).max()
    tol = dict(rtol=1e-6, atol=1e-6 * float(mag))
    np.testing.assert_allclose(out, np.asarray(jagg_ops.accumulate_quant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(wtab), jnp.asarray(seg),
        jnp.asarray(mask), use_kernel=True, interpret=True)), **tol)
    np.testing.assert_allclose(out, np.asarray(jagg_ref.quant_accum_ref(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(seg),
        jnp.asarray(mask))), **tol)
    assert np.all(out[-37:] == 0.0)


@pytest.mark.parametrize("n", [1, 127, 4099, (1 << 17) + 3])
def test_trimmed_norm_matches_reference(n):
    rng = np.random.default_rng(n)
    w = rng.normal(size=n).astype(np.float32)
    t = np.float32(np.quantile(np.abs(w), 0.9))
    before = agg_ops.TRIMMED_SUMSQ.launches
    got = agg_ops.trimmed_norm(torch.from_numpy(w), float(t))
    assert agg_ops.TRIMMED_SUMSQ.launches == before
    want = jagg_ops.trimmed_norm(jnp.asarray(w), jnp.asarray(t),
                                 interpret=True)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(
        float(agg_ops.trimmed_sumsq(torch.from_numpy(w), torch.tensor(t))),
        float(jagg_ref.trimmed_sumsq_ref(jnp.asarray(w), t)), rtol=1e-6)


def _jax_chain(jindex, x, jmasks, jgmaps, graft, e_buf, es_buf, dt):
    """The reference round's admission (repro/core/round.py, _round_q),
    its functions composed in that order."""
    if graft:
        x = jax.vmap(functools.partial(jflat._graft_flat, jindex))(x, jgmaps)
    dens, _ = jax.vmap(functools.partial(jflat._density_and_fraction, JCFG,
                                         jindex))(jmasks)
    y = (x + jflat.dequantize_cohort(jindex, e_buf, es_buf)) * dens
    x_q, scales = jflat.quantize_cohort(jindex, y, dt)
    e = y - jflat.dequantize_cohort(jindex, x_q, scales)
    e_q, e_s = jflat.quantize_cohort(jindex, e, dt)
    return x_q, scales, e_q, e_s


@pytest.mark.parametrize("dt", QDTYPES)
@pytest.mark.parametrize("graft", [True, False])
def test_admission_chain_matches_reference(dt, graft):
    x = _cohort(1)
    resid = 1e-3 * np.random.default_rng(2).normal(size=x.shape)
    index, jindex = _index(), jflat.get_index(JPARAMS)
    je, jes = jflat.quantize_cohort(jindex, jnp.asarray(resid, jnp.float32),
                                    dt)
    masks, _, gmaps = _runtimes(ARCHS, port=True)
    jmasks, _, jgmaps = _runtimes(ARCHS, port=False)
    want = _jax_chain(jindex, jnp.asarray(x), jmasks, jgmaps, graft, je, jes,
                      dt)
    state = quant_state_from_numpy(
        index, dt, [np.asarray(a) for a in (want[0], want[1], je, jes)],
        "cpu")
    state[0].zero_()                        # x_q is written, never read
    flat.admit_quantized(index, CFG, torch.from_numpy(x), masks, gmaps,
                         graft, state, dt)
    for got, ref in zip(state, want):
        np.testing.assert_array_equal(_bits(got), _bits(np.asarray(ref)))


# ---------------------------------------------------------------------------
# the fused admission (agg_ops.quant_admit) against the piece loop it
# replaced, kept here frozen as the yardstick
# ---------------------------------------------------------------------------

def _frozen_quantize_rows(y, update_dtype, floor=None):
    ones = lambda: torch.ones(y.shape[:2], dtype=torch.float32,
                              device=y.device)
    if update_dtype == "f32":
        return y, ones()
    if update_dtype == "bf16":
        return y.to(torch.bfloat16), ones()
    seg_max = torch.amax(torch.abs(y), dim=2)
    if floor is not None:
        seg_max = torch.maximum(seg_max, floor)
    scales = seg_max / 127.0
    safe = torch.where(seg_max > 0, scales, 1.0)
    q = torch.clamp(torch.round(y / safe[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scales


def _frozen_deq(q, scales):
    return q.to(torch.float32) * scales[..., None]


def _frozen_admit(index, cfg, x, masks, gmaps, graft, state, update_dtype,
                  all_reduce, cols=None):
    """``flat.admit_quantized`` as it was before the fused kernel: the
    per-piece chain of elementwise ops (``all_reduce(table)`` stands for
    the all-reduce of the maxima over ``model``)."""
    import bisect
    from repro_torch.core.masking import axis_mask_tree, mask_density
    from repro_torch.tree import leaves_with_path
    x_q, scales, e_q, e_s = state
    cols = cols or slice(0, index.n_padded)
    m = x.shape[0]
    seg0s = [spec.seg0 for spec in index.leaves]
    axs = [dict(leaves_with_path(axis_mask_tree(cfg, masks.client(c))))
           for c in range(m)]
    rows = torch.arange(m, device=x.device)[:, None]
    dens_of = {}

    def y_of(p):
        s0, k, rest, a, _ = p
        li = bisect.bisect_right(seg0s, s0) - 1
        spec = index.leaves[li]
        j = s0 - spec.seg0
        c = cols.start + a - spec.offset - j * spec.rest
        xl = flat._leaf_rows(x, spec)
        xl = xl[rows, gmaps[:, j:j + k]] if (graft and spec.stacked
                                             and spec.stage == 0) \
            else xl[:, j:j + k]
        y = xl[..., c:c + rest] + _frozen_deq(flat._piece_rows(e_q, p),
                                              e_s[:, s0:s0 + k])
        if li not in dens_of:
            dens_of.clear()
            dens_of[li] = torch.stack([mask_density(spec.shape,
                                                    axs[i][spec.path])
                                       for i in range(m)]).to(x.device)
        dens = dens_of[li]
        if (k, rest) == (spec.lead, spec.rest):
            return (y.view((m,) + spec.shape) * dens).view(y.shape)
        return y * torch.broadcast_to(dens, (m,) + spec.shape).reshape(
            m, spec.lead, spec.rest)[:, j:j + k, c:c + rest]

    pieces = flat._pieces(index, cols)
    y_max = e_max = None
    if update_dtype == "int8" and cols != slice(0, index.n_padded):
        y_max = torch.zeros((m, index.n_segments), device=x.device)
        e_max = torch.zeros_like(y_max)
        for p in pieces:
            y_max[:, p[0]:p[0] + p[1]] = torch.amax(torch.abs(y_of(p)), dim=2)
        all_reduce(y_max)
        for p in pieces:
            y = y_of(p)
            q, s = _frozen_quantize_rows(y, update_dtype,
                                         y_max[:, p[0]:p[0] + p[1]])
            e_max[:, p[0]:p[0] + p[1]] = torch.amax(
                torch.abs(y - _frozen_deq(q, s)), dim=2)
        all_reduce(e_max)
    for p in pieces:
        segs = slice(p[0], p[0] + p[1])
        y = y_of(p)
        q, s = _frozen_quantize_rows(y, update_dtype,
                                     None if y_max is None else y_max[:, segs])
        e = y - _frozen_deq(q, s)
        eq, es = _frozen_quantize_rows(e, update_dtype,
                                       None if e_max is None else e_max[:, segs])
        flat._piece_rows(x_q, p).copy_(q)
        scales[:, segs] = s
        flat._piece_rows(e_q, p).copy_(eq)
        e_s[:, segs] = es
    if y_max is not None:
        scales.copy_(y_max / 127.0)
        e_s.copy_(e_max / 127.0)


def _admit_case(dt, case):
    """(index, x, masks, gmaps, graft, state, cols) of one fused-admission
    case: the 4-layer fixture with an all-zero client and segment, a
    segment whose y lands on halves after the division, a residual state
    on every other segment; the layout padded (an inert tail); "cut":
    columns from inside the embedding's row to inside a stacked row,
    "tail": from inside a stacked row into the inert tail."""
    params = params_from_numpy(jax.tree.map(np.asarray, JPARAMS), CFG, "cpu")
    index = flat.FlatIndex(params, pad_to=4096)
    rng = np.random.default_rng(7)
    m = 3
    x = np.zeros((m, index.n_padded), np.float32)
    x[:, :index.n] = _cohort(3, m)
    x[:, index.n:] = 9.0            # nothing admits the inert tail
    # client 2's final norm: y = x exactly, halves after the division by
    # the scale 127 / 127 = 1
    fin = next(s for s in index.leaves if s.path[0] == "final_norm")
    halves = np.array([127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5,
                       -126.5, 3.5, 0.0, 64.5], np.float32)
    x[2, fin.offset:fin.offset + fin.size] = np.resize(halves, fin.size)
    stacked = next(s for s in index.leaves if s.stacked and s.rest > 8)
    cols = {"cut": slice(1002, stacked.offset + 2 * stacked.rest + 6),
            "tail": slice(stacked.offset + stacked.rest + 4,
                          index.n_padded - 64)}.get(
        case, slice(0, index.n_padded))
    assert index.leaves[0].size > 1002 and index.n < index.n_padded - 64
    want = flat.update_dtype_of(dt)
    w = cols.stop - cols.start
    S = index.n_segments
    e = torch.from_numpy(rng.normal(size=(m, w)).astype(np.float32))
    e_q = (e * 40).round().clamp(-127, 127).to(want) if dt == "int8" \
        else (1e-3 * e).to(want)
    e_s = torch.from_numpy(rng.uniform(1e-5, 1e-4, (m, S)).astype(np.float32))
    e_s[1] = 0.0                    # client 1: x zero, so y zero
    e_s[2, fin.seg0] = 0.0          # the halves segment: y = x
    if dt == "bf16":
        e_s[0] = 1.0
    x_q = torch.from_numpy(rng.integers(-9, 9, (m, w))).to(want)
    scales = torch.from_numpy(rng.uniform(0, 1, (m, S)).astype(np.float32))
    masks, _, gmaps = _runtimes(ARCHS, port=True)
    state = (x_q, scales, e_q, e_s)
    return index, torch.from_numpy(x), masks, gmaps, case != "nograft", \
        state, cols


ADMIT_CASES = ["graft", "nograft", "cut", "tail"]


@pytest.mark.parametrize("dt", QDTYPES)
@pytest.mark.parametrize("case", ADMIT_CASES)
def test_fused_admission_matches_piece_loop(dt, case):
    """The new ``admit_quantized`` (the kernel's plain version on the CPU)
    bit for bit against the piece loop it replaced: int8 and bf16, graft
    on and off, an all-zero client and segment (scale 0), halves rounded
    to even, the inert tail left alone, and columns cut inside rows whose
    maxima are floored by the other shards' (``all_reduce`` stands in
    with a fixed table of theirs)."""
    index, x, masks, gmaps, graft, state, cols = _admit_case(dt, case)
    rng = np.random.default_rng(11)
    others = [torch.from_numpy(rng.uniform(0, 0.2, state[1].shape)
                               .astype(np.float32)) for _ in range(2)]
    calls = []

    def floor(t):
        t.copy_(torch.maximum(t, others[len(calls) % 2]))
        calls.append(1)

    want = tuple(t.clone() for t in state)
    _frozen_admit(index, CFG, x, masks, gmaps, graft, want, dt, floor, cols)
    got = tuple(t.clone() for t in state)
    orig = flat.coll.all_reduce
    mesh = object() if cols.stop - cols.start < index.n_padded else None
    flat.coll.all_reduce = lambda t, mesh, axis, op="sum": floor(t)
    try:
        flat.admit_quantized(index, CFG, x, masks, gmaps, graft, got, dt,
                             mesh, cols)
    finally:
        flat.coll.all_reduce = orig
    assert len(calls) == (4 if dt == "int8" and mesh else 0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    if dt == "int8":
        fin = next(s for s in index.leaves if s.path[0] == "final_norm")
        if cols.start <= fin.offset:
            a = fin.offset - cols.start
            q = got[0][2, a:a + 12].tolist()
            assert q == [127, -127, 0, 2, 2, 0, -2, 126, -126, 4, 0, 64]
        assert not bool(torch.any(got[0][1, :min(cols.stop, index.n)
                                         - cols.start]))   # all-zero client
        if mesh is None:
            assert float(got[1][1].abs().max()) == 0.0       # scale 0


def _emulate_kernel_y(plan, x, gmaps, graft, fac, e_q, e_s):
    """y as the kernel addresses it, from the plan's tables alone (numpy):
    the tile rows, the x column (the graft's row gather), the state column,
    the segment and each factor's index by the tables' divisors, the
    products rounded in f32 in the kernel's order.  -> the (m, W) y."""
    table, tiles = plan._build()
    m = x.shape[0]
    W = e_q.shape[1]
    xs, gm, fc = x.numpy(), gmaps.numpy(), fac.numpy()
    eq = e_q.to(torch.float32).numpy()
    es = e_s.numpy()
    y = np.full((m, W), np.nan, np.float32)
    div = lambda n, mul, sh: ((n * mul >> 32) + n) >> sh
    for pi, u, t0, ln in tiles.tolist():
        P = table[pi]
        rest, a, xoff, rowlen, j0, c0 = (int(v) for v in P[1:7])
        j, s = j0 + u, int(P[0]) + u
        t = np.arange(t0, t0 + ln, dtype=np.int64)
        col = c0 + t
        for c in range(m):
            src = gm[c, j] if (graft and P[7]) else j
            q = a + u * rest + t
            assert np.isnan(y[c, q]).all()           # each element once
            v = (xs[c, xoff + src * rowlen + col]
                 + (eq[c, q] * es[c, s]).astype(np.float32)) \
                .astype(np.float32)
            d = None
            for k in range(int(P[9])):
                F = P[10 + 7 * k:17 + 7 * k]
                qq = div(col, int(F[1]), int(F[2]))
                idx = qq - div(qq, int(F[4]), int(F[5])) * int(F[6])
                f = fc[c, int(F[0]) + idx]
                d = f if d is None else (d * f).astype(np.float32)
            y[c, q] = v if d is None else (v * d).astype(np.float32)
    return y


def test_admission_plan_tables_address_what_the_twin_reads():
    """The kernel's piece and tile tables, read as the kernel reads them
    (``_emulate_kernel_y``), cover every admitted element once and give
    the y the plain version computes, bit for bit, on the padded cut
    layout and the whole one; the divisors divide."""
    for d in (1, 2, 3, 4, 64, 192, 576, 1536, 49152, (1 << 31) - 1):
        mul, sh, _ = agg_ops._divider(d)
        n = np.array([0, 1, d - 1, d, d + 1, 3 * d + 5, (1 << 31) - 1],
                     np.int64)
        assert mul < 1 << 32
        assert (((n * mul >> 32) + n) >> sh).tolist() == (n // d).tolist()
    for case in ("graft", "cut", "tail"):
        index, x, masks, gmaps, graft, state, cols = _admit_case("int8", case)
        fac, per_leaf = flat._admit_factors(CFG, index, masks, 3, "cpu")
        plan = flat._admit_plan(index, cols, per_leaf, fac.shape[1])
        assert fac.shape[1] % 4 == 0
        got = _emulate_kernel_y(plan, x, gmaps, graft, fac, state[2],
                                state[3])
        want = np.full_like(got, np.nan)
        for p in plan.pieces:
            want[:, p.a:p.a + p.k * p.rest] = agg_ref.admit_rows(
                x, gmaps, fac, state[2], state[3], p, graft) \
                .reshape(3, -1).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))
        assert np.isnan(got).sum() == 3 * (state[0].shape[1] - plan.n_elems)
        assert plan.n_elems == min(cols.stop, index.n) - cols.start


@pytest.mark.parametrize("dt", ["int8", "bf16", "f32"])
def test_admission_counts_its_pieces(dt):
    """A recorded admission counts its pieces under ``admit``: every one
    fused at int8 and bf16 (the kernel's route, its plain version on the
    CPU), every one plain at f32; int8 takes three steps, bf16 one."""
    from repro_torch import tracing
    index = _index()
    masks, _, gmaps = _runtimes(ARCHS, port=True)
    state = fresh_quant_state(index, 3, dt, "cpu")
    n = len(flat._pieces(index, slice(0, index.n_padded)))
    assert n == len(index.leaves)
    calls = []
    orig = agg_ops.ref.quant_admit_ref
    agg_ops.ref.quant_admit_ref = lambda step, *a: (calls.append(step),
                                                    orig(step, *a))
    rec = tracing.start("cpu")
    try:
        flat.admit_quantized(index, CFG, torch.from_numpy(_cohort(4)), masks,
                             gmaps, True, state, dt)
    finally:
        tracing.stop()
        agg_ops.ref.quant_admit_ref = orig
    fused = dt != "f32"
    assert rec.tree()["admit"]["counts"] == {
        "admit_pieces_fused": n if fused else 0,
        "admit_pieces_plain": 0 if fused else n}
    assert calls == {"int8": [1, 2, 3], "bf16": [3], "f32": []}[dt]


def test_quant_admit_checks_its_inputs():
    """The wrapper refuses what the kernel would not take, on every
    device: a wrong state dtype or step, an f32 x of another dtype, a
    state narrower than the plan, a tensor on another device."""
    index, x, masks, gmaps, graft, state, cols = _admit_case("int8", "graft")
    fac, per_leaf = flat._admit_factors(CFG, index, masks, 3, "cpu")
    plan = flat._admit_plan(index, cols, per_leaf, fac.shape[1])
    x_q, scales, e_q, e_s = state
    g = gmaps.long()
    ymax = torch.zeros_like(scales)
    ok = (x, g, True, fac, e_q, e_s, x_q, ymax, ymax.clone(), plan)
    agg_ops.quant_admit(1, *ok)
    with pytest.raises(TypeError, match="int8 or bf16"):
        agg_ops.quant_admit(1, x, g, True, fac, e_q.float(), e_s, x_q, ymax,
                            ymax, plan)
    with pytest.raises(ValueError, match="no step 4"):
        agg_ops.quant_admit(4, *ok)
    with pytest.raises(ValueError, match="no step 1"):
        agg_ops.quant_admit(1, x, g, True, fac, e_q.bfloat16(), e_s,
                            x_q.bfloat16(), None, None, plan)
    with pytest.raises(TypeError, match="x has dtype"):
        agg_ops.quant_admit(1, x.double(), *ok[1:])
    with pytest.raises(TypeError, match="gmaps has dtype"):
        agg_ops.quant_admit(1, x, gmaps.int(), *ok[2:])
    with pytest.raises(ValueError, match="the plan needs"):
        narrow = slice(0, plan.width - 8)
        agg_ops.quant_admit(1, x, g, True, fac, e_q[:, narrow].contiguous(),
                            e_s, x_q[:, narrow].contiguous(), ymax, ymax,
                            plan)
    with pytest.raises(ValueError, match="is on meta"):
        agg_ops.quant_admit(1, x, g, True, fac, e_q, e_s.to("meta"), x_q,
                            ymax, ymax, plan)


def test_quant_state_loader_checks_layout():
    index = _index()
    fresh = fresh_quant_state(index, 2, "int8", "cpu")
    arrays = [t.numpy() for t in fresh]
    assert all(torch.equal(a, b) for a, b in zip(
        quant_state_from_numpy(index, "int8", arrays, "cpu"), fresh))
    with pytest.raises(ValueError, match="x_q"):
        quant_state_from_numpy(index, "bf16", arrays, "cpu")
    with pytest.raises(ValueError, match="scales"):
        quant_state_from_numpy(index, "int8",
                               [arrays[0], arrays[1][:, :3]] + arrays[2:],
                               "cpu")


@pytest.mark.parametrize("dt", QDTYPES)
@pytest.mark.parametrize("strategy",
                         ["fedfa", "heterofl", "fedfa-scale-only"])
def test_aggregate_quantized_matches_reference(strategy, dt):
    x = _cohort(3, m=4)
    rng = np.random.default_rng(4)
    archs = ARCHS + [(0.75, (1, 2))]
    nd = rng.integers(1, 5, len(archs)).astype(np.float32)
    index, jindex = _index(), jflat.get_index(JPARAMS)
    jx_q, jscales = jflat.quantize_cohort(jindex, jnp.asarray(x), dt)
    masks, gates, gmaps = _runtimes(archs, port=True)
    jmasks, jgates, jgmaps = _runtimes(archs, port=False)
    g = np.asarray(jflat.flatten(jindex, JPARAMS))
    kw = dict(pregrafted=True, trim=0.95)
    out = flat.aggregate_buffers(
        index, torch.from_numpy(g), _to_torch(np.asarray(jx_q)), CFG, masks,
        gates, gmaps, torch.from_numpy(nd),
        scales=torch.from_numpy(np.asarray(jscales)), **kw,
        **STRATEGIES[strategy])
    want = jflat.aggregate_buffers(
        jindex, jnp.asarray(g), jx_q, JCFG, jmasks, jgates, jgmaps,
        jnp.asarray(nd), scales=jscales, interpret=True, **kw,
        **JSTRATEGIES[strategy])
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError, match="pregrafted"):
        flat.aggregate_buffers(
            index, torch.from_numpy(g), _to_torch(np.asarray(jx_q)), CFG,
            masks, gates, gmaps, torch.from_numpy(nd),
            scales=torch.from_numpy(np.asarray(jscales)), graft=True)


def _steps(index, want: np.ndarray, dt: str, scales: torch.Tensor):
    """Per element, one admission step of its segment: int8's largest
    scale over the cohort, bf16's ulp at the segment's largest magnitude."""
    row_of = torch.as_tensor(index.row_of).long()
    if dt == "int8":
        return scales.amax(0)[row_of].numpy()
    seg_max = torch.zeros(index.n_segments).scatter_reduce(
        0, row_of, torch.from_numpy(np.abs(want)), "amax")
    return (2.0 ** (torch.floor(torch.log2(seg_max)) - 7))[row_of].numpy()


def assert_round_close(got, want, steps, what, flips_alone=True):
    """Every element within rtol 1e-4 / atol 1e-5 or within one admission
    step.  If ``flips_alone`` (one round from a shared state), also: at
    most 1e-4·N elements past the tolerance, relative L2 within 1e-4."""
    err = np.abs(got - want)
    out = ~(err <= 1e-5 + 1e-4 * np.abs(want))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"{what}: {int(out.sum())} of {got.size} elements past rtol 1e-4 "
          f"/ atol 1e-5, largest {float(err.max()):.3g}, relative L2 "
          f"{rel:.3g}")
    assert (err[out] <= steps[out]).all()
    if flips_alone:
        assert out.sum() <= 1e-4 * got.size
        assert rel <= 1e-4


@pytest.mark.parametrize("dt", QDTYPES)
@pytest.mark.parametrize("synced", [True, False])
def test_resident_quantized_rounds_match_reference(dt, synced):
    """Two resident rounds of the port's driver against the reference's
    (the driver ``run_rounds`` steps), from the same weights, cohort,
    batches and label permutations.  ``synced``: each round starts from the
    reference's global and quantized state, loaded from its numpy arrays,
    so one round's flips are checked alone.  Free-running, round 1's flips
    (a step in a few elements of the global) change round 2's training
    everywhere and flip more elements there (about 200 for int8, 570 for
    bf16, of N = 2.4M): every element stays within one step, but neither
    the count nor the relative L2 (2.4e-4 for int8) keeps to the bounds of
    a single round."""
    M, E, ROUNDS = 3, 2, 2
    _, jdata = make_cohort(JCFG, M, local_steps=E, malicious_frac=0.34)
    specs, data = _port_cohort(M, malicious_frac=0.34)
    jfl = JFLConfig(local_steps=E, lr=0.05, strategy="fedfa", task="cls",
                    update_dtype=dt)
    fl = FLConfig(local_steps=E, lr=0.05, strategy="fedfa", task="cls",
                  update_dtype=dt)
    jindex = jflat.get_index(JPARAMS)
    jdriver = jround.ResidentDriver(JCFG, jfl, jindex)
    jg = jflat.flatten(jindex, JPARAMS)
    params = params_from_numpy(jax.tree.map(np.asarray, JPARAMS), CFG, "cpu")
    index = flat.FlatIndex(params)
    driver = ResidentDriver(CFG, fl, index, "cpu")
    g_buf = flat.flatten(index, params)
    for r in range(ROUNDS):
        if synced and r > 0:
            g_buf.copy_(torch.from_numpy(np.asarray(jg)))
            jstate = [np.asarray(a) for a in jdriver._cbufs[(M, dt)]]
            for t, a in zip(driver.pool(M)[1], quant_state_from_numpy(
                    index, dt, jstate, "cpu")):
                t.copy_(a)
        jspecs, jbatches = jdata(r)
        jg, jloss = jdriver.round(jg, jspecs, jbatches,
                                  jax.random.fold_in(KEY, r))
        _, batches = data(r)
        perms = _jax_perms(r, M, batches["labels"][0].numel())
        loss = float(driver.round(g_buf, specs, batches, perms))
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-4)
        want = np.asarray(jg)
        assert_round_close(g_buf.numpy(), want,
                           _steps(index, want, dt, driver.pool(M)[1][1]),
                           f"{dt} global after round {r}",
                           flips_alone=synced or r == 0)


def test_driver_keeps_f32_and_quantized_pools_apart():
    specs, data = _port_cohort(3)
    fl = FLConfig(local_steps=2, lr=0.05, strategy="fedfa", task="cls")
    params = params_from_numpy(jax.tree.map(np.asarray, JPARAMS), CFG, "cpu")
    index = flat.FlatIndex(params)
    driver = ResidentDriver(CFG, fl, index, "cpu")
    g_buf = flat.flatten(index, params)
    driver.round(g_buf, specs, data(0)[1])
    fl.update_dtype = "int8"
    driver.round(g_buf, specs, data(1)[1])
    (c8, q8), (c32, q32) = driver.pool(3), driver._pools[(3, "f32")]
    assert set(driver._pools) == {(3, "f32"), (3, "int8")}
    assert q32 is None and q8[0].dtype == torch.int8
    assert c32.data_ptr() != c8.data_ptr()
    assert bool(torch.any(q8[0] != 0)) and bool(torch.any(q8[3] != 0))


@pytest.mark.parametrize("dt", QDTYPES)
def test_cli_quantized_runs_on_cpu(dt):
    res = train.main(["--rounds", "2", "--clients", "4", "--batch", "2",
                      "--seq-len", "8", "--update-dtype", dt, "--device",
                      "cpu"])
    assert res["round"] == [0, 1] and len(res["round_loss"]) == 2
    assert np.all(np.isfinite(res["round_loss"]))


def test_cli_per_round_quantized_runs_at_f32(capsys):
    args = ["--rounds", "1", "--clients", "4", "--batch", "2", "--seq-len",
            "8", "--driver", "per-round", "--device", "cpu"]
    res = train.main(args + ["--update-dtype", "int8"])
    assert "running the per-round driver at f32" in capsys.readouterr().out
    assert res["round_loss"] == train.main(args)["round_loss"]
