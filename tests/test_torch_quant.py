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
