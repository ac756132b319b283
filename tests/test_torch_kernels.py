"""The port's kernel wrappers on the CPU (their plain PyTorch versions,
which the CUDA kernels are held against on the card) against the JAX
package's kernels in interpret mode and their jnp references.

Tolerances: thresholds t are bit-equal (both sides find exact order
statistics and interpolate with the same f32 operations); sums of squares
and weighted sums agree to the f32 rounding of a different summation
order (rtol 1e-5 and 1e-6)."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fedfa_agg import ops as jagg_ops
from repro.kernels.fedfa_agg import ref as jagg_ref
from repro.kernels.fedfa_quantile import multilevel as jml
from repro.kernels.fedfa_quantile import ops as jq_ops
from repro.kernels.fedfa_quantile import ref as jq_ref
from repro_torch.kernels.fedfa_agg import ops as agg_ops
from repro_torch.kernels.fedfa_quantile import multilevel, ops, ref

torch.set_num_threads(2)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("m,n", [(1, 7), (3, 1000), (5, 4096), (8, 5003)])
def test_scaled_accum_matches_reference(m, n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(m, n)).astype(np.float32)
    w = rng.uniform(0, 5, m).astype(np.float32)
    mask = (rng.random(n) < 0.8).astype(np.float32)
    before = agg_ops.SCALED_ACCUM.launches
    out = agg_ops.scaled_accum(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(mask)).numpy()
    assert agg_ops.SCALED_ACCUM.launches == before   # CPU: the plain version
    # f32 sums in another order: error relative to the summed magnitudes
    tol = dict(rtol=1e-6,
               atol=1e-6 * float((np.abs(w)[:, None] * np.abs(x)).sum(0).max()))
    np.testing.assert_allclose(out, np.asarray(jagg_ref.scaled_accum_ref(
        x, w, mask)), **tol)
    np.testing.assert_allclose(out, np.asarray(jagg_ops.accumulate(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask), interpret=True)),
        **tol)


@pytest.mark.parametrize("m,n", [(3, 512), (8, 5000), (16, 12_345)])
def test_scaled_accum_bf16_matches_reference(m, n):
    """bf16 rows, upcast as they are read (weights and mask stay f32), at
    the JAX sweep's shapes."""
    rng = np.random.default_rng(m)
    x = np.asarray(jnp.asarray(rng.normal(size=(m, n)), jnp.bfloat16))
    w = rng.uniform(0, 1, m).astype(np.float32)
    mask = (np.arange(n) < int(0.7 * n)).astype(np.float32)
    before = agg_ops.SCALED_ACCUM.launches
    out = agg_ops.scaled_accum(torch.from_numpy(x.astype(np.float32)).to(
        torch.bfloat16), torch.from_numpy(w), torch.from_numpy(mask)).numpy()
    assert agg_ops.SCALED_ACCUM.launches == before
    xf = x.astype(np.float32)
    tol = dict(rtol=1e-6,
               atol=1e-6 * float((np.abs(w)[:, None] * np.abs(xf)).sum(0)
                                 .max()))
    np.testing.assert_allclose(out, np.asarray(jagg_ops.accumulate(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask), interpret=True)),
        **tol)


@pytest.mark.parametrize("n", [1000, 4096, 50_000])
def test_trimmed_norm_bf16_matches_reference(n):
    """bf16 vectors at the JAX sweep's lengths and threshold (its 0.95
    quantile of |w|), against the interpret-mode kernel."""
    w = np.asarray(jnp.asarray(np.random.default_rng(n).normal(size=n),
                               jnp.bfloat16))
    t = jnp.quantile(jnp.abs(jnp.asarray(w).astype(jnp.float32)), 0.95)
    tw = torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16)
    got = agg_ops.trimmed_norm(tw, float(t))
    want = jagg_ops.trimmed_norm(jnp.asarray(w), t, interpret=True)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(
        float(agg_ops.trimmed_sumsq(tw, torch.tensor(float(t)))),
        float(jagg_ref.trimmed_sumsq_ref(jnp.asarray(w), t)), rtol=1e-6)


def test_interpolation_matches_jnp_quantile():
    """t = v0·(1−frac) + v1·frac rounds as jnp.quantile compiles it (one
    product fused into the add), bit for bit: on two-element rows
    [v0, v1] the level q is the interpolation weight itself."""
    rng = np.random.default_rng(0)
    v0 = np.abs(rng.normal(size=20000)).astype(np.float32)
    v1 = (v0 + np.abs(rng.normal(size=20000)) * 0.01).astype(np.float32)
    frac = rng.random(20000).astype(np.float32)
    frac[:100] = 0.0
    want = jax.vmap(jnp.quantile)(jnp.stack([v0, v1], 1), frac)
    got = ref.interpolate(*map(torch.from_numpy, (v0, v1, frac)))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _rows(kind, R, L, seed):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=(R, L)).astype(np.float32)
    if kind == "ties":        # few distinct magnitudes, both signs
        return (rng.integers(-4, 5, (R, L)) * 0.25).astype(np.float32)
    if kind == "zeros":       # all-masked rows: every magnitude is 0
        return np.zeros((R, L), np.float32)
    raise ValueError(kind)


CASES = [("normal", 3, 1000, "mid"), ("normal", 4, 4093, "mid"),
         ("ties", 3, 2048, "mid"), ("zeros", 2, 1500, "mid"),
         ("normal", 3, 1537, "ends"), ("ties", 2, 1, "ends"),
         ("normal", 2, 2, "ends")]


def _levels(how, R, seed):
    if how == "ends":
        return np.array([0.0, 1.0, 0.5][:R] + [1.0] * max(0, R - 3),
                        np.float32)
    return np.random.default_rng(seed + 1).uniform(0.9, 1.0, R) \
        .astype(np.float32)


@pytest.mark.parametrize("kind,R,L,how", CASES)
def test_quantile_fused_matches_reference(kind, R, L, how):
    rows, q = _rows(kind, R, L, L), _levels(how, R, L)
    t, ss = ops.quantile_fused(torch.from_numpy(rows), torch.from_numpy(q))
    jt, jss = jq_ops.row_trimmed_stats(jnp.asarray(rows), jnp.asarray(q),
                                       interpret=True)
    rt, _ = jq_ref.row_trimmed_stats_ref(jnp.asarray(rows), jnp.asarray(q))
    np.testing.assert_array_equal(_bits(t), _bits(jt))
    np.testing.assert_array_equal(_bits(t), _bits(rt))
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss), rtol=1e-5)


@pytest.mark.parametrize("kind,R,L,how", CASES)
def test_multilevel_matches_reference(kind, R, L, how):
    rows, q = _rows(kind, R, L, L + 7), _levels(how, R, L)
    t, ss = multilevel.row_trimmed_stats_multilevel(torch.from_numpy(rows),
                                                    torch.from_numpy(q))
    jt, jss = jml.row_trimmed_stats_multilevel(jnp.asarray(rows),
                                               jnp.asarray(q), interpret=True)
    pt, pss = ref.row_trimmed_stats_ref(torch.from_numpy(rows),
                                        torch.from_numpy(q))
    np.testing.assert_array_equal(_bits(t), _bits(jt))
    np.testing.assert_array_equal(_bits(t), _bits(pt))
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss), rtol=1e-5)
    np.testing.assert_allclose(ss.numpy(), pss.numpy(), rtol=1e-5)


def _segmented_case(seed):
    rng = np.random.default_rng(seed)
    m, C, S = 3, 1024, 3
    x = rng.normal(size=(m, C)).astype(np.float32)
    seg = np.repeat(np.arange(S, dtype=np.int32), [300, 500, 200])
    seg = np.concatenate([seg, np.full(C - seg.size, -1, np.int32)])
    seg_len = np.bincount(seg[seg >= 0], minlength=S).astype(np.int32)
    q = rng.uniform(0.9, 1.0, (m, S)).astype(np.float32)
    return x, seg, seg_len, q


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_hist_level_planes_match_reference(level):
    """One level's count and Σx² planes, with segments, inert columns and a
    resolved prefix taken from the data so later levels see real brackets."""
    x, seg, _, _ = _segmented_case(level)
    m, S = x.shape[0], 3
    shift = 24 - 8 * level
    bits = np.abs(x).view(np.int32)
    hs = min(shift + 8, 31)
    hi = np.stack([bits[:, [0, 300, 800]] >> hs,
                   bits[:, [1, 301, 801]] >> hs], axis=1)
    hi = np.ascontiguousarray(hi, dtype=np.int32)
    cnt, sq = multilevel.hist_level(torch.from_numpy(x), torch.from_numpy(seg),
                                    torch.from_numpy(hi), shift)
    jcnt, jsq = jml._hist_call(jnp.asarray(x), jnp.asarray(seg),
                               jnp.ones((m, S), jnp.float32), jnp.asarray(hi),
                               jnp.asarray(shift, jnp.int32), interpret=True)
    assert int(cnt.sum()) > 0
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_allclose(sq.numpy(), np.asarray(jsq), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_segmented_stats_match_reference(seed):
    x, seg, seg_len, q = _segmented_case(seed)
    t, ss = multilevel.segmented_trimmed_stats(
        torch.from_numpy(x), torch.from_numpy(seg),
        torch.from_numpy(seg_len), torch.from_numpy(q))
    # jitted, as the JAX round runs it: XLA fuses the interpolation's
    # multiply-add only in compiled code
    jt, jss = jax.jit(functools.partial(jml.segmented_trimmed_stats,
                                        interpret=True))(
        jnp.asarray(x), jnp.asarray(seg), jnp.asarray(seg_len), jnp.asarray(q))
    np.testing.assert_array_equal(_bits(t), _bits(jt))
    np.testing.assert_allclose(ss.numpy(), np.asarray(jss), rtol=1e-5)


def test_long_rows_dispatch_to_multilevel(monkeypatch):
    """The JAX dispatch rule: rows whose lane-padded length exceeds 2^18
    take the multilevel path, shorter rows the single-pass kernel."""
    calls = []
    real = multilevel.row_trimmed_stats_multilevel
    monkeypatch.setattr(ops.multilevel, "row_trimmed_stats_multilevel",
                        lambda r, q, *scale: calls.append(r.shape)
                        or real(r, q, *scale))
    rng = np.random.default_rng(0)
    short = torch.from_numpy(rng.normal(size=(2, 1 << 18)).astype(np.float32))
    long = torch.from_numpy(
        rng.normal(size=(2, (1 << 18) + 1)).astype(np.float32))
    q = torch.tensor([0.95, 0.97])
    ops.row_trimmed_stats(short, q)
    assert calls == []
    t, ss = ops.row_trimmed_stats(long, q)
    assert calls == [(2, (1 << 18) + 1)]
    pt, pss = ref.row_trimmed_stats_ref(long, q)
    np.testing.assert_array_equal(_bits(t), _bits(pt))
    np.testing.assert_allclose(ss.numpy(), pss.numpy(), rtol=1e-5)


def test_wrappers_reject_other_devices():
    """Off the CPU a wrapper launches its kernel or raises: a tensor on
    another device type never falls back to the plain version."""
    x = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError):
        agg_ops.scaled_accum(x, torch.empty(2, device="meta"),
                             torch.empty(8, device="meta"))
    with pytest.raises(ValueError):
        ops.quantile_fused(x, torch.empty(2, device="meta"))
    with pytest.raises(ValueError):
        multilevel.hist_level(x, torch.empty(8, dtype=torch.int32,
                                             device="meta"),
                              torch.empty((2, 2, 1), dtype=torch.int32,
                                          device="meta"), 24)


def _plane_case(dtype, S, seed=0):
    """Rows (3, 1500) of ``dtype`` with S segments and inert columns, and
    their quantile levels: f32 rows; int8 rows quantized per (row,
    segment) with their scales; bf16 rows with unit scales.  The values
    lie on a grid of 1/8 (exact in bf16), so neighbouring order
    statistics often tie and the floor and ceil prefixes agree at every
    level, as they do on the main path's long rows."""
    rng = np.random.default_rng(seed)
    m, C = 3, 1500
    x = (np.round(rng.normal(size=(m, C)) * 8) / 8).astype(np.float32)
    seg = (np.arange(C) % (S + 1) - 1).astype(np.int32)     # every S+1-th inert
    seg_len = np.bincount(seg[seg >= 0], minlength=S).astype(np.int64)
    q = torch.from_numpy(rng.uniform(0.9, 1.0, (m, S)).astype(np.float32))
    x = torch.from_numpy(x)
    sc = None
    if dtype == "int8":
        segs = torch.from_numpy(seg).clamp(min=0).long()
        amax = torch.zeros((m, S)).scatter_reduce(
            1, segs.expand(m, C), x.abs(), "amax")
        sc = amax / 127.0
        x = torch.round(x / sc[:, segs]).clamp(-127, 127).to(torch.int8)
    elif dtype == "bf16":
        x, sc = x.to(torch.bfloat16), torch.ones((m, S))
    return x, torch.from_numpy(seg), torch.from_numpy(seg_len), q, sc


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("dtype", ["f32", "int8", "bf16"])
def test_hist_level_planes_equal_where_prefixes_agree(dtype, S):
    """What the CUDA hist_level relies on to build one plane where a row's
    floor and ceil prefixes agree and copy it into the other: the plain
    version's two planes are then equal, counts and Σx².  At every level of
    the search, with the prefixes the plain level loop finds."""
    x, seg, seg_len, q, sc = _plane_case(dtype, S)
    levels = multilevel.level_prefixes(x, seg, seg_len, q, sc)
    assert [shift for shift, _ in levels] == [24, 16, 8, 0]
    agree = []
    for shift, hi in levels:
        cnt, sq = multilevel.hist_level(x, seg, hi, shift, sc)
        same = hi[:, 0] == hi[:, 1]                          # (m, S)
        agree.append(int(same.sum()))
        assert torch.equal(cnt[:, 0][same], cnt[:, 1][same])
        assert torch.equal(sq[:, 0][same], sq[:, 1][same])
        assert int(cnt[:, 0][same].sum()) > 0 or not same.any()
    # the top level's prefixes are all 0; every level has agreeing ones
    assert agree[0] == 3 * S and min(agree) > 0


def test_hist_level_planes_differ_where_prefixes_differ():
    """The same planes with the ceil path's prefix moved to the bin below
    it at the level above: the planes differ, and each is the one its own
    prefix gives."""
    x, seg, seg_len, q, sc = _plane_case("f32", 1)
    shift, hi = multilevel.level_prefixes(x, seg, seg_len, q, sc)[1]
    moved = hi.clone()
    moved[:, 1] -= 1
    cnt, sq = multilevel.hist_level(x, seg, moved, shift, sc)
    assert not torch.equal(cnt[:, 0], cnt[:, 1])
    assert int(cnt[:, 1].sum()) > 0
    for p, prefix in ((0, hi[:, 0]), (1, moved[:, 1])):
        alone = torch.stack([prefix, prefix], dim=1)
        c1, s1 = multilevel.hist_level(x, seg, alone, shift, sc)
        assert torch.equal(cnt[:, p], c1[:, 0])
        assert torch.equal(sq[:, p], s1[:, 0])


@pytest.mark.parametrize("how", ["permute", "split"])
@pytest.mark.parametrize("dtype", ["f32", "int8", "bf16"])
def test_hist_level_integer_planes_exact_under_reorder(dtype, how):
    """The Σx² planes are exact integers in each bin's units, so the kernel's
    blocks, and model shards whose planes are all-reduced, may add them in
    any order: the plain planes of permuted columns, or the sum of the
    planes of uneven chunks of the columns, equal the whole row's bit for
    bit, at every level of the search; scaled to f32 they lie within one
    f32 rounding of the f64 sum of the squares."""
    x, seg, seg_len, q, sc = _plane_case(dtype, 3, seed=2)
    C = x.shape[1]
    for shift, hi in multilevel.level_prefixes(x, seg, seg_len, q, sc):
        cnt, sq = ref.hist_level_planes_ref(x, seg, hi, shift, sc)
        assert sq.dtype == torch.int64 and int(cnt.sum()) > 0
        if how == "permute":
            perm = torch.randperm(C, generator=torch.Generator().manual_seed(
                shift))
            c2, s2 = ref.hist_level_planes_ref(x[:, perm], seg[perm], hi,
                                               shift, sc)
        else:
            c2, s2 = torch.zeros_like(cnt), torch.zeros_like(sq)
            for c0, c1 in ((0, 1), (1, 377), (377, 1000), (1000, C)):
                a, b = ref.hist_level_planes_ref(x[:, c0:c1].contiguous(),
                                                 seg[c0:c1], hi, shift, sc)
                c2, s2 = c2 + a, s2 + b
        assert torch.equal(cnt, c2) and torch.equal(sq, s2)
        # the f32 planes against an f64 sum of the same squares
        a = x.to(torch.float32)
        if sc is not None:
            a = a * sc[:, seg.clamp(min=0).long()]
        a = a.abs()
        bits = a.view(torch.int32)
        m, S = hi.shape[0], hi.shape[2]
        want = torch.zeros((m, 2, S, 256), dtype=torch.float64)
        for p in range(2):
            inb = ((bits >> min(shift + 8, 31)) == hi[:, p][:, seg.clamp(
                min=0).long()]) & (seg >= 0)
            for r in range(m):
                idx = (seg.long() * 256 + ((bits[r] >> shift) & 0xFF))[inb[r]]
                want[r, p].view(-1).index_add_(
                    0, idx, (a[r] * a[r]).double()[inb[r]])
        np.testing.assert_allclose(ref.scale_sums(sq, hi, shift).numpy(),
                                   want.numpy(), rtol=2 ** -24, atol=0)


@pytest.mark.parametrize("shift", [24, 16, 8, 0])
def test_hist_level_scale_sums_rounds_once(shift):
    """``scale_sums`` is each bin's (float)((double)t · 2^(2 ef − 254 −
    KFRAC)), ef the exponent field of the bin's lowest bit pattern (the
    prefix above the byte, the bin at it), element by element in Python:
    bit for bit, for integers up to 2^60."""
    g = torch.Generator().manual_seed(shift)
    hs = min(shift + 8, 31)
    hi = torch.randint(0, 1 << (31 - hs) if hs < 31 else 1, (2, 2, 3),
                       generator=g, dtype=torch.int32)
    e = torch.randint(0, 61, (2, 2, 3, 256), generator=g)
    sq = torch.randint(0, 1 << 62, (2, 2, 3, 256), generator=g,
                       dtype=torch.int64) >> (62 - e)
    got = ref.scale_sums(sq, hi, shift)
    top = (hi.long() << hs) if hs < 31 else torch.zeros_like(hi).long()
    want = np.empty(tuple(sq.shape), dtype=np.float32)
    for i in np.ndindex(*sq.shape):
        ef = (int(top[i[:3]]) | (i[3] << shift)) >> 23
        want[i] = np.float32(math.ldexp(float(int(sq[i])),
                                        2 * ef - 254 - ref.KFRAC))
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n,fits", [(2 ** 31 - 1, True), (2 ** 31, False)])
def test_hist_level_row_limit(n, fits):
    """The counts are int32: a row of 2^31 elements is refused before a
    launch, a shorter one fits, and its bin sums stay within int64."""
    if fits:
        ref.check_row_length(n)
        assert n * ((1 << (ref.KFRAC + 5)) - 1) < 2 ** 63
    else:
        with pytest.raises(ValueError, match="2\\^31"):
            ref.check_row_length(n)


@pytest.mark.parametrize("itemsize", [4, 2, 1])
def test_quantile_cluster_geometry_over_single_pass_lengths(itemsize):
    """quantile_fused's launch geometry for every row length the single-pass
    kernel takes (L <= 2^18): a cluster of 1, 2, 4 or 8 CTAs that holds the
    row in 16-byte vectors, at most 64 KB of it a CTA unless 8 CTAs do not
    allow it, the fewest such CTAs, and a CTA's shared memory within the
    227 KB a block may take.  The main path's (240, 110,592) rows take 8,
    4 and 2 CTAs at f32, bf16 and int8; rows 8 CTAs cannot hold raise."""
    vec = 16 // itemsize
    part = ops._CLUSTER_PART
    for L in range(1, (1 << 18) + 1):
        cs, per, smem = ops.cluster_geometry(L, itemsize)
        assert cs in (1, 2, 4, 8) and cs * per >= L and per % vec == 0
        assert per * itemsize <= part or cs == 8
        assert cs == 1 or -(-(-(-L // (cs // 2))) // vec) * vec * itemsize \
            > part
        assert smem == per * itemsize + 16 + ops._STATIC_SMEM <= 232_448
    assert ops.cluster_geometry(110_592, itemsize)[0] == {4: 8, 2: 4,
                                                          1: 2}[itemsize]
    with pytest.raises(ValueError, match="do not fit"):
        ops.cluster_geometry(8 * (232_448 // itemsize), itemsize)


def test_library_name_hashes_shared_headers(tmp_path):
    """A kernel's library is named by its source, every header beside it
    and the flags: editing a shared header names every kernel's library
    anew, so each is rebuilt."""
    from repro_torch.kernels.build import CudaKernel
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "b.cu").write_text("// no header\n")
    (tmp_path / "shared.cuh").write_text("// helpers\n")
    a = CudaKernel(str(tmp_path / "a.cu"), "a", [])
    b = CudaKernel(str(tmp_path / "b.cu"), "b", [])
    before = (a.library, b.library)
    assert a.library == before[0]          # the same files, the same name
    (tmp_path / "shared.cuh").write_text("// helpers, edited\n")
    assert a.library != before[0] and b.library != before[1]
    edited = a.library
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert a.library not in (before[0], edited)


def test_ablation_edits_match_their_sources():
    """launch/ablate.py builds each variant by text replacements in its
    kernel's source: every replaced text is still in the source (the tool
    raises on one that is not)."""
    from repro_torch.launch import ablate
    for kernel, variants in (
            (ablate.FLASH_ATTENTION, ablate.FLASH_VARIANTS),
            (ablate.HIST_LEVEL, ablate.HIST_VARIANTS),
            (ablate.SSD_INTRA_CHUNK, ablate.SSD_VARIANTS),
            (ablate.QUANTILE_FUSED, ablate.QUANTILE_VARIANTS)):
        src = kernel.source.read_text()
        for name, edits in variants:
            for old, _ in edits:
                assert old in src, (kernel.symbol, name, old)


def test_library_name_hashes_defines(tmp_path):
    """A kernel's compile-time values (-D flags) are part of its library's
    name: changing one rebuilds it."""
    from repro_torch.kernels.build import CudaKernel
    (tmp_path / "a.cu").write_text("// uses N\n")
    one = CudaKernel(str(tmp_path / "a.cu"), "a", [], defines={"N": 1})
    two = CudaKernel(str(tmp_path / "a.cu"), "a", [], defines={"N": 2})
    assert "-DN=1" in one.flags and "-DN=2" in two.flags
    assert one.library != two.library
    assert one.library == CudaKernel(str(tmp_path / "a.cu"), "a", [],
                                     defines={"N": 1}).library


def test_launch_counts_by_shape(tmp_path):
    """``launch`` counts every launch, and by shape where the wrapper names
    one; ``reset`` zeroes both; a launch that fails counts nowhere."""
    from repro_torch.kernels.build import CudaKernel
    (tmp_path / "a.cu").write_text("\n")
    k = CudaKernel(str(tmp_path / "a.cu"), "a", [])
    rcs = iter([0, 0, 0, 2])
    k._fn = lambda *args: next(rcs)
    k.launch(1, shape=(240, 576))
    k.launch(2, shape=(240, 576))
    k.launch(3)
    with pytest.raises(RuntimeError, match="failed to launch"):
        k.launch(4, shape=(8, 576))
    assert k.launches == 3 and dict(k.by_shape) == {(240, 576): 2}
    k.reset()
    assert k.launches == 0 and not k.by_shape


def test_quantile_fused_limits_set_in_one_place():
    """quantile_fused's launch limits are set in ops.py alone: the kernel
    is built with each as a -D flag and takes its constant from it."""
    src = ops.QUANTILE_FUSED.source.read_text()
    for name, value in (("QF_MAX_CLUSTER", ops._MAX_CLUSTER),
                        ("QF_STATIC_SMEM", ops._STATIC_SMEM),
                        ("QF_GATHER", ops._GATHER),
                        ("QF_SMEM_MAX", ops._SMEM_MAX)):
        assert f"-D{name}={value}" in ops.QUANTILE_FUSED.flags
        assert f" = {name};" in src, name
