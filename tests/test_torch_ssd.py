"""The port's SSD (``repro_torch.kernels.ssd``, ``repro_torch.models.ssm``)
against the JAX package's, on the CPU, where the wrapper runs its plain
version: the intra-chunk function against the Pallas kernel in interpret
mode and its jnp oracle, the chunked SSD, and the SSD block's prefill and
decode at full width and with half its heads masked.

Tolerances: f32 at atol 1e-5 (the intra-chunk products are sums of at most
128 terms taken in another order; L, summed in the reference's own order,
is bit-equal); rtol 1e-5 / atol 1e-5 for the chunked SSD (the carry adds
one product per chunk), rtol 1e-4 / atol 1e-5 for the block (two
projections and a norm around it); bf16 inputs at atol 1e-2, as the JAX
package's own sweep holds its bf16 SSD (both widen to f32 first).  The
emulation of the CUDA kernel's split-TF32 route is held at the card's
check, 1e-4 + 1e-4·|w|."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels.ssd import ops as jssd_ops
from repro.kernels.ssd import ref as jssd_ref
from repro.kernels.ssd.kernel import ssd_intra_chunk as jssd_intra_chunk
from repro.models import masks as jmasks
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro_torch.configs import get_arch
from repro_torch.kernels.ssd import ops, ref
from repro_torch.models import masks, ssm
from repro_torch.models.model import _to_torch, params_from_numpy

torch.set_num_threads(2)

SHAPES = [(2, 96, 4, 32, 16, 32),       # b, S, nh, hp, N, Q
          (1, 128, 2, 64, 32, 64),
          (2, 70, 3, 32, 16, 32)]       # ragged: S % Q != 0
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(b, S, nh, hp, N, dtype, seed=0):
    """x, dt (post-softplus), A, B, C as numpy, made from a seed."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, S, nh, hp)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, S, nh)))).astype(np.float32)
    A = (-np.exp(rng.normal(size=(nh,)) * 0.2)).astype(np.float32)
    B = (rng.normal(size=(b, S, N)) * 0.3).astype(np.float32)
    C = (rng.normal(size=(b, S, N)) * 0.3).astype(np.float32)
    cast = DTYPES[dtype][0]
    return x.astype(cast), dt, A, B.astype(cast), C.astype(cast)


def _t(a):
    return _to_torch(np.asarray(a))


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _grouped(x, dt, B, C, Q):
    """The (batch·chunks) layout of ``ssd/ops.py``, zero-padded."""
    pad = (-x.shape[1]) % Q
    x = np.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0)))
    dt = np.pad(dt, ((0, 0), (0, pad), (0, 0)))
    B = np.pad(B, ((0, 0), (0, pad), (0, 0)))
    C = np.pad(C, ((0, 0), (0, pad), (0, 0)))
    G = x.shape[0] * x.shape[1] // Q
    return (x.reshape(G, Q, *x.shape[2:]), dt.reshape(G, Q, -1),
            B.reshape(G, Q, -1), C.reshape(G, Q, -1))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,S,nh,hp,N,Q", SHAPES)
def test_intra_chunk_matches_kernel_and_oracle(b, S, nh, hp, N, Q, dtype):
    x, dt, A, B, C = _inputs(b, S, nh, hp, N, dtype)
    xg, dtg, Bg, Cg = _grouped(x, dt, B, C, Q)
    got = ops.ssd_intra_chunk(_t(xg), _t(dtg), _t(A), _t(Bg), _t(Cg))
    assert all(t.dtype == torch.float32 for t in got)
    args = [jnp.asarray(a) for a in (xg, dtg, A, Bg, Cg)]
    kern = jssd_intra_chunk(*args, interpret=True)
    orac = jssd_ref.ssd_intra_chunk_ref(*args)
    atol = 1e-5 if dtype == "float32" else 1e-2
    for want in (kern, orac):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0,
                                       atol=atol)
        # L = cumsum(dt·A) is summed in the reference's order
        np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))


@pytest.mark.parametrize("b,S,nh,hp,N,Q", SHAPES)
def test_chunked_ssd_matches_reference(b, S, nh, hp, N, Q):
    x, dt, A, B, C = _inputs(b, S, nh, hp, N, "float32", seed=1)
    y, h = ops.ssd(*(_t(a) for a in (x, dt, A, B, C)), Q)
    ry, rh = ref.ssd_chunked_ref(*(_t(a) for a in (x, dt, A, B, C)), Q)
    assert torch.equal(y, ry) and torch.equal(h, rh)   # same CPU path
    args = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    for wy, wh in (jssd_ops.ssd(*args, Q, use_kernel=False, interpret=True),
                   jssm.ssd_chunked_ref(*args, Q)):
        np.testing.assert_allclose(_np(y), np.asarray(wy), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(_np(h), np.asarray(wh), rtol=1e-5,
                                   atol=1e-5)


def test_intra_chunk_checks_inputs():
    x, dt, A, B, C = _inputs(1, 32, 2, 8, 8, "float32")
    x, dt, A, B, C = (_t(a) for a in (x[0, None], dt[0, None], A, B[0, None],
                                      C[0, None]))
    with pytest.raises(TypeError):
        ops.ssd_intra_chunk(x, dt, A, B.to(torch.bfloat16), C)
    with pytest.raises(ValueError, match="shape"):
        ops.ssd_intra_chunk(x, dt[:, :16], A, B, C)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_intra_chunk(x.transpose(2, 3).contiguous().transpose(2, 3),
                            dt, A, B, C)


# --- the SSD block, at the reduced mamba2 size ----------------------------

JCFG = jax_get_arch("mamba2-130m").reduced()
CFG = get_arch("mamba2-130m").reduced()


def _block_params():
    """Repeat 0 of stage 0's SSD block of the JAX init, both ways."""
    jp = jmodel.init_params(JCFG, jax.random.PRNGKey(2))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), CFG, "cpu")
    jblk = jax.tree.map(lambda a: a[0], jp["stages"][0][0]["ssd"])
    blk = {k: v[0] for k, v in params["stages"][0][0]["ssd"].items()}
    # a nonzero norm scale, A_log, D and dt_bias, so each is exercised
    rng = np.random.default_rng(3)
    for k in ("norm", "A_log", "D", "dt_bias"):
        v = (rng.normal(size=blk[k].shape) * 0.3).astype(np.float32)
        jblk = dict(jblk, **{k: jnp.asarray(v)})
        blk[k] = torch.from_numpy(v)
    return jblk, blk


@pytest.mark.parametrize("width", [1.0, 0.5])
def test_ssd_block_prefill_and_decode_match_reference(width):
    jblk, blk = _block_params()
    jm, m = jmasks.width_masks(JCFG, width), masks.width_masks(CFG, width)
    np.testing.assert_array_equal(_np(m.ssm_heads), np.asarray(jm.ssm_heads))
    assert (width < 1.0) == bool((m.ssm_heads == 0).any())
    D = CFG.d_model
    rng = np.random.default_rng(4)
    u = rng.normal(size=(2, 45, D)).astype(np.float32)
    tok = rng.normal(size=(3, 2, 1, D)).astype(np.float32)
    kw = dict(head_mask=m.ssm_heads, d_model_mask=m.d_model)
    jkw = dict(head_mask=jm.ssm_heads, d_model_mask=jm.d_model)
    cache = ssm.init_ssm_cache(2, D, CFG.ssm, torch.float32, "cpu")
    jcache = jssm.init_ssm_cache(2, D, JCFG.ssm, jnp.float32)
    out, cache = ssm.ssd_forward(blk, torch.from_numpy(u), CFG.ssm, D,
                                 cache=cache, **kw)
    jout, jcache = jssm.ssd_forward(jblk, jnp.asarray(u), JCFG.ssm, D,
                                    cache=jcache, **jkw)
    outs = [(out, jout)]
    for t in tok:
        out, cache = ssm.ssd_decode(blk, torch.from_numpy(t), CFG.ssm, D,
                                    cache, **kw)
        jout, jcache = jssm.ssd_decode(jblk, jnp.asarray(t), JCFG.ssm, D,
                                       jcache, **jkw)
        outs.append((out, jout))
    for o, jo in outs:
        np.testing.assert_allclose(_np(o), np.asarray(jo), rtol=1e-4,
                                   atol=1e-5)
    for c, jc in zip(cache, jcache):
        np.testing.assert_allclose(_np(c), np.asarray(jc, np.float32),
                                   rtol=1e-4, atol=1e-5)
    assert int(cache.pos) == 45 + len(tok)


def test_softplus_follows_jax_above_twenty():
    x = np.array([-30.0, -1.0, 0.0, 3.0, 19.0, 20.5, 40.0], np.float32)
    np.testing.assert_array_equal(ssm.softplus(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.nn.softplus(x)))


# --- the CUDA kernel's tensor-core route, emulated on the CPU -------------

def _within_card_tolerance(got, want):
    """chip_smoke.py's check of the kernel's y and state: |got - want| <=
    1e-4 + 1e-4·|want|."""
    got, want = _np(got), np.asarray(want, np.float32)
    return bool((np.abs(got - want) <= 1e-4 + 1e-4 * np.abs(want)).all())


@functools.lru_cache(maxsize=None)
def _interpret(b, S, nh, hp, N, Q, dtype):
    """The grouped inputs and the Pallas kernel's outputs in interpret mode."""
    x, dt, A, B, C = _inputs(b, S, nh, hp, N, dtype)
    xg, dtg, Bg, Cg = _grouped(x, dt, B, C, Q)
    args = (xg, dtg, A, Bg, Cg)
    out = jssd_intra_chunk(*(jnp.asarray(a) for a in args), interpret=True)
    return args, tuple(np.asarray(o, np.float32) for o in out)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,S,nh,hp,N,Q", SHAPES)
def test_split_tf32_ref_matches_interpret_kernel(b, S, nh, hp, N, Q, dtype):
    """The CUDA kernel takes C·Bᵀ, M·x and the state on the tensor cores:
    three TF32 products each from f32 inputs (two for M·x and the state
    from bf16 ones, which are exact in TF32).  Its emulation holds the
    card's tolerance against the Pallas kernel in interpret mode, and L
    keeps its bits."""
    args, want = _interpret(b, S, nh, hp, N, Q, dtype)
    got = ref.ssd_intra_chunk_split_tf32_ref(*(_t(a) for a in args))
    for g, w in zip(got[:2], want[:2]):
        assert _within_card_tolerance(g, w)
    np.testing.assert_array_equal(_np(got[2]), want[2])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_single_tf32_product_misses_card_tolerance(dtype):
    """hi·hi′ alone, one TF32 product, misses the card's tolerance: the
    check above can fail, and the kernel needs the other products."""
    args, want = _interpret(*SHAPES[1], dtype)
    got = ref.ssd_intra_chunk_split_tf32_ref(*(_t(a) for a in args), terms=1)
    assert not all(_within_card_tolerance(g, w)
                   for g, w in zip(got[:2], want[:2]))


@pytest.mark.parametrize("itemsize", [4, 2])
def test_heads_per_block_over_shapes(itemsize):
    """heads_per_block over chunk counts 1..256 and the head counts of the
    registry's SSD widths: a divisor of nh; one head a block while the
    grid fits one wave of the SMs; at mamba2-130m's 8 x 1024 prefill (G =
    64, 24 heads) 12, 128 blocks in one wave of 132."""
    for nh in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64):
        for G in range(1, 257):
            hg = ops.heads_per_block(G, 128, nh, 64, 128, 132, itemsize)
            assert nh % hg == 0
            if G * nh <= 132:
                assert hg == 1
    assert ops.heads_per_block(64, 128, 24, 64, 128, 132, itemsize) == 12
