"""The port's blocked attention — ``kernels/flash_attention`` (the CUDA
kernel's wrapper and its plain version) and ``models/attention.py``'s
``attend`` / ``attend_blocked`` — against the JAX package, on the CPU, with
the same numpy inputs on both sides.

Tolerances: 2e-5 at f32 (the JAX kernel tests'; both sides sum the same
f32 products in another order); at bf16 one bf16 step (2^-8 relative): of
each element (plus the f32 tolerance) for ``attention_ref``, whose only
bf16 rounding is the output's, and of the largest magnitude for
``attend_blocked``, which also rounds its probabilities to bf16 before the
value product, so an f32 probability an ulp apart can move a rounded one
by a step.  Gradients at rtol 1e-4 / atol 1e-5; the long-prompt prefill's
logits at the serving tests' tolerance, its value caches at theirs, and
its key caches at theirs plus what RoPE's frequencies allow (see
``test_prefill_long_prompt_matches_reference``).  The CUDA kernel's f32
route (three TF32 products for each f32 one) is emulated on the f32 bits
and held to the f32 tolerance against the Pallas kernel in interpret mode;
one TF32 product is shown to miss it."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import fl_round_fixture

from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention import ref as jfa_ref
from repro.kernels.flash_attention.kernel import flash_attention
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.launch.train import fl_config
from repro_torch.models import attention, model
from repro_torch.models.model import params_from_numpy
from test_torch_serve import TOL, _cache_leaves

torch.set_num_threads(2)

BF16_STEP = 2.0 ** -8
F32_TOL = dict(rtol=2e-5, atol=2e-5)

# tests/test_kernels.py's sweep: (B, Sq, Sk, H, K, hd) x masks, without
# causal cross-length (not used by the stack)
SHAPES = [(2, 256, 256, 4, 2, 64), (1, 128, 128, 8, 8, 128),
          (2, 192, 192, 4, 1, 64), (1, 64, 320, 2, 2, 32)]
MASKS = [(True, None), (True, 96), (False, None)]
SWEEP = [(s, c, w) for s in SHAPES for c, w in MASKS
         if not (c and s[1] != s[2])]


def _qkv(B, Sq, Sk, H, K, hd, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, S, n, hd)).astype(np.float32)
                 for S, n in ((Sq, H), (Sk, K), (Sk, K)))


def _both(arrays, dtype):
    """The same values as JAX and as torch arrays of ``dtype`` (both round
    f32 to bf16 to nearest even)."""
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _f32(x):
    return (x.to(torch.float32).numpy() if isinstance(x, torch.Tensor)
            else np.asarray(jnp.asarray(x).astype(jnp.float32)))


def _within_bf16_step(got, want):
    """Each element within one bf16 step (ulp) of the larger magnitude,
    plus the f32 tolerance (near zero the f32 sums' own difference spans
    several bf16 steps)."""
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.where(big > 0, 2.0 ** (np.floor(np.log2(
        np.where(big > 0, big, 1.0))) - 7), 0.0)
    assert (np.abs(got - want) <= ulp + F32_TOL["atol"]).all(), \
        float(np.abs(got - want).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,causal,window", SWEEP)
def test_attention_ref_matches_reference(shape, causal, window, dtype):
    jx, tx = _both(_qkv(*shape), dtype)
    got = _f32(ref.attention_ref(*tx, causal=causal, window=window))
    want = _f32(jfa_ref.attention_ref(*jx, causal=causal, window=window))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        _within_bf16_step(got, want)


# recurrentgemma-2b's heads: 10 query heads over 1 kv head of 256
WIDE = (1, 192, 192, 10, 1, 256)


@pytest.mark.parametrize("shape,causal,window", [
    ((2, 192, 192, 4, 1, 64), True, 96), ((1, 64, 320, 2, 2, 32), False,
                                          None), (WIDE, True, 96)])
def test_attention_matches_interpret_kernel(shape, causal, window):
    """The wrapper on a CPU tensor (the plain version; no launch) against
    the Pallas kernel in interpret mode, at bq = bk = 64 as the sweep."""
    jx, tx = _both(_qkv(*shape, seed=1), "f32")
    before = ops.FLASH_ATTENTION.launches
    got = ops.attention(*tx, causal=causal, window=window).numpy()
    assert ops.FLASH_ATTENTION.launches == before
    want = flash_attention(*jx, causal=causal, window=window, bq=64, bk=64,
                           interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)


def test_attention_ragged_matches_padding_wrapper():
    """Ragged Sq, Sk and hd = 48: the JAX wrapper pads to its tiles and to
    128 lanes and unpads; the port pads nothing."""
    jx, tx = _both(_qkv(2, 100, 100, 4, 2, 48, seed=2), "f32")
    got = ops.attention(*tx, causal=True).numpy()
    want = jfa_ops.attention(*jx, causal=True, use_kernel=True,
                             interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)


def test_attention_checks_inputs():
    q, k, v = (torch.zeros((1, 8, H, 8)) for H in (4, 2, 2))
    with pytest.raises(ValueError, match="H % K"):
        ops.attention(q, torch.zeros((1, 8, 3, 8)), torch.zeros((1, 8, 3, 8)))
    with pytest.raises(TypeError):
        ops.attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        ops.attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError):
        ops.attention(q, k[:, :4], v)
    with pytest.raises(ValueError):     # off the CPU: the kernel or a raise
        ops.attention(*(t.to("meta") for t in (q, k, v)))
    # a strided view is legitimate: the wrapper makes it contiguous
    qs = torch.zeros((1, 4, 8, 8)).transpose(1, 2)
    assert ops.attention(qs, k, v).shape == (1, 8, 4, 8)


# the long prompt of the serving checks, at two heads
LONG = (1, 2100, 2100, 2, 2, 64)


def test_tf32_round_is_round_to_nearest_ties_away():
    """``cvt.rna.tf32.f32``: 10 mantissa bits, ties away from zero (an even
    tie-break would round 1 + 2^-11 down to 1)."""
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                      1 + 2 ** -11 - 2 ** -23, 1 + 2 ** -10, 3.0])
    assert ref.tf32_round(x).tolist() == [
        1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -9, 1.0, 1 + 2 ** -10, 3.0]


@functools.lru_cache(maxsize=None)
def _pallas(shape, causal, window, seed):
    """The JAX Pallas kernel in interpret mode on ``_qkv``'s inputs: at the
    sweep's bq = bk = 64, through the padding wrapper (bq = bk = 512) where
    the lengths do not tile."""
    jx, _ = _both(_qkv(*shape, seed=seed), "f32")
    if shape[1] % 64 == 0 and shape[2] % 64 == 0:
        out = flash_attention(*jx, causal=causal, window=window, bq=64,
                              bk=64, interpret=True)
    else:
        out = jfa_ops.attention(*jx, causal=causal, window=window, bq=512,
                                bk=512, use_kernel=True, interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("shape,causal,window", SWEEP + [
    (LONG, True, None), (WIDE, True, 96), (WIDE, False, None)])
def test_split_tf32_ref_matches_interpret_kernel(shape, causal, window):
    """The CUDA kernel's f32 route takes each product as three TF32
    products (lo·hi′ + hi·lo′ + hi·hi′); its emulation on the f32 bits
    holds the f32 tolerance against the Pallas kernel in interpret mode."""
    _, tx = _both(_qkv(*shape, seed=3), "f32")
    got = ref.attention_split_tf32_ref(*tx, causal=causal,
                                       window=window).numpy()
    np.testing.assert_allclose(got, _pallas(shape, causal, window, 3),
                               **F32_TOL)


def test_single_tf32_product_misses_f32_tolerance():
    """hi·hi′ alone, one TF32 product, misses 2e-5 at the long shape: the
    check above can fail, and the kernel needs the other two products."""
    _, tx = _both(_qkv(*LONG, seed=3), "f32")
    got = ref.attention_split_tf32_ref(*tx, causal=True, terms=1).numpy()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, _pallas(LONG, True, None, 3),
                                   **F32_TOL)


# tests/test_perf_features.py's window block skip (S, window, bq, bk) and
# tests/test_properties.py's drawn (Sq, H, causal) at bq = bk = 64
BLOCKED = [((1, 512, 512, 4, 2, 32), True, 100, 64, 64),
           ((1, 768, 768, 4, 2, 32), True, 64, 128, 64),
           ((1, 640, 640, 4, 2, 32), True, 300, 64, 128),
           ((1, 17, 17, 2, 1, 32), True, None, 64, 64),
           ((1, 130, 130, 4, 2, 32), False, None, 64, 64),
           ((1, 257, 257, 4, 2, 32), True, None, 64, 64)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,causal,window,bq,bk", BLOCKED)
def test_attend_blocked_matches_reference(shape, causal, window, bq, bk,
                                          dtype):
    jx, tx = _both(_qkv(*shape, seed=shape[1]), dtype)
    hm = np.array([1.0, 0.0, 1.0, 1.0][:shape[3]], np.float32)
    got = _f32(attention.attend_blocked(
        *tx, causal=causal, window=window, head_mask=torch.from_numpy(hm),
        bq=bq, bk=bk))
    want = _f32(jattn.attend_blocked(*jx, causal=causal, window=window,
                                     head_mask=jnp.asarray(hm), bq=bq,
                                     bk=bk))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        np.testing.assert_allclose(
            got, want, rtol=0, atol=BF16_STEP * float(np.abs(want).max()))
    assert not got[:, :, 1].any()


def test_attend_blocked_gradients_match_reference():
    """q, k, v gradients of Σ out·w through the checkpointed kv steps,
    against jax.grad of the reference's ``attend_blocked``."""
    shape = (1, 150, 4, 2, 32)
    q, k, v = _qkv(shape[0], shape[1], shape[1], *shape[2:], seed=3)
    w = np.random.default_rng(4).normal(size=q.shape).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jattn.attend_blocked(q, k, v, causal=True, bq=64,
                                            bk=64) * w)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = attention.attend_blocked(tq, tk, tv, causal=True, bq=64, bk=64)
    (out * torch.from_numpy(w)).sum().backward()
    for t, g in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("S,blocked", [(2048, False), (2049, True)])
def test_attend_dispatch_matches_reference(monkeypatch, S, blocked):
    """Sq·Sk > 2048² takes the blocked branch (on the CPU
    ``attend_blocked``), anything else the dense softmax; both sides
    agree with the reference's ``attend``."""
    calls = []
    real = attention.attend_blocked
    monkeypatch.setattr(attention, "attend_blocked",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    jx, tx = _both(_qkv(1, S, S, 2, 1, 16, seed=S), "f32")
    got = attention.attend(*tx, causal=True).numpy()
    assert calls == ([1] if blocked else [])
    want = jattn.attend(*jx, causal=True)
    np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)


def test_attend_under_autograd_takes_blocked_path(monkeypatch):
    """A long sequence that needs a gradient trains through
    ``attend_blocked`` (never the kernel's wrapper), and its gradient is
    the dense softmax's."""
    monkeypatch.setattr(ops, "attention", lambda *a, **kw: pytest.fail(
        "the kernel's wrapper ran under autograd"))
    q, k, v = _qkv(1, 2049, 2049, 2, 1, 8, seed=5)
    grads = []
    for fn in (attention.attend, attention._attend_dense):
        tq = torch.from_numpy(q).requires_grad_(True)
        fn(tq, torch.from_numpy(k), torch.from_numpy(v),
           causal=True).square().sum().backward()
        grads.append(tq.grad.numpy())
    assert np.isfinite(grads[0]).all()
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-4, atol=1e-5)


def test_prefill_long_prompt_matches_reference():
    """The whole slice on the CPU: prefill of a 2,056-token prompt through
    every layer's blocked attention, at the 4-layer smollm fixture.

    The key caches hold RoPE-rotated keys.  The reference's compiled code
    rounds some of its f32 frequencies an ulp away from f32 ``pow`` (its
    own eager run differs from it the same way), and the position
    multiplies that into the angle: an element at position p may move by
    up to |k|·p·2^-23 on top of the f32 tolerance.  The value caches and
    the logits are held at the serving tests' tolerances."""
    jcfg, jp = fl_round_fixture()
    cfg = fl_config("smollm-135m", "cls", 10, full_size=False)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (1, 2056)).astype(np.int32)
    jlg, jc, _ = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                capacity=2060, cache_dtype=jnp.float32)
    with torch.no_grad():
        lg, c, _ = model.prefill(params, cfg, {"tokens": torch.from_numpy(
            toks).long()}, capacity=2060, cache_dtype=torch.float32)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    kc, vc, pos = _cache_leaves(c)
    jk, jv, jpos = jax.tree.leaves(jc)
    assert (pos == 2056).all() and (np.asarray(jpos) == 2056).all()
    for got, want in ((kc, jk), (vc, jv)):
        got, want = got.numpy(), np.asarray(want)
        big = float(np.abs(want).max())
        rope = 0.0 if got is vc else \
            big * np.arange(want.shape[2])[:, None, None] * 2.0 ** -23
        assert (np.abs(got - want)
                <= 1e-4 * np.abs(want) + 1e-5 * big + rope).all()
