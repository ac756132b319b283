"""The port's serving path (``repro_torch.models.model`` prefill / decode
and ``repro_torch.launch.serve.Engine``) against the JAX package's, on the
CPU, with the JAX parameters carried across: reduced mamba2-130m and the
4-layer smollm-135m fixture.

Tolerances: logits at rtol 1e-4 / atol 1e-5 (the frameworks sum products
in different orders) wherever both run from the same cache values.  A bf16
cache stores values that the two frameworks' f32 arithmetic computed an
ulp apart, so now and then one lands on the other side of a bf16 rounding
boundary and the stored value moves by one bf16 step (2^-8 relative);
such flips are what the bf16 checks allow, and no more: the stored caches
within one bf16 step elementwise, mamba2's decode from the reference's
bf16 caches at the f32 tolerance, and smollm's (whose attention also
rounds its probabilities to bf16) within one bf16 step of its largest
logit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import fl_round_fixture

from repro.configs import get_arch as jax_get_arch
from repro.data import synthetic as jsynthetic
from repro.launch.serve import Engine as JEngine
from repro.models import model as jmodel
from repro_torch.configs import get_arch
from repro_torch.data import synthetic
from repro_torch.launch import serve
from repro_torch.launch.train import fl_config
from repro_torch.models import model
from repro_torch.models.attention import KVCache
from repro_torch.models.model import _to_torch, params_from_numpy
from repro_torch.models.ssm import SSMCache
from repro_torch.tree import leaves

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)
BF16_STEP = 2.0 ** -8
CACHE_DTYPES = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _mamba2():
    jcfg = jax_get_arch("mamba2-130m").reduced()
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(1))
    return jcfg, jp, get_arch("mamba2-130m").reduced()


def _smollm():
    jcfg, jp = fl_round_fixture()
    return jcfg, jp, fl_config("smollm-135m", "cls", 10, full_size=False)


MODELS = {"mamba2-130m": _mamba2, "smollm-135m": _smollm}


def _both(arch):
    jcfg, jp, cfg = MODELS[arch]()
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg, "cpu")


def _tokens(cfg, B=2, S=44, seed=5):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _tt(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.int64)


def _port_caches(jcaches):
    """The reference's caches as the port's (same stacking, int64 pos)."""
    kinds = {"self": KVCache, "ssm": SSMCache}

    def leaf(a):
        a = np.array(a)
        return torch.from_numpy(a.astype(np.int64)) if a.dtype == np.int32 \
            else _to_torch(a)
    return tuple(tuple({k: kinds[k](*(leaf(a) for a in c))
                        for k, c in d.items()} for d in stage)
                 for stage in jcaches)


def _cache_leaves(caches):
    return [x for stage in caches for d in stage for c in d.values()
            for x in c]


def _close_caches(caches, jcaches, bf16: bool):
    """Stored caches: f32 leaves (SSM states, sums over the prompt) within
    rtol 1e-4 and 1e-5 of the leaf's largest magnitude; bf16 leaves within
    that same absolute f32 error plus one bf16 step (ulp), and at most 1 %
    of them different."""
    for c, jc in zip(_cache_leaves(caches), jax.tree.leaves(jcaches)):
        want = np.asarray(jc).astype(np.float64)
        got = c.to(torch.float64).numpy()
        assert got.shape == want.shape
        atol = 1e-5 * max(1.0, float(np.abs(want).max()))
        if c.dtype == torch.bfloat16:
            assert bf16 and jc.dtype == jnp.bfloat16
            big = np.maximum(np.abs(want), np.abs(got))
            ulp = np.where(big > 0, 2.0 ** (np.floor(np.log2(
                np.where(big > 0, big, 1.0))) - 7), 0.0)
            assert (np.abs(got - want) <= ulp + atol).all()
            assert (got != want).mean() <= 1e-2
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_forward_matches_reference(arch):
    jcfg, jp, cfg, params = _both(arch)
    toks = _tokens(cfg)
    jl, _ = jmodel.forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                           remat=False)
    with torch.no_grad():
        got, _ = model.forward(params, cfg, {"tokens": _tt(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("cache_dtype", sorted(CACHE_DTYPES))
@pytest.mark.parametrize("arch", sorted(MODELS))
def test_prefill_and_decode_match_reference(arch, cache_dtype):
    """Prefill 40 tokens (a chunk of 32 and a ragged tail for mamba2), then
    teacher-forced decode of 4; each decode step also runs from the
    reference's caches."""
    jcfg, jp, cfg, params = _both(arch)
    jdt, dt = CACHE_DTYPES[cache_dtype]
    bf16 = cache_dtype == "bfloat16"
    toks = _tokens(cfg)
    P = 40
    jlg, jc, _ = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :P])},
                                capacity=48, cache_dtype=jdt)
    with torch.no_grad():
        lg, c, _ = model.prefill(params, cfg, {"tokens": _tt(toks[:, :P])},
                                 capacity=48, cache_dtype=dt)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
        _close_caches(c, jc, bf16)
        for i in range(P, toks.shape[1]):
            tok = toks[:, i:i + 1]
            shared, _ = model.decode_step(params, cfg, _tt(tok),
                                          _port_caches(jc))
            lg, c = model.decode_step(params, cfg, _tt(tok), c)
            jlg, jc = jmodel.decode_step(jp, jcfg, jnp.asarray(tok), jc)
            want = np.asarray(jlg)
            if bf16:
                # the largest real logit: vocab padding reads -1e30
                real = np.abs(want[..., :cfg.vocab_size]).max()
                flip = dict(rtol=0, atol=BF16_STEP * float(real))
                np.testing.assert_allclose(lg.numpy(), want, **flip)
                np.testing.assert_allclose(
                    shared.numpy(), want,
                    **(flip if arch == "smollm-135m" else TOL))
            else:
                np.testing.assert_allclose(shared.numpy(), want, **TOL)
                np.testing.assert_allclose(lg.numpy(), want, **TOL)
        if not bf16:    # free-running bf16 flips feed the next layers
            _close_caches(c, jc, bf16)
    assert int(model._cache_pos(c)) == toks.shape[1]


def _margins(jcfg, jp, prompts, tokens):
    """The reference's top-2 logit margin at every generated position,
    teacher-forced on the generated tokens with the Engine's bf16 cache."""
    lg, caches, _ = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(prompts)},
                                   capacity=prompts.shape[1] + 16)
    out = []
    for i in range(tokens.shape[1]):
        top2 = np.sort(np.asarray(lg[:, -1], np.float32), -1)[:, -2:]
        out.append(top2[:, 1] - top2[:, 0])
        if i + 1 < tokens.shape[1]:
            lg, caches = jmodel.decode_step(jp, jcfg,
                                            jnp.asarray(tokens[:, i:i + 1]),
                                            caches)
    return np.stack(out, 1)


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_engine_greedy_tokens_match_reference(arch):
    jcfg, jp, cfg, params = _both(arch)
    prompts = synthetic.lm_stream(cfg.vocab_size, 2, 40, seed=0)
    want = JEngine(jcfg, jp, capacity=56).generate(prompts, max_new=8)
    # the comparison decides nothing where the reference is nearly tied
    assert _margins(jcfg, jp, prompts, want).min() > 1e-4
    got = serve.Engine(cfg, params, capacity=56).generate(prompts, max_new=8)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_serve_cli_runs_on_cpu():
    out = serve.main(["--arch", "mamba2-130m", "--batch", "2",
                      "--prompt-len", "40", "--max-new", "3",
                      "--device", "cpu"])
    assert out["tokens"].shape == (2, 3)
    assert ((0 <= out["tokens"]) & (out["tokens"] < 512)).all()

    cfg = get_arch("smollm-135m").reduced()
    eng = serve.Engine(cfg, model.init_params(
        cfg, torch.Generator().manual_seed(0)), capacity=16)
    with pytest.raises(ValueError, match="exceed"):
        eng.generate(out["prompts"][:, :8], max_new=10)


def test_engine_refuses_a_ring_shorter_than_the_window():
    """A windowed request longer than the cache: with capacity 16 under a
    window of 32 the ring would overwrite positions still inside the
    window, which the reference does silently; the Engine refuses it."""
    cfg = get_arch("smollm-135m").reduced()
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    eng = serve.Engine(cfg, params, capacity=16, window=32)
    prompts = synthetic.lm_stream(cfg.vocab_size, 2, 12, seed=1)
    with pytest.raises(ValueError, match="ring shorter than the window 32"):
        eng.generate(prompts, max_new=6)
    assert eng.generate(prompts, max_new=5).shape == (2, 5)   # 16 positions


def test_engine_serves_past_capacity_through_a_window_ring():
    """Capacity 24 over a window of 8: the cache is a ring of 8, which holds
    every position the window can see, so a prompt of 20 and 10 new tokens
    (29 positions, past the capacity) run, greedy tokens equal to the
    reference Engine's."""
    jcfg, jp, cfg, params = _both("smollm-135m")
    prompts = synthetic.lm_stream(cfg.vocab_size, 2, 20, seed=3)
    got = serve.Engine(cfg, params, capacity=24, window=8).generate(
        prompts, max_new=10)
    want = JEngine(jcfg, jp, capacity=24, window=8).generate(prompts,
                                                              max_new=10)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_serve_cuts_depth():
    cfg, params = serve.build("phi3.5-moe-42b-a6.6b", n_layers=2,
                              device="cpu")
    want = get_arch("phi3.5-moe-42b-a6.6b").reduced().replace(n_layers=2)
    assert cfg == want
    ref = model.init_params(want, torch.Generator().manual_seed(0))
    for a, b in zip(leaves(params), leaves(ref)):
        assert torch.equal(a, b)
    out = serve.main(["--arch", "phi3.5-moe-42b-a6.6b", "--n-layers", "2",
                      "--batch", "2", "--prompt-len", "16", "--max-new", "3",
                      "--device", "cpu"])
    assert out["n_layers"] == 2 and out["tokens"].shape == (2, 3)


def test_engine_samples_from_its_seed():
    cfg = get_arch("smollm-135m").reduced()
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    eng = serve.Engine(cfg, params, capacity=32)
    prompts = synthetic.lm_stream(cfg.vocab_size, 2, 8, seed=1)
    a = eng.generate(prompts, max_new=4, temperature=1.0, seed=3)
    b = eng.generate(prompts, max_new=4, temperature=1.0, seed=3)
    np.testing.assert_array_equal(a, b)


def test_lm_stream_matches_reference_at_a_wide_vocab():
    np.testing.assert_array_equal(synthetic.lm_stream(4099, 2, 30, seed=2),
                                  jsynthetic.lm_stream(4099, 2, 30, seed=2))


def test_unported_serving_options_raise():
    """Windowed prefill, which the port once refused, now runs: the
    4-layer smollm-135m with window 4 over 12 tokens at capacity 16 (a ring
    of 4 that the prompt wraps) against the reference's — logits, and the
    ring's slots and position equal the reference's; a chunk asked for
    with a window takes the prompt in one shot (the same logits and
    caches)."""
    jcfg, jp, cfg, params = _both("smollm-135m")
    toks = _tokens(cfg, S=12)
    jlg, jc, _ = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                capacity=16, window=4, cache_dtype=jnp.float32)
    with torch.no_grad():
        lg, c, _ = model.prefill(params, cfg, {"tokens": _tt(toks)},
                                 capacity=16, window=4,
                                 cache_dtype=torch.float32)
        lg_c, c_c, _ = model.prefill(params, cfg, {"tokens": _tt(toks)},
                                     capacity=16, window=4, chunk_size=4,
                                     cache_dtype=torch.float32)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **TOL)
    # stacked over the repeats: (R, B, capacity, K, hd)
    assert c[0][0]["self"].k.shape[2] == 4 and int(model._cache_pos(c)) == 12
    _close_caches(c, jc, bf16=False)
    assert torch.equal(lg, lg_c)
    for a, b in zip(_cache_leaves(c), _cache_leaves(c_c)):
        assert torch.equal(a, b)
