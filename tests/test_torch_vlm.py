"""The vlm family in the port (``repro_torch``) against the JAX package, on
the CPU, with the reference's weights carried across as numpy:
internvl2-76b's patch projector (gelu(patches @ w1) @ w2, masked to the
active d_model) and the projected patches in front of the tokens —
forward, loss and gradients, prefill and decode, dense training, the
serving ``Engine``, the axis masks and both aggregation engines — and its
two faults of the reference (ROADMAP queue 3 items 27 and 28).

Sizes: ``reduced()`` (2 layers, d_model 256, 4 query and 2 kv heads of
64, d_ff 512, vocabulary 512, 16 patches of width 128) for serving and
training; the JAX CLI's 4-layer cut of it (2 sections) where depth must
vary (forward with depth gates, the aggregation cohort).  Patches, tokens
and client perturbations are drawn with numpy.

Tolerances: rtol 1e-4 / atol 1e-5 at f32 (the frameworks sum products in
other orders), the atol scaled by the largest magnitude of the tensor
compared where it exceeds 1, vocabulary padding aside (``_close``);
gradients the same way, leaf by leaf; with a bf16 KV cache the logits
within one bf16 step (2^-8) of the largest real logit (ROADMAP queue 3
item 8).  Each reference program is compiled once per module.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import fedfa as jfedfa
from repro.core import flat as jflat
from repro.core import masking as jmasking
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models.masks import ClientArch as JClientArch
from repro.models.masks import WidthMasks as JWidthMasks
from repro.models.masks import stack_masks as jstack_masks
from repro.models.masks import width_masks as jwidth_masks
from repro.optim import optimizers as jopt
from repro_torch.configs import get_arch
from repro_torch.core import fedfa, flat, masking
from repro_torch.data import synthetic
from repro_torch.launch import serve, steps, train
from repro_torch.models import attention, model
from repro_torch.models.masks import (ClientArch, WidthMasks, stack_masks,
                                      width_masks)
from repro_torch.models.model import _to_torch, params_from_numpy
from repro_torch.optim import init_opt
from repro_torch.tree import leaves, leaves_with_path, tree_map

torch.set_num_threads(2)

ARCH = "internvl2-76b"
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_STEP = 2.0 ** -8
JCFG, CFG = jget_arch(ARCH).reduced(), get_arch(ARCH).reduced()
JPARAMS = jmodel.init_params(JCFG, jax.random.PRNGKey(0))
# the JAX CLI's 4-layer cut: two sections of two repeats, so depth varies
JCUT = JCFG.replace(n_layers=4, n_sections=2)
CUT = CFG.replace(n_layers=4, n_sections=2)
JCUT_PARAMS = jmodel.init_params(JCUT, jax.random.PRNGKey(1))
P, VIT = CFG.vision.n_patches, CFG.vision.vit_dim


def _port(tree, cfg=CFG):
    return params_from_numpy(jax.tree.map(np.asarray, tree), cfg, "cpu")


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _close(got, want, what=""):
    """rtol 1e-4, atol 1e-5 of the largest magnitude (at least 1) of
    ``want``, its -1e30 vocabulary padding aside."""
    want = np.asarray(want, np.float32)
    real = np.abs(want)[np.abs(want) < 1e29]
    np.testing.assert_allclose(
        _np(got), want, rtol=1e-4,
        atol=1e-5 * max(1.0, float(real.max()) if real.size else 1.0),
        err_msg=what)


def _inputs(seed: int, B: int, S: int, cfg=CFG):
    """Tokens and patches (B, n_patches, vit_dim) at scale 0.02, numpy."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (B, S)),
            (0.02 * rng.standard_normal((B, P, VIT))).astype(np.float32))


def _batches(toks, patches):
    return ({"tokens": torch.as_tensor(toks),
             "patches": torch.as_tensor(patches)},
            {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)})


# ---------------------------------------------------------------------------
# The projector, forward, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [None, 0.5])
def test_project_patches_matches_reference(w):
    """gelu (tanh form) of patches @ w1, @ w2, without a d_model mask
    (``w`` None) and masked to the active d_model at width 0.5."""
    _, patches = _inputs(1, 2, 4)
    if w is None:
        m, jm = WidthMasks(None, None, None, None), \
            JWidthMasks(None, None, None, None)
    else:
        m, jm = width_masks(CFG, w), jwidth_masks(JCFG, w)
    got = model._project_patches(_port(JPARAMS), torch.as_tensor(patches), m)
    want = jmodel._project_patches(JPARAMS, jnp.asarray(patches), jm)
    assert got.shape == (2, P, CFG.d_model)
    _close(got, want)
    if w is not None:
        dm = int(m.d_model.sum())
        assert dm == CFG.d_model // 2 and not got[..., dm:].any()


@functools.lru_cache(maxsize=None)
def _jax_forward_loss_grad(task: str):
    """The reference's logits and value_and_grad of ``loss_fn``, one
    program per task."""
    return jax.jit(lambda p, b, m, g: (
        jmodel.forward(p, JCUT, b, masks=m, gates=g, remat=False)[0],
        jax.value_and_grad(jmodel.loss_fn, has_aux=True)(
            p, JCUT, b, masks=m, gates=g, task=task)))


@pytest.mark.parametrize("task,w,depths", [("lm", 1.0, (2, 2)),
                                           ("lm", 0.5, (1, 2)),
                                           ("cls", 0.5, (2, 1)),
                                           ("cls", 1.0, (2, 2))])
def test_forward_loss_and_grad_match_reference(task, w, depths):
    """Text logits (the patch positions cut off), the loss and every
    gradient leaf (the projector's too) at width ``w`` and section depths
    ``depths``: the gated repeats take no gradient, nor do the masked
    channels."""
    params = _port(JCUT_PARAMS, CUT)
    toks, patches = _inputs(2, 2, 12)
    batch, jbatch = _batches(toks, patches)
    if task == "cls":
        labels = np.array([3, 7])
        batch["labels"], jbatch["labels"] = torch.as_tensor(labels), \
            jnp.asarray(labels)
    arch, jarch = ClientArch(w, depths), JClientArch(w, depths)
    m, jm = arch.masks(CUT), jarch.masks(JCUT)
    g, jg = arch.gates(CUT), jarch.gates(JCUT)
    jlogits, ((jtotal, _), jgrads) = _jax_forward_loss_grad(task)(
        JCUT_PARAMS, jbatch, jm, jg)
    with torch.no_grad():
        logits, _ = model.forward(params, CUT, batch, masks=m, gates=g)
    assert logits.shape == (2, 12, CUT.padded_vocab)
    _close(logits, jlogits)
    (total, _), grads = model.loss_and_grad(params, CUT, batch, masks=m,
                                            gates=g, task=task)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-4)
    got = list(leaves_with_path(grads))
    assert len(got) == len(jax.tree.leaves(jgrads))
    for (path, gr), jgr in zip(got, jax.tree.leaves(jgrads)):
        _close(gr, jgr, str(path))
    assert grads["projector"]["w1"].any() and grads["projector"]["w2"].any()
    for r in np.flatnonzero(g.numpy() == 0):
        assert not any(x[r].any() for x in leaves(grads["stages"][0]))
    if w < 1.0:   # the projector's output is masked to the active d_model
        assert not grads["projector"]["w2"][:, int(m.d_model.sum()):].any()


# ---------------------------------------------------------------------------
# Serving at reduced()
# ---------------------------------------------------------------------------

_JDECODE = jax.jit(lambda p, t, c: jmodel.decode_step(p, JCFG, t, c))


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(cache):
    """``prefill`` of 16 patches + 20 tokens (caches of 48) and
    teacher-forced ``decode_step`` steps against the reference's: the
    caches' positions run over the patches, the logits (f32 cache at the
    f32 tolerance, bf16 within one bf16 step of the largest real
    logit)."""
    params = _port(JPARAMS)
    toks, patches = _inputs(3, 2, 26)
    S = 20
    jdt, dt = {"float32": (jnp.float32, torch.float32),
               "bfloat16": (jnp.bfloat16, torch.bfloat16)}[cache]
    batch, jbatch = _batches(toks[:, :S], patches)
    jlg, jc, _ = jmodel.prefill(JPARAMS, JCFG, jbatch, capacity=48,
                                cache_dtype=jdt)
    with torch.no_grad():
        lg, c, enc = model.prefill(params, CFG, batch, capacity=48,
                                   cache_dtype=dt)
        assert enc is None and int(model._cache_pos(c)) == P + S
        got, want = [lg], [np.asarray(jlg)]
        for i in range(S, toks.shape[1]):
            t = toks[:, i:i + 1]
            lg, c = model.decode_step(params, CFG, torch.as_tensor(t), c)
            jlg, jc = _JDECODE(JPARAMS, jnp.asarray(t), jc)
            got.append(lg)
            want.append(np.asarray(jlg))
    assert int(model._cache_pos(c)) == P + toks.shape[1]
    got, want = torch.cat(got, 1).float().numpy(), np.concatenate(want, 1)
    if cache == "float32":
        _close(got, want)
        kv, jkv = c[0][0]["self"], jc[0][0]["self"]
        _close(kv.k, jkv.k)
        _close(kv.v, jkv.v)
    else:
        real = float(np.abs(want[..., :CFG.vocab_size]).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_STEP * real)


def test_decode_matches_forward():
    """Prefill + decode == the full forward, teacher forced (the port's
    counterpart of ``test_arch_smoke.py::test_reduced_decode_matches_forward``
    for internvl2-76b): decode's positions continue after P + S."""
    params = _port(JPARAMS)
    toks, patches = _inputs(4, 2, 12)
    batch, _ = _batches(toks, patches)
    S = toks.shape[1]
    with torch.no_grad():
        full, _ = model.forward(params, CFG, batch)
        lg, caches, _ = model.prefill(
            params, CFG, {"tokens": batch["tokens"][:, :S - 3],
                          "patches": batch["patches"]},
            capacity=P + S + 4, cache_dtype=torch.float32)
        got = [lg[:, 0]]
        for i in range(S - 3, S):
            lg, caches = model.decode_step(params, CFG,
                                           batch["tokens"][:, i:i + 1],
                                           caches)
            got.append(lg[:, 0])
    _close(torch.stack(got, 1), full[:, S - 4:])


def test_prefill_step_sizes_caches_for_the_patches():
    """``make_prefill_step`` sizes the caches to P + S
    (``_prefill_capacity``) and tests a ``prefill_chunk`` against P + S,
    as the reference does: 8 divides the 12 tokens but not 16 + 12, so the
    prompt goes in one shot; 4 divides 28, so it goes in 7 chunks against
    the bf16 cache, as the reference's chunked step does (its logits
    within one bf16 step of the largest)."""
    params = _port(JPARAMS)
    toks, patches = _inputs(5, 2, 12)
    batch, jbatch = _batches(toks, patches)
    assert steps._prefill_capacity(CFG, batch) == P + 12 == \
        jsteps._prefill_capacity(JCFG, jbatch)
    with torch.no_grad():
        lg, caches = steps.make_prefill_step(CFG)(params, batch)
        lg8, _ = steps.make_prefill_step(CFG.replace(prefill_chunk=8))(
            params, batch)
        lg4, _ = steps.make_prefill_step(CFG.replace(prefill_chunk=4))(
            params, batch)
    assert caches[0][0]["self"].k.shape[2] == P + 12
    assert torch.equal(lg8, lg)
    _close(lg, jsteps.make_prefill_step(JCFG)(JPARAMS, jbatch)[0])
    # the chunks attend against the bf16 cache: one bf16 step (item 8)
    want4 = np.asarray(jsteps.make_prefill_step(JCFG.replace(
        prefill_chunk=4))(JPARAMS, jbatch)[0])
    real = float(np.abs(want4[..., :CFG.vocab_size]).max())
    np.testing.assert_allclose(_np(lg4), want4, rtol=0,
                               atol=BF16_STEP * real)


def test_engine_tokens_match_reference():
    """``Engine.generate(patches=)``: greedy tokens equal to the JAX
    ``Engine``'s at a capacity that holds 16 patches + 10 + 5."""
    toks, patches = _inputs(6, 2, 10)
    want = jserve.Engine(JCFG, JPARAMS, capacity=32).generate(
        toks, max_new=6, patches=patches)
    eng = serve.Engine(CFG, _port(JPARAMS), capacity=32,
                       cache_dtype=torch.float32)
    got, logits = eng.generate(toks, max_new=6, patches=patches,
                               return_logits=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    # the patches matter: other patches, other logits
    _, other = eng.generate(toks, max_new=6, patches=2 * patches,
                            return_logits=True)
    assert not np.allclose(other, logits)


# ---------------------------------------------------------------------------
# The serve CLI's capacity (ROADMAP queue 3 item 28)
# ---------------------------------------------------------------------------

# the CLI defaults: 32 prompt tokens, 32 new; the reference sizes the
# cache to 32 + 32 + 8 = 72, 16 patches + 32 + 31 decodes write 79
CLI_S, CLI_NEW = 32, 32
CLI_CAP = CLI_S + CLI_NEW + 8


@functools.lru_cache(maxsize=None)
def _reference_cli_tokens(capacity: int):
    toks, patches = _inputs(20, 2, CLI_S)
    return np.asarray(jserve.Engine(JCFG, JPARAMS, capacity=capacity)
                      .generate(toks, max_new=CLI_NEW, patches=patches))


def test_reference_cli_capacity_drops_the_last_writes():
    """At the reference CLI's capacity the decode writes past position 71
    are dropped (``cache_extend``'s scatter ignores them), and the last
    tokens differ from a run whose cache holds all 79 positions."""
    short, fits = _reference_cli_tokens(CLI_CAP), \
        _reference_cli_tokens(P + CLI_S + CLI_NEW + 8)
    first_dropped = CLI_CAP - (P + CLI_S) + 1    # decode step writing 72
    np.testing.assert_array_equal(short[:, :first_dropped],
                                  fits[:, :first_dropped])
    assert not np.array_equal(short, fits)


def test_engine_refuses_the_reference_cli_capacity():
    """The port's ``Engine`` counts the patches: 16 + 32 + 31 positions
    do not fit 72, and it refuses before any work."""
    toks, patches = _inputs(20, 2, CLI_S)
    eng = serve.Engine(CFG, _port(JPARAMS), capacity=CLI_CAP)
    with pytest.raises(ValueError, match="exceed the KV cache's 72"):
        eng.generate(toks, max_new=CLI_NEW, patches=patches)


def test_serve_sizes_a_capacity_that_fits():
    """The port's ``serve()`` at the CLI's defaults sizes its cache to
    patches + prompt + max_new + 8, and its tokens equal the reference
    ``Engine``'s on the same weights, prompts and patches there."""
    out = serve.serve(ARCH, batch=2, prompt_len=CLI_S, max_new=CLI_NEW,
                      device="cpu")
    cap = out["engine"].capacity
    assert cap == P + CLI_S + CLI_NEW + 8
    assert out["patches"].shape == (2, P, VIT)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                           out["engine"].params)
    want = jserve.Engine(JCFG, jparams, capacity=cap).generate(
        out["prompts"], max_new=CLI_NEW, patches=out["patches"])
    np.testing.assert_array_equal(out["tokens"], np.asarray(want))


# ---------------------------------------------------------------------------
# Dense training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum", [2])
def test_train_step_matches_reference(accum):
    """Two SGD steps of ``make_train_step`` with patches in the batch
    (split into ``accum`` microbatches with the tokens; one microbatch is
    ``run_dense``'s, below) against the jitted reference's: losses at
    rtol 1e-4, the weights free-running at the f32 tolerance."""
    cfg, jcfg = CFG.replace(grad_accum=accum), JCFG.replace(grad_accum=accum)
    jp = JPARAMS
    p = _port(jp, cfg)
    st, jst = init_opt(p, "sgd"), jopt.init_opt(jp, "sgd")
    step_fn = steps.make_train_step(cfg, total_steps=3)
    jstep = jax.jit(jsteps.make_train_step(jcfg, total_steps=3))
    for s in (1, 2):
        batch, jbatch = _batches(*_inputs(10 + s, 4, 16))
        p, st, loss = step_fn(p, st, batch, s)
        jp, jst, jloss = jstep(jp, jst, jbatch, jnp.asarray(s))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    for (path, a), b in zip(leaves_with_path(p), jax.tree.leaves(jp)):
        _close(a, b, str(path))


def test_run_dense_draws_patches_each_step():
    """``run_dense`` draws each step's patches from its CPU generator
    seeded by ``seed``: its losses are ``make_train_step``'s on those
    patches, from the same weights."""
    cfg = CFG.replace(grad_accum=1)
    got = train.run_dense(ARCH, 2, 2, 16, device="cpu",
                          params=_port(JPARAMS, cfg))
    p, gen = _port(JPARAMS, cfg), torch.Generator().manual_seed(0)
    st, step_fn = init_opt(p, cfg.optimizer), \
        steps.make_train_step(cfg, total_steps=2)
    data = synthetic.lm_stream(cfg.vocab_size, 4, 16, seed=0)
    for s in range(2):
        patches = 0.02 * torch.randn((2, P, VIT), generator=gen)
        p, st, loss = step_fn(p, st, {"tokens": torch.as_tensor(
            data[2 * s:2 * s + 2], dtype=torch.int64),
            "patches": patches}, s)
        assert float(loss) == got["losses"][s]


# ---------------------------------------------------------------------------
# Masks and aggregation at the 4-layer cut
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [0.5, 1.0])
def test_axis_mask_tree_matches_reference(w):
    """Every leaf's axis masks (the projector's ``w1`` on its output
    axis, ``w2`` on both) equal the reference's."""
    ax = dict(leaves_with_path(masking.axis_mask_tree(
        CUT, width_masks(CUT, w)), is_leaf=lambda x: isinstance(
            x, masking.AX)))
    jax_ax = jax.tree_util.tree_flatten_with_path(
        jmasking.axis_mask_tree(JCUT, jwidth_masks(JCUT, w)),
        is_leaf=lambda x: isinstance(x, jmasking.AX))[0]
    shapes = dict(leaves_with_path(_port(JCUT_PARAMS, CUT)))
    assert len(ax) == len(jax_ax) == len(shapes)
    for (path, a), (_, b) in zip(ax.items(), jax_ax):
        assert len(a.ms) == len(b.ms), path
        for x, y in zip(a.ms, b.ms):
            assert (x is None) == (y is None), path
            if x is not None:
                np.testing.assert_array_equal(_np(x), np.asarray(y))
        np.testing.assert_array_equal(
            _np(masking.mask_density(tuple(shapes[path].shape), a)),
            np.asarray(jmasking.mask_density(tuple(shapes[path].shape), b)))
    assert ax[("projector", "w1")].ms[0] is None


# mixed widths and section depths: client 1 grafts its second section's
# missing repeat, client 3 its first
COHORT = [(1.0, (2, 2)), (0.5, (2, 1)), (0.75, (2, 2)), (0.25, (1, 2))]


@functools.lru_cache(maxsize=None)
def _cohort():
    """Four clients: the global plus numpy noise; numpy data counts."""
    rng = np.random.default_rng(12)
    stacked = jax.tree.map(lambda x: np.stack([
        np.asarray(x) + 0.01 * rng.standard_normal(x.shape).astype(np.float32)
        for _ in COHORT]), JCUT_PARAMS)
    return stacked, np.array([5.0, 3.0, 8.0, 2.0], np.float32)


def _flat_of(tree) -> np.ndarray:
    return np.concatenate([_np(x).ravel() for x in tree])


@pytest.mark.parametrize("engine,strategy", [
    ("flat", "fedfa"), ("tree", "fedfa")])
def test_aggregation_matches_reference(engine, strategy):
    """Both engines on the cohort of four internvl2 trees against the
    reference's (``repro.core.flat.aggregate_flat`` for the flat engine,
    ``repro.core.fedfa.aggregate`` for the tree one): the projector's
    leaves are aggregated under their width masks, with a norm and a
    scaling factor each but no graft and no depth gate."""
    stacked, nd = _cohort()
    flags = fedfa.STRATEGIES[strategy]
    archs = [ClientArch(w, d) for w, d in COHORT]
    jarchs = [JClientArch(w, d) for w, d in COHORT]
    got = fedfa.aggregate(
        _port(JCUT_PARAMS, CUT), tree_map(_to_torch, stacked), CUT,
        stack_masks([a.masks(CUT) for a in archs]),
        torch.stack([a.gates(CUT) for a in archs]),
        torch.stack([a.graft(CUT) for a in archs]), torch.from_numpy(nd),
        engine=engine, **flags)
    jargs = (JCUT_PARAMS, jax.tree.map(jnp.asarray, stacked), JCUT,
             jstack_masks([a.masks(JCUT) for a in jarchs]),
             jnp.stack([a.gates(JCUT) for a in jarchs]),
             jnp.stack([a.graft(JCUT) for a in jarchs]), jnp.asarray(nd))
    fn = (functools.partial(jflat.aggregate_flat, cfg=JCUT, **flags)
          if engine == "flat" else functools.partial(
              jfedfa.aggregate, cfg=JCUT, engine="tree", **flags))
    want = jax.jit(fn)(jargs[0], jargs[1], masks=jargs[3], gates=jargs[4],
                       gmaps=jargs[5], n_data=jargs[6])
    np.testing.assert_allclose(_flat_of(leaves(got)),
                               _flat_of(jax.tree.leaves(want)), **TOL)


def test_projector_leaves_are_unstacked_segments():
    """The flat layout (as the reference's ``_path_stage_info`` has it):
    each projector leaf is one unstacked segment, and grafting never
    moves it."""
    params = _port(JCUT_PARAMS, CUT)
    index = flat.FlatIndex(params)
    jindex = jflat.FlatIndex(JCUT_PARAMS)
    assert index.n == jindex.n and index.n_segments == jindex.n_segments
    np.testing.assert_array_equal(index.seg_stage0, jindex.seg_stage0)
    proj = [s for s in index.leaves if s.path[0] == "projector"]
    assert [s.path for s in proj] == [("projector", "w1"),
                                      ("projector", "w2")]
    assert {(s.stacked, s.stage, s.lead) for s in proj} == {(False, None, 1)}
    x = torch.randn((1, index.n))
    gmaps = ClientArch(1.0, (1, 1)).graft(CUT)[None]
    out = flat._graft_flat(index, x, gmaps)
    for s in proj:
        cols = slice(s.offset, s.offset + s.size)
        assert torch.equal(out[0, cols], x[0, cols])


def test_vlm_fl_fails_in_both_packages():
    """FL batches carry no patches (ROADMAP queue 3 item 27): the
    reference's round fails with ``KeyError: 'patches'``; the port raises
    a ValueError naming them before the first round."""
    with pytest.raises(KeyError, match="patches"):
        jtrain.run_fl(ARCH, 1, 2, batch=2, seq_len=16, quiet=True)
    with pytest.raises(ValueError, match="patches"):
        train.run_fl(ARCH, 1, 2, batch=2, seq_len=16, device="cpu",
                     quiet=True)


# ---------------------------------------------------------------------------
# The flash route's footprint, and the CLIs
# ---------------------------------------------------------------------------

def test_patch_prefix_attention_matches_blocked_and_reference():
    """The self attention of a ``reduced()`` prefill of 16 patches + 2,040
    tokens: 2,056 positions, whose footprint passes 2048² only through the
    patches (2,040² does not), causal GQA (4 heads over 2 of 64).  On the
    card ``attend`` takes the flash kernel; on the CPU ``attend_blocked``,
    held against the JAX ``attend`` (its blocked path too)."""
    S = P + 2040
    assert 2040 ** 2 <= attention._BLOCKED_THRESHOLD < S ** 2
    rng = np.random.default_rng(13)
    q = rng.standard_normal((1, S, 4, 64)).astype(np.float32)
    k, v = (rng.standard_normal((1, S, 2, 64)).astype(np.float32)
            for _ in range(2))
    hm = np.array([1.0, 1.0, 0.0, 0.0], np.float32)
    got = attention.attend(*map(torch.from_numpy, (q, k, v)),
                           head_mask=torch.from_numpy(hm))
    blocked = attention.attend_blocked(*map(torch.from_numpy, (q, k, v)),
                                       head_mask=torch.from_numpy(hm))
    assert torch.equal(got, blocked)
    want = np.asarray(jattn.attend(*map(jnp.asarray, (q, k, v)),
                                   head_mask=jnp.asarray(hm)))
    _close(got, want)
    assert not got[..., 2:, :].any()


def test_clis_run_internvl2_on_cpu():
    """The serve CLI at its defaults (16 patches + 32 + 32 new), three
    dense steps with patches, and the FL mode's refusal."""
    out = serve.main(["--arch", ARCH, "--batch", "2", "--device", "cpu"])
    assert out["tokens"].shape == (2, 32)
    assert ((0 <= out["tokens"]) & (out["tokens"] < CFG.vocab_size)).all()
    res = train.main(["--mode", "dense", "--arch", ARCH, "--steps", "3",
                      "--batch", "2", "--seq-len", "16", "--device", "cpu"])
    assert len(res["losses"]) == 3 and np.all(np.isfinite(res["losses"]))
    with pytest.raises(ValueError, match="patches"):
        train.main(["--mode", "fl", "--arch", ARCH, "--device", "cpu"])


def test_init_has_the_reference_tree():
    """The port's own init: the projector's ``w1`` (vit_dim, D) and ``w2``
    (D, D) at fan-in scale; the tree has the reference's shapes."""
    params = model.init_params(CFG, torch.Generator().manual_seed(0))
    w1, w2 = params["projector"]["w1"], params["projector"]["w2"]
    assert w1.shape == (VIT, CFG.d_model) and w2.shape == (CFG.d_model,) * 2
    assert abs(float(w1.std()) - VIT ** -0.5) < 0.1 * VIT ** -0.5
    assert tree_map(lambda t: t.shape, params) == tree_map(
        lambda t: t.shape, _port(JPARAMS))
