"""The audio family in the port (``repro_torch``) against the JAX package,
on the CPU, with the reference's weights carried across as numpy:
whisper-base's encoder-decoder — LayerNorm, the biased MLP, the learned
``pos_embed`` table, the non-causal encoder over frame embeddings and the
decoder's cross attention — through forward, loss and gradients, prefill
and decode (``enc_out`` carried from one to the other), dense training,
the serving ``Engine``, the axis masks and both aggregation engines, and
its two faults of the reference (ROADMAP queue 3 items 25 and 26).

Sizes: ``reduced()`` (2 layers, d_model 256, 4 query and 2 kv heads of
64, d_ff 512, vocabulary 512, encoder 2 layers over 64 frames, a
``pos_embed`` of 2,048 rows) for serving and training; the JAX CLI's
4-layer cut of it (2 sections) where depth must vary (forward with depth
gates, the aggregation cohort).  Frames, tokens and client perturbations
are drawn with numpy.

Tolerances: rtol 1e-4 / atol 1e-5 at f32 (the frameworks sum products in
other orders), the atol scaled by the largest magnitude of the tensor
compared where it exceeds 1, vocabulary padding aside (``_close``);
gradients the same way, leaf by leaf; with a bf16 KV cache the logits
within one bf16 step (2^-8) of the largest real logit (ROADMAP queue 3
item 8); each AdamW step, from the reference's state, as
``test_torch_dense.py`` holds it (queue 3 item 17), where a gradient
within 100 eps (1e-6) of AdamW's eps counts as noise too: the first step
moves an element by lr·g/(|g| + eps), whose sensitivity to the
gradient's f32 error is eps/|g|, and whisper's attention leaves hold
gradients of 4e-8 to 1.5e-7 (1.1e-5 of their leaf's largest, above item
17's floor) that move 1.5e-5 apart in one step.  Each reference program
is compiled once per module.
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
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models.masks import ClientArch as JClientArch
from repro.models.masks import stack_masks as jstack_masks
from repro.models.masks import width_masks as jwidth_masks
from repro.optim import optimizers as jopt
from repro_torch.configs import get_arch
from repro_torch.core import fedfa, flat, masking
from repro_torch.data import synthetic
from repro_torch.launch import serve, steps, train
from repro_torch.models import attention, layers, model
from repro_torch.models.masks import ClientArch, stack_masks, width_masks
from repro_torch.models.model import _to_torch, params_from_numpy
from repro_torch.optim import init_opt
from repro_torch.tree import leaves, leaves_with_path, tree_map
from test_torch_dense import _noise, _torch

torch.set_num_threads(2)

ARCH = "whisper-base"
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_STEP = 2.0 ** -8
JCFG, CFG = jget_arch(ARCH).reduced(), get_arch(ARCH).reduced()
JPARAMS = jmodel.init_params(JCFG, jax.random.PRNGKey(0))
# the JAX CLI's 4-layer cut: two sections of two repeats, so depth varies
JCUT = JCFG.replace(n_layers=4, n_sections=2)
CUT = CFG.replace(n_layers=4, n_sections=2)
JCUT_PARAMS = jmodel.init_params(JCUT, jax.random.PRNGKey(1))
T = CFG.encoder.n_frames


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


def _assert_adamw_step_close(got, want, jgrads):
    """One AdamW step from the reference's state: rtol 1e-4 / atol 1e-5 on
    every element whose reference gradient lies above the noise (item
    17's, and within 100 eps of AdamW's eps; see the module docstring)."""
    got, want = leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want) == len(jax.tree.leaves(jgrads))
    for a, b, g in zip(got, want, jax.tree.leaves(jgrads)):
        a, b, g = _np(a), np.asarray(b, np.float32), np.asarray(g)
        out = np.abs(a - b) > 1e-5 + 1e-4 * np.abs(b)
        noise = _noise(g) | (np.abs(g) <= 1e-6)
        assert np.all(noise[out]), \
            f"{int(np.sum(out & ~noise))} elements off above the noise"


def _inputs(seed: int, B: int, S: int, cfg=CFG):
    """Tokens and frames (B, n_frames, d_model) at scale 0.02, numpy."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (B, S)),
            (0.02 * rng.standard_normal((B, T, cfg.d_model)))
            .astype(np.float32))


def _batches(toks, frames):
    return ({"tokens": torch.as_tensor(toks), "frames": torch.as_tensor(
        frames)}, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("active", [None, 40])
def test_layer_norm_matches_reference(active):
    """LayerNorm over the active channels only (``active`` of 64; None:
    all): the mean over them, the variance of the re-masked centred
    values; masked channels come out 0."""
    rng = np.random.default_rng(1)
    x = (3.0 + rng.standard_normal((2, 5, 64))).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    mask = None if active is None else \
        (np.arange(64) < active).astype(np.float32)
    got = layers.layer_norm(*(None if a is None else torch.from_numpy(a)
                              for a in (x, scale, bias, mask)))
    want = jlayers.layer_norm(*(None if a is None else jnp.asarray(a)
                                for a in (x, scale, bias, mask)))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    if active is not None:
        assert not got[..., active:].any()
        ref = layers.layer_norm(torch.from_numpy(x[..., :active]),
                                torch.from_numpy(scale[:active]),
                                torch.from_numpy(bias[:active]), None)
        np.testing.assert_allclose(_np(got[..., :active]), _np(ref), **TOL)


def test_sinusoidal_positions_matches_reference():
    np.testing.assert_allclose(
        _np(layers.sinusoidal_positions(50, 64)),
        np.asarray(jlayers.sinusoidal_positions(50, 64)), **TOL)


# ---------------------------------------------------------------------------
# Forward, loss and gradients at the 4-layer cut
# ---------------------------------------------------------------------------

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
                                           ("cls", 0.75, (2, 1))])
def test_forward_loss_and_grad_match_reference(task, w, depths):
    """Logits, the loss and every gradient leaf (the encoder's, the cross
    attention's, ``pos_embed``'s) at width ``w`` and section depths
    ``depths``: the gated repeats take no gradient, and neither do the
    masked channels."""
    params = _port(JCUT_PARAMS, CUT)
    toks, frames = _inputs(2, 2, 24)
    batch, jbatch = _batches(toks, frames)
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
    _close(logits, jlogits)
    (total, _), grads = model.loss_and_grad(params, CUT, batch, masks=m,
                                            gates=g, task=task)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-4)
    got = list(leaves_with_path(grads))
    assert len(got) == len(jax.tree.leaves(jgrads))
    for (path, gr), jgr in zip(got, jax.tree.leaves(jgrads)):
        _close(gr, jgr, str(path))
    assert grads["encoder"]["blocks"]["attn"]["wq"].any()
    assert grads["stages"][0][0]["xattn"]["wk"].any()
    for r in np.flatnonzero(g.numpy() == 0):
        assert not any(x[r].any() for x in leaves(grads["stages"][0]))
    if w < 1.0:
        dm = int(m.d_model.sum())
        assert not grads["pos_embed"][:, dm:].any()
        assert not grads["encoder"]["blocks"]["ffn"]["b_out"][:, dm:].any()


# ---------------------------------------------------------------------------
# Serving at reduced()
# ---------------------------------------------------------------------------

_JDECODE = jax.jit(lambda p, t, c, e, pos=None: jmodel.decode_step(
    p, JCFG, t, c, pos=pos, enc_out=e))


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(cache):
    """``prefill`` (which returns ``enc_out``) and teacher-forced
    ``decode_step`` steps against the reference's: the encoder's output,
    the caches and the logits (f32 cache at the f32 tolerance, bf16 within
    one bf16 step of the largest real logit)."""
    params = _port(JPARAMS)
    toks, frames = _inputs(3, 2, 26)
    P = 20
    jdt, dt = {"float32": (jnp.float32, torch.float32),
               "bfloat16": (jnp.bfloat16, torch.bfloat16)}[cache]
    batch, jbatch = _batches(toks[:, :P], frames)
    jlg, jc, jenc = jmodel.prefill(JPARAMS, JCFG, jbatch, capacity=32,
                                   cache_dtype=jdt)
    with torch.no_grad():
        lg, c, enc = model.prefill(params, CFG, batch, capacity=32,
                                   cache_dtype=dt)
        _close(enc, jenc)
        assert enc.shape == (2, T, CFG.d_model)
        got, want = [lg], [np.asarray(jlg)]
        for i in range(P, toks.shape[1]):
            t = toks[:, i:i + 1]
            lg, c = model.decode_step(params, CFG, torch.as_tensor(t), c,
                                      enc_out=enc)
            jlg, jc = _JDECODE(JPARAMS, jnp.asarray(t), jc, jenc)
            got.append(lg)
            want.append(np.asarray(jlg))
    assert int(model._cache_pos(c)) == toks.shape[1]
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
    for whisper-base): the position re-added in decode, the cross attention
    against the prefill's ``enc_out``."""
    params = _port(JPARAMS)
    toks, frames = _inputs(4, 2, 12)
    batch, _ = _batches(toks, frames)
    S = toks.shape[1]
    with torch.no_grad():
        full, _ = model.forward(params, CFG, batch)
        lg, caches, enc = model.prefill(
            params, CFG, {"tokens": batch["tokens"][:, :S - 3],
                          "frames": batch["frames"]},
            capacity=S + 4, cache_dtype=torch.float32)
        got = [lg[:, 0]]
        for i in range(S - 3, S):
            lg, caches = model.decode_step(params, CFG,
                                           batch["tokens"][:, i:i + 1],
                                           caches, enc_out=enc)
            got.append(lg[:, 0])
    _close(torch.stack(got, 1), full[:, S - 4:])


def test_prefill_step_returns_enc_out():
    """``make_prefill_step`` returns the encoder's output third, as the
    reference's step does where there is an encoder, and never chunks it
    (a ``prefill_chunk`` that divides the prompt changes nothing)."""
    params = _port(JPARAMS)
    toks, frames = _inputs(5, 2, 16)
    batch, jbatch = _batches(toks, frames)
    with torch.no_grad():
        lg, _, enc = steps.make_prefill_step(CFG)(params, batch)
        lg4, _, _ = steps.make_prefill_step(CFG.replace(prefill_chunk=4))(
            params, batch)
    jlg, _, jenc = jsteps.make_prefill_step(JCFG)(JPARAMS, jbatch)
    assert torch.equal(lg, lg4)
    _close(lg, jlg)
    _close(enc, jenc)


def test_engine_tokens_match_reference():
    """``Engine.generate(frames=)``: greedy tokens equal to the JAX
    ``Engine``'s, ``enc_out`` carried from prefill into every decode
    step."""
    toks, frames = _inputs(6, 2, 10)
    want = jserve.Engine(JCFG, JPARAMS, capacity=32).generate(
        toks, max_new=6, frames=frames)
    eng = serve.Engine(CFG, _port(JPARAMS), capacity=32,
                       cache_dtype=torch.float32)
    got, logits = eng.generate(toks, max_new=6, frames=frames,
                               return_logits=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    # the frames matter: other frames, other logits
    _, other = eng.generate(toks, max_new=6, frames=2 * frames,
                            return_logits=True)
    assert not np.allclose(other, logits)


# ---------------------------------------------------------------------------
# The pos_embed table's end (ROADMAP queue 3 item 26)
# ---------------------------------------------------------------------------

def test_reference_clamps_decode_positions_past_the_table():
    """The reference's ``decode_step`` takes its position through
    ``dynamic_slice_in_dim``, which clamps the start: every position past
    the table's last row (2,047 at ``reduced()``) reads that row, so
    decode there gives the logits of position 2,047.  The port's
    ``decode_step`` does the same (its ``Engine`` refuses such requests);
    a prefill longer than the table fails in both packages."""
    rows = JPARAMS["pos_embed"].shape[0]
    assert rows == 2048
    params = _port(JPARAMS)
    toks, frames = _inputs(7, 1, 9)
    batch, jbatch = _batches(toks[:, :8], frames)
    _, jc, jenc = jmodel.prefill(JPARAMS, JCFG, jbatch, capacity=16,
                                 cache_dtype=jnp.float32)
    with torch.no_grad():
        _, c, enc = model.prefill(params, CFG, batch, capacity=16,
                                  cache_dtype=torch.float32)
    tok = toks[:, 8:9]
    jlg = {pos: np.asarray(_JDECODE(JPARAMS, jnp.asarray(tok), jc, jenc,
                                    jnp.int32(pos))[0])
           for pos in (rows - 2, rows - 1, rows, rows + 900)}
    assert not np.array_equal(jlg[rows - 2], jlg[rows - 1])
    np.testing.assert_array_equal(jlg[rows], jlg[rows - 1])
    np.testing.assert_array_equal(jlg[rows + 900], jlg[rows - 1])
    for pos in (rows - 1, rows + 900):
        with torch.no_grad():
            lg, _ = model.decode_step(
                params, CFG, torch.as_tensor(tok),
                tree_map(torch.clone, c), pos=torch.tensor(pos),
                enc_out=enc)
        _close(lg, jlg[pos])
    long_toks, _ = _inputs(8, 1, rows + 1)
    with pytest.raises(Exception):
        jmodel.prefill(JPARAMS, JCFG, {"tokens": jnp.asarray(long_toks),
                                       "frames": jnp.asarray(frames)})
    with pytest.raises(ValueError, match="pos_embed"):
        model.prefill(params, CFG, {"tokens": torch.as_tensor(long_toks),
                                    "frames": torch.as_tensor(frames)})


def test_engine_refuses_positions_past_the_table():
    """The port's ``Engine`` refuses a request whose last position,
    prompt + max_new − 1, outgrows the table, before any work."""
    eng = serve.Engine(CFG, _port(JPARAMS), capacity=4096)
    toks, frames = _inputs(9, 1, 2040)
    with pytest.raises(ValueError, match="pos_embed table's 2048"):
        eng.generate(toks, max_new=10, frames=frames)


# ---------------------------------------------------------------------------
# Dense training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_train_step_matches_reference(optimizer):
    """Two steps of ``make_train_step`` (whisper's grad_accum 1, as
    ``run_dense`` runs it) with frames in the batch, against the jitted
    reference's: losses at rtol 1e-4; SGD's weights free-running at the
    f32 tolerance, AdamW's each step from the reference's state (ROADMAP
    queue 3 item 17)."""
    cfg = CFG.replace(grad_accum=1, optimizer=optimizer)
    jcfg = JCFG.replace(grad_accum=1, optimizer=optimizer)
    jp = JPARAMS
    p = _port(jp, cfg)
    st, jst = init_opt(p, optimizer), jopt.init_opt(jp, optimizer)
    step_fn = steps.make_train_step(cfg, total_steps=3)
    jstep = jsteps.make_train_step(jcfg, total_steps=3)
    # the reference's step and, for AdamW, the gradient it takes: one
    # program
    jrun = jax.jit(lambda q, o, b, s: (jstep(q, o, b, s), jax.grad(
        lambda x: jmodel.loss_fn(x, jcfg, b, task="lm")[0])(q)
        if optimizer == "adamw" else None))
    for s in (1, 2):
        batch, jbatch = _batches(*_inputs(10 + s, 2, 16))
        if optimizer == "adamw":
            forced, _, _ = step_fn(
                _port(jp, cfg), {"step": int(jst["step"]),
                                 "m": _torch(jst["m"]),
                                 "v": _torch(jst["v"])}, batch, s)
        p, st, loss = step_fn(p, st, batch, s)
        (jp, jst, jloss), jg = jrun(jp, jst, jbatch, jnp.asarray(s))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
        if optimizer == "adamw":
            _assert_adamw_step_close(forced, jp, jg)
    if optimizer == "sgd":
        for (path, a), b in zip(leaves_with_path(p), jax.tree.leaves(jp)):
            _close(a, b, str(path))


def test_run_dense_draws_frames_each_step():
    """``run_dense`` draws each step's frames from its CPU generator
    seeded by ``seed``: its losses are ``make_train_step``'s on those
    frames, from the same weights."""
    cfg = CFG.replace(grad_accum=1)
    got = train.run_dense(ARCH, 2, 2, 16, device="cpu",
                          params=_port(JPARAMS, cfg))
    p, gen = _port(JPARAMS, cfg), torch.Generator().manual_seed(0)
    st, step_fn = init_opt(p, cfg.optimizer), \
        steps.make_train_step(cfg, total_steps=2)
    data = synthetic.lm_stream(cfg.vocab_size, 4, 16, seed=0)
    for s in range(2):
        frames = 0.02 * torch.randn((2, T, cfg.d_model), generator=gen)
        p, st, loss = step_fn(p, st, {"tokens": torch.as_tensor(
            data[2 * s:2 * s + 2], dtype=torch.int64), "frames": frames}, s)
        assert float(loss) == got["losses"][s]


# ---------------------------------------------------------------------------
# Masks and aggregation at the 4-layer cut
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [0.5, 1.0])
def test_axis_mask_tree_matches_reference(w):
    """Every leaf's axis masks (LayerNorm scale and bias, the biased MLP,
    the cross entries, ``pos_embed``, the encoder) equal the reference's."""
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
    ("flat", "fedfa"), ("tree", "fedfa"), ("flat", "heterofl"),
    ("tree", "heterofl")])
def test_aggregation_matches_reference(engine, strategy):
    """Both engines on the cohort of four whisper trees against the
    reference's (``repro.core.flat.aggregate_flat`` for the flat engine,
    ``repro.core.fedfa.aggregate`` for the tree one): grafting and trimmed
    norms reach stage 0's rows, the encoder's rows take a norm and a
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


def test_encoder_rows_are_segments_never_grafted():
    """The flat layout (as the reference's ``_path_stage_info`` has it):
    every encoder leaf is depth-stacked with stage None — one segment per
    encoder layer — and grafting moves stage 0's rows only."""
    params = _port(JCUT_PARAMS, CUT)
    index = flat.FlatIndex(params)
    jindex = jflat.FlatIndex(JCUT_PARAMS)
    assert index.n == jindex.n and index.n_segments == jindex.n_segments
    np.testing.assert_array_equal(index.seg_stage0, jindex.seg_stage0)
    enc = [s for s in index.leaves if s.path[0] == "encoder"]
    assert {(s.stacked, s.stage, s.lead) for s in enc
            if s.path[1] == "blocks"} == {(True, None, 2)}
    assert {(s.stacked, s.lead) for s in enc
            if s.path[1] == "final_norm"} == {(False, 1)}
    x = torch.randn((2, index.n))
    gmaps = torch.stack([ClientArch(1.0, d).graft(CUT)
                         for d in ((1, 1), (2, 2))])
    out = flat._graft_flat(index, x, gmaps)
    for s in index.leaves:
        cols = slice(s.offset, s.offset + s.size)
        moved = not torch.equal(out[0, cols], x[0, cols])
        assert moved == (s.stacked and s.stage == 0), s.path
        assert torch.equal(out[1, cols], x[1, cols])


def test_whisper_fl_fails_in_both_packages():
    """FL batches carry no frames (ROADMAP queue 3 item 25): the
    reference's round fails with ``KeyError: 'frames'``; the port raises a
    ValueError naming them before the first round."""
    with pytest.raises(KeyError, match="frames"):
        jtrain.run_fl(ARCH, 1, 2, batch=2, seq_len=16, quiet=True)
    with pytest.raises(ValueError, match="frames"):
        train.run_fl(ARCH, 1, 2, batch=2, seq_len=16, device="cpu",
                     quiet=True)


# ---------------------------------------------------------------------------
# Long cross attention, and the CLIs
# ---------------------------------------------------------------------------

def test_long_cross_attention_matches_blocked_and_reference():
    """The cross attention the flash route takes on the card, at the
    smallest prompt whose footprint passes 2048² against 1,500 frames:
    Sq 2,816 × Sk 1,500 (4,224,000 > 4,194,304), non-causal, MHA (4 heads
    over 4), a ragged last kv block.  On the CPU ``attend`` runs
    ``attend_blocked``; held against the JAX ``attend`` (its blocked path
    too) and the flash wrapper's plain version."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    rng = np.random.default_rng(13)
    q, k, v = (rng.standard_normal((1, S, 4, 64)).astype(np.float32)
               for S in (2816, 1500, 1500))
    hm = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    got = attention.attend(*map(torch.from_numpy, (q, k, v)), causal=False,
                           head_mask=torch.from_numpy(hm))
    blocked = attention.attend_blocked(*map(torch.from_numpy, (q, k, v)),
                                       causal=False,
                                       head_mask=torch.from_numpy(hm))
    assert torch.equal(got, blocked)
    want = np.asarray(jattn.attend(*map(jnp.asarray, (q, k, v)),
                                   causal=False, head_mask=jnp.asarray(hm)))
    _close(got, want)
    plain = flash_ops.attention(*map(torch.from_numpy, (q, k, v)),
                                causal=False)
    _close(plain[..., :3, :], want[..., :3, :])
    assert not got[..., 3, :].any()


def test_clis_run_whisper_on_cpu():
    out = serve.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "40",
                      "--max-new", "4", "--device", "cpu"])
    assert out["tokens"].shape == (2, 4)
    assert ((0 <= out["tokens"]) & (out["tokens"] < 51_865)).all()
    assert out["frames"].shape == (2, T, CFG.d_model)
    res = train.main(["--mode", "dense", "--arch", ARCH, "--steps", "3",
                      "--batch", "2", "--seq-len", "16", "--device", "cpu"])
    assert len(res["losses"]) == 3 and np.all(np.isfinite(res["losses"]))
    with pytest.raises(ValueError, match="frames"):
        train.main(["--mode", "fl", "--arch", ARCH, "--device", "cpu"])


def test_init_draws_the_reference_distributions():
    """The port's own init: LayerNorm scales one and biases zero, the MLP's
    biases zero, ``pos_embed`` normal at scale 0.02 over max(max_seq_len,
    2048) rows; the tree has the reference's shapes."""
    params = model.init_params(CFG, torch.Generator().manual_seed(0))
    blk = params["stages"][0][0]
    for norm in (blk["ln1"], blk["lnx"], params["encoder"]["final_norm"]):
        assert (norm["scale"] == 1).all() and not norm["bias"].any()
    assert not blk["ffn"]["b_in"].any() and not blk["ffn"]["b_out"].any()
    pe = params["pos_embed"]
    assert pe.shape == (2048, CFG.d_model)
    assert abs(float(pe.std()) - 0.02) < 5e-4
    assert tree_map(lambda t: t.shape, params) == tree_map(
        lambda t: t.shape, _port(JPARAMS))
