"""Dense pretraining in the port (``--mode dense``) against the JAX
package, on the same numpy-made inputs with the JAX weights carried
across: the optimizers (``adamw``, ``opt_update``, ``init_opt``), the
train step of every dense registry entry and its two gradient-accumulation
branches, ``run_dense``, ``make_prefill_step``, the paper transformer's
cut that neither package can run, the CLI, and the repaired optimizer
arguments of ``local_update``.

Tolerances: optimizer steps on the same inputs at rtol 1e-5 / atol 1e-6
(the bias corrections are f32 powers on both sides; the compiled
reference may contract a product into an FMA); train steps and runs,
which differentiate and sum in another order, losses at rtol 1e-4 and
SGD's parameters at rtol 1e-4 / atol 1e-5.  Gradients at rtol 1e-4 with
atol 1e-5 of their leaf's largest magnitude (the f32 summation noise of
the two backward passes: at the reduced minicpm-2b the largest
difference is 1.7e-6 of its leaf's largest gradient).

AdamW's parameters cannot keep to rtol 1e-4 / atol 1e-5 over free-running
steps (ROADMAP queue 3 item 17).  Its first step moves each element by
the rate times the sign of its gradient, so an element whose gradient is
at that noise (|g| about 1e-8 against a largest 0.22) may move the other
way in one package; the moved weight then changes every later gradient
by more than the noise, and after three steps 4.8 % of the elements lie
past the tolerance.  So each AdamW step is also taken once from the
reference's parameters and optimizer state, and held there to rtol 1e-4
/ atol 1e-5 on every element whose reference gradient in that step lies
above the noise (|g| > 1e-5 of its leaf's largest); the free-running
steps are held by their losses and, on the elements whose first
gradient lies above the noise, by the difference of the parameters:
within 1e-3 of the update in relative L2 (measured: 5.2e-4 after three
train steps of the reduced minicpm-2b, 1.7e-4 after two local steps of
a client).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import fl_round_fixture

from repro.configs import get_arch as jget_arch
from repro.core.client import local_update as jlocal_update
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro.optim import optimizers as jopt
from repro_torch.configs import get_arch
from repro_torch.core.client import local_update
from repro_torch.data import synthetic
from repro_torch.launch import steps, train
from repro_torch.models import model
from repro_torch.models.masks import ClientArch
from repro_torch.models.model import params_from_numpy
from repro_torch.optim import adamw, init_opt, opt_update
from repro_torch.tree import leaves, leaves_with_path, tree_map

torch.set_num_threads(2)

DENSE = ["smollm-135m", "minicpm-2b", "tinyllama-1.1b", "codeqwen1.5-7b",
         "fedfa-paper-transformer"]
B, S, STEPS = 4, 16, 3


def _tree(rng, shapes):
    return {k: rng.normal(size=s).astype(np.float32) for k, s in
            shapes.items()}


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_trees_close(got, want, rtol, atol):
    """A port tree against a reference tree (the same flatten order)."""
    got, want = leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32),
                                   rtol=rtol, atol=atol)


def _noise(g: np.ndarray) -> np.ndarray:
    """Where a reference gradient leaf lies at the f32 summation noise of
    the backward passes: |g| <= 1e-5 of the leaf's largest magnitude."""
    g = np.abs(np.asarray(g, np.float32))
    return g <= 1e-5 * g.max()


def _assert_adamw_step_close(got, want, jgrads):
    """One AdamW step from the reference's state: rtol 1e-4 / atol 1e-5
    on every element whose reference gradient ``jgrads`` lies above the
    noise (see the module docstring)."""
    got, want = leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want) == len(jax.tree.leaves(jgrads))
    for a, b, g in zip(got, want, jax.tree.leaves(jgrads)):
        a, b = a.detach().numpy(), np.asarray(b, np.float32)
        out = np.abs(a - b) > 1e-5 + 1e-4 * np.abs(b)
        assert np.all(_noise(g)[out]), \
            f"{int(np.sum(out & ~_noise(g)))} elements off above the noise"


def _assert_update_close(got, want, start, jgrads):
    """Free-running AdamW steps from ``start``: on the elements whose first
    step's reference gradient ``jgrads`` lies above the noise, the
    parameters' difference within 1e-3 of the reference's update in
    relative L2."""
    flat = lambda t: np.concatenate([np.asarray(x, np.float32).ravel()
                                     for x in t])
    a = flat(x.detach().numpy() for x in leaves(got))
    b, b0 = flat(jax.tree.leaves(want)), flat(jax.tree.leaves(start))
    keep = ~flat(_noise(g) for g in jax.tree.leaves(jgrads)).astype(bool)
    assert np.linalg.norm((a - b)[keep]) <= 1e-3 * np.linalg.norm(b - b0)


def _jgrad(jcfg, **kw):
    """The reference's compiled gradient of ``loss_fn`` (``kw`` as it
    takes them)."""
    return jax.jit(lambda pp, b: jax.grad(
        lambda q: jmodel.loss_fn(q, jcfg, b, **kw)[0])(pp))


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_optimizer_matches_reference(name):
    """Five ``opt_update`` steps on random trees; the learning rate an f32
    scalar as the schedules give it."""
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 4), "b": (7,), "c": (2, 2, 2)}
    jp = _tree(rng, shapes)
    p = _torch(jp)
    st, jst = init_opt(p, name), jopt.init_opt(jp, name)
    for _ in range(5):
        g = _tree(rng, shapes)
        lr = np.float32(rng.uniform(0.01, 0.1))
        p, st = opt_update(name, p, _torch(g), st, torch.tensor(lr))
        jp, jst = jopt.opt_update(name, jp, g, jst, jnp.float32(lr))
    _assert_trees_close(p, jp, 1e-5, 1e-6)
    _assert_trees_close(st["m"], jst["m"], 1e-5, 1e-6)
    if name == "adamw":
        _assert_trees_close(st["v"], jst["v"], 1e-5, 1e-6)
    assert st["step"] == int(jst["step"]) == 5


def test_adamw_bias_corrections_are_f32():
    """One AdamW step at step 7 with zero gradients and moments: the
    update is weight decay and m/bc1 = 0, and the bias corrections are
    f32 powers, as the reference's."""
    p = {"w": torch.tensor([1.0, -2.0])}
    st = {"step": 6, "m": {"w": torch.tensor([0.5, 0.25])},
          "v": {"w": torch.tensor([0.04, 0.01])}}
    g = {"w": torch.tensor([0.1, -0.3])}
    new, st2 = adamw(p, g, st, 0.01)
    jnew, _ = jopt.adamw({"w": np.array([1.0, -2.0], np.float32)},
                         {"w": np.array([0.1, -0.3], np.float32)},
                         {"step": jnp.int32(6),
                          "m": {"w": np.array([0.5, 0.25], np.float32)},
                          "v": {"w": np.array([0.04, 0.01], np.float32)}},
                         0.01)
    np.testing.assert_array_equal(new["w"].numpy(), np.asarray(jnew["w"]))
    assert st2["step"] == 7


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_init_opt_layout_matches_reference(name):
    p = {"a": torch.zeros(3, 2), "b": (torch.zeros(4),)}
    jp = {"a": jnp.zeros((3, 2)), "b": (jnp.zeros(4),)}
    st = init_opt(p, name, momentum_dtype=torch.bfloat16)
    jst = jopt.init_opt(jp, name, momentum_dtype=jnp.bfloat16)
    assert sorted(st) == sorted(jst) and st["step"] == 0
    for k in ("m", "v") if name == "adamw" else ("m",):
        got = [(pth, tuple(x.shape), str(x.dtype).split(".")[-1])
               for pth, x in leaves_with_path(st[k])]
        want = [(pth, tuple(x.shape), str(x.dtype)) for pth, x in
                zip([q for q, _ in leaves_with_path(st[k])],
                    jax.tree.leaves(jst[k]))]
        assert got == want
    with pytest.raises(ValueError):
        init_opt(p, "lion")


def _cfgs(name, **over):
    """(port, reference) configurations of a train-step case: the
    ``reduced()`` cut, the paper transformer at its published size."""
    port, ref = get_arch(name), jget_arch(name)
    if name != "fedfa-paper-transformer":
        port, ref = port.reduced(), ref.reduced()
    return port.replace(**over), ref.replace(**over)


# (case id, arch, overrides): every dense entry as ``run_dense`` runs it
# (grad_accum 1), and the two accumulation branches at grad_accum 2
STEP_CASES = [(n, n, {}) for n in DENSE] + [
    ("smollm-sgd-accum2-bf16m", "smollm-135m",
     dict(grad_accum=2, momentum_dtype="bfloat16")),
    ("minicpm-adamw-accum2", "minicpm-2b", dict(grad_accum=2))]


@pytest.mark.parametrize("case", [c[0] for c in STEP_CASES])
def test_train_step_matches_reference(case):
    """Three steps from step 1 (WSD's warmup makes step 0's rate 0) of
    the port's ``make_train_step`` against the jitted reference's; with
    AdamW, each step also from the reference's state."""
    _, arch, over = next(c for c in STEP_CASES if c[0] == case)
    cfg, jcfg = _cfgs(arch, **over)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(3))
    p = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    mdt = torch.bfloat16 if cfg.momentum_dtype == "bfloat16" \
        else torch.float32
    st = init_opt(p, cfg.optimizer, momentum_dtype=mdt)
    jst = jopt.init_opt(jp, jcfg.optimizer,
                        momentum_dtype=jnp.bfloat16
                        if jcfg.momentum_dtype == "bfloat16" else jnp.float32)
    step_fn = steps.make_train_step(cfg, total_steps=STEPS + 1)
    jstep_fn = jax.jit(jsteps.make_train_step(jcfg, total_steps=STEPS + 1))
    data = synthetic.lm_stream(cfg.vocab_size, STEPS * B, S, seed=2)
    adam = cfg.optimizer == "adamw"
    jgrad = _jgrad(jcfg, task="lm") if adam else None
    start, first = jp, None
    for s in range(1, STEPS + 1):
        tok = data[(s - 1) * B:s * B]
        batch, jbatch = {"tokens": torch.from_numpy(tok).long()}, \
            {"tokens": jnp.asarray(tok)}
        p, st, loss = step_fn(p, st, batch, s)
        if adam:    # the same step from the reference's state
            forced, _, _ = step_fn(
                params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu"),
                {"step": int(jst["step"]), "m": _torch(jst["m"]),
                 "v": _torch(jst["v"])}, batch, s)
            jg = jgrad(jp, jbatch)
            first = jg if first is None else first
        jp, jst, jloss = jstep_fn(jp, jst, jbatch, jnp.asarray(s))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
        if adam:
            _assert_adamw_step_close(forced, jp, jg)
    if adam:
        _assert_update_close(p, jp, start, first)
    else:
        _assert_trees_close(p, jp, 1e-4, 1e-5)
    assert st["step"] == int(jst["step"]) == STEPS
    for x, y in zip(leaves(st["m"]), jax.tree.leaves(jst["m"])):
        assert str(x.dtype).split(".")[-1] == str(y.dtype)


def test_gradients_match_reference():
    """``model.loss_and_grad`` at the reduced minicpm-2b against
    ``jax.grad`` on the same weights and tokens: every leaf at rtol 1e-4 /
    atol 1e-5 of its largest magnitude."""
    cfg, jcfg = _cfgs("minicpm-2b")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(3))
    p = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    tok = synthetic.lm_stream(cfg.vocab_size, B, S, seed=2)
    (loss, _), g = model.loss_and_grad(
        p, cfg, {"tokens": torch.from_numpy(tok).long()}, task="lm")
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda q, b: jmodel.loss_fn(q, jcfg, b, task="lm"), has_aux=True))(
            jp, {"tokens": jnp.asarray(tok)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    got, want = leaves(g), jax.tree.leaves(jg)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("arch", ["smollm-135m", "minicpm-2b"])
def test_run_dense_matches_reference(arch, capsys):
    """``run_dense`` from the reference's weights: the same history."""
    want = jtrain.run_dense(arch, 3, 2, S)
    jcfg = jget_arch(arch).reduced().replace(grad_accum=1)
    cfg = get_arch(arch).reduced().replace(grad_accum=1)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    got = train.run_dense(arch, 3, 2, S, device="cpu",
                          params=params_from_numpy(
                              jax.tree.map(np.asarray, jp), cfg, "cpu"))
    assert got["arch"] == want["arch"] and len(got["losses"]) == 3
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    np.testing.assert_allclose([got["first"], got["last"]],
                               [want["first"], want["last"]], rtol=1e-4)
    assert "step    0  loss" in capsys.readouterr().out


def test_prefill_step_matches_reference():
    """``make_prefill_step`` is ``prefill`` with the prompt's capacity, and
    matches the reference's step (logits and caches)."""
    cfg, jcfg = _cfgs("smollm-135m")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(4))
    p = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    tok = synthetic.lm_stream(cfg.vocab_size, 2, 12, seed=5)
    with torch.no_grad():
        logits, caches = steps.make_prefill_step(cfg)(
            p, {"tokens": torch.from_numpy(tok).long()})
        direct, _, _ = model.prefill(
            p, cfg, {"tokens": torch.from_numpy(tok).long()}, capacity=12)
    assert torch.equal(logits, direct)
    assert steps._prefill_capacity(cfg, {"tokens": tok}) == 12
    jlogits, jcaches = jsteps.make_prefill_step(jcfg)(
        jp, {"tokens": jnp.asarray(tok)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    kv = caches[0][0]["self"]
    jkv = jcaches[0][0]["self"]
    np.testing.assert_allclose(kv.k.float().numpy(),
                               np.asarray(jkv.k, np.float32), rtol=1e-2,
                               atol=1e-2)
    # with prefill_chunk the step runs the prompt in 3 chunks of 4, as the
    # reference's step does; each chunk attends against the step's bf16
    # cache, so within one bf16 step of the largest logit (ROADMAP queue 3
    # item 8)
    with torch.no_grad():
        logits, _ = steps.make_prefill_step(cfg.replace(prefill_chunk=4))(
            p, {"tokens": torch.from_numpy(tok).long()})
    jlogits, _ = jsteps.make_prefill_step(jcfg.replace(prefill_chunk=4))(
        jp, {"tokens": jnp.asarray(tok)})
    want = np.asarray(jlogits)
    np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                               atol=2.0 ** -8 * float(np.abs(want).max()))


def test_paper_transformer_cut_raises_in_both_packages():
    """``reduced()`` leaves 3 query heads over 2 kv heads (ROADMAP queue 3
    item 14): the reference fails in its attention einsum, the port
    raises a ValueError naming the head counts."""
    with pytest.raises(ValueError):
        jtrain.run_dense("fedfa-paper-transformer", 1, 2, 8)
    with pytest.raises(ValueError, match="n_heads 3 is not a multiple of "
                                         "n_kv_heads 2"):
        train.run_dense("fedfa-paper-transformer", 1, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="n_kv_heads 2"):
        train.run_fl("fedfa-paper-transformer", 1, 2, batch=2, seq_len=8,
                     device="cpu", quiet=True)


def test_cli_dense_runs_on_cpu(tmp_path):
    out = tmp_path / "dense.json"
    res = train.main(["--mode", "dense", "--steps", "3", "--batch", "2",
                      "--seq-len", "16", "--device", "cpu", "--out",
                      str(out)])
    assert out.exists() and len(res["losses"]) == 3
    assert np.all(np.isfinite(res["losses"]))


def test_local_update_adamw_matches_reference():
    """The repaired ``local_update``: AdamW runs with its own weight decay
    (0.1), as the reference passes SGD's arguments to SGD only.  One local
    step is held element by element above the gradient noise, two by
    their losses and their update (see the module docstring)."""
    from repro.core.masking import apply_mask_tree, axis_mask_tree
    from repro.models.masks import ClientArch as JClientArch
    jcfg, jparams = fl_round_fixture()
    jcfg = jcfg.replace(optimizer="adamw")
    cfg = train.fl_config("smollm-135m", "cls", 10, full_size=False) \
        .replace(optimizer="adamw")
    p = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    arch, jarch = ClientArch(0.5, (2, 1)), JClientArch(0.5, (2, 1))
    jmasks, jgates = jarch.masks(jcfg), jarch.gates(jcfg)
    rng = np.random.default_rng(6)
    batches = {"tokens": rng.integers(0, 64, (2, 2, 8)),
               "labels": rng.integers(0, 10, (2, 2))}
    kw = dict(lr=0.05, task="cls", momentum=0.9, weight_decay=1e-4)
    start = apply_mask_tree(jparams, axis_mask_tree(jcfg, jmasks))
    jg = _jgrad(jcfg, masks=jmasks, gates=jgates, task="cls")(
        start, {k: jnp.asarray(v[0]) for k, v in batches.items()})
    for steps_ in (1, 2):
        got, losses = local_update(
            p, cfg, {k: torch.from_numpy(v[:steps_]).long()
                     for k, v in batches.items()},
            masks=arch.masks(cfg), gates=arch.gates(cfg), **kw)
        want, jlosses = jlocal_update(
            jparams, jcfg, {k: jnp.asarray(v[:steps_])
                            for k, v in batches.items()},
            masks=jmasks, gates=jgates, **kw)
        np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                                   rtol=1e-4)
        if steps_ == 1:
            _assert_adamw_step_close(got, want, jg)
        else:
            _assert_update_close(got, want, start, jg)
