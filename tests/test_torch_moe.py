"""The moe family in the port (``repro_torch``) against the JAX package, on
the CPU, with the reference's weights carried across as numpy: the
expert-axis masks, ``moe_ffn`` (forward, aux losses, gradients), a
client's local update, FL rounds and dense training of phi3.5-moe at the
JAX CLI's 4-layer cut, and chunked prefill (``prefill(chunk_size=)``,
attention with a q offset) on the smollm, mamba2 and phi cuts.

Tolerances:
  * masks and masked weights are bit-equal;
  * ``moe_ffn``'s output and aux losses at rtol 1e-4 / atol 1e-5, its
    gradients at rtol 1e-4 with atol 1e-5 scaled by each leaf's largest
    magnitude (sums of products in other orders);
  * local updates, f32 rounds and dense histories at rtol 1e-4 / atol
    1e-5 (losses rtol 1e-4); int8 rounds within ROADMAP queue 3 item 6's
    flip allowance;
  * chunked prefill with an f32 cache at rtol 1e-4 / atol 1e-5; with a
    bf16 cache within one bf16 step of the largest real logit (queue 3
    item 8: a value stored an ulp apart before rounding can land a bf16
    step away);
  * chunked against single-shot prefill with f32 caches and no dropped
    token within 1e-5 (the reference's own difference is 3.8e-6).
The reference's compiled programs are shared through module caches.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import fl_round_fixture

from repro.configs import get_arch as jget_arch
from repro.configs.base import MoEConfig as JMoEConfig
from repro.core import masking as jmasking
from repro.core.client import local_update as jlocal_update
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models import masks as jmasks
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch.configs import MoEConfig, get_arch
from repro_torch.core import masking
from repro_torch.core import round as round_mod
from repro_torch.core.client import local_update
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.launch import train
from repro_torch.models import attention, masks, model, moe
from repro_torch.models.masks import ClientArch
from repro_torch.models.model import params_from_numpy
from repro_torch.tree import leaves, leaves_with_path, tree_map
from test_torch_quant import _steps, assert_round_close

torch.set_num_threads(2)

PHI, ARCTIC = "phi3.5-moe-42b-a6.6b", "arctic-480b"
CFG = train.fl_config(PHI, "cls", 10, full_size=False)
JCFG = jget_arch(PHI).reduced().replace(n_layers=4, n_sections=2,
                                        vocab_size=64, tie_embeddings=False)
JPARAMS = jmodel.init_params(JCFG, jax.random.PRNGKey(0))
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_STEP = 2.0 ** -8
RUN = dict(rounds=1, n_clients=4, batch=2, seq_len=16, eval_every=1)


def _port_params(tree=JPARAMS, cfg=CFG):
    return params_from_numpy(jax.tree.map(np.asarray, tree), cfg, "cpu")


def _flat_np(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in tree])


def _grad_close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


# ---------------------------------------------------------------------------
# Width masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [PHI, ARCTIC, "recurrentgemma-2b"])
@pytest.mark.parametrize("w", [0.1, 0.25, 0.5, 0.75, 1.0])
def test_width_spec_and_masks_match_reference(arch, w):
    """n_experts = max(top_k, round(w·E)), the experts a prefix; the hybrid's
    d_rnn = max(8, ⌊w·d_rnn⌋ rounded down to 8) below full width, a
    prefix too."""
    for cut in (False, True):
        cfg, jcfg = get_arch(arch), jget_arch(arch)
        if cut:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        spec, jspec = masks.width_spec(cfg, w), jmasks.width_spec(jcfg, w)
        assert [f.name for f in dataclasses.fields(spec)] == \
            [f.name for f in dataclasses.fields(jspec)]
        assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
        m, jm = masks.width_masks(cfg, w), jmasks.width_masks(jcfg, w)
        fields = ["d_model", "heads", "kv_heads", "d_ff"]
        if cfg.moe:
            assert spec.n_experts >= cfg.moe.top_k
            fields.append("experts")
        else:
            assert spec.d_rnn % 8 == 0 and (w < 1.0) == bool(
                (m.d_rnn == 0).any())
            fields.append("d_rnn")
        for f in fields:
            np.testing.assert_array_equal(getattr(m, f).numpy(),
                                          np.asarray(getattr(jm, f)))
        assert m.ssm_heads is None and jm.ssm_heads is None


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("w", [0.25, 0.5, 1.0])
def test_axis_masks_match_reference(w):
    """The moe leaves' axis masks (router columns and the expert axis by
    the expert prefix, d_model rows and columns; d_ff_expert whole): mask
    densities and masked weights bit-equal."""
    mk = ClientArch(w, (2, 2)).masks(CFG)
    jmk = jmasks.ClientArch(w, (2, 2)).masks(JCFG)
    ax = dict(leaves_with_path(masking.axis_mask_tree(CFG, mk)))
    jax_ = jmasking.axis_mask_tree(JCFG, jmk)
    jleaves = jax.tree_util.tree_leaves_with_path(
        jax_, is_leaf=lambda x: isinstance(x, jmasking.AX))
    assert len(ax) == len(jleaves)
    assert ("stages", 0, 0, "ffn", "w_gate") in ax
    for (path, a), (_, ja) in zip(ax.items(), jleaves):
        shape = tuple(np.shape(_leaf(JPARAMS, path)))
        np.testing.assert_array_equal(
            np.broadcast_to(masking.mask_density(shape, a).numpy(), shape),
            np.broadcast_to(np.asarray(jmasking.mask_density(shape, ja)),
                            shape), err_msg=str(path))
    got = masking.apply_mask_tree(_port_params(),
                                  masking.axis_mask_tree(CFG, mk))
    want = jmasking.apply_mask_tree(JPARAMS, jax_)
    np.testing.assert_array_equal(_flat_np(x.numpy() for x in leaves(got)),
                                  _flat_np(jax.tree.leaves(want)))
    if w < 1.0:   # a weak client's missing experts are zero
        n = masks.width_spec(CFG, w).n_experts
        assert not got["stages"][0][0]["ffn"]["w_up"][:, n:].any()


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

D, FE, E = 64, 32, 4
MOE_CASES = {
    # (MoEConfig overrides, expert mask, router zeroed)
    "default": ({}, None, False),
    "expert_mask": ({}, [1.0, 1.0, 1.0, 0.0], False),
    "dense_residual": ({"dense_residual": True}, None, False),
    "cf100": ({"capacity_factor": 100.0}, [1.0, 1.0, 0.0, 0.0], False),
    "tie": ({}, None, True),
}


def _jmoe_grad(jcfg, mask):
    """The reference's compiled (output, aux) and gradients of
    sum(out·w) + lb + z."""
    em = None if mask is None else jnp.asarray(mask, jnp.float32)

    def f(p, x, w):
        out, aux = jmoe.moe_ffn(p, x, jcfg, "silu", expert_mask=em)
        return jnp.sum(out * w) + aux["lb_loss"] + aux["z_loss"], (out, aux)
    return jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_matches_reference(case):
    over, mask, tie = MOE_CASES[case]
    jcfg = JMoEConfig(n_experts=E, top_k=2, d_ff_expert=FE, **over)
    cfg = MoEConfig(n_experts=E, top_k=2, d_ff_expert=FE, **over)
    jp = jmoe.init_moe(jax.random.PRNGKey(7), D, jcfg, jnp.float32)
    if tie:
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    rng = np.random.default_rng(11)
    # tokens near one direction, so that the router sends most of them to
    # the same experts and the default capacity drops some
    x = (rng.normal(size=(1, 1, D)) + 0.3 * rng.normal(size=(2, 24, D))
         ).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    (_, (jout, jaux)), (jg, jgx) = _jmoe_grad(jcfg, mask)(
        jp, jnp.asarray(x), jnp.asarray(w))

    tree = tree_map(lambda a: torch.from_numpy(np.array(a))
                    .requires_grad_(True), jax.tree.map(np.asarray, jp))
    xt = torch.from_numpy(x).requires_grad_(True)
    em = None if mask is None else torch.tensor(mask)
    out, aux = moe.moe_ffn(tree, xt, cfg, "silu", expert_mask=em)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for name in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[name].detach()),
                                   float(jaux[name]),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
    total = (out * torch.from_numpy(w)).sum() + aux["lb_loss"] \
        + aux["z_loss"]
    paths, p = zip(*leaves_with_path(tree))    # the reference's leaf order
    grads = torch.autograd.grad(total, [xt, *p])
    _grad_close(grads[0].numpy(), jgx, "x")
    for path, g, jgl in zip(paths, grads[1:], jax.tree.leaves(jg)):
        _grad_close(g.numpy(), jgl, str(path))

    # the routing the case is there for
    logits = torch.from_numpy(x.reshape(-1, D)) \
        @ torch.from_numpy(np.array(jp["router"]))
    if em is not None:
        logits = torch.where(em > 0, logits, torch.tensor(-1e30))
    gates = torch.softmax(logits, -1)
    top = moe._top_k(gates, 2)[1]
    counts = torch.bincount(top.reshape(-1), minlength=E)
    C = max(1, int(cfg.capacity_factor * 2 * 48 / E))
    if tie:       # all gates equal: experts 0 and 1, as lax.top_k picks
        assert (top == torch.tensor([0, 1])).all()
    if case == "cf100":
        assert int(counts.max()) <= C
    elif case in ("default", "tie"):
        assert int(counts.max()) > C, "the default capacity drops no token"
    if em is not None:
        assert not counts[em == 0].any()


def test_capacity_at_decode_keeps_the_lower_flat_index():
    """Decode with B = 2 at phi's published routing: C = max(1,
    int(1.25·2·2/16)) = 1, so two rows that pick the same expert keep the
    first row's token, as the reference's stable sort does."""
    cfg = MoEConfig(n_experts=16, top_k=2, d_ff_expert=8)
    jcfg = JMoEConfig(n_experts=16, top_k=2, d_ff_expert=8)
    jp = jmoe.init_moe(jax.random.PRNGKey(3), 16, jcfg, jnp.float32)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))   # both pick 0 and 1
    x = np.random.default_rng(2).normal(size=(2, 1, 16)).astype(np.float32)
    jout, _ = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg, "silu")
    out, _ = moe.moe_ffn({k: torch.from_numpy(np.array(v))
                          for k, v in jp.items()}, torch.from_numpy(x), cfg,
                         "silu")
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    assert out[0].abs().sum() > 0 and not out[1].any()


# ---------------------------------------------------------------------------
# Local training, FL rounds, dense steps
# ---------------------------------------------------------------------------

def test_local_update_matches_reference():
    arch, jarch = ClientArch(0.5, (2, 1)), jmasks.ClientArch(0.5, (2, 1))
    rng = np.random.default_rng(5)
    batches = {"tokens": rng.integers(0, 64, (2, 2, 16)),
               "labels": rng.integers(0, 10, (2, 2))}
    kw = dict(lr=0.05, task="cls", momentum=0.9, weight_decay=1e-4)
    got, losses = local_update(
        _port_params(), CFG,
        {k: torch.from_numpy(v).long() for k, v in batches.items()},
        masks=arch.masks(CFG), gates=arch.gates(CFG), **kw)
    want, jlosses = jlocal_update(
        JPARAMS, JCFG, {k: jnp.asarray(v) for k, v in batches.items()},
        masks=jarch.masks(JCFG), gates=jarch.gates(JCFG), **kw)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-4)
    np.testing.assert_allclose(_flat_np(x.numpy() for x in leaves(got)),
                               _flat_np(jax.tree.leaves(want)), **TOL)


def test_loss_differentiates_the_aux_losses():
    """``loss_fn`` reports the task loss and differentiates it plus the
    aux losses; its gradient matches the reference's."""
    rng = np.random.default_rng(8)
    b = {"tokens": rng.integers(0, 64, (2, 16)),
         "labels": rng.integers(0, 10, (2,))}
    (total, met), g = model.loss_and_grad(
        _port_params(), CFG, {k: torch.from_numpy(v).long()
                              for k, v in b.items()}, task="cls")
    (jtotal, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, bb: jmodel.loss_fn(p, JCFG, bb, task="cls"),
        has_aux=True))(JPARAMS, {k: jnp.asarray(v) for k, v in b.items()})
    for k in ("loss", "lb_loss", "z_loss"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-4,
                                   err_msg=k)
        assert float(met[k]) > 0
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-4)
    assert float(total) == float(met["loss"] + met["lb_loss"]
                                 + met["z_loss"])
    for (path, a), b_ in zip(leaves_with_path(g), jax.tree.leaves(jg)):
        _grad_close(a.numpy(), b_, str(path))


def _ckpt_buffer(prefix) -> tuple:
    """(the round-0 checkpoint's leaves as one flat f32 buffer, its
    json)."""
    with np.load(f"{prefix}_r00000.npz") as z:
        buf = np.concatenate([z[f"a{i}"].astype(np.float32).ravel()
                              for i in range(len(z.files))])
    with open(f"{prefix}_r00000.json") as f:
        return buf, json.load(f)


@pytest.mark.parametrize("driver,engine,dt", [
    ("resident", "flat", "f32"), ("per-round", "tree", "f32"),
    ("resident", "flat", "int8")])
def test_run_fl_round_matches_reference(driver, engine, dt, tmp_path,
                                        monkeypatch):
    """One round of each CLI from the same weights: the histories and the
    round-0 checkpoints."""
    want = jtrain.run_fl(PHI, agg_engine=engine, driver=driver,
                         update_dtype=dt, ckpt=str(tmp_path / "jax"),
                         quiet=True, **RUN)
    seen = {}
    flat_round = round_mod.flat_round

    def keep_state(*a, **kw):     # the int8 scales, for the step sizes
        out = flat_round(*a, **kw)
        seen["qstate"], seen["index"] = a[-1], a[4]
        return out
    monkeypatch.setattr(round_mod, "flat_round", keep_state)
    got = train.run_fl(PHI, agg_engine=engine, driver=driver,
                       update_dtype=dt, ckpt=str(tmp_path / "port"),
                       device="cpu", params=_port_params(), quiet=True,
                       **RUN)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["global_acc"], want["global_acc"],
                               rtol=1e-6)
    got_buf, got_json = _ckpt_buffer(tmp_path / "port")
    want_buf, want_json = _ckpt_buffer(tmp_path / "jax")
    assert got_json == want_json
    if dt == "f32":
        np.testing.assert_allclose(got_buf, want_buf, **TOL)
    else:
        assert_round_close(got_buf, want_buf,
                           _steps(seen["index"], want_buf, dt,
                                  seen["qstate"][1]),
                           "phi int8 global after round 0")


@pytest.mark.parametrize("arch", [PHI, ARCTIC])
def test_run_dense_matches_reference(arch):
    """``run_dense`` at ``reduced()`` from the reference's weights (arctic
    with its dense residual branch): the same history."""
    want = jtrain.run_dense(arch, 3, 2, 16)
    jcfg = jget_arch(arch).reduced().replace(grad_accum=1)
    cfg = get_arch(arch).reduced().replace(grad_accum=1)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    got = train.run_dense(arch, 3, 2, 16, device="cpu",
                          params=_port_params(jp, cfg))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)


def test_arctic_fl_fails_in_both_packages():
    """ROADMAP queue 3 item 20: the reference masks arctic's dense residual
    branch by d_ff (512 at the cut) though it is d_ff_expert (256) wide, and
    fails; the port fails there too, naming the leaf and both widths."""
    with pytest.raises(TypeError, match="incompatible shapes"):
        jtrain.run_fl(ARCTIC, 1, 2, batch=2, seq_len=8, quiet=True)
    with pytest.raises(ValueError, match=r"ffn\.dense.*256.*d_ff 512"):
        train.run_fl(ARCTIC, 1, 2, batch=2, seq_len=8, device="cpu",
                     quiet=True)
    # the published size, where the two widths are equal, builds its masks
    cfg = get_arch(ARCTIC)
    assert cfg.d_ff == cfg.moe.d_ff_expert
    ax = masking.axis_mask_tree(cfg, masks.width_masks(cfg, 0.5))
    assert ax["stages"][0][0]["ffn"]["dense"]["w_up"].ms[1].shape == (4864,)


def test_cli_runs_phi_on_cpu():
    res = train.main(["--arch", PHI, "--rounds", "1", "--clients", "4",
                      "--batch", "2", "--seq-len", "16", "--device", "cpu",
                      "--update-dtype", "bf16", "--driver", "async"])
    assert res["round"] == [0] and np.isfinite(res["round_loss"][0])


# ---------------------------------------------------------------------------
# Chunked prefill and the q offset
# ---------------------------------------------------------------------------

def _smollm():
    jcfg, jp = fl_round_fixture()
    return jcfg, jp, train.fl_config("smollm-135m", "cls", 10,
                                     full_size=False)


def _mamba2():
    jcfg = jget_arch("mamba2-130m").reduced()
    return jcfg, jmodel.init_params(jcfg, jax.random.PRNGKey(1)), \
        get_arch("mamba2-130m").reduced()


def _phi():
    return JCFG, JPARAMS, CFG


STACKS = {"smollm-135m": _smollm, "mamba2-130m": _mamba2, "phi": _phi}
CACHES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_JPREFILL = {}


def _prefill_both(stack, cache, toks, chunk, *, slow=False, cf=None):
    """(port logits, reference logits) of ``prefill(chunk_size=chunk)``
    (None: single shot).  ``slow``: mamba2's A_log at -8 (slow decay);
    ``cf``: the MoE capacity factor."""
    jcfg, jp, cfg = STACKS[stack]()
    if cf is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                    capacity_factor=cf))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=cf))
    if slow:
        jp = jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.full_like(a, -8.0)
            if getattr(path[-1], "key", None) == "A_log" else a, jp)
    jdt, dt = CACHES[cache]
    key = (stack, cache, chunk, slow, cf)
    if key not in _JPREFILL:
        _JPREFILL[key] = jax.jit(lambda p, t: jmodel.prefill(
            p, jcfg, {"tokens": t}, capacity=toks.shape[1] + 8,
            cache_dtype=jdt, chunk_size=chunk)[0])
    want = np.asarray(_JPREFILL[key](jp, jnp.asarray(toks)))
    with torch.no_grad():
        got, _, _ = model.prefill(_port_params(jp, cfg), cfg,
                                  {"tokens": torch.from_numpy(toks).long()},
                                  capacity=toks.shape[1] + 8, cache_dtype=dt,
                                  chunk_size=chunk)
    return got.numpy(), want, cfg


def _tokens(vocab, B=2, S=32, seed=5):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


@pytest.mark.parametrize("cache", sorted(CACHES))
@pytest.mark.parametrize("stack", sorted(STACKS))
def test_chunked_prefill_matches_reference(stack, cache):
    """A prompt of 32 in 4 chunks of 8 (mamba2's SSD chunk is 32: each
    prefill chunk is a ragged SSD chunk), the reference's chunked prefill
    against the port's."""
    cfg = STACKS[stack]()[2]
    got, want, _ = _prefill_both(stack, cache, _tokens(cfg.vocab_size),
                                 chunk=8)
    assert got.shape == want.shape == (2, 1, cfg.padded_vocab)
    if cache == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        real = float(np.abs(want[..., :cfg.vocab_size]).max())
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=BF16_STEP * real)


@pytest.mark.parametrize("stack", ["smollm-135m", "phi"])
def test_chunked_equals_single_shot_prefill(stack):
    """With f32 caches and no dropped token (capacity factor 100), chunks
    of 8 give single-shot prefill's logits within 1e-5, in both
    packages."""
    cfg = STACKS[stack]()[2]
    toks = _tokens(cfg.vocab_size, seed=9)
    cf = 100.0 if stack == "phi" else None
    chunked, jchunked, _ = _prefill_both(stack, "float32", toks, 8, cf=cf)
    single, jsingle, _ = _prefill_both(stack, "float32", toks, None, cf=cf)
    np.testing.assert_allclose(chunked, single, rtol=0, atol=1e-5)
    np.testing.assert_allclose(jchunked, jsingle, rtol=0, atol=1e-5)
    np.testing.assert_allclose(chunked, jchunked, **TOL)


def test_ssd_chunks_drop_the_state_in_both_packages():
    """ROADMAP queue 3 item 21: an SSD block starts each prefill chunk from
    a zero state in the reference, and in the port.  With slow decay
    (A_log = -8) the dropped state shows: both packages' chunked prefills
    agree with each other and both differ from single-shot prefill."""
    toks = _tokens(512, S=64, seed=3)
    got, want, _ = _prefill_both("mamba2-130m", "float32", toks, 32,
                                 slow=True)
    single, jsingle, _ = _prefill_both("mamba2-130m", "float32", toks, None,
                                       slow=True)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(single, jsingle, **TOL)
    assert np.abs(got - single).max() > 0.1
    assert np.abs(want - jsingle).max() > 0.1


def test_prefill_rule_for_not_chunking():
    """A chunk that does not divide the prompt, or a prompt no longer than
    one chunk, takes the prompt in one shot (same bits as without
    ``chunk_size``)."""
    params = _port_params()
    toks = {"tokens": torch.from_numpy(_tokens(64, S=12)).long()}
    with torch.no_grad():
        one, _, _ = model.prefill(params, CFG, toks, capacity=20)
        for chunk in (5, 12, 16):
            got, _, _ = model.prefill(params, CFG, toks, capacity=20,
                                      chunk_size=chunk)
            assert torch.equal(got, one), chunk
        got, caches, _ = model.prefill(params, CFG, toks, capacity=20,
                                       chunk_size=4)
    assert int(model._cache_pos(caches)) == 12
    assert not torch.equal(got, one)     # three chunks, dispatched apart


OFFSET_CASES = [(16, 40, 24, True, None), (8, 40, 5, True, 9),
                (12, 30, 0, False, None), (20, 64, 37, True, None)]


@pytest.mark.parametrize("Sq,Sk,off,causal,window", OFFSET_CASES)
def test_attend_with_q_offset_matches_reference(Sq, Sk, off, causal, window):
    """``attend`` (dense branch), ``_attend_dense`` and ``attend_blocked``
    (small tiles, several kv blocks and the window's moving first block)
    with a q offset, and the flash kernel's plain version, against the
    reference's ``_attend_dense`` / ``attend_blocked``."""
    rng = np.random.default_rng(Sq + off)
    q = rng.normal(size=(2, Sq, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, Sk, 2, 16)).astype(np.float32)
            for _ in range(2))
    hm = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    kw = dict(causal=causal, window=window, q_offset=off)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = np.asarray(jattn._attend_dense(jq, jk, jv, head_mask=hm, **kw))
    jblk = np.asarray(jattn.attend_blocked(jq, jk, jv, head_mask=hm, bq=8,
                                           bk=8, **kw))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    th = torch.from_numpy(hm)
    np.testing.assert_allclose(
        attention.attend(tq, tk, tv, head_mask=th, **kw).numpy(), want,
        **TOL)
    np.testing.assert_allclose(
        attention._attend_dense(tq, tk, tv, head_mask=th, **kw).numpy(),
        want, **TOL)
    np.testing.assert_allclose(
        attention.attend_blocked(tq, tk, tv, head_mask=th, bq=8, bk=8,
                                 **kw).numpy(), jblk, **TOL)
    ref = flash_ref.attention_ref(tq, tk, tv, **kw) * th[None, None, :, None]
    np.testing.assert_allclose(ref.numpy(), jblk, **TOL)
    emul = flash_ref.attention_split_tf32_ref(tq, tk, tv, **kw)
    np.testing.assert_allclose(emul.numpy() * hm[None, None, :, None], jblk,
                               rtol=1e-3, atol=1e-3)


def test_flash_wrapper_refuses_a_negative_offset():
    from repro_torch.kernels.flash_attention import ops as flash_ops
    x = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="q_offset"):
        flash_ops.attention(x, x, x, q_offset=-1)
    out = flash_ops.attention(x + 1, x + 1, x + 1, q_offset=3)
    assert torch.equal(out, torch.ones_like(out))
