"""Federated training of mamba2-130m in the port against the JAX package,
at the JAX CLI's 4-layer cut (``reduced()``: d_model 256, 16 SSD heads of
32, d_state 32, chunk 32): the SSD block's axis masks, training through
the plain chunked SSD (its gradients), a client's local update, and whole
rounds of ``run_fl`` — the resident driver at f32 and int8 and the
per-round driver with ``--agg-engine tree`` — from the reference's
weights, compared through the checkpoints both CLIs write.

Tolerances:
  * masks and masked weights are bit-equal;
  * the SSD's forward through the plain chunked SSD keeps its bits
    (the same as without a gradient); forward and gradients agree with
    JAX's at rtol 1e-4 / atol 1e-5, the gradients' atol scaled by each
    leaf's largest magnitude (they are sums in other orders of terms that
    large: the projections reduce over up to 1,104 columns, and JAX's
    cumulative sum transposes to a reversed cumulative sum);
  * local updates and f32 rounds at rtol 1e-4 / atol 1e-5 (losses rtol
    1e-4), the dense rounds' tolerance;
  * int8 rounds within ROADMAP queue 3 item 6's allowance: every element
    within rtol 1e-4 / atol 1e-5 or one admission step, at most 1e-4·N
    elements past the tolerance (one round from the same state).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import masking as jmasking
from repro.core.client import local_update as jlocal_update
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.models.masks import ClientArch as JClientArch
from repro_torch.core import masking
from repro_torch.core import round as round_mod
from repro_torch.core.client import local_update
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.launch import train
from repro_torch.models import ssm
from repro_torch.models.masks import ClientArch
from repro_torch.models.model import params_from_numpy
from repro_torch.tree import leaves, leaves_with_path
from test_torch_quant import _steps, assert_round_close

torch.set_num_threads(2)

ARCH = "mamba2-130m"
CFG = train.fl_config(ARCH, "cls", 10, full_size=False)
JCFG = jget_arch(ARCH).reduced().replace(n_layers=4, n_sections=2,
                                         vocab_size=64, tie_embeddings=False)
JPARAMS = jmodel.init_params(JCFG, jax.random.PRNGKey(0))
RUN = dict(rounds=1, n_clients=4, batch=2, seq_len=16, eval_every=1)


def _port_params():
    return params_from_numpy(jax.tree.map(np.asarray, JPARAMS), CFG, "cpu")


def _flat_np(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in tree])


def test_cut_matches_reference():
    assert CFG == CFG.replace() and CFG.ssm.n_heads(CFG.d_model) == 16
    for f in ("n_layers", "d_model", "vocab_size", "n_sections",
              "tie_embeddings"):
        assert getattr(CFG, f) == getattr(JCFG, f), f
    assert CFG.ssm.chunk == JCFG.ssm.chunk == 32


@pytest.mark.parametrize("w", [0.25, 0.5, 0.75, 1.0])
def test_axis_masks_match_reference(w):
    """The SSD block's axis masks (heads over in_proj's z, x and dt
    columns, conv channels, A_log / D / dt_bias, the inner norm and
    out_proj's rows): mask densities and masked weights bit-equal."""
    mk, jmk = ClientArch(w, (2, 2)).masks(CFG), \
        JClientArch(w, (2, 2)).masks(JCFG)
    ax = dict(leaves_with_path(masking.axis_mask_tree(CFG, mk)))
    jax_ = jmasking.axis_mask_tree(JCFG, jmk)
    jleaves = jax.tree_util.tree_leaves_with_path(
        jax_, is_leaf=lambda x: isinstance(x, jmasking.AX))
    assert len(ax) == len(jleaves)
    for (path, a), (_, ja) in zip(ax.items(), jleaves):
        shape = tuple(np.shape(_leaf(JPARAMS, path)))
        np.testing.assert_array_equal(
            np.broadcast_to(masking.mask_density(shape, a).numpy(), shape),
            np.broadcast_to(np.asarray(jmasking.mask_density(shape, ja)),
                            shape), err_msg=str(path))
    got = masking.apply_mask_tree(_port_params(), masking.axis_mask_tree(
        CFG, mk))
    want = jmasking.apply_mask_tree(JPARAMS, jax_)
    np.testing.assert_array_equal(_flat_np(x.numpy() for x in leaves(got)),
                                  _flat_np(jax.tree.leaves(want)))
    assert masking.mask_gradients(got, masking.axis_mask_tree(CFG, mk)) \
        .keys() == got.keys()


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_ssd_training_runs_the_plain_chunked_ssd(monkeypatch):
    """Under autograd the SSD block calls ``ssd_chunked_ref`` (the wrapper
    ``ssd_ops.ssd`` is not reached) and gives the output it gives without
    a gradient; output and gradients match JAX's."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    rng = np.random.default_rng(3)
    p = {k: v[0] for k, v in _port_params()["stages"][0][0]["ssd"].items()}
    jp = {k: v[0] for k, v in JPARAMS["stages"][0][0]["ssd"].items()}
    u = rng.normal(size=(2, 40, CFG.d_model)).astype(np.float32)
    with torch.no_grad():
        want_nograd, _ = ssm.ssd_forward(p, torch.from_numpy(u), CFG.ssm,
                                         CFG.d_model)
    monkeypatch.setattr(ssd_ops, "ssd", lambda *a, **k: pytest.fail(
        "the SSD wrapper was called under autograd"))
    leaves_ = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    ut = torch.from_numpy(u).requires_grad_(True)
    out, _ = ssm.ssd_forward(leaves_, ut, CFG.ssm, CFG.d_model)
    assert torch.equal(out.detach(), want_nograd)
    w = rng.normal(size=out.shape).astype(np.float32)

    def jloss(pp, uu):      # the weighted sum, and the output as aux
        y = jssm.ssd_forward(pp, uu, JCFG.ssm, JCFG.d_model)[0]
        return jnp.sum(y * w), y
    # compiled once: JAX's eager scans would recompile on every call
    jgrads, jout = jax.jit(jax.grad(jloss, argnums=(1, 0), has_aux=True))(
        jp, jnp.asarray(u))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-4, atol=1e-5)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                [ut] + list(leaves_.values()))
    for k, g, jg in [("u", grads[0], jgrads[0])] + [
            (k, g, jgrads[1][k]) for k, g in zip(leaves_, grads[1:])]:
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(jg).max()),
                                   err_msg=k)


def test_cumsum_like_jax_under_autograd():
    """Autograd through the in-place tile sums: the same forward bits as
    without a gradient, and the gradient of a weighted sum equal to JAX's
    reversed cumulative sum at rtol 1e-5."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 70, 5)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = ssd_ref.cumsum_like_jax(xt, 1)
    assert torch.equal(y.detach(),
                       ssd_ref.cumsum_like_jax(torch.from_numpy(x), 1))
    (g,) = torch.autograd.grad((y * torch.from_numpy(w)).sum(), xt)
    jg = jax.grad(lambda a: jnp.sum(jnp.cumsum(a, axis=1) * w))(
        jnp.asarray(x))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)


def test_local_update_matches_reference():
    arch, jarch = ClientArch(0.5, (2, 1)), JClientArch(0.5, (2, 1))
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
                               _flat_np(jax.tree.leaves(want)),
                               rtol=1e-4, atol=1e-5)


def _ckpt_buffer(prefix) -> tuple:
    """(the round-0 checkpoint's leaves as one flat f32 buffer in flatten
    order, its json: leaf names and meta)."""
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
    want = jtrain.run_fl(ARCH, agg_engine=engine, driver=driver,
                         update_dtype=dt, ckpt=str(tmp_path / "jax"),
                         quiet=True, **RUN)
    seen = {}
    flat_round = round_mod.flat_round

    def keep_state(*a, **kw):     # the int8 scales, for the step sizes
        out = flat_round(*a, **kw)
        seen["qstate"], seen["index"] = a[-1], a[4]
        return out
    monkeypatch.setattr(round_mod, "flat_round", keep_state)
    got = train.run_fl(ARCH, agg_engine=engine, driver=driver,
                       update_dtype=dt, ckpt=str(tmp_path / "port"),
                       device="cpu", params=_port_params(), quiet=True,
                       **RUN)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    assert got["round"] == want["round"] == [0]
    got_buf, got_json = _ckpt_buffer(tmp_path / "port")
    want_buf, want_json = _ckpt_buffer(tmp_path / "jax")
    assert got_json == want_json
    if dt == "f32":
        np.testing.assert_allclose(got_buf, want_buf, rtol=1e-4, atol=1e-5)
    else:
        assert_round_close(got_buf, want_buf,
                           _steps(seen["index"], want_buf, dt,
                                  seen["qstate"][1]),
                           "mamba2 int8 global after round 0")


def test_cli_runs_mamba2_on_cpu():
    res = train.main(["--arch", ARCH, "--rounds", "1", "--clients", "4",
                      "--batch", "2", "--seq-len", "16", "--device", "cpu"])
    assert res["round"] == [0] and np.isfinite(res["round_loss"][0])
