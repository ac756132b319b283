"""The port's dense model and local update against the JAX package's, with
the JAX parameters carried across: loss and gradients of full, width-masked
and depth-masked clients, in f32 (rtol 1e-4: the frameworks sum products
in different orders) and in bf16 (rtol 2e-2, atol 2e-2 of each leaf's largest gradient: bf16
rounds at the same casts in both, but one cast that rounds the other way
moves a value by bf16's 2^-8 step, and a gradient element by about one
such step of the leaf's largest gradient)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import fl_round_fixture

from repro.core.client import local_update as jlocal_update
from repro.models import model as jmodel
from repro.models.masks import ClientArch as JClientArch
from repro_torch.core.client import local_update
from repro_torch.launch.train import fl_config
from repro_torch.models import model
from repro_torch.models.masks import ClientArch
from repro_torch.tree import from_paths, leaves_with_path

torch.set_num_threads(2)

JCFG, JPARAMS = fl_round_fixture()
CFG = fl_config("smollm-135m", "cls", 10, full_size=False)
ARCHS = {"full": (1.0, (2, 2)), "width": (0.5, (2, 2)),
         "depth": (1.0, (1, 2)), "both": (0.25, (1, 1))}
TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _batch(seed, B=2, S=8):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 64, (B, S)).astype(np.int32),
            "labels": rng.integers(0, 10, B).astype(np.int32)}


def _both(arch, dtype):
    w, d = ARCHS[arch]
    jparams = jax.tree.map(lambda x: x.astype(dtype), JPARAMS)
    params = model.params_from_numpy(jax.tree.map(np.asarray, jparams), CFG,
                                     "cpu")
    return (jparams, JClientArch(w, d)), (params, ClientArch(w, d))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("task", ["cls", "lm"])
def test_loss_and_grads_match_reference(arch, dtype, task):
    (jparams, ja), (params, a) = _both(arch, dtype)
    b = _batch(1)
    jloss_grad = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, JCFG, {k: jnp.asarray(v) for k, v in
                                           b.items()},
                                 masks=ja.masks(JCFG), gates=ja.gates(JCFG),
                                 task=task)[0])
    jl, jg = jloss_grad(jparams)
    leaves = [x.clone().requires_grad_(True)
              for _, x in leaves_with_path(params)]
    paths = [p for p, _ in leaves_with_path(params)]
    loss, _ = model.loss_fn(from_paths(paths, leaves), CFG,
                         {k: torch.as_tensor(v, dtype=torch.int64)
                          for k, v in b.items()},
                         masks=a.masks(CFG), gates=a.gates(CFG), task=task)
    grads = torch.autograd.grad(loss, leaves)
    _close(float(loss), float(jl), TOL[dtype])
    for (path, g), jgl in zip(zip(paths, grads), jax.tree.leaves(jg)):
        assert g.dtype == leaves[0].dtype
        scale = float(np.abs(np.asarray(jgl, np.float32)).max()) or 1.0
        _close(g.float().numpy() / scale, np.asarray(jgl, np.float32) / scale,
               TOL[dtype])


@pytest.mark.parametrize("arch", ["full", "both"])
def test_local_update_matches_reference(arch):
    (jparams, ja), (params, a) = _both(arch, "float32")
    rng = np.random.default_rng(3)
    batches = {"tokens": rng.integers(0, 64, (2, 2, 8)).astype(np.int32),
               "labels": rng.integers(0, 10, (2, 2)).astype(np.int32)}
    jp, jl = jlocal_update(jparams, JCFG, {k: jnp.asarray(v)
                                           for k, v in batches.items()},
                           masks=ja.masks(JCFG), gates=ja.gates(JCFG),
                           lr=0.05, task="cls")
    p, losses = local_update(params, CFG, {k: torch.as_tensor(
        v, dtype=torch.int64) for k, v in batches.items()},
        masks=a.masks(CFG), gates=a.gates(CFG), lr=0.05, task="cls")
    _close(losses.numpy(), np.asarray(jl), TOL["float32"])
    for (_, x), y in zip(leaves_with_path(p), jax.tree.leaves(jp)):
        _close(x.numpy(), np.asarray(y), TOL["float32"])


def test_init_params_shapes_and_seed():
    g = lambda: torch.Generator().manual_seed(0)
    a, b = model.init_params(CFG, g()), model.init_params(CFG, g())
    ref = [x.shape for x in jax.tree.leaves(JPARAMS)]
    for (p, x), (_, y), s in zip(leaves_with_path(a), leaves_with_path(b),
                                 ref):
        assert tuple(x.shape) == s and torch.equal(x, y), p
        if p[-1] == "scale":
            assert not x.any()
