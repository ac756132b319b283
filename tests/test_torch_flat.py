"""The port's flat aggregation engine against the JAX package's, on random
heterogeneous cohorts in the style of ``test_differential_oracle``: random
widths and depths, outlier (+10) clients and data counts that include 0.
Every strategy preset, at that file's tolerance (rtol 1e-4 / atol 1e-5),
against the JAX flat engine on its kernel path (Pallas in interpret mode),
the path the port's kernels port: the engines sum in different orders.
(The JAX CPU default, its top-k path, sums the trimmed squares of
outlier clients less exactly and is off by up to ~1e-4 here.)"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import fl_round_fixture

from repro.core import flat as jflat
from repro.core.fedfa import STRATEGIES as JSTRATEGIES
from repro.models.masks import ClientArch as JClientArch
from repro.models.masks import stack_masks as jstack_masks
from repro_torch.core import flat
from repro_torch.core.fedfa import STRATEGIES
from repro_torch.launch.train import fl_config
from repro_torch.models.masks import ClientArch, stack_masks
from repro_torch.models.model import params_from_numpy

torch.set_num_threads(2)

JCFG, JPARAMS = fl_round_fixture()
CFG = fl_config("smollm-135m", "cls", 10, full_size=False)
_WIDTHS = (0.25, 0.5, 0.75, 1.0)


def _cohort(seed: int):
    """(g (N,), x (m, N), archs, n_data) of a random cohort, numpy."""
    rng = np.random.default_rng(seed)
    index = jflat.get_index(JPARAMS)
    g = np.asarray(jflat.flatten(index, JPARAMS))
    m = int(rng.integers(2, 6))
    archs = [(float(rng.choice(_WIDTHS)),
              tuple(int(rng.integers(1, hi - lo + 1))
                    for lo, hi in JCFG.section_bounds())) for _ in range(m)]
    x = g[None] + 0.05 * rng.normal(size=(m, g.size)).astype(np.float32)
    x[rng.random(m) < 0.3] += 10.0
    nd = rng.integers(0, 5, m).astype(np.float32)
    if nd.sum() == 0:
        nd[int(rng.integers(m))] = 3.0
    return g, x.astype(np.float32), archs, nd


def _runtimes(archs, port: bool):
    A = ClientArch if port else JClientArch
    cfg = CFG if port else JCFG
    arch = [A(w, d) for w, d in archs]
    stack = stack_masks if port else jstack_masks
    cat = torch.stack if port else jnp.stack
    return (stack([a.masks(cfg) for a in arch]),
            cat([a.gates(cfg) for a in arch]),
            cat([a.graft(cfg) for a in arch]))


def _index():
    return flat.FlatIndex(params_from_numpy(
        jax.tree.map(np.asarray, JPARAMS), CFG, "cpu"))


def test_strategy_presets_match_reference():
    assert STRATEGIES == JSTRATEGIES


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("strategy", sorted(JSTRATEGIES))
def test_aggregate_buffers_matches_reference(strategy, seed):
    g, x, archs, nd = _cohort(seed)
    masks, gates, gmaps = _runtimes(archs, port=True)
    jmasks, jgates, jgmaps = _runtimes(archs, port=False)
    out = flat.aggregate_buffers(
        _index(), torch.from_numpy(g), torch.from_numpy(x), CFG, masks, gates,
        gmaps, torch.from_numpy(nd), **STRATEGIES[strategy])
    want = jflat.aggregate_buffers(
        jflat.get_index(JPARAMS), jnp.asarray(g), jnp.asarray(x), JCFG,
        jmasks, jgates, jgmaps, jnp.asarray(nd), interpret=True,
        **JSTRATEGIES[strategy])
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("seed", range(2))
def test_graft_and_norms_match_reference(seed):
    g, x, archs, _ = _cohort(seed)
    masks, _, gmaps = _runtimes(archs, port=True)
    jmasks, _, jgmaps = _runtimes(archs, port=False)
    index, jindex = _index(), jflat.get_index(JPARAMS)
    xg = flat._graft_flat(index, torch.from_numpy(x), gmaps)
    jxg = jax.vmap(lambda b, gm: jflat._graft_flat(jindex, b, gm))(
        jnp.asarray(x), jgmaps)
    np.testing.assert_array_equal(xg.numpy(), np.asarray(jxg))
    dens = torch.stack([flat._density_and_fraction(CFG, index,
                                                   masks.client(c))[0]
                        for c in range(len(archs))])
    fr = torch.stack([flat._density_and_fraction(CFG, index,
                                                 masks.client(c))[1]
                      for c in range(len(archs))])
    jd, jf = jax.vmap(lambda mk: jflat._density_and_fraction(
        JCFG, jindex, mk))(jmasks)
    norms = torch.sqrt(flat._cohort_stats(index, xg * dens, fr, 0.95)[1])
    jn = jflat._cohort_norms(jindex, jxg * jd, jf, 0.95, False, True)
    np.testing.assert_allclose(norms.numpy(), np.asarray(jn), rtol=1e-5)
