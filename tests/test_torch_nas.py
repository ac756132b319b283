"""The client-side NAS (``repro_torch.core.nas``) and the port's examples
against the JAX package, on the CPU.

``zico_score`` is held against ``repro.core.nas.zico_score`` on the
example's configuration (reduced smollm, 4 layers in 2 sections, a
64-entry vocabulary, 3 probe minibatches of 2 × 16 tokens drawn with
numpy) with the reference's weights carried across.  The search's draws
(``random_arch``, ``mutate``) and its choice (``evolutionary_search``)
are held exactly: in the choice test both packages' ``zico_score`` is
replaced by one numpy function of the architecture, which keeps the
reference's retraces out of the run and holds the search logic alone.

Tolerances: ``zico_score`` at rtol 1e-4 (f32 gradients summed in other
orders; neighbouring architectures score 6e-3 apart on ~9); the draws
and the choice exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import nas as jnas
from repro.models import model as jmodel
from repro.models.masks import ClientArch as JClientArch
from repro_torch.core import nas
from repro_torch.examples import (backdoor_robustness, nas_client_selection,
                                  quickstart, serve_batched, train_lm)
from repro_torch.models.masks import ClientArch
from repro_torch.models.model import params_from_numpy

torch.set_num_threads(2)

CFG, _, BATCHES = nas_client_selection.setup("cpu")
JCFG = jget_arch("smollm-135m").reduced().replace(
    n_layers=4, n_sections=2, vocab_size=64)


@functools.lru_cache(maxsize=None)
def _jparams():
    return jmodel.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.mark.parametrize("w,depths", [(1.0, (2, 2)), (0.5, (1, 1)),
                                      (0.75, (1, 2))])
def test_zico_score_matches_reference(w, depths):
    """The score at full width and depth, at half width with one repeat
    of each section gated off, and with the first section's second repeat
    off."""
    jp = _jparams()
    params = params_from_numpy(jax.tree.map(np.asarray, jp), CFG, "cpu")
    want = jnas.zico_score(JCFG, JClientArch(w, depths), jp,
                           {"tokens": jnp.asarray(BATCHES["tokens"].numpy())})
    got = nas.zico_score(CFG, ClientArch(w, depths), params, BATCHES)
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 7])
def test_random_arch_and_mutate_draw_the_reference_archs(seed):
    """Equal seeds draw equal candidates and equal mutations, in the
    reference's order of draws."""
    space, jspace = nas.SearchSpace(), jnas.SearchSpace()
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(20):
        a = nas.random_arch(CFG, space, rng)
        b = jnas.random_arch(JCFG, jspace, jrng)
        assert (a.width_mult, a.section_depths) == \
            (b.width_mult, b.section_depths)
        for _ in range(3):
            a = nas.mutate(CFG, a, space, rng)
            b = jnas.mutate(JCFG, b, jspace, jrng)
            assert (a.width_mult, a.section_depths) == \
                (b.width_mult, b.section_depths)


def _fake_score(cfg, arch, params, batches, task="lm"):
    """A numpy function of the architecture alone, with no ties."""
    w = arch.width_mult
    d = np.asarray(arch.section_depths, np.float64)
    return float(np.sin(7.0 * w) + np.dot(np.cos(3.0 * d + w),
                                          np.arange(1, d.size + 1)))


@pytest.mark.parametrize("population,generations,seed",
                         [(6, 2, 0), (8, 3, 5)])
def test_evolutionary_search_selects_the_reference_arch(
        monkeypatch, population, generations, seed):
    monkeypatch.setattr(nas, "zico_score", _fake_score)
    monkeypatch.setattr(jnas, "zico_score", _fake_score)
    got = nas.evolutionary_search(CFG, None, None, population=population,
                                  generations=generations, seed=seed)
    want = jnas.evolutionary_search(JCFG, None, None, population=population,
                                    generations=generations, seed=seed)
    assert (got.width_mult, got.section_depths) == \
        (want.width_mult, want.section_depths)


# ---------------------------------------------------------------------------
# The examples, on the CPU
# ---------------------------------------------------------------------------

def test_quickstart_runs(capsys):
    out = quickstart.main(["--device", "cpu"])
    assert np.isfinite(out["loss"])
    assert out["delta_embed"] > 0 and out["delta_wq1"] > 0
    assert "grafting kept it fully aggregated" in capsys.readouterr().out


def test_train_lm_loss_falls():
    res = train_lm.main(["--steps", "12", "--batch", "4", "--seq-len", "32",
                         "--device", "cpu"])
    assert len(res["losses"]) == 12
    assert res["last"] < res["first"]


def test_backdoor_robustness_runs_small(capsys):
    out = backdoor_robustness.main(rounds=1, clients=4, device="cpu")
    for run in ("clean", "attacked"):
        assert set(out[run]) == {"fedfa", "nefl"}
        assert all(0.0 <= a <= 1.0 for a in out[run].values())
    assert "drop=" in capsys.readouterr().out


def test_serve_batched_runs():
    out = serve_batched.main(["--device", "cpu"])
    assert list(out) == [a for a, _ in serve_batched.RUNS]
    for arch, toks in out.items():
        assert toks.shape == (4, 16)


def test_nas_client_selection_runs(capsys):
    out = nas_client_selection.main(["--device", "cpu"])
    assert np.isfinite(out["zico_full"]) and np.isfinite(out["zico_half"])
    assert out["zico_full"] != out["zico_half"]
    assert isinstance(out["best"], ClientArch)
    assert "selected architecture" in capsys.readouterr().out


def test_examples_need_a_device_choice_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])
