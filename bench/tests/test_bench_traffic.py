"""The traffic generator: the same seed gives the same inputs, another
seed other inputs, and every input keeps to its traffic file."""
import numpy as np
import pytest
import torch

from bench import traffic as tr
from bench.reference import model as md
from bench.reference.config import ModelConfig
from conftest import small_cell

SEEDS = (0, 2**31 + 5, 3_000_000_017)


def _cfg(cell):
    config, traffic = small_cell(cell)
    return ModelConfig.from_json(config["model"]), traffic


@pytest.mark.parametrize("seed", SEEDS)
def test_population_and_cohorts_repeat(seed):
    cfg, t = _cfg("smollm-135m.round")
    a = tr.population(cfg, t["population"], seed)
    assert a == tr.population(cfg, t["population"], seed)
    lo, hi = t["population"]["n_data"]
    assert all(lo <= n <= hi for *_, n in a)
    smallest = min((w, sum(d)) for w, d, _ in a)
    assert all((w, sum(d)) == smallest for w, d, _ in a[::2])
    ids = tr.cohorts(len(a), t["cohort"], 5, seed)
    assert np.array_equal(ids, tr.cohorts(len(a), t["cohort"], 5, seed))
    assert all(len(set(row)) == t["cohort"] for row in ids)


def test_seeds_differ():
    cfg, t = _cfg("smollm-135m.round")
    ids = tr.cohorts(16, 8, 4, 1)
    assert not np.array_equal(ids, tr.cohorts(16, 8, 4, 2))
    assert not np.array_equal(tr.lm_tokens(256, ids, 1, 2, 16, 1),
                              tr.lm_tokens(256, ids, 1, 2, 16, 2))


@pytest.mark.parametrize("seed", SEEDS)
def test_tokens_repeat_and_follow_domains(seed):
    ids = tr.cohorts(8, 4, 3, seed)
    a = tr.lm_tokens(256, ids, 2, 3, 64, seed)
    assert a.shape == (3, 4, 2, 3, 64) and a.dtype == np.int64
    assert np.array_equal(a, tr.lm_tokens(256, ids, 2, 3, 64, seed))
    assert a.min() >= 0 and a.max() < 256
    # a token is followed by one of its 4 successors 70 % of the time (and
    # by a Zipf draw the rest), so successors repeat far above chance
    succ = tr.rng(seed, 3).integers(0, 256, size=(8, 256, 4))
    dom = np.broadcast_to(ids[:, :, None, None, None], a.shape)[..., 1:]
    hit = np.any(succ[dom, a[..., :-1]] == a[..., 1:, None], axis=-1)
    assert 0.65 < hit.mean() < 0.85


@pytest.mark.parametrize("seed", SEEDS)
def test_uploads_repeat_and_are_masked(seed):
    cfg, t = _cfg("smollm-135m.merge-f32")
    g = md.init_flat(cfg, seed, "cpu")
    assert torch.equal(g, md.init_flat(cfg, seed, "cpu"))
    members = tr.population(cfg, t["population"], seed)[:3]
    x = tr.uploads(cfg, g, members, t["sigma"], seed, 10)
    assert torch.equal(x, tr.uploads(cfg, g, members, t["sigma"], seed, 10))
    for c, mem in enumerate(members):
        for off, size, shape, d in tr.client_mask_rows(cfg, mem, "cpu"):
            row = x[c, off:off + size].view(shape)
            dd = torch.broadcast_to(d, shape)
            assert torch.all(row[dd == 0] == 0)
            on = dd > 0
            dev = row[on] - g[off:off + size].view(shape)[on]
            assert float(dev.abs().max()) < 10 * t["sigma"]
