"""The port's resident round driver against the JAX package's
``run_rounds`` on the 4-layer fixture, with the JAX initial parameters and
(for attackers) the JAX label permutations carried across; the port's
resident and per-round drivers against each other; and the CLI."""
import jax
import numpy as np
import pytest
import torch

from conftest import fl_round_fixture, make_cohort

from repro.core import flat as jflat
from repro.core import round as jround
from repro.core.server import FLConfig as JFLConfig
from repro.core.server import make_client_specs as jmake_client_specs
from repro.core.server import select_clients as jselect_clients
from repro_torch import resolve_device
from repro_torch.core import flat
from repro_torch.core.round import eval_boundary, run_rounds
from repro_torch.core.server import (FLConfig, fl_round, make_client_specs,
                                     select_clients)
from repro_torch.data import partition, pipeline, synthetic
from repro_torch.launch import train
from repro_torch.models.model import params_from_numpy

torch.set_num_threads(2)

JCFG, JPARAMS = fl_round_fixture()
CFG = train.fl_config("smollm-135m", "cls", 10, full_size=False)
KEY = jax.random.PRNGKey(0)
E, M, ROUNDS = 2, 3, 2


def _port_cohort(m, malicious_frac=0.0, seed=0, n_classes=10):
    """The port's twin of ``conftest.make_cohort`` (same numpy draws)."""
    specs = make_client_specs(CFG, m, archs=train.client_arch_pool(CFG, "width"),
                              malicious_frac=malicious_frac, seed=seed)
    parts = partition.iid_partition(m, n_classes, seed=seed)
    profiles = synthetic.make_class_profiles(n_classes, CFG.vocab_size,
                                             seed=seed)

    def data_fn(r):
        b = pipeline.round_batches_cls(
            parts, list(range(m)), n_classes, CFG.vocab_size, local_steps=E,
            batch=2, seq_len=8, profiles=profiles, seed=100 + r)
        return specs, {k: torch.as_tensor(v, dtype=torch.int64)
                       for k, v in b.items()}
    return specs, data_fn


def _jax_perms(r, m, n):
    """The label permutations the JAX round draws for round r's clients."""
    keys = jax.random.split(jax.random.fold_in(KEY, r), m)
    return torch.as_tensor(np.stack([np.asarray(jax.random.permutation(k, n))
                                     for k in keys]), dtype=torch.int64)


def _port_params():
    return params_from_numpy(jax.tree.map(np.asarray, JPARAMS), CFG, "cpu")


@pytest.mark.parametrize("strategy,mal", [("fedfa", 0.0), ("heterofl", 0.0),
                                          ("fedfa", 0.34)])
def test_resident_rounds_match_reference(strategy, mal):
    jspecs, jdata = make_cohort(JCFG, M, local_steps=E, malicious_frac=mal)
    specs, data = _port_cohort(M, malicious_frac=mal)
    assert [s.malicious for s in specs] == [s.malicious for s in jspecs]
    assert any(s.malicious for s in specs) == (mal > 0)
    jfl = JFLConfig(local_steps=E, lr=0.05, strategy=strategy, task="cls")
    fl = FLConfig(local_steps=E, lr=0.05, strategy=strategy, task="cls")
    jp, jlosses = jround.run_rounds(JPARAMS, JCFG, jfl, ROUNDS, jdata, KEY)
    p, losses = run_rounds(_port_params(), CFG, fl, ROUNDS, data,
                           perm_fn=_jax_perms)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    index = flat.FlatIndex(p)
    np.testing.assert_allclose(
        flat.flatten(index, p).numpy(),
        np.asarray(jflat.flatten(jflat.get_index(jp), jp)),
        rtol=1e-4, atol=1e-5)


def test_resident_matches_per_round_driver():
    specs, data = _port_cohort(M, malicious_frac=0.34)
    fl = FLConfig(local_steps=E, lr=0.05, strategy="fedfa", task="cls")
    p_res, losses = run_rounds(_port_params(), CFG, fl, ROUNDS, data,
                               perm_fn=_jax_perms)
    p = _port_params()
    for r in range(ROUNDS):
        _, batches = data(r)
        p, loss = fl_round(p, CFG, fl, specs, batches,
                           perms=_jax_perms(r, M, batches["labels"][0].numel()))
        assert float(loss) == losses[r]
    index = flat.FlatIndex(p)
    assert torch.equal(flat.flatten(index, p), flat.flatten(index, p_res))


def test_host_side_helpers_match_reference():
    for r, rounds, every in [(0, 5, 2), (3, 5, 2), (4, 5, 2), (2, 3, 0)]:
        assert eval_boundary(r, rounds, every) == \
            jround.eval_boundary(r, rounds, every)
    a = select_clients(16, 0.5, np.random.default_rng(3))
    b = jselect_clients(16, 0.5, np.random.default_rng(3))
    np.testing.assert_array_equal(a, b)
    from repro.launch.train import client_arch_pool
    ps = make_client_specs(CFG, 9, archs=train.client_arch_pool(CFG, "both"),
                           malicious_frac=0.3, seed=4)
    js = jmake_client_specs(JCFG, 9, archs=client_arch_pool(JCFG, "both"),
                            malicious_frac=0.3, seed=4)
    assert [(s.arch.width_mult, s.arch.section_depths, s.n_data, s.malicious)
            for s in ps] == \
        [(s.arch.width_mult, s.arch.section_depths, s.n_data, s.malicious)
         for s in js]


@pytest.mark.parametrize("driver", ["resident", "per-round"])
def test_cli_runs_on_cpu(driver, tmp_path):
    out = tmp_path / "fl.json"
    res = train.main(["--rounds", "2", "--clients", "4", "--batch", "2",
                      "--seq-len", "8", "--malicious-frac", "0.25",
                      "--driver", driver, "--device", "cpu", "--out",
                      str(out)])
    assert out.exists() and res["round"] == [0, 1]
    assert len(res["round_loss"]) == 2
    assert np.all(np.isfinite(res["round_loss"]))
    assert 0.0 <= res["final_acc"] <= 1.0


# flags the port refuses on the CPU, with what it raises: an unknown mesh,
# meshes of more ranks than are running (one here), FL of internvl2-76b,
# whose batches carry no patches (ROADMAP queue 3 item 27), the kernels
# asked for without a card, the paper transformer's cut (3 query heads
# over 2 kv heads), and FL of whisper-base, whose batches carry no frames
# (item 25)
_REFUSED = [
    (["--mesh", "2y2"], ValueError, "unknown mesh"),
    (["--mesh", "production"], ValueError, "needs 256 ranks but 1 is"),
    (["--mesh-shape", "2x2"], ValueError, "needs 4 ranks but 1 is"),
    (["--arch", "internvl2-76b"], ValueError, "patches"),
    (["--use-kernel", "on"], RuntimeError, "use_kernel=True"),
    (["--mode", "dense", "--arch", "fedfa-paper-transformer"], ValueError,
     "n_kv_heads 2"),
    (["--arch", "whisper-base"], ValueError, "frames")]


@pytest.mark.parametrize("flag", [f for f, _, _ in _REFUSED])
def test_cli_unported_flags_raise(flag):
    _, err, match = next(r for r in _REFUSED if r[0] == flag)
    with pytest.raises(err, match=match):
        train.main(flag + ["--rounds", "1", "--steps", "1", "--clients", "2",
                           "--batch", "2", "--seq-len", "8", "--device",
                           "cpu"])


def test_entry_points_need_a_device():
    """Without an explicit device the port runs on cuda, and raises where
    there is none instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.run_fl("smollm-135m", 1, 2)
    assert resolve_device("cpu") == torch.device("cpu")
