"""Three paths of the port's FL CLI against the JAX package's, at the 4-layer
cut of smollm-135m, from the reference's weights, compared through the
checkpoints both CLIs write: the async driver with a finite
``--async-deadline``, rounds with ``--noniid`` clients, and rounds on
``--task lm``.

Tolerance: losses at rtol 1e-4 and the last checkpoint at rtol 1e-4 / atol
1e-5 (training sums in another order), the resident rounds' tolerance.
"""
import json

import jax
import numpy as np
import pytest

from repro.configs import get_arch as jget_arch
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro_torch.launch import train
from repro_torch.models.model import params_from_numpy

ARCH = "smollm-135m"
RUNS = {
    # a deadline of 3 time units fires merges before merge_k arrivals
    "async-deadline": dict(driver="async", rounds=4, n_clients=8,
                           async_deadline=3.0),
    "noniid": dict(rounds=2, n_clients=4, noniid=True),
    "task-lm": dict(rounds=2, n_clients=4, task="lm"),
}


def _checkpoint(prefix, last: str) -> tuple:
    """(the checkpoint's leaves as one flat f32 buffer, its json)."""
    with np.load(f"{prefix}_{last}.npz") as z:
        buf = np.concatenate([z[f"a{i}"].astype(np.float32).ravel()
                              for i in range(len(z.files))])
    with open(f"{prefix}_{last}.json") as f:
        return buf, json.load(f)


@pytest.mark.parametrize("case", sorted(RUNS))
def test_fl_path_matches_reference(case, tmp_path):
    kw = dict(RUNS[case], batch=2, seq_len=16, eval_every=1, quiet=True)
    task = kw.get("task", "cls")
    jcfg = jget_arch(ARCH).reduced().replace(n_layers=4, n_sections=2)
    if task == "cls":
        jcfg = jcfg.replace(vocab_size=64, tie_embeddings=False)
    cfg = train.fl_config(ARCH, task, 10, full_size=False)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))   # the CLI's seed
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    want = jtrain.run_fl(ARCH, ckpt=str(tmp_path / "jax"), **kw)
    got = train.run_fl(ARCH, ckpt=str(tmp_path / "port"), device="cpu",
                       params=params, **kw)
    assert got["round"] == want["round"] == list(range(kw["rounds"]))
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["global_acc"], want["global_acc"],
                               rtol=1e-6)
    last = ("m" if kw.get("driver") == "async" else "r") \
        + f"{kw['rounds'] - 1:05d}"
    got_buf, got_json = _checkpoint(tmp_path / "port", last)
    want_buf, want_json = _checkpoint(tmp_path / "jax", last)
    assert got_json == want_json
    np.testing.assert_allclose(got_buf, want_buf, rtol=1e-4, atol=1e-5)
    if case == "async-deadline":
        # the deadline changed the run: without it the last merge differs
        free = train.run_fl(ARCH, ckpt=str(tmp_path / "free"), device="cpu",
                            params=params, **dict(kw, async_deadline=np.inf))
        assert not np.allclose(_checkpoint(tmp_path / "free", last)[0],
                               got_buf, rtol=1e-4, atol=1e-5)
        assert free["loss"] != got["loss"]
