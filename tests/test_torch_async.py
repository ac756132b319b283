"""The port's async engine (``repro_torch.core.async_round``) against the
JAX package's on the 4-layer fixture, with the JAX initial parameters and
the JAX label permutations carried across.

Tolerances, and why each holds:
  * the host schedule (per-merge weights, simulated time, merged and
    dropped rows) is numpy on both sides and equal exactly;
  * f32: losses at rtol 1e-4 and the global after every merge at rtol 1e-4
    / atol 1e-5, the resident round test's (training sums in another
    order, compounded over the merges);
  * int8, each merge from the reference's state: losses at rtol 1e-4, and
    the global within rtol 1e-4 / atol 1e-5 except at most 1e-4·N
    elements, each within one admission step of its segment: jitted JAX
    contracts the error feedback into FMAs, the port does not, and an ulp
    can flip an int8 rounding;
  * parity mode is bit-equal to the port's own ``run_rounds``.
The JAX runs are shared between tests through a module-level cache.
"""
import json

import jax
import numpy as np
import pytest
import torch

from conftest import fl_round_fixture, make_cohort

from repro.core import async_round as jasync
from repro.core import flat as jflat
from repro.core.server import ClientSpec as JClientSpec
from repro.core.server import FLConfig as JFLConfig
from repro.models.masks import full_client as jfull_client
from repro.sim import TraceSource as JTraceSource
from repro_torch.core import flat
from repro_torch.core.async_round import (AsyncConfig, AsyncEngine, SlotPool,
                                          run_async, staleness_weight)
from repro_torch.core.round import quant_state_from_numpy, run_rounds
from repro_torch.core.server import ClientSpec, FLConfig
from repro_torch.launch import train
from repro_torch.models.masks import full_client
from repro_torch.models.model import params_from_numpy
from repro_torch.sim import ParitySource, TraceSource
from test_torch_quant import _steps, assert_round_close
from test_torch_round import _jax_perms, _port_cohort

torch.set_num_threads(2)

JCFG, JPARAMS = fl_round_fixture()
CFG = train.fl_config("smollm-135m", "cls", 10, full_size=False)
KEY = jax.random.PRNGKey(0)       # the key _jax_perms folds dispatches into
M, E, MERGES, SEED = 4, 2, 4, 5   # seed 5: the attacker is client 2 of 4
SKEW = dict(capacity=4, merge_k=2, staleness_max=1)


def _skew_latency(i):
    """The last client of each cohort straggles."""
    return 40.0 if i % M == M - 1 else 1.0 + (i % 3)


def _port_params():
    return params_from_numpy(jax.tree.map(np.asarray, JPARAMS), CFG, "cpu")


def _drive(eng, merges, after=None):
    """Step an engine to ``merges`` merges; per merge (sim time, merged
    rows, dropped rows).  ``after(m)`` runs after merge m."""
    sched = []
    while eng.merges < merges:
        if eng.step() is not None:
            sched.append((eng.now, eng.merged_rows, eng.dropped_rows))
            if after is not None:
                after(eng.merges - 1)
    return sched


_JAX_RUNS = {}


def _jax_skewed(dt):
    if dt not in _JAX_RUNS:
        _, jdata = make_cohort(JCFG, M, local_steps=E, malicious_frac=0.25,
                               seed=SEED)
        jfl = JFLConfig(local_steps=E, lr=0.05, strategy="fedfa", task="cls",
                        update_dtype=dt)
        jindex = jflat.get_index(JPARAMS)
        rec, states = [], []
        eng = jasync.AsyncEngine(
            jflat.flatten(jindex, JPARAMS), JCFG, jfl, jindex,
            JTraceSource(jdata, _skew_latency), KEY,
            acfg=jasync.AsyncConfig(**SKEW), on_merge=rec.append)
        keep = lambda m: states.append(
            [np.asarray(a) for a in eng._c_buf] if dt != "f32" else None)
        _JAX_RUNS[dt] = (_drive(eng, MERGES, keep), rec, states)
    return _JAX_RUNS[dt]


@pytest.mark.parametrize("dt", ["f32", "int8"])
def test_skewed_trace_matches_reference(dt):
    """The skewed stream through both engines, merge by merge.  At int8,
    after each merge the port takes the reference's global and quantized
    pool, so each merge's flips are counted alone.  Free-running, one
    merge's flips change the next admissions' training everywhere and
    compound past 1e-4·N by the fourth merge, and a flipped step of a row
    whose α exceeds 1 moves the global by more than one step."""
    jsched, jrec, jstates = _jax_skewed(dt)
    specs, data = _port_cohort(M, malicious_frac=0.25, seed=SEED)
    assert [s.malicious for s in specs] == [False, False, True, False]
    fl = FLConfig(local_steps=E, lr=0.05, strategy="fedfa", task="cls",
                  update_dtype=dt)
    params = _port_params()
    index = flat.FlatIndex(params)
    rec = []
    eng = AsyncEngine(flat.flatten(index, params), CFG, fl, index,
                      TraceSource(data, _skew_latency), acfg=AsyncConfig(**SKEW),
                      perm_fn=_jax_perms, on_merge=rec.append)

    def sync(m):
        eng.g_buf.copy_(torch.from_numpy(jrec[m]["g_after"]))
        for t, a in zip(eng._c_buf, quant_state_from_numpy(
                index, dt, jstates[m], "cpu")):
            t.copy_(a)
    assert _drive(eng, MERGES, None if dt == "f32" else sync) == jsched
    # the attacker merged, and so did a stale row
    assert any(r["w"][2] > 0 for r in rec)
    assert any(0 < w < s.n_data for r in rec for w, s in zip(r["w"], r["specs"]))
    for m, (got, want) in enumerate(zip(rec, jrec)):
        np.testing.assert_array_equal(got["w"], want["w"])
        assert [s.n_data for s in got["specs"]] == \
            [s.n_data for s in want["specs"]]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        if dt == "f32":
            np.testing.assert_allclose(got["g_after"], want["g_after"],
                                       rtol=1e-4, atol=1e-5)
        else:
            steps = _steps(index, want["g_after"], dt,
                           torch.from_numpy(jstates[m][1]))
            assert_round_close(got["g_after"], want["g_after"], steps,
                               f"{dt} global after merge {m}")


@pytest.mark.parametrize("strategy,dt", [("fedfa", "f32"), ("heterofl", "f32"),
                                         ("fedfa", "int8")])
def test_parity_bit_equal_to_run_rounds(strategy, dt):
    """Parity mode (full-pool merges, staleness 0, full-cohort arrivals)
    runs the resident round at every merge: losses and the global equal
    ``run_rounds``' bit for bit, with an attacker in the cohort."""
    specs, data = _port_cohort(M, malicious_frac=0.25, seed=SEED)
    fl = FLConfig(local_steps=E, lr=0.05, strategy=strategy, task="cls",
                  update_dtype=dt)
    p_sync, l_sync = run_rounds(_port_params(), CFG, fl, 2, data,
                                eval_every=0, perm_fn=_jax_perms)
    p_async, l_async = run_async(_port_params(), CFG, fl, 2,
                                 ParitySource(data),
                                 acfg=AsyncConfig.parity(M), eval_every=0,
                                 perm_fn=_jax_perms)
    assert l_sync == l_async
    index = flat.FlatIndex(p_sync)
    assert torch.equal(flat.flatten(index, p_sync),
                       flat.flatten(index, p_async))


def test_stale_attacker_dropped_with_weight_zero():
    """A straggling attacker that arrives past ``staleness_max`` is
    dropped: its weight is exactly 0 in every merge, and the engine counts
    it as dropped."""
    specs, data = _port_cohort(M, malicious_frac=0.25, seed=SEED)
    fl = FLConfig(local_steps=1, lr=0.05, strategy="fedfa", task="cls")
    params = _port_params()
    index = flat.FlatIndex(params)
    rec = []
    eng = AsyncEngine(
        flat.flatten(index, params), CFG, fl, index,
        TraceSource(data, lambda i: 4.0 if specs[i % M].malicious else 1.0),
        acfg=AsyncConfig(capacity=2, merge_k=1, staleness_max=1),
        perm_fn=_jax_perms, on_merge=rec.append)
    _drive(eng, 5)
    assert eng.dropped_rows >= 1
    for info in rec:
        for w, s in zip(info["w"], info["specs"]):
            if s.malicious:
                assert w == 0.0


def test_host_policy_matches_reference():
    for kw in (dict(capacity=4, merge_k=2, staleness_max=3),
               dict(capacity=4, merge_k=2, staleness_max=3, discount="const")):
        s = np.arange(6)
        got = staleness_weight(s, AsyncConfig(**kw))
        want = jasync.staleness_weight(s, jasync.AsyncConfig(**kw))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert AsyncConfig.parity(3) == AsyncConfig(capacity=3, merge_k=3,
                                                staleness_max=0)
    for bad in (dict(capacity=0), dict(capacity=4, merge_k=5),
                dict(capacity=4, merge_k=0), dict(staleness_max=-1),
                dict(discount="linear")):
        with pytest.raises(ValueError):
            jasync.AsyncConfig(**bad)
        with pytest.raises(ValueError):
            AsyncConfig(**bad)
    pools = SlotPool(capacity=3, rows=4), jasync.SlotPool(capacity=3, rows=4)
    spec = ClientSpec(arch=full_client(CFG), n_data=10)
    jspec = JClientSpec(arch=jfull_client(JCFG), n_data=10)
    for pool, s in zip(pools, (spec, jspec)):
        pool.admit(np.asarray([0, 2]), [s, s], np.asarray([1.0, 5.0]),
                   now=0.5, version=3)
        pool.release(pool.ready(1.5))
    for f in ("occupied", "arrival", "version", "nd", "loss"):
        np.testing.assert_array_equal(getattr(pools[0], f),
                                      getattr(pools[1], f))
    np.testing.assert_array_equal(pools[0].free_slots(), pools[1].free_slots())
    assert [s is None for s in pools[0].specs] == \
        [s is None for s in pools[1].specs]


def test_population_source_matches_reference():
    """``PopulationSource`` over ``make_class_spec_fn``: the same cohorts,
    latencies and client specs as the reference's, dispatch by dispatch."""
    from repro.sim import ClientPopulation as JClientPopulation
    from repro.sim import PopulationSource as JPopulationSource
    from repro.sim import make_class_spec_fn as jmake_class_spec_fn
    from repro_torch.sim import (ClientPopulation, PopulationSource,
                                 make_class_spec_fn)
    pops = ClientPopulation(5000, seed=3), JClientPopulation(5000, seed=3)
    sources = [PopulationSource(pops[0], make_class_spec_fn(
                   CFG, pops[0], malicious_frac=0.3), lambda d, ids: ids),
               JPopulationSource(pops[1], jmake_class_spec_fn(
                   JCFG, pops[1], malicious_frac=0.3), lambda d, ids: ids)]
    for d, t in ((0, 0.0), (1, 250.0), (7, 3000.5)):
        (specs, ids, lat), (jspecs, jids, jlat) = (src(d, t, 16)
                                                   for src in sources)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(lat, jlat)
        assert [(s.arch.width_mult, s.arch.section_depths, s.n_data,
                 s.malicious) for s in specs] == \
            [(s.arch.width_mult, s.arch.section_depths, s.n_data,
              s.malicious) for s in jspecs]
        assert any(s.malicious for s in specs)


def test_starvation_raises():
    fl = FLConfig(local_steps=E, lr=0.05, strategy="fedfa", task="cls")
    params = _port_params()
    index = flat.FlatIndex(params)
    eng = AsyncEngine(flat.flatten(index, params), CFG, fl, index,
                      lambda d, t, k: None,
                      acfg=AsyncConfig(capacity=2, merge_k=1, max_retries=5))
    with pytest.raises(RuntimeError, match="starved"):
        for _ in range(100):
            eng.step()


def test_run_async_noop():
    params = _port_params()
    p, losses = run_async(params, CFG, FLConfig(task="cls"), 0,
                          ParitySource(lambda r: ([], {})),
                          acfg=AsyncConfig.parity(1))
    assert losses == [] and p is params


def test_cli_async_runs_and_checkpoints(tmp_path):
    res = train.main(["--driver", "async", "--rounds", "2", "--clients", "4",
                      "--batch", "2", "--seq-len", "8", "--malicious-frac",
                      "0.25", "--device", "cpu", "--ckpt",
                      str(tmp_path / "x")])
    assert res["round"] == [0, 1] and len(res["round_loss"]) == 2
    assert np.all(np.isfinite(res["round_loss"]))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"x_m{r:05d}.{ext}" for r in (0, 1) for ext in ("json", "npz")]
    meta = json.loads((tmp_path / "x_m00001.json").read_text())["meta"]
    assert meta["merge"] == 1 and meta["strategy"] == "fedfa"
    assert set(meta) == {"merge", "strategy", "sim_time", "flat_n"}
    assert meta["sim_time"] > 0
