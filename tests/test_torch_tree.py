"""The port's tree engine (``repro_torch.core.fedfa``) against the JAX
package's and against the port's flat engine, on the random heterogeneous
cohorts of ``test_differential_oracle.py`` (their perturbations drawn in
JAX and carried across as numpy, their architectures redrawn from the
same numpy seed); the per-round driver and CLI with ``--agg-engine tree``;
``fl_round_flat``; and the kernel choice (``use_kernel`` / ``interpret``)
on the CPU.

Tolerances: rtol 1e-4 / atol 1e-5 everywhere, the oracle's own — the
engines sum clients and elements in other orders; the trimmed thresholds
are bit-equal (a sort and the fused interpolation).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from conftest import fl_round_fixture
from test_differential_oracle import SEEDS, _WIDTHS, _random_cohort

from repro.core import fedfa as jfedfa
from repro_torch.core import fedfa, flat
from repro_torch.core.round import run_rounds
from repro_torch.core.server import FLConfig, fl_round, fl_round_flat
from repro_torch.kernels.fedfa_agg import ops as agg_ops
from repro_torch.kernels.fedfa_quantile import multilevel
from repro_torch.kernels.fedfa_quantile import ops as quant_ops
from repro_torch.launch import train
from repro_torch.models.masks import ClientArch, stack_masks
from repro_torch.models.model import _to_torch, params_from_numpy
from repro_torch.tree import leaves
from test_torch_round import _port_cohort

torch.set_num_threads(2)

JCFG, JPARAMS = fl_round_fixture()
CFG = train.fl_config("smollm-135m", "cls", 10, full_size=False)
# the oracle's seeds for every preset, and the reference's red hypothesis
# case (ROADMAP queue 3 item 3: the JAX flat and tree engines part there)
RED_CASE = (162, "fedfa")
CASES = [(s, n) for s in SEEDS for n in sorted(fedfa.STRATEGIES)] \
    + [RED_CASE]


def _port_params():
    return params_from_numpy(jax.tree.map(np.asarray, JPARAMS), CFG, "cpu")


@functools.lru_cache(maxsize=8)
def _port_cohort_of(seed: int):
    """The port's twin of the oracle's ``_random_cohort(seed)``: the same
    numpy draws of m and the architectures, the JAX-drawn clients."""
    rng = np.random.default_rng(seed)
    bounds = CFG.section_bounds()
    m = int(rng.integers(1, 6))
    archs = [ClientArch(float(rng.choice(_WIDTHS)),
                        tuple(int(rng.integers(1, hi - lo + 1))
                              for lo, hi in bounds))
             for _ in range(m)]
    stacked, jmasks, _, _, nd = _random_cohort(seed)
    masks = stack_masks([a.masks(CFG) for a in archs])
    np.testing.assert_array_equal(masks.d_model.numpy(),
                                  np.asarray(jmasks.d_model))
    return (jax.tree.map(lambda x: _to_torch(np.asarray(x)), stacked), masks,
            torch.stack([a.gates(CFG) for a in archs]),
            torch.stack([a.graft(CFG) for a in archs]),
            torch.from_numpy(np.array(nd)))


def _port(seed: int, strategy: str, engine: str) -> np.ndarray:
    flags = fedfa.STRATEGIES[strategy]
    return _port_of(seed, engine, flags["graft"], flags["scale"])


@functools.lru_cache(maxsize=None)
def _port_of(seed: int, engine: str, graft: bool, scale: bool):
    """The port's aggregate of cohort ``seed``, once per preset's flags."""
    stacked, masks, gates, gmaps, nd = _port_cohort_of(seed)
    return _flat_of(leaves(fedfa.aggregate(
        _port_params(), stacked, CFG, masks, gates, gmaps, nd, engine=engine,
        graft=graft, scale=scale)))


@functools.lru_cache(maxsize=None)
def _reference(seed: int, engine: str, graft: bool, scale: bool):
    """The reference's aggregate of the oracle's cohort ``seed``, compiled
    once per (engine, flags, cohort size) and computed once per preset's
    flags: four of the seven presets share graft = scale = False."""
    stacked, masks, gates, gmaps, nd = _random_cohort(seed)
    return _flat_of(jax.tree.leaves(_jitted_reference(engine, graft, scale)(
        JPARAMS, stacked, masks=masks, gates=gates, gmaps=gmaps, n_data=nd)))


@functools.lru_cache(maxsize=None)
def _jitted_reference(engine: str, graft: bool, scale: bool):
    return jax.jit(functools.partial(jfedfa.aggregate, cfg=JCFG, engine=engine,
                                     graft=graft, scale=scale))


def _flat_of(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in (t.numpy() if isinstance(t, torch.Tensor)
                                     else t for t in tree)])


@pytest.mark.parametrize("seed,strategy,against",
                         [c + (a,) for c in CASES
                          for a in ("reference", "flat")])
def test_tree_engine_matches(seed, strategy, against):
    """Against the reference's tree engine, and against the port's flat
    engine.  At the red case, where the reference's tree engine parts from
    its flat engine (``test_reference_tree_threshold_at_the_red_case``),
    the reference is its flat engine, at the same tolerance."""
    if against == "flat":
        want = _port(seed, strategy, "flat")
    else:
        engine = "flat" if (seed, strategy) == RED_CASE else "tree"
        flags = jfedfa.STRATEGIES[strategy]
        want = _reference(seed, engine, flags["graft"], flags["scale"])
    np.testing.assert_allclose(_port(seed, strategy, "tree"), want,
                               rtol=1e-4, atol=1e-5)


def test_reference_tree_threshold_at_the_red_case():
    """Why the reference's engines part at seed 162 (ROADMAP queue 3 item
    16): on the attacker's row 1 of stage 0's ``wk`` the two order
    statistics are adjacent floats, v1 = v0 + 1 ulp, at frac 0.65.  The
    correctly rounded interpolation is v1; the port's fused form gives v1,
    as the reference's flat engine does, while ``jnp.quantile`` (the
    reference's tree engine) gives v0 and so drops the element at v1 from
    the trimmed norm."""
    import jax.numpy as jnp
    from repro_torch.kernels.fedfa_quantile.ref import (interpolate,
                                                        interpolation_ranks)
    stacked, masks, _, _, _ = _port_cohort_of(RED_CASE[0])
    assert bool(torch.all(masks.kv_heads[2] == 1))   # the full width
    q = 1.0 - (1.0 - 0.95) * torch.ones((), dtype=torch.float32)
    # the reference's view: the leaf's (R, L) magnitudes, quantile per row
    wf = torch.abs(stacked["stages"][0][0]["attn"]["wk"][2]).reshape(4, -1)
    row = wf[1]
    r0, r1, frac = interpolation_ranks(q, torch.tensor(row.numel()))
    srt = torch.sort(row).values
    v0, v1 = srt[r0], srt[r1]
    assert torch.nextafter(v0, torch.tensor(np.inf)) == v1
    exact = v0.double() + (v1.double() - v0.double()) * frac.double()
    assert float(interpolate(v0, v1, frac)) == float(exact.float()) \
        == float(v1)
    jt = jnp.quantile(jnp.asarray(wf.numpy()), jnp.float32(q.item()),
                      axis=-1, keepdims=True)
    assert float(jt[1, 0]) == float(v0)


def test_tree_helpers_match_reference():
    """Grafting, extraction, trimmed norms and the data-weighted α."""
    from repro.core import masking as jmasking
    stacked, masks, _, gmaps, nd = _port_cohort_of(0)
    jstacked, jmasks, _, jgmaps, jnd = _random_cohort(0)
    client = jax.tree.map(lambda x: x[1], jstacked)
    p = jax.tree.map(lambda x: _to_torch(np.asarray(x)), client)
    g = fedfa.graft_stage0(p, gmaps[1])
    jg = jfedfa.graft_stage0(client, jgmaps[1])
    np.testing.assert_array_equal(_flat_of(leaves(g)),
                                  _flat_of(jax.tree.leaves(jg)))
    e = fedfa.extract_client_model(g, CFG, masks.client(1))
    je = jfedfa.extract_client_model(jg, JCFG, jax.tree.map(
        lambda x: x[1], jmasks))
    np.testing.assert_array_equal(_flat_of(leaves(e)),
                                  _flat_of(jax.tree.leaves(je)))
    from repro_torch.core.masking import axis_mask_tree
    n = fedfa.trimmed_sq_norms(e, axis_mask_tree(CFG, masks.client(1)))
    jn = jfedfa.trimmed_sq_norms(je, jmasking.axis_mask_tree(
        JCFG, jax.tree.map(lambda x: x[1], jmasks)))
    np.testing.assert_allclose(_flat_of(leaves(n)),
                               _flat_of(jax.tree.leaves(jn)), rtol=1e-5)
    norms = {"a": torch.tensor([[1.0, 2.0], [3.0, 0.0], [5.0, 6.0]])}
    wd = torch.tensor([1.0, 0.0, 2.0])
    for kw, jkw in [({}, {}), ({"n_data": wd}, {"n_data": wd.numpy()})]:
        np.testing.assert_allclose(
            fedfa.scaling_factors(norms, **kw)["a"].numpy(),
            np.asarray(jfedfa.scaling_factors(
                {"a": norms["a"].numpy()}, **jkw)["a"]), rtol=1e-6)


def _round_inputs(m=3):
    specs, data = _port_cohort(m)
    return specs, data(0)[1]


def test_per_round_tree_engine_matches_flat():
    specs, batches = _round_inputs()
    p, out = _port_params(), {}
    for eng in ("flat", "tree"):
        fl = FLConfig(local_steps=2, lr=0.05, strategy="fedfa", task="cls",
                      agg_engine=eng)
        out[eng] = fl_round(p, CFG, fl, specs, batches)
    assert float(out["flat"][1]) == float(out["tree"][1])
    np.testing.assert_allclose(_flat_of(leaves(out["tree"][0])),
                               _flat_of(leaves(out["flat"][0])),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="engine"):
        fl_round(p, CFG, FLConfig(local_steps=2, task="cls",
                                  agg_engine="nope"), specs, batches)


@pytest.mark.parametrize("dt", ["f32", "int8"])
def test_fl_round_flat_matches_resident_driver(dt):
    """``fl_round_flat`` on a resident buffer, its cohort state handed
    back, is bit-equal to two rounds of ``run_rounds``."""
    specs, data = _port_cohort(3)
    fl = FLConfig(local_steps=2, lr=0.05, strategy="fedfa", task="cls",
                  update_dtype=dt)
    p = _port_params()
    index = flat.FlatIndex(p)
    g_buf, c_buf = flat.flatten(index, p), None
    losses = []
    for r in range(2):
        g_buf, c_buf, loss = fl_round_flat(g_buf, CFG, fl, specs, data(r)[1],
                                           index=index, c_buf=c_buf)
        losses.append(float(loss))
    assert isinstance(c_buf, tuple) == (dt != "f32")
    p_res, want = run_rounds(_port_params(), CFG, fl, 2, data)
    assert losses == want
    assert torch.equal(g_buf, flat.flatten(index, p_res))
    with pytest.raises(ValueError, match="FlatIndex"):
        fl_round_flat(g_buf, CFG, fl, specs, data(0)[1])


def test_cli_tree_engine_falls_back_to_per_round(capsys):
    args = ["--rounds", "1", "--clients", "4", "--batch", "2", "--seq-len",
            "8", "--device", "cpu"]
    res = train.main(args + ["--agg-engine", "tree"])
    assert "falling back to the per-round driver" in capsys.readouterr().out
    flat_res = train.main(args + ["--driver", "per-round"])
    np.testing.assert_allclose(res["round_loss"], flat_res["round_loss"],
                               rtol=1e-6)
    assert res["global_acc"] == flat_res["global_acc"]


def _kernel_calls(x, mode):
    """Every wrapper of the aggregation path on CPU tensors, with a kernel
    choice: scaled_accum, quant_accum, trimmed_norm, quantile_fused,
    hist_level (through the multilevel quantile)."""
    kw = dict(use_kernel=mode)
    m, n = x.shape
    w = torch.linspace(0.5, 2.0, m)
    seg = torch.zeros(n, dtype=torch.int32)
    q = torch.full((m,), 0.95)
    return [agg_ops.scaled_accum(x, w, torch.ones(n), **kw),
            agg_ops.quant_accum(x.to(torch.int8), torch.ones((m, 1)), seg,
                                torch.ones(n), **kw),
            agg_ops.trimmed_norm(x[0], 0.5, **kw),
            *quant_ops.quantile_fused(x, q, **kw),
            *multilevel.row_trimmed_stats_multilevel(x, q, **kw)]


def test_kernel_choice_on_the_cpu():
    """On a CPU tensor: use_kernel=True raises (no silent plain version),
    also from every level of the multilevel quantile on a row longer than
    2^18; False runs the plain version, equal to auto's."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 600)).astype(np.float32))
    for a, b in zip(_kernel_calls(x, False), _kernel_calls(x, None)):
        assert torch.equal(a, b)
    long_row = torch.ones((1, (1 << 18) + 1))
    for call in (
            lambda: multilevel.row_trimmed_stats_multilevel(
                x, torch.full((3,), 0.9), use_kernel=True),
            lambda: quant_ops.row_trimmed_stats(
                long_row, torch.full((1,), 0.9), use_kernel=True),
            lambda: agg_ops.scaled_accum(x, torch.ones(3), torch.ones(600),
                                         use_kernel=True),
            lambda: quant_ops.row_trimmed_stats(x, torch.full((3,), 0.9),
                                                use_kernel=True),
            lambda: multilevel.hist_level(
                x, torch.zeros(600, dtype=torch.int32),
                torch.zeros((3, 2, 1), dtype=torch.int32), 24,
                use_kernel=True)):
        with pytest.raises(RuntimeError, match="use_kernel=True"):
            call()


def test_round_kernel_choice_on_the_cpu():
    """A round with use_kernel False or interpret equals auto's on the CPU;
    use_kernel=True raises there.  ``FLConfig`` folds interpret into
    use_kernel False, the one choice the round threads down."""
    assert FLConfig(use_kernel=True, interpret=True).use_kernel is False
    specs, batches = _round_inputs()
    p = _port_params()
    want = None
    for kw in ({}, {"use_kernel": False}, {"interpret": True}):
        fl = FLConfig(local_steps=2, lr=0.05, strategy="fedfa", task="cls",
                      **kw)
        got = flat.flatten(flat.FlatIndex(p),
                           fl_round(p, CFG, fl, specs, batches)[0])
        if want is None:
            want = got
        assert torch.equal(got, want)
    with pytest.raises(RuntimeError, match="use_kernel=True"):
        fl_round(p, CFG, FLConfig(local_steps=2, task="cls", use_kernel=True),
                 specs, batches)
