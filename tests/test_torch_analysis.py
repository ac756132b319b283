"""The port's program contracts (``repro_torch.analysis``) against the
reference's (``repro.analysis``): the Contract machinery, the 11 contract
factories field by field, the recorder's counting rules, the memory
sweep, planted failures, the pool passes, the lint, and the ``check``
CLI, whose run (two spawned 4-rank gloo meshes) the module shares.

Restated fields (each named in its factory's docstring): ``donated`` of
``round/quant``; ``peak_live_bytes_per_device`` of ``async/admit`` and
``async/admit-quant``; ``row_reads`` and ``peak_live_bytes_per_device`` of
``quantile/topk`` (and ``topk-pad``).  Every other field equals the
reference's exactly.
"""
import dataclasses
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.analysis import Contract, contracts, dispatch, lint, passes
from repro_torch.analysis import blame, comms, memory, programs
from repro_torch.analysis.dispatch import Recorder, Run, trace_counts
from repro_torch.core import async_round, flat
from repro_torch.core import round as round_mod
from repro_torch.kernels.build import kernel_scope
from repro_torch.kernels.fedfa_agg import ops as agg_ops
from repro_torch.kernels.fedfa_quantile import multilevel as q_ml
from repro_torch.kernels.fedfa_quantile import ops as q_ops
from repro_torch.kernels.fedfa_quantile import ref as q_ref
from repro_torch.launch.mesh import Mesh, get_mesh
from repro_torch.sharding import cohort as csh
from repro_torch.sharding import collectives as coll

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
FIXTURE = Path(__file__).resolve().parent / "fixtures" / \
    "lint_bad_import_device.py"
NAMES = ["round/ms1", "round/ms2", "round/quant", "agg/ms1", "agg/ms2",
         "async/admit", "async/admit-quant", "async/merge",
         "async/merge-ms2", "quantile/fused", "quantile/topk",
         "quantile/fused-pad", "quantile/topk-pad", "quantile/multilevel",
         "quantile/dist"]


# ---------------------------------------------------------------------------
# the check CLI, run once for the module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """``python -m repro_torch.analysis check --device cpu --json``: (exit
    code, stdout, the JSON report)."""
    out = tmp_path_factory.mktemp("analysis") / "analysis.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "check", "--device",
         "cpu", "--quiet", "--json", str(out)],
        capture_output=True, text=True, env=env, timeout=300)
    report = json.loads(out.read_text()) if out.exists() else None
    return proc.returncode, proc.stdout + proc.stderr, report


def test_check_cli_passes_all_15(cli):
    rc, text, report = cli
    assert rc == 0, text[-4000:]
    assert "contracts: 15/15 passed" in text
    assert report["ok"] and report["device"] == "cpu"
    assert [p["program"] for p in report["programs"]] == NAMES
    assert all(p["ok"] for p in report["programs"])
    assert [p["name"] for p in report["passes"]] == [
        "pool-key discrimination",
        "pool audit (rebuilt config, int8 vs f32)"]
    assert all(p["ok"] for p in report["passes"])


def test_check_cli_measures_the_mesh_structure(cli):
    """The measured collectives of the mesh programs: the data mesh's
    (M', γ) sums are N-sized all-reduces, the 2 x 2 aggregation's N/2, its
    histogram planes within ``histogram_elems``, and only the 2 x 2 round
    gathers (the global, once, over ``model``)."""
    _, _, report = cli
    got = {p["program"]: p["measured"] for p in report["programs"]}
    blame = {p["program"]: p["blame"] for p in report["programs"]}
    for name in ("round/ms1", "agg/ms1", "async/merge", "round/quant"):
        assert got[name]["scale_allreduces"] == 2, name
        assert got[name]["all_gathers"] == 0, name
    for name in ("agg/ms2", "async/merge-ms2"):
        assert got[name]["reduce_scatters"] == 0
        assert got[name]["scale_allreduces"] == 2
    assert got["round/ms2"]["all_gathers"] == 1
    (ag,) = [b for b in blame["round/ms2"] if b["kind"] == "all-gather"]
    assert ag["axis"] == "model" and ag["source"].startswith("round.py:")
    assert got["quantile/dist"]["all_reduces"] == 4          # one a level
    assert got["quantile/dist"]["row_reads"] == 1
    assert got["quantile/dist"]["row_reads_executed"] == 4
    assert got["round/ms1"]["donated"] == [0, 1]
    assert got["async/admit-quant"]["donated"] == [1, 2, 3, 4]


def test_check_without_device_raises_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.analysis.__main__ import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["check", "--quiet"])


# ---------------------------------------------------------------------------
# (a) the Contract machinery, against the reference's
# ---------------------------------------------------------------------------

HLO_SAMPLE = """\
HloModule jit_round, input_output_alias={ {0}: (0, {}, may-alias), {1}: (1, {}, must-alias) }

  %ar0 = f32[1024]{0} all-reduce(f32[1024]{0} %x), replica_groups={{0,1,2,3}}
  %ag0 = (f32[256]{0:T(256)}, f32[1024]{0:T(256)}) all-gather-start(f32[256]{0} %y), replica_groups=[2,2]<=[4]
  %ag0d = f32[1024]{0} all-gather-done((f32[256]{0}, f32[1024]{0}) %ag0)
  %ar1 = (f32[512]{0}, u32[]) all-reduce-start(f32[512]{0} %z)
  %ar1d = f32[512]{0} all-reduce-done((f32[512]{0}, u32[]) %ar1)
  %rs0 = f32[128]{0} reduce-scatter(f32[512]{0} %w), replica_groups={{0,1,2,3}}
"""

# the same collectives as the port records them, and the same donations
SAMPLE_OPS = [comms.CollectiveOp("all-reduce", "data", 1024, 4096),
              comms.CollectiveOp("all-gather", "model", 1024, 4096,
                                 "/x/round.py", 119),
              comms.CollectiveOp("all-reduce", "data", 512, 2048),
              comms.CollectiveOp("reduce-scatter", "model", 128, 512)]
SAMPLE_RUN = Run(ops=SAMPLE_OPS, in_place=frozenset({0, 1}))


@pytest.mark.parametrize("value,bound", [
    (3, 3), (3, 2), (3, (1, None)), (3, (4, None)), (3, (None, 2)),
    (3, None), (3, (None, 3)), (0, (1, 2))])
def test_check_bound_equals_reference(value, bound):
    from repro.analysis import contracts as jcontracts
    assert contracts.check_bound("x", value, bound) == \
        jcontracts.check_bound("x", value, bound)


@pytest.mark.parametrize("kw,match", [
    (dict(full_cohort_gathers=0), "cohort_elems"),
    (dict(scale_allreduces=1), "scale_elems")])
def test_contract_validation_equals_reference(kw, match):
    from repro.analysis import Contract as JContract
    with pytest.raises(ValueError, match=match) as mine:
        Contract(name="bad", **kw)
    with pytest.raises(ValueError, match=match) as theirs:
        JContract(name="bad", **kw)
    assert str(mine.value) == str(theirs.value)


def test_contract_check_measures_like_reference():
    from repro.analysis import Contract as JContract
    from repro.analysis import format_table as jformat
    kw = dict(name="t", all_gathers=1, reduce_scatters=(1, None),
              allreduce_max_elems=2048, scale_allreduces=(1, 2),
              scale_elems=512, full_cohort_gathers=0, cohort_elems=4096,
              donated=frozenset({0, 1}))
    mine = Contract(**kw).check(SAMPLE_RUN)
    theirs = JContract(**kw).check(hlo=HLO_SAMPLE)
    assert mine.ok and theirs.ok
    assert mine.measured == theirs.measured
    assert mine.contract.spec() == theirs.contract.spec()
    assert contracts.format_table([mine]) == jformat([theirs])

    tight = dict(name="t2", all_gathers=0, allreduce_max_elems=600,
                 donated=frozenset({2}))
    rep = Contract(**tight).check(SAMPLE_RUN)
    jrep = JContract(**tight).check(hlo=HLO_SAMPLE)
    assert not rep.ok and not jrep.ok
    assert len(rep.violations) == len(jrep.violations) == 3
    joined = " ".join(rep.violations)
    assert "all_gathers" in joined and "exceed" in joined \
        and "in-place" in joined
    # the violation names the line that issued the all-gather
    assert "round.py:119" in rep.violations[0]


def test_collective_records_read_like_the_reference():
    from repro.analysis import hlo
    jops = hlo.collectives(HLO_SAMPLE)
    for kind in comms.KINDS:
        assert comms.count(SAMPLE_OPS, kind) == hlo.count(jops, kind)
        assert comms.max_elems(SAMPLE_OPS, kind) == hlo.max_elems(jops,
                                                                   kind)
        assert comms.sizes(SAMPLE_OPS, kind, min_elems=600) == \
            hlo.sizes(jops, kind, min_elems=600)
    assert comms.summarize(SAMPLE_OPS) == hlo.summarize(jops)
    # the port counts each result once; the reference's HLO also counts
    # an async start's sync flag and an all-gather's operand beside it
    assert comms.byte_totals(SAMPLE_OPS) == {
        "all-reduce": 6144, "all-gather": 4096, "reduce-scatter": 512,
        "total": 10752}
    assert blame.describe(SAMPLE_OPS[1]) == \
        "all-gather[1024] over model (round.py:119)"
    assert blame.describe(SAMPLE_OPS[0]) == \
        "all-reduce[1024] over data (no provenance)"
    lines = blame.format_blame(SAMPLE_OPS, kinds=["all-reduce"])
    assert lines == ["all-reduce x2 (max 1024 elems) over data <- at "
                     "(no provenance)"]


def test_contract_missing_measurements_are_violations():
    for kw, what in ((dict(all_gathers=0), "no collective record"),
                     (dict(row_reads=1), "no recorded run"),
                     (dict(peak_live_bytes_per_device=(None, 8)),
                      "no memory measurement"),
                     (dict(donated=frozenset({0})), "no in-place record")):
        rep = Contract(name="t", **kw).check()
        assert not rep.ok and what in rep.violations[0]
    rep = Contract(name="t", row_reads=1).check(Run(counts=dispatch.Counts()))
    assert not rep.ok and "no row_elems" in rep.violations[0]


def test_format_table_and_json_equal_reference():
    from repro.analysis import Contract as JContract
    from repro.analysis import format_table as jformat
    good = dict(name="g", all_gathers=1)
    bad = dict(name="b", all_gathers=0)
    mine = [Contract(**good).check(SAMPLE_RUN),
            Contract(**bad).check(SAMPLE_RUN)]
    theirs = [JContract(**good).check(hlo=HLO_SAMPLE),
              JContract(**bad).check(hlo=HLO_SAMPLE)]
    table, jtable = contracts.format_table(mine), jformat(theirs)
    assert "PASS" in table and "FAIL b:" in table
    # the rows agree; a violation's blame lines name each package's source
    assert table.splitlines()[:4] == jtable.splitlines()[:4]
    for m, t in zip(mine, theirs):
        d, jd = json.loads(json.dumps(m.to_json())), t.to_json()
        for key in ("program", "description", "spec", "measured", "ok"):
            assert d[key] == jd[key], key
    d = mine[1].to_json()
    assert any(b["source"] == "round.py:119" for b in d["blame"])


# ---------------------------------------------------------------------------
# (b) the 11 factories, field by field against the reference's
# ---------------------------------------------------------------------------

# (factory name, restated fields) — the restated ones are checked below
RESTATED = {"quantized_round_contract": {"donated"},
            "admit_contract": {"peak_live_bytes_per_device"},
            "quantized_admit_contract": {"peak_live_bytes_per_device"},
            "topk_tail_contract": {"row_reads",
                                   "peak_live_bytes_per_device"}}


def _port_cfg():
    """The port's config of the shared fixture."""
    from repro_torch.launch.train import fl_config
    return fl_config("smollm-135m", "cls", 10, full_size=False)


def _indices(shape):
    """(port FlatIndex, reference FlatIndex, port mesh, reference stand-in
    mesh) of the shared fixture for a mesh shape (None: no mesh)."""
    import jax
    from conftest import fl_round_fixture
    from repro.core import flat as jflat
    from repro.sharding import cohort as jcsh
    from repro_torch.models.model import params_from_numpy
    _, jparams = fl_round_fixture()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), _port_cfg(),
                               "cpu")
    if shape is None:
        mesh = jmesh = None
    else:
        mesh = Mesh(shape, (0, 0), {}, torch.device("cpu"), "gloo", False)
        jmesh = SimpleNamespace(size=shape[0] * shape[1],
                                shape={"data": shape[0], "model": shape[1]},
                                axis_names=("data", "model"))
    index = flat.FlatIndex(params, pad_to=csh.pad_unit(mesh))
    jindex = jflat.get_index(jparams, pad_to=jcsh.pad_unit(jmesh))
    assert (index.n_padded, index.n_segments) == \
        (jindex.n_padded, jindex.n_segments)
    return index, jindex, mesh, jmesh


def _equal_but(c, jc, skip):
    for f in dataclasses.fields(c):
        if f.name in skip or f.name == "description":
            continue
        assert getattr(c, f.name) == getattr(jc, f.name), (c.name, f.name)


@pytest.mark.parametrize("shape", [None, (4, 1), (2, 2)],
                         ids=["no-mesh", "4x1", "2x2"])
def test_factories_equal_reference(shape):
    from repro.core import async_round as jasync
    from repro.core import round as jround
    from repro.kernels.fedfa_agg import ops as jagg
    from repro.kernels.fedfa_quantile import multilevel as jml
    from repro.kernels.fedfa_quantile import ops as jqops
    index, jindex, mesh, jmesh = _indices(shape)
    rows = 3 + csh.pad_rows(3, mesh)
    pairs = [
        ("round_contract", round_mod.round_contract(index, mesh, rows=rows),
         jround.round_contract(jindex, jmesh, rows=rows)),
        ("quantized_round_contract",
         round_mod.quantized_round_contract(index, mesh, rows=rows),
         jround.quantized_round_contract(jindex, jmesh, rows=rows)),
        ("admit_contract", async_round.admit_contract(index, mesh, rows=rows),
         jasync.admit_contract(jindex, jmesh, rows=rows)),
        ("merge_contract", async_round.merge_contract(index, mesh, rows=rows),
         jasync.merge_contract(jindex, jmesh, rows=rows)),
        ("quantized_admit_contract",
         async_round.quantized_admit_contract(index, mesh, rows=rows),
         jasync.quantized_admit_contract(jindex, jmesh, rows=rows))]
    for r in (None, rows):
        for segs in (None, index.n_segments):
            pairs.append(("accumulate_contract",
                          agg_ops.accumulate_contract(index.n_padded, mesh,
                                                      r, segs),
                          jagg.accumulate_contract(jindex.n_padded, jmesh, r,
                                                   segs)))
    for bb in (None, 4096, 42000):
        for padded in (False, True):
            pairs += [("fused_quantile_contract",
                       q_ops.fused_quantile_contract(bb, padded=padded),
                       jqops.fused_quantile_contract(bb, padded=padded)),
                      ("topk_tail_contract",
                       q_ops.topk_tail_contract(bb, padded=padded),
                       jqops.topk_tail_contract(bb, padded=padded)),
                      ("multilevel_quantile_contract",
                       q_ml.multilevel_quantile_contract(bb, padded=padded),
                       jml.multilevel_quantile_contract(bb, padded=padded))]
        local = rows // csh.data_shards(mesh)
        pairs.append(("distributed_quantile_contract",
                      q_ml.distributed_quantile_contract(
                          local, index.n_segments, bb),
                      jml.distributed_quantile_contract(
                          local, jindex.n_segments, bb)))
    for name, c, jc in pairs:
        _equal_but(c, jc, RESTATED.get(name, set()))
    for r in (1, 2, 3):
        for segs in (1, 39):
            assert q_ml.histogram_elems(r, segs) == \
                jml.histogram_elems(r, segs)


@pytest.mark.parametrize("shape", [None, (4, 1), (2, 2)],
                         ids=["no-mesh", "4x1", "2x2"])
def test_restated_fields(shape):
    """Each restated field holds its documented value, and the reference's
    differs from it (else it would not be restated)."""
    from repro.core import async_round as jasync
    from repro.core import round as jround
    from repro.kernels.fedfa_quantile import ops as jqops
    index, jindex, mesh, jmesh = _indices(shape)
    rows = 3 + csh.pad_rows(3, mesh)
    r = rows // csh.data_shards(mesh)
    n4 = index.n_padded * 4
    q = round_mod.quantized_round_contract(index, mesh, rows=rows)
    assert q.donated == {0, 1, 8} != jround.quantized_round_contract(
        jindex, jmesh, rows=rows).donated
    assert "flat_round" in inspect.getdoc(round_mod.quantized_round_contract)
    a = async_round.admit_contract(index, mesh, rows=rows)
    assert a.peak_live_bytes_per_device == (None, (8 + 5 * r) * n4)
    assert jasync.admit_contract(jindex, jmesh, rows=rows) \
        .peak_live_bytes_per_device == (None, (2 + 5 * r) * n4)
    aq = async_round.quantized_admit_contract(index, mesh, rows=rows)
    assert aq.peak_live_bytes_per_device == (None, (8 + 6 * r) * n4)
    for padded in (False, True):
        t = q_ops.topk_tail_contract(1000, padded=padded)
        jt = jqops.topk_tail_contract(1000, padded=padded)
        assert (t.row_reads, t.peak_live_bytes_per_device) == \
            (8, (None, 6000))
        assert (jt.row_reads, jt.sorts) == (7, t.sorts)
    for fn in (async_round.admit_contract,
               async_round.quantized_admit_contract,
               q_ops.topk_tail_contract):
        assert "restated" in inspect.getdoc(fn)


# ---------------------------------------------------------------------------
# (c) the recorder's counting rules on planted programs
# ---------------------------------------------------------------------------

def _x():
    return torch.arange(24, dtype=torch.float32).reshape(4, 6)


def test_layout_ops_are_not_reads():
    def prog(x):
        y = x.reshape(6, 4).permute(1, 0).contiguous()
        z = x.to(torch.float64).clone()
        w = x.t().expand(6, 4)[1:]
        return torch.abs(x), y, z, w
    c = trace_counts(prog, _x(), row_elems=24)
    assert (c.reads, c.sorts) == (1, 0)


def test_sorts_gathers_and_scatters_are_counted():
    def prog(x):
        s = torch.sort(x, dim=1).values
        t = torch.topk(x, 2, dim=1).values
        i = torch.argsort(x[0])
        g = torch.gather(x, 1, torch.zeros((4, 1), dtype=torch.int64))
        x.index_copy_(0, torch.tensor([0]), x[1:2].clone())
        return s, t, i, g
    c = trace_counts(prog, _x(), row_elems=24)
    assert c.sorts == 3 and c.gathers == 1 and c.scatters == 1


def test_kernel_scope_is_one_read_not_recursed():
    def prog(x):
        with kernel_scope("planted", x):
            torch.sort(x)
            y = x * 2
            return y + x
    c = trace_counts(prog, _x(), row_elems=24)
    assert (c.reads, c.reads_executed, c.sorts) == (1, 1, 0)
    # the wrappers' plain versions count alike: quantile_fused sorts inside
    rows = torch.randn(4, 64)
    c = trace_counts(q_ops.quantile_fused, rows, torch.full((4,), 0.9),
                     row_elems=rows.numel())
    assert (c.reads, c.sorts) == (1, 0)
    # a scope whose inputs are not the row block is no read
    c = trace_counts(prog, _x(), row_elems=7)
    assert (c.reads, c.sorts) == (0, 0)


def test_a_loop_is_one_site():
    def prog(x):
        for _ in range(4):
            y = x * 2
        z = x * 3
        return y, z
    c = trace_counts(prog, _x(), row_elems=24)
    assert (c.reads, c.reads_executed) == (2, 5)


def test_multilevel_level_loop_is_one_site():
    rows = torch.randn(2, (1 << 18) + 512)
    c = trace_counts(q_ops.row_trimmed_stats, rows, torch.full((2,), 0.975),
                     row_elems=rows.numel())
    assert (c.reads, c.reads_executed, c.sorts) == (1, 4, 0)


# ---------------------------------------------------------------------------
# (d) the quantile paths against the reference's jaxpr walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["fused", "fused-pad", "multilevel"])
def test_quantile_counts_equal_reference_walk(case):
    import jax.numpy as jnp
    from repro.analysis import jaxpr as jaxpr_mod
    from repro.core import flat as jflat
    from repro.kernels.fedfa_quantile import ops as jqops
    rng = np.random.default_rng(0)
    shape = {"fused": (4, 8, 512), "fused-pad": (3, 7, 500),
             "multilevel": (2, (1 << 18) + 512)}[case]
    rows = rng.standard_normal(shape, np.float32)
    q = np.full((shape[0],), 0.975, np.float32)
    if case == "multilevel":
        def jfn(r, qq):
            return jqops.row_trimmed_stats(r, qq, use_kernel=True,
                                           interpret=True)
        fn = q_ops.row_trimmed_stats
    else:
        def jfn(r, qq):
            return jnp.sqrt(jflat._rows_trimmed_stats(r, qq, 0.95, True,
                                                      True)[1])

        def fn(r, qq):
            return torch.sqrt(flat._rows_trimmed_stats(r, qq)[1])
    jc = jaxpr_mod.trace_counts(jfn, jnp.asarray(rows), jnp.asarray(q),
                                row_elems=rows.size)
    c = trace_counts(fn, torch.from_numpy(rows), torch.from_numpy(q),
                     row_elems=rows.size)
    assert (c.reads, c.sorts) == (jc.reads, jc.sorts) == (1, 0)


# ---------------------------------------------------------------------------
# (e) the memory sweep on planted sequences
# ---------------------------------------------------------------------------

def _sweep(prog, x):
    return memory.analyze(prog, x)


def test_sweep_frees_reuses_and_holds_scopes():
    x = torch.zeros(1024)                  # 4096 bytes
    blk = x.numel() * 4

    def frees(x):
        a = x * 2
        del a
        b = x * 3
        return b
    assert _sweep(frees, x).peak_bytes == 2 * blk

    def in_place(x):
        x.mul_(2)
        x.add_(1)
    assert _sweep(in_place, x).peak_bytes == blk

    def view_keeps_alive(x):
        a = x * 2
        v = a[:10]
        del a
        b = x * 3
        return v, b
    assert _sweep(view_keeps_alive, x).peak_bytes == 3 * blk

    def scoped(x):
        with kernel_scope("planted", x):
            t = x * 2
            t2 = t * 3
            out = torch.empty_like(x)
            del t, t2
        return out
    mem = _sweep(scoped, x)
    assert mem.peak_bytes == 2 * blk and mem.source == "sweep"


def test_peak_violation_names_the_largest_live_buffers():
    x = torch.zeros(1024)

    def prog(x):
        a = x * 2
        b = torch.cat([x, x])
        return a, b
    mem = _sweep(prog, x)
    assert mem.peak_bytes == 4 * 4096
    assert dict(mem.top) == {"input[0]": 4096, "aten.mul": 4096,
                             "aten.cat": 8192}
    rep = Contract(name="t", peak_live_bytes_per_device=(None, 8192)).check(
        Run(memory=mem))
    assert not rep.ok
    assert "aten.cat=8192B" in rep.violations[0] \
        and "largest live buffers" in rep.violations[0]


def test_sweep_charges_kernel_outputs_alike():
    """A wrapper's plain version frees its transients inside its scope:
    only its output is charged, as the kernel's ``torch.empty`` is."""
    x, w, mask = torch.randn(3, 4096), torch.ones(3), torch.ones(4096)
    with Recorder(inputs=(x, w, mask)) as rec:
        agg_ops.scaled_accum(x, w, mask)
    assert rec.memory.peak_bytes == (x.numel() + 3 + 2 * 4096) * 4


# ---------------------------------------------------------------------------
# (f) planted failures
# ---------------------------------------------------------------------------

def test_quantile_contract_fails_on_the_plain_path():
    """The counterpart of the reference's
    ``test_quantile_contract_fails_on_oracle_path``: the plain sort-based
    version, called outside the wrapper, must FAIL the fused and
    multilevel contracts, not pass them vacuously."""
    rows = torch.randn(2, 2048)
    q = torch.full((2,), 0.975)
    with Recorder(row_elems=rows.numel(), inputs=(rows, q)) as rec:
        q_ref.row_trimmed_stats_ref(rows, q)
    for contract in (q_ops.fused_quantile_contract(),
                     q_ml.multilevel_quantile_contract()):
        rep = contract.check(rec.run(ops=[]))
        assert not rep.ok
        joined = " ".join(rep.violations)
        assert "sorts == 1" in joined and "row_reads" in joined


def test_round_writing_a_fresh_global_fails_donated():
    cfg, fl, params, specs, batches = programs._fixture(3)
    index = flat.FlatIndex(params)
    from repro_torch.core.server import stack_runtimes
    runtimes = stack_runtimes(cfg, specs, "cpu")
    contract = round_mod.round_contract(index, None, rows=3)

    def fresh_global(g_buf, c_buf, *rest):
        return round_mod.flat_round(g_buf.clone(), c_buf, *rest)
    args = (flat.flatten(index, params), torch.zeros(3, index.n_padded),
            cfg, fl, index, runtimes, batches)
    msgs = passes.check_in_place(fresh_global, args, contract.donated)
    assert msgs == ["argument 0 does not hold the result in place "
                    "(held in place: [1])"]
    _, rec, held = passes.run_in_place(fresh_global, args)
    rep = contract.check(rec.run(ops=[], in_place=held))
    assert not rep.ok and "in-place results missing for argument(s) [0]" \
        in rep.violations[0]
    # the real round holds both
    assert passes.check_in_place(round_mod.flat_round, args, {0, 1}) == []


def test_planted_all_gather_fails_admit_with_its_source_line(monkeypatch):
    """An all-gather planted into the admission (through the graft it
    calls) fails ``async/admit``, and the violation's blame names the
    line of the port that issued it."""
    mesh = get_mesh("1x1", "cpu")
    try:
        graft = flat._graft_flat

        def planted(index, x, gmaps):
            coll.all_gather(x.reshape(-1), mesh, csh.MODEL_AXIS)
            return graft(index, x, gmaps)
        monkeypatch.setattr(flat, "_graft_flat", planted)
        eng, index = programs._engine(mesh, 3, "f32", "cpu")
        rec, held = programs.record_admission(eng, mesh)
        rep = async_round.admit_contract(index, mesh, rows=eng.rows).check(
            rec.run(ops=programs._ops(mesh), in_place=held))
    finally:
        mesh.close()
    src = inspect.getsource(async_round.AsyncEngine._admit).splitlines()
    first = inspect.getsourcelines(async_round.AsyncEngine._admit)[1]
    line = first + next(i for i, s in enumerate(src)
                        if "flat._graft_flat(" in s)
    assert not rep.ok
    joined = "\n".join(rep.violations)
    assert "all_gathers == 1, expected exactly 0" in joined
    assert "full_cohort_gathers == 1" in joined
    assert f"blame: all-gather x1 (max {3 * index.n_padded} elems) over " \
           f"model <- at async_round.py:{line}" in joined


# ---------------------------------------------------------------------------
# (g) pool passes
# ---------------------------------------------------------------------------

def test_pool_auditor_and_key_variants():
    assert all(not v for _, v in programs.cache_checks())
    cfg, fl, params, _, _ = programs._fixture(3)
    index = flat.FlatIndex(params)
    drv = round_mod.ResidentDriver(cfg, fl, index, "cpu")
    with passes.PoolAuditor() as aud:
        made = round_mod.ResidentDriver(cfg, fl, index, "cpu")
        made.pool(2)
        made.pool(2)
    assert aud.report() == {"hits": 1, "allocs": 1}
    assert type(made._pools) is dict              # restored on exit
    with passes.PoolAuditor(drv) as aud:
        for dt in ("f32", "int8", "bf16"):
            drv.fl = dataclasses.replace(fl, update_dtype=dt)
            drv.pool(3)
        drv.fl = dataclasses.replace(fl)
        drv.pool(3)
    assert aud.report() == {"hits": 1, "allocs": 3}
    assert passes.audit_pools(drv) == []
    # a key that under-discriminates (no dtype) collides
    keys = [(f"{dt}", (3,)) for dt in ("f32", "int8")]
    assert len(passes.check_cache_keys(keys)) == 1
    # a pool whose buffers do not match its key is flagged
    c_buf, q = drv._pools[(3, "int8")]
    drv._pools[(3, "int8")] = (c_buf[:2], q)
    drv._pools[(3, "bf16")] = (drv._pools[(3, "bf16")][0], None)
    msgs = passes.audit_pools(drv)
    assert len(msgs) == 2 and "training buffer" in msgs[0] \
        and "lacks a quantized state" in msgs[1]


def test_data_mesh_pads_share_a_pool():
    cfg, fl, params, _, _ = programs._fixture(3)
    index = flat.FlatIndex(params)
    mesh = Mesh((4, 1), (0, 0), {}, torch.device("cpu"), "gloo", False)
    drv = round_mod.ResidentDriver(cfg, fl, index, "cpu", mesh)
    assert drv.pool_key(3) == drv.pool_key(4) == (4, "f32")
    assert drv.pool_key(5) == (8, "f32")


# ---------------------------------------------------------------------------
# (i) lint
# ---------------------------------------------------------------------------

def test_lint_flags_planted_fixture():
    findings = lint.lint_paths([str(FIXTURE)])
    assert [f.rule for f in findings] == ["import-time-device"] * 4 + \
        ["bare-assert"]
    assert [f.line for f in findings] == [9, 10, 11, 12, 19]


def test_lint_noqa_deferred_and_kernels_exempt():
    src = ("import torch\n"
           "A = torch.zeros(3, device='cuda')  # noqa: import-time-device\n"
           "B = torch.zeros(3)\n"
           "F = lambda: torch.cuda.synchronize()\n"
           "def f():\n"
           "    torch.cuda.synchronize()\n"
           "    assert True  # noqa\n")
    assert lint.lint_source(src, "x.py") == []
    assert lint.lint_source("assert 1\n", "src/repro_torch/kernels/k.py") == []
    bad = lint.lint_source("def f(:\n", "bad.py")
    assert [f.rule for f in bad] == ["syntax-error"]


def test_lint_port_tree_is_clean():
    findings = lint.lint_paths([str(REPO / "src" / "repro_torch")])
    assert findings == [], "\n".join(map(str, findings))
    from repro_torch.analysis.__main__ import main
    assert main(["lint"]) == 0
