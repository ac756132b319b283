"""Whole runs of every cell on the CPU at the tests' small size: they
prove correct against the reference, report their metrics, load nothing
of JAX, and come out not correct when the timed path is broken."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness
from conftest import ROOT, run_small

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
ROUND = [c for c in CELLS if c.endswith(".round")]
MERGE = [c for c in CELLS if ".merge" in c]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_and_reports_its_metrics(cell):
    out = run_small(cell)
    assert out["correct"], out["checks"]
    want = {m["name"] for m in harness.cell_metrics(
        harness.benchmark(), cell, "end_to_end")}
    assert set(out["metrics"]) == want
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(harness.load("workloads",
                                                  cell)["limits"])


@pytest.mark.parametrize("cell", [ROUND[0], MERGE[-1]])
def test_traced_run_reports_spans(cell):
    out = run_small(cell, trace=1, seconds=3.0)
    assert out["correct"]
    names = set(out["metrics"])
    assert {"train_ms.round", "aggregate_ms.round"} <= names or \
        {"aggregate_ms.merge", "admit_ms.merge"} <= names
    # no device on the CPU: the trace's readers give nothing, never 0
    assert not any(n.startswith(("idle", "mfu")) or n.endswith("_roofline")
                   for n in names)
    assert out["device"]["window_s"] > 0 and "breakdown" in out


def _unchanged(flat):
    orig = flat.aggregate_buffers
    return lambda index, g, *a, **kw: (orig(index, g, *a, **kw), g.clone())[1]


def _half(flat):
    orig = flat.aggregate_buffers

    def agg(index, g, x, cfg, masks, gates, gmaps, nd, **kw):
        nd = nd.clone()
        nd[nd.shape[0] // 2:] = 0.0      # left out; the mean over the rest
        return orig(index, g, x, cfg, masks, gates, gmaps, nd, **kw)
    return agg


def _altered(flat):
    orig = flat.aggregate_buffers

    def agg(*a, **kw):
        out = orig(*a, **kw)
        out[0] += 1.0
        return out
    return agg


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_aggregation_is_not_correct(cell, fault, monkeypatch):
    from repro_torch.core import flat
    make = {"unchanged": _unchanged, "half": _half, "altered": _altered}
    monkeypatch.setattr(flat, "aggregate_buffers", make[fault](flat))
    assert not run_small(cell)["correct"]


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
@pytest.mark.parametrize("cell", ROUND)
def test_half_batch_or_altered_update_is_not_correct(cell, fault,
                                                     monkeypatch):
    from repro_torch.core import round as rnd
    orig = rnd.cohort_update

    def half_batch(g, cfg, fl, index, masks, gates, batches, *a):
        b = {k: v[:, :, :v.shape[2] // 2] for k, v in batches.items()}
        return orig(g, cfg, fl, index, masks, gates, b, *a)

    def altered(*a):
        losses = orig(*a)
        a[-1][0, 0] += 1.0               # the first row's first element
        return losses
    monkeypatch.setattr(rnd, "cohort_update",
                        {"half_batch": half_batch, "altered": altered}[fault])
    assert not run_small(cell)["correct"]


def test_altered_admission_is_not_correct(monkeypatch):
    from repro_torch.core import flat
    orig = flat.admit_quantized

    def admit(index, cfg, x, masks, gmaps, graft, state, *a, **kw):
        orig(index, cfg, x, masks, gmaps, graft, state, *a, **kw)
        state[0][0, :8] = 127            # one row's first values at the top
    monkeypatch.setattr(flat, "admit_quantized", admit)
    assert not run_small("smollm-135m.merge-int8")["correct"]


def test_no_jax_in_a_run():
    code = ("import sys; sys.argv = ['x']; sys.path[:0] = [{!r}, {!r}]\n"
            "from conftest import run_small\n"
            "from bench import harness\n"
            "out = run_small('smollm-135m.merge-int8')\n"
            "print(harness.forbidden_modules(), "
            "'repro_torch' in sys.modules)").format(
                str(Path(__file__).parent), str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torchx", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro", object())
    assert harness.forbidden_modules() == ["repro"]


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "bench" / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro", "jax"), \
                    (path.name, n)


def test_run_without_the_program_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, env=env,
                       timeout=900)
    assert p.returncode != 0 and not p.stdout.strip()


def test_benchmark_file_is_well_formed():
    bm = harness.benchmark()
    assert set(bm) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    for w in bm["workloads"]:
        cell = harness.load("workloads", w["name"])
        assert {k: cell[k] for k in ("config", "traffic", "chips", "why")} \
            == {k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert len(w["why"]) <= 200
    for m in bm["per_layer"]:
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").exists()
    for c in bm["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]


def test_stretch_reads_every_loaded_kernel(monkeypatch):
    """A kernel that a later change adds is read by its name alone: the
    harness finds every ``CudaKernel`` of the program's kernel modules."""
    import time
    import types
    from repro_torch.core import flat  # noqa: F401  (imports the kernels)
    from repro_torch.kernels.build import CudaKernel
    fake = types.ModuleType("repro_torch.kernels.fake_for_test")
    fake.FAKE = CudaKernel("scaled_accum.cu", "fake_kernel", [])
    monkeypatch.setitem(sys.modules, fake.__name__, fake)
    assert harness.loaded_kernels()["fake_kernel"] is fake.FAKE
    fake.FAKE.by_shape[(1, 2)] += 5          # before the stretch: left out
    h = harness.Harness(CELLS[0], 1, 0.0, True, time.perf_counter(), "cpu")
    h.stretch = (0,)
    h._stretch_begin()
    fake.FAKE.by_shape[(3, 4)] += 2
    h._stretch_end()
    assert h.by_shape["fake_kernel"] == {(3, 4): 2}
    assert {"scaled_accum", "hist_level"} <= set(h.by_shape)


def test_trace_reduction_counts_overlaps_once():
    dev = [(10, 30, "void a_kernel<float>(int)"), (20, 40, "b_kernel"),
           (60, 70, "a_kernel"), (90, 200, "c_kernel")]
    host = [(0, 50, "train"), (50, 100, "aggregate")]
    t = harness.reduce_trace(dev, host, 0, 100)
    assert t["busy_s"] == pytest.approx((30 + 10 + 10) / 1e9)
    assert t["window_s"] == pytest.approx(100 / 1e9)
    assert t["by_name"]["a_kernel"] == (pytest.approx(30 / 1e9), 2)
    assert t["kernels"] == 4
    assert dict(t["idle_gaps"]) == pytest.approx({
        "train -> a_kernel": 10e-9 + 20e-9, "aggregate -> c_kernel": 20e-9})


@pytest.mark.parametrize("cell", ROUND)
def test_checked_rounds_reach_the_limits(cell):
    import time
    from bench.entries import round as rnd
    h = harness.Harness(cell, 1, 0.0, False, time.perf_counter(), "cpu")
    want = (h.traffic["checked_rounds"]
            if {"loss", "change"} & set(h.limits) else 1)
    assert rnd.checked_rounds(h) == want
