"""The program's recording in traced runs (``bench/program_trace.py``):
idle gaps named by the innermost program span, kernels counted inside
spans, every metric of ``METRICS`` reported by a small traced run, and on
the card, the shared clock of host stamps and device timestamps."""
import time

import pytest

from bench import harness
from bench import program_trace as pt
from conftest import run_small, small_cell

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def test_gaps_take_the_innermost_program_span():
    # device kernels at [0, 10), [20, 30), [50, 60), [80, 90) of [0, 110)
    dev = [(0, 10, "void k1<float>(int)"), (20, 30, "k2"), (50, 60, "k3"),
           (80, 90, "k4")]
    program = [(5, 45, "aggregate", 0), (15, 40, "aggregate/norms", 1),
               (16, 22, "aggregate/norms/multilevel", 2)]
    outside = [(0, 70, "admit")]
    gaps = dict(pt.name_gaps(dev, program, outside, 0, 110))
    assert gaps == {"aggregate -> k2": 10e-9,           # at 10: aggregate
                    "aggregate/norms -> k3": 20e-9,      # at 30: its child
                    "admit -> k4": 20e-9,                # at 60: outside
                    "outside spans -> end": 20e-9}       # at 90: neither
    # the same gaps, and as much idle time, as the harness finds
    base = harness.reduce_trace(dev, outside, 0, 110)
    assert sum(t for _, t in base["idle_gaps"]) == pytest.approx(
        sum(gaps.values()))


def test_kernels_are_counted_inside_spans():
    dev = [(0, 1, "a"), (5, 6, "Memcpy DtoD"), (7, 8, "b"), (12, 13, "c")]
    got = pt.kernels_within(dev, [(0, 10, "x"), (10, 20, "x"),
                                  (6, 13, "y")])
    assert got == {"x": 3, "y": 2}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_small_run_reports_the_program_metrics(cell, monkeypatch):
    monkeypatch.setattr(harness, "Harness", pt.ProgramHarness)
    monkeypatch.setattr(harness, "benchmark", pt.benchmark)
    out = run_small(cell, trace=1, seconds=3.0)
    assert out["correct"], out["checks"]
    mine = {m["name"] for m in pt.METRICS if cell in m["workloads"]}
    # no device on the CPU: the trace's readers give nothing, never 0
    on_cpu = {m["name"] for m in pt.METRICS if m["source"] != "device_trace"}
    assert mine & on_cpu <= set(out["metrics"])
    assert not (mine - on_cpu) & set(out["metrics"])
    for name in mine & on_cpu:
        assert out["metrics"][name]["value"] > 0, name
    if cell.endswith(".round"):
        (syncs,) = [n for n in mine if n.startswith("host_syncs")]
        # one ``bool(mal[i])`` a client
        assert out["metrics"][syncs]["value"] == small_cell(cell)[1]["cohort"]
    # the program's spans add to what a run reports, and change nothing of it
    base = {m["name"] for m in harness.cell_metrics(
        harness.benchmark(), cell, "per_layer")}
    assert set(out["metrics"]) - mine <= base


def test_untraced_run_starts_no_recording(monkeypatch):
    from repro_torch import tracing
    monkeypatch.setattr(harness, "Harness", pt.ProgramHarness)
    started = []
    monkeypatch.setattr(tracing, "start", lambda d: started.append(d))
    out = run_small(CELLS[-1], trace=0)
    assert out["correct"] and not started


@pytest.mark.card
def test_host_stamps_fall_on_the_device_timeline(card):
    """A marker and then three launches 100 ms apart, each after a
    synchronize and a host stamp, as the stretch's marker is launched.
    Mapped as ``ProgramHarness`` maps host time (the marker's start + the
    time since its stamp), each kernel starts within 50 µs of its stamp.
    The marker's own launch latency is the map's zero, so a launch quicker
    than the marker's starts a little before its mapped stamp."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    stamps = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)                  # warm the launch path
        for _ in range(4):
            time.sleep(0.1)
            torch.cuda.synchronize()
            stamps.append(time.perf_counter_ns())
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    _, marks = pt.device_events(prof)
    starts = sorted(a for a, _, _ in marks)[1:]
    assert len(starts) == 4
    offsets = [(s - starts[0]) - (t - stamps[0])
               for s, t in zip(starts[1:], stamps[1:])]
    print("clock offsets (us):", [o / 1e3 for o in offsets])
    assert all(abs(o) <= 50_000 for o in offsets), offsets


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_traced_small_run_on_the_card(card, cell, monkeypatch):
    monkeypatch.setattr(harness, "Harness", pt.ProgramHarness)
    monkeypatch.setattr(harness, "benchmark", pt.benchmark)
    out = run_small(cell, trace=1, seconds=3.0, device="cuda")
    assert out["correct"], out["checks"]
    mine = {m["name"] for m in pt.METRICS if cell in m["workloads"]}
    assert mine <= set(out["metrics"])
