"""On the card, at the tests' small size: every cell proves correct, and
its control (the reference in a lower precision in the program's place)
and its planted faults fail at least one of the cell's limits.  Skips
without a CUDA device."""
import time

import pytest

from bench import calibrate, harness
from conftest import run_small, small_cell

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    assert run_small(cell, device="cuda")["correct"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_a_limit(card, cell):
    config, traffic = small_cell(cell)
    h = harness.Harness(cell, 3_000_000_011, 0.0, False, time.perf_counter(),
                        "cuda", config, traffic)
    readings = (calibrate.round_readings(h, ("control", "half_batch"))
                if traffic["entry"] == "round" else
                calibrate.merge_readings(h, ("control", "half_cohort",
                                             "unchanged")))
    for variant, got in readings:
        assert any(got[k] > lim for k, lim in h.limits.items()), \
            (variant, got)
