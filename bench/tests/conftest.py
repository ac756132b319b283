"""The benchmark's own tests: ``python -m pytest bench/tests`` from the root
of a checkout.  Tests marked ``card`` need a CUDA device and skip without
one (decided in the ``card`` fixture, never at import)."""
import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

HERE = Path(__file__).parent
# the entries' small sizes; each family's model sizes in small/<family>.json
SMALL = json.loads((HERE / "small.json").read_text())


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def small_cell(cell: str):
    """(config, traffic) of ``cell`` at the tests' small size: the widths
    and depths of ``small/<family>.json``, the cohort and batch of
    ``small.json``, the traffic's other parameters kept."""
    from bench import harness
    c = harness.load("workloads", cell)
    config = copy.deepcopy(harness.load("configs", c["config"]))
    family = config["model"]["family"]
    config["model"].update(json.loads(
        (HERE / "small" / f"{family}.json").read_text()))
    traffic = copy.deepcopy(harness.load("traffic", c["traffic"]))
    traffic["population"]["clients"] = SMALL["clients"]
    traffic.update(SMALL[traffic["entry"]])
    return config, traffic


def run_small(cell: str, seed: int = 3_000_000_007, trace: int = 0,
              seconds: float = 0.5, device: str = "cpu"):
    import time
    from bench import run as bench_run
    config, traffic = small_cell(cell)
    args = bench_run.parse(["--workload", cell, "--seed", str(seed),
                            "--seconds", str(seconds), "--trace", str(trace)])
    return bench_run.run(args, device=device, config=config, traffic=traffic,
                         t_start=time.perf_counter())
