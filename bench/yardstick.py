"""The benchmark's yardstick: the card's peaks, the work a cell requires
(the FLOPs of each client's sub-model, the bytes a merge must move, and
each kernel's work from its own file, ``bench/kernels/<kernel>.py``), the
least time that work can take, and the spread of a set of runs.  It
counts required work, not what the program happens to do: a program that
does less reads as a higher share of the peak, never as one above
100 %."""
from __future__ import annotations

import importlib.util
import json
import statistics
from pathlib import Path
from typing import Iterable, Sequence, Tuple

from bench.reference import blocks
from bench.reference import masks as mk
from bench.reference.config import ModelConfig

BENCH = Path(__file__).resolve().parent
PEAKS = json.loads((BENCH / "peaks.json").read_text())
_SPECS: dict = {}


def load_file(path: Path, name: str):
    """Import one file of ``bench/`` by its path, as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def least_ms(nbytes: float, flops: float, flops_per_s: float) -> float:
    """The least time (ms) to move ``nbytes`` through HBM and do ``flops``
    operations at ``flops_per_s``: the larger of the two bounds."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"], flops / flops_per_s) * 1e3


# ---------------------------------------------------------------------------
# Sub-model FLOPs (the port's analytic model, launch/costs.py, per block)
# ---------------------------------------------------------------------------

def client_step_flops(cfg: ModelConfig, width: float, depths,
                      B: int, S: int) -> float:
    """Forward and backward (3x the forward) of one local step of a
    client's sub-model on a batch of B x S: each block at the client's
    active sizes (``masks.width_sizes``), sum(depths) repeats of the first
    stage and every repeat of a later one, and the head."""
    sizes = mk.width_sizes(cfg, width)
    f = 0.0
    for i, (unit, reps) in enumerate(cfg.stages()):
        for kind in unit:
            f += ((reps if i else sum(depths))
                  * blocks.of(cfg, kind).flops(cfg, sizes, B, S))
    f += 2 * B * S * sizes["d_model"] * cfg.padded_vocab
    return 3.0 * f


# ---------------------------------------------------------------------------
# Required bytes
# ---------------------------------------------------------------------------

ITEMSIZE = {"f32": 4, "bf16": 2, "int8": 1}


def merge_bytes(n: int, m: int, update_dtype: str, n_segments: int) -> float:
    """What one merge must move: the f32 cohort read once, and the global
    read and written; with quantized admission also the error-feedback
    state (rows and scales) read and written."""
    b = m * n * 4 + 2 * n * 4
    if update_dtype != "f32":
        b += 2 * (m * n * ITEMSIZE[update_dtype] + m * n_segments * 4)
    return b


def kernel_spec(kernel: str):
    """The yardstick of one kernel, ``bench/kernels/<kernel>.py`` (named as
    its C entry point): ``DEVICE_NAMES``, the prefixes of its device
    functions' names in a trace; ``required(shape, dtype)``, the (bytes,
    operations) a launch at ``shape`` (the wrapper's ``by_shape`` key)
    must move and do; and optionally ``PEAK``, the key in ``peaks.json``
    of the rate its operations run at (f32 by default)."""
    if kernel not in _SPECS:
        path = BENCH / "kernels" / f"{kernel}.py"
        if not path.is_file():
            raise ValueError(f"no yardstick for kernel {kernel!r}: "
                             f"add bench/kernels/{kernel}.py")
        _SPECS[kernel] = load_file(path, "bench_kernel_" + kernel)
    return _SPECS[kernel]


def kernel_least_ms(kernel: str, shape: Tuple[int, ...], dtype: str) -> float:
    """The least time one launch at ``shape`` takes on the card."""
    spec = kernel_spec(kernel)
    nbytes, flops = spec.required(shape, dtype)
    return least_ms(nbytes, flops,
                    PEAKS[getattr(spec, "PEAK", "f32_flops_per_s")])


# ---------------------------------------------------------------------------
# Spread of a set of runs
# ---------------------------------------------------------------------------

def spread(values: Sequence[float]) -> float:
    """(Q3 − Q1) / median, the quartiles as ``statistics.quantiles`` gives
    them."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def median(values: Iterable[float]) -> float:
    return statistics.median(list(values))
