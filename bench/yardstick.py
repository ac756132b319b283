"""The benchmark's yardstick: the card's peaks, the work a cell requires
(the FLOPs of each client's sub-model, the bytes a merge must move, and
each kernel's work from its own file, ``bench/kernels/<kernel>.py``), the
least time that work can take, and the spread of a set of runs.  It
counts required work, not what the program happens to do: a program that
does less reads as a higher share of the peak, never as one above
100 %."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import statistics
from pathlib import Path
from typing import Iterable, Sequence, Tuple

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
# Sub-model FLOPs (a copy of the port's analytic model, launch/costs.py)
# ---------------------------------------------------------------------------

def _attn_block_flops(cfg: ModelConfig, B, S) -> float:
    D, hd, H, K = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    proj = 2 * B * S * D * (H + 2 * K) * hd + 2 * B * S * H * hd * D
    attn = 2 * 2 * B * S * (S / 2) * H * hd
    ffn = 2 * 3 * B * S * D * cfg.d_ff
    return proj + attn + ffn


def _ssd_block_flops(cfg: ModelConfig, B, S) -> float:
    s, D = cfg.ssm, cfg.d_model
    di = s.d_inner(D)
    nh, hp, N, Q = s.n_heads(D), s.head_dim, s.d_state, s.chunk
    proj = 2 * B * S * D * (2 * di + 2 * N + nh)
    conv = 2 * B * S * (di + 2 * N) * s.d_conv
    nc = max(S // Q, 1)
    intra = B * nc * nh * (2 * Q * Q * N + 2 * Q * Q * hp + 2 * Q * N * hp)
    inter = B * nc * nh * 2 * Q * N * hp
    return proj + conv + intra + inter + 2 * B * S * di * D


def train_step_flops(cfg: ModelConfig, B: int, S: int) -> float:
    """Forward and backward (3x the forward) of one batch of B x S."""
    f = 0.0
    for unit, reps in cfg.stages():
        for kind in unit:
            f += reps * (_ssd_block_flops(cfg, B, S) if kind == "ssd"
                         else _attn_block_flops(cfg, B, S))
    f += 2 * B * S * cfg.d_model * cfg.padded_vocab
    return 3.0 * f


def client_step_flops(cfg: ModelConfig, width: float, depths,
                      B: int, S: int) -> float:
    """One local step of a client's sub-model: its widths (``masks``'s
    active sizes) and its depth, sum(depths) blocks."""
    from bench.reference.masks import width_sizes
    w = width_sizes(cfg, width)
    sub = dataclasses.replace(
        cfg, d_model=w["d_model"], n_heads=max(w["heads"], 1),
        n_kv_heads=max(w["kv_heads"], 1), d_ff=max(w["d_ff"], 1),
        n_layers=max(int(sum(depths) * len(cfg.layer_pattern)), 1))
    return train_step_flops(sub, B, S)


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
