#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, all at once).
3. Checks the port on the card against the port on the CPU at the 4-layer
   test size: two resident rounds with an attacker, same seed, same
   weights (losses and the global model at rtol 1e-3 / atol 1e-4: f32
   sums in another order, compounded by two rounds of SGD).
4. Drives the main path — ``launch.train.run_fl`` with the CLI defaults
   (smollm-135m at full width and depth, 16 clients at participation 0.5,
   batch 8, sequence 64, 2 local steps, fedfa, cls) — for 2 rounds, with
   every kernel's launch count set to 0 just before and read just after;
   fails unless the losses are finite and every kernel ran.
5. Times one resident round and its aggregation alone.
6. Holds each kernel against its plain PyTorch version at the main path's
   shapes (scaled_accum within 1e-5 of the summed magnitudes; thresholds
   bit-equal; trimmed sums of squares at rtol 1e-5; histogram counts
   equal) and times the kernel, the plain version and, where one PyTorch
   call computes the same function, that call.
7. Prints the kernels line, then ``{"ok": true, "device": {...}}`` last.

Any failure exits non-zero before the last line.  Without CUDA, or without
the repository around it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_OPS_PER_S = 67e12              # H100 SXM f32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float):
    """(least time in ms, what bounds it) for moving ``nbytes`` and doing
    ``ops`` f32 operations."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def small_reference_check() -> None:
    """Two resident rounds at the 4-layer size on the card and on the CPU."""
    from repro_torch.core import flat
    from repro_torch.core.round import run_rounds
    from repro_torch.core.server import FLConfig, make_client_specs
    from repro_torch.data import partition, pipeline, synthetic
    from repro_torch.launch import train
    from repro_torch.models.model import init_params
    from repro_torch.tree import tree_map

    cfg = train.fl_config("smollm-135m", "cls", 10, full_size=False)
    specs = make_client_specs(cfg, 4, archs=train.client_arch_pool(cfg, "both"),
                              malicious_frac=0.25, seed=0)
    parts = partition.iid_partition(4, 10, seed=0)
    profiles = synthetic.make_class_profiles(10, cfg.vocab_size, seed=0)
    fl = FLConfig(local_steps=2, lr=0.05, strategy="fedfa", task="cls")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cuda", "cpu"):
        def data_fn(r, dev=dev):
            b = pipeline.round_batches_cls(
                parts, list(range(4)), 10, cfg.vocab_size, local_steps=2,
                batch=2, seq_len=16, profiles=profiles, seed=100 + r)
            return specs, {k: torch.as_tensor(v, dtype=torch.int64,
                                              device=dev) for k, v in b.items()}
        p, losses = run_rounds(tree_map(lambda t: t.to(dev), params), cfg, fl,
                               2, data_fn)
        out[dev] = (flat.flatten(flat.FlatIndex(p), p).cpu(), losses)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-3)
    np.testing.assert_allclose(out["cuda"][0].numpy(), out["cpu"][0].numpy(),
                               rtol=1e-3, atol=1e-4)
    log(f"small check: cuda losses {out['cuda'][1]} cpu {out['cpu'][1]}")


def main_path(kernels) -> dict:
    """The CLI defaults at full size for 2 rounds; returns the history."""
    from repro_torch.launch import train
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = train.run_fl("smollm-135m", 2, 16, strategy="fedfa", batch=8,
                        seq_len=64, participation=0.5, local_steps=2, lr=0.05,
                        task="cls", eval_every=5, driver="resident",
                        full_size=True, device="cuda")
    torch.cuda.synchronize()
    hist["seconds"] = time.perf_counter() - t0
    hist["launches"] = {k.symbol: k.launches for k in kernels}
    hist["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    check(len(hist["round_loss"]) == 2
          and bool(np.all(np.isfinite(hist["round_loss"]))),
          f"main path losses {hist['round_loss']}")
    check(all(n > 0 for n in hist["launches"].values()),
          f"a kernel of the main path never ran: {hist['launches']}")
    return hist


def round_timing() -> dict:
    """Local training and aggregation of one full-size resident round."""
    from repro_torch.launch import profile
    r = profile.full_round(8, device="cuda")
    return {"n_params": r["index"].n, "m": 8, **profile.breakdown(r)}


def main_path_shapes(m: int):
    """(N, single-pass row shapes, multilevel row shapes) of the main path:
    each leaf's rows (m·lead, rest), split by the JAX dispatch rule."""
    from repro_torch.kernels.fedfa_quantile.ops import _LANES, _SINGLE_PASS_ELEMS
    from repro_torch.launch import train
    from repro_torch.models.transformer import _is_shape, param_shapes
    from repro_torch.tree import leaves_with_path
    cfg = train.fl_config("smollm-135m", "cls", 10, full_size=True)
    leaves = list(leaves_with_path(param_shapes(cfg), is_leaf=_is_shape))
    n = sum(int(np.prod(s)) for _, s in leaves)
    rows = {(m * s[0], int(np.prod(s[1:]))) if path[0] == "stages"
            else (m, int(np.prod(s))) for path, s in leaves}
    single = sorted((r for r in rows
                     if -(-r[1] // _LANES) * _LANES <= _SINGLE_PASS_ELEMS),
                    key=lambda r: r[0] * r[1])
    multi = sorted((r for r in rows if r not in single),
                   key=lambda r: r[0] * r[1])
    return n, single, multi


def kernel_checks(launches: dict) -> list:
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.kernels.fedfa_agg import ops as agg_ops
    from repro_torch.kernels.fedfa_agg import ref as agg_ref
    from repro_torch.kernels.fedfa_quantile import multilevel, ops, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    out = []

    # scaled_accum: the (m, N) cohort of smollm-135m, m = 8 clients
    m = 8
    n, single, multi = main_path_shapes(m)
    x = randn(m, n)
    w = torch.rand(m, generator=gen, device="cuda") * 150 + 100
    mask = torch.ones(n, device="cuda")
    got = agg_ops.scaled_accum(x, w, mask)
    want = agg_ref.scaled_accum_ref(x, w, mask)
    mag = agg_ref.scaled_accum_ref(x.abs(), w.abs(), mask)
    err = (got - want).abs()
    check(bool((err <= 1e-5 * mag).all()), "scaled_accum disagrees")
    b, by = bound((m * n + m + 2 * n) * 4, 2 * m * n + n)
    out.append({
        "name": "scaled_accum", "route": "cuda",
        "source": "src/repro_torch/csrc/scaled_accum.cu",
        "replaces": "src/repro/kernels/fedfa_agg/kernel.py:71",
        "launches": launches["scaled_accum"], "max_abs_err": float(err.max()),
        "ms": time_ms(lambda: agg_ops.scaled_accum(x, w, mask), 10),
        "plain_ms": time_ms(lambda: agg_ref.scaled_accum_ref(x, w, mask), 5),
        "bound_ms": b, "bound_by": by,
        "library_ms": time_ms(lambda: torch.mv(x.t(), w) * mask, 5)})
    del x, got, want, mag, err

    # quantile_fused: every single-pass row shape of the main path (the
    # norms, wk/wv) and an odd length; timed at the largest
    qerr = 0.0
    for R, L in single + [(16, 4099)]:
        rows = randn(R, L)
        q = 1.0 - 0.05 * torch.rand(R, generator=gen, device="cuda")
        t, ss = ops.quantile_fused(rows, q)
        pt, pss = ref.row_trimmed_stats_ref(rows, q)
        check(torch.equal(t.view(torch.int32), pt.view(torch.int32)),
              f"quantile_fused thresholds differ at {(R, L)}")
        torch.testing.assert_close(ss, pss, rtol=1e-5, atol=0)
        qerr = max(qerr, float((ss - pss).abs().max()))
    R, L = single[-1]
    rows = randn(R, L)
    q = 1.0 - 0.05 * torch.rand(R, generator=gen, device="cuda")
    b, by = bound((R * L + 3 * R) * 4, R * L)
    out.append({
        "name": "quantile_fused", "route": "cuda",
        "source": "src/repro_torch/csrc/quantile_fused.cu",
        "replaces": "src/repro/kernels/fedfa_quantile/kernel.py:85",
        "launches": launches["quantile_fused"], "max_abs_err": qerr,
        "ms": time_ms(lambda: ops.quantile_fused(rows, q), 10),
        "plain_ms": time_ms(lambda: ref.row_trimmed_stats_ref(rows, q), 5),
        "bound_ms": b, "bound_by": by, "library_ms": None})
    del rows

    # hist_level: every multilevel row shape of the main path (wq/wo, the
    # FFN, the embedding), S = 1, at the top level; and the whole multilevel
    # quantile on the kernel against the sorting plain version.  Timed at
    # the largest shape.
    herr = 0.0
    for R, L in multi:
        x = randn(R, L)
        seg = torch.zeros(L, dtype=torch.int32, device="cuda")
        hi = torch.zeros((R, 2, 1), dtype=torch.int32, device="cuda")
        cnt, sq = multilevel.hist_level(x, seg, hi, 24)
        pcnt, psq = ref.hist_level_ref(x, seg, hi, 24)
        check(torch.equal(cnt, pcnt), f"hist_level counts differ at {(R, L)}")
        torch.testing.assert_close(sq, psq, rtol=1e-5, atol=1e-6)
        herr = max(herr, float((sq - psq).abs().max()))
        q = 1.0 - 0.05 * torch.rand(R, generator=gen, device="cuda")
        t, ss = multilevel.row_trimmed_stats_multilevel(x, q)
        pt, pss = ref.row_trimmed_stats_ref(x, q)
        check(torch.equal(t.view(torch.int32), pt.view(torch.int32)),
              f"multilevel thresholds differ at {(R, L)}")
        torch.testing.assert_close(ss, pss, rtol=1e-5, atol=0)
        del x, pcnt, psq, pt, pss
    R, L = multi[-1]
    x = randn(R, L)
    seg = torch.zeros(L, dtype=torch.int32, device="cuda")
    hi = torch.zeros((R, 2, 1), dtype=torch.int32, device="cuda")
    b, by = bound((R * L + L + R * 2) * 4 + R * 2 * 256 * 8, R * L)
    out.append({
        "name": "hist_level", "route": "cuda",
        "source": "src/repro_torch/csrc/hist_level.cu",
        "replaces": "src/repro/kernels/fedfa_quantile/multilevel.py:107",
        "launches": launches["hist_level"], "max_abs_err": herr,
        "ms": time_ms(lambda: multilevel.hist_level(x, seg, hi, 24), 10),
        "plain_ms": time_ms(lambda: ref.hist_level_ref(x, seg, hi, 24), 3),
        "bound_ms": b, "bound_by": by, "library_ms": None})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        log("chip_smoke: src/repro_torch not found beside the script")
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.fedfa_agg.ops import SCALED_ACCUM
    from repro_torch.kernels.fedfa_quantile.multilevel import HIST_LEVEL
    from repro_torch.kernels.fedfa_quantile.ops import QUANTILE_FUSED

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    kernels = [SCALED_ACCUM, QUANTILE_FUSED, HIST_LEVEL]
    t0 = time.perf_counter()
    build.build_all(kernels)
    log(f"built {len(kernels)} kernels in {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        log(k.library.with_suffix(".log").read_text().strip()
            if k.library.with_suffix(".log").exists() else k.library.name)

    small_reference_check()
    hist = main_path(kernels)
    print(json.dumps({"main_path": {
        k: hist[k] for k in ("round_loss", "global_acc", "local_acc",
                             "launches", "seconds", "peak_gib")}}), flush=True)
    timing = round_timing()
    print(json.dumps({"round": timing, "card": card}), flush=True)
    print(json.dumps({"kernels": kernel_checks(hist["launches"])}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
