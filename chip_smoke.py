#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, all at once).
3. Checks the port on the card against the port on the CPU at the 4-layer
   test size: two resident rounds with an attacker, same seed, same
   weights (losses and the global model at rtol 1e-3 / atol 1e-4: f32
   sums in another order, compounded by two rounds of SGD).  Then two
   quantized resident rounds each for int8 and bf16, each round started
   on the card from the CPU's global and quantized state, at the round
   test's tolerance (losses rtol 1e-4; the global within rtol 1e-4 /
   atol 1e-5 but at most 1e-4·N elements, each within one admission step
   of its segment, and relative L2 within 1e-4).
4. Drives the main path — ``launch.train.run_fl`` with the CLI defaults
   (smollm-135m at full width and depth, 16 clients at participation 0.5,
   batch 8, sequence 64, 2 local steps, fedfa, cls) — for 2 rounds, with
   every kernel's launch count set to 0 just before and read just after;
   fails unless the losses are finite and every kernel of the path ran.
   Then the same with ``--update-dtype int8`` and with ``bf16``, each its
   own path with its own counts.
   Then the async driver: the card-vs-CPU check at the 4-layer size (the
   skewed trace of the async tests: the last client of each cohort
   arrives after 40, the others after 1 + (i mod 3); capacity 4, merge_k
   2, staleness_max 1, one attacker, 4 merges), the schedule (weights,
   simulated times, merged and dropped rows) equal exactly, at f32 the
   losses and the global after every merge at rtol 1e-3 / atol 1e-4, at
   int8 each card merge started from the CPU's global and pool and held to
   the flip allowance; and parity mode on the card, bit-equal to the
   card's ``run_rounds`` (f32 and int8).  Then ``run_fl(driver="async")``
   at the CLI defaults and full size for 4 merges (capacity 8, merge_k 4)
   at f32 and int8, counts reset before each: fails unless the losses are
   finite and each kernel ran exactly its launches per merge; times one
   merge alone (CUDA events) and one admission of 4 clients.  The f32 run
   writes its checkpoints into a temporary directory: the last one,
   restored onto the card, equals the final global; one saved from the
   card restores bit-equal on the CPU; saving and restoring the full model
   are timed.
5. Times one resident round and its aggregation alone, at f32 and int8.
6. Drives ``trimmed_norm`` (the entry point of ``trimmed_sumsq``) once on
   the full-size global, counts reset just before it.
7. Serving: ``launch.serve``'s Engine on the card against the same
   Engine on the CPU at the reduced sizes (mamba2-130m ``reduced()`` and
   the 4-layer smollm-135m), same weights, greedy, prompt 48 (an SSD chunk
   of 32 and a ragged tail), 8 new tokens: tokens equal; with an f32 cache
   the prefill and decode logits within rtol 1e-3 / atol 1e-4, with the
   default bf16 cache within one bf16 step (2^-8) of the largest real
   logit, vocabulary padding aside (a stored value that the two devices' f32 sums put on either side of a
   bf16 rounding boundary moves by one step).
   Then the long prompt: the 4-layer smollm-135m with 2 prompts of 2,100
   tokens (2100² > 2048², so prefill takes blocked attention) and 8 new
   tokens, the card through the ``flash_attention`` kernel (exactly once
   per layer) and the CPU through ``attend_blocked``, at the same
   tolerances.
8. Drives the serving path at full size: ``launch.serve`` with
   ``--arch mamba2-130m --full-size --batch 8 --prompt-len 1024
   --max-new 32`` (counts reset just before; fails unless
   ``ssd_intra_chunk`` ran exactly once per layer, 24 times, no other
   kernel ran, and every token is in the vocabulary), then smollm-135m at
   the serve defaults (batch 8, prompt 32, 32 new tokens; no kernel
   launches), then smollm-135m with a long prompt (batch 8, prompt 4096,
   32 new tokens: ``flash_attention`` exactly once per layer, 30 times,
   and nothing else); prints prefill ms, decode ms per token, tokens/s and
   peak memory of each run and of a second, warm run of the same engine.
9. Holds each kernel against its plain PyTorch version at the main path's
   shapes (weighted sums within 1e-5 of the summed magnitudes; thresholds
   bit-equal; trimmed sums of squares at rtol 1e-5; the SSD's y and state
   within atol 1e-4 + rtol 1e-4 and its L bit-equal; attention within
   2e-5 at f32 and 5e-2 at bf16, the JAX package's kernel tolerances),
   f32 and the quantized or bf16 variants, ``quantile_fused`` also on the
   CPU tests' adversarial rows (ties, all-zero rows, q at 0 and 1, L = 1,
   2, 4099 and the longest single-pass row, 2^18) and on the rows each
   main path's first round passed it (captured in that run; timed there
   at every cluster size, with the rows that overflow CTA 0 counted),
   each call twice with the same bits, and ``trimmed_sumsq``
   also against ``quantile_fused``'s Σx² at that kernel's thresholds;
   ``hist_level`` at every multilevel row shape of the main path and each
   of the four levels, with the prefixes the plain level loop finds
   (counts equal, Σx² at rtol 1e-5; at the second level also with the two
   planes' prefixes differing), and its per-round total (the launches
   beside each shape are the wrappers' counts by shape on the main path);
   ``flash_attention`` also against the 3xTF32 emulation of its f32 route
   (within 1e-5), at the JAX package's sweep of shapes and masks and on a
   ragged shape, and refusing inputs that need a gradient; times the
   kernel, the plain version and, where one PyTorch call computes the same
   function, that call.
10. Prints the kernels line, then ``{"ok": true, "device": {...}}`` last.

Any failure exits non-zero before the last line.  Without CUDA, or without
the repository around it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_OPS_PER_S = 67e12              # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12            # H100 SXM TF32 tensor cores, dense
BF16_STEP = 2.0 ** -8


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


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    """(least time in ms, what bounds it) for moving ``nbytes`` and doing
    ``ops`` operations at ``ops_per_s`` (the f32 rate unless given)."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
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


def round_close(got, want, steps, what: str) -> None:
    """One quantized round against another from the same state: every
    element within rtol 1e-4 / atol 1e-5, except at most 1e-4·N elements,
    each within one admission step; relative L2 within 1e-4."""
    err = np.abs(got - want)
    out = ~(err <= 1e-5 + 1e-4 * np.abs(want))
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    log(f"{what}: {int(out.sum())} of {got.size} elements past rtol 1e-4 / "
        f"atol 1e-5, largest {float(err.max()):.3g}, relative L2 {rel:.3g}")
    check(out.sum() <= 1e-4 * got.size and bool((err[out] <= steps[out]).all())
          and rel <= 1e-4, f"{what} differs past the flip allowance")


def small_quantized_check(update_dtype: str) -> None:
    """Two quantized resident rounds at the 4-layer size on the card and on
    the CPU, each card round started from the CPU's global and state."""
    from repro_torch.core import flat
    from repro_torch.core.round import ResidentDriver, default_perms
    from repro_torch.core.server import FLConfig, make_client_specs
    from repro_torch.data import partition, pipeline, synthetic
    from repro_torch.launch import train
    from repro_torch.models.model import init_params

    cfg = train.fl_config("smollm-135m", "cls", 10, full_size=False)
    specs = make_client_specs(cfg, 4, archs=train.client_arch_pool(cfg, "both"),
                              malicious_frac=0.25, seed=0)
    parts = partition.iid_partition(4, 10, seed=0)
    profiles = synthetic.make_class_profiles(10, cfg.vocab_size, seed=0)
    fl = FLConfig(local_steps=2, lr=0.05, strategy="fedfa", task="cls",
                  update_dtype=update_dtype)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    index = flat.FlatIndex(params)
    drivers = {d: ResidentDriver(cfg, fl, index, d) for d in ("cuda", "cpu")}
    g = {d: flat.flatten(index, params).to(d) for d in drivers}
    perms = {d: default_perms(0) for d in drivers}
    for r in range(2):
        b = pipeline.round_batches_cls(
            parts, list(range(4)), 10, cfg.vocab_size, local_steps=2,
            batch=2, seq_len=16, profiles=profiles, seed=100 + r)
        if r:
            g["cuda"].copy_(g["cpu"])
            for t, c in zip(drivers["cuda"].pool(4)[1],
                            drivers["cpu"].pool(4)[1]):
                t.copy_(c)
        loss = {}
        for d, drv in drivers.items():
            batches = {k: torch.as_tensor(v, dtype=torch.int64, device=d)
                       for k, v in b.items()}
            pm = perms[d](r, 4, batches["labels"][0].numel()).to(d)
            loss[d] = float(drv.round(g[d], specs, batches, pm))
        np.testing.assert_allclose(loss["cuda"], loss["cpu"], rtol=1e-4)
        want = g["cpu"].numpy()
        row_of = torch.as_tensor(index.row_of).long()
        if update_dtype == "int8":
            steps = drivers["cpu"].pool(4)[1][1].amax(0)[row_of]
        else:   # one bf16 ulp at the segment's largest magnitude
            seg_max = torch.zeros(index.n_segments).scatter_reduce(
                0, row_of, g["cpu"].abs(), "amax")
            steps = (2.0 ** (torch.floor(torch.log2(seg_max)) - 7))[row_of]
        round_close(g["cuda"].cpu().numpy(), want, steps.numpy(),
                    f"small {update_dtype} check, round {r}")
        log(f"small {update_dtype} check round {r}: losses {loss}")


ASYNC_SKEW = dict(capacity=4, merge_k=2, staleness_max=1)


def _async_cohort(dev: str):
    """The async tests' 4-layer cohort (seed 5: 4 clients, the attacker is
    client 2) and its data_fn on ``dev``."""
    from repro_torch.core.server import make_client_specs
    from repro_torch.data import partition, pipeline, synthetic
    from repro_torch.launch import train
    cfg = train.fl_config("smollm-135m", "cls", 10, full_size=False)
    specs = make_client_specs(cfg, 4, archs=train.client_arch_pool(cfg, "width"),
                              malicious_frac=0.25, seed=5)
    parts = partition.iid_partition(4, 10, seed=5)
    profiles = synthetic.make_class_profiles(10, cfg.vocab_size, seed=5)

    def data_fn(r):
        b = pipeline.round_batches_cls(
            parts, list(range(4)), 10, cfg.vocab_size, local_steps=2,
            batch=2, seq_len=8, profiles=profiles, seed=100 + r)
        return specs, {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
                       for k, v in b.items()}
    return cfg, specs, data_fn


def small_async_check() -> dict:
    """The async engine at the 4-layer size on the card and on the CPU, same
    weights, over the skewed trace (the last client of each cohort arrives
    after 40, the others after 1 + (i mod 3)) for 4 merges: the schedule
    (weights, simulated times, merged and dropped rows) equal exactly; at
    f32 the losses and the global after every merge at rtol 1e-3 / atol
    1e-4; at int8 each card merge starts from the CPU's global and pool,
    losses at rtol 1e-4 and the global within the flip allowance.  Then
    parity mode on the card, bit-equal to the card's ``run_rounds``."""
    from repro_torch.core import flat
    from repro_torch.core.async_round import (AsyncConfig, AsyncEngine,
                                              run_async)
    from repro_torch.core.round import run_rounds
    from repro_torch.core.server import FLConfig
    from repro_torch.models.model import init_params
    from repro_torch.sim import ParitySource, TraceSource
    from repro_torch.tree import tree_map

    cfg = _async_cohort("cpu")[0]
    params = init_params(cfg, torch.Generator().manual_seed(0))
    index = flat.FlatIndex(params)
    lat = lambda i: 40.0 if i % 4 == 3 else 1.0 + (i % 3)
    out = {}
    for dtype in ("f32", "int8"):
        fl = FLConfig(local_steps=2, lr=0.05, strategy="fedfa", task="cls",
                      update_dtype=dtype)
        runs = {}
        for dev in ("cpu", "cuda"):
            _, specs, data_fn = _async_cohort(dev)
            rec, sched = [], []
            eng = AsyncEngine(flat.flatten(index, params).to(dev), cfg, fl,
                              index, TraceSource(data_fn, lat),
                              acfg=AsyncConfig(**ASYNC_SKEW),
                              on_merge=rec.append)
            while eng.merges < 4:
                if eng.step() is None:
                    continue
                m = eng.merges - 1
                sched.append((eng.now, eng.merged_rows, eng.dropped_rows))
                if dtype == "f32":
                    continue
                if dev == "cpu":
                    rec[m]["state"] = [t.clone() for t in eng._c_buf]
                else:                  # the CPU's global and pool
                    eng.g_buf.copy_(torch.from_numpy(runs["cpu"][0][m][
                        "g_after"]))
                    for t, c in zip(eng._c_buf, runs["cpu"][0][m]["state"]):
                        t.copy_(c)
            runs[dev] = (rec, sched)
        (rec, sched), (want, want_sched) = runs["cuda"], runs["cpu"]
        check(sched == want_sched, f"async {dtype}: card schedule {sched} "
              f"!= cpu {want_sched}")
        for m, (got, ref) in enumerate(zip(rec, want)):
            check(np.array_equal(got["w"], ref["w"]),
                  f"async {dtype} merge {m}: weights {got['w']} != "
                  f"{ref['w']}")
            if dtype == "f32":
                np.testing.assert_allclose(got["loss"], ref["loss"],
                                           rtol=1e-3)
                np.testing.assert_allclose(got["g_after"], ref["g_after"],
                                           rtol=1e-3, atol=1e-4)
            else:
                np.testing.assert_allclose(got["loss"], ref["loss"],
                                           rtol=1e-4)
                steps = ref["state"][1].amax(0)[torch.as_tensor(
                    index.row_of).long()]
                round_close(got["g_after"], ref["g_after"], steps.numpy(),
                            f"small async {dtype} check, merge {m}")
        check(any(r["w"][2] > 0 for r in rec), "the attacker never merged")
        out[dtype] = {"schedule": sched,
                      "weights": [r["w"].tolist() for r in rec],
                      "loss": [r["loss"] for r in rec]}
        log(f"small async {dtype} check: schedule {sched}, losses "
            f"{out[dtype]['loss']}")
        # parity mode on the card against the card's resident rounds
        _, _, data_fn = _async_cohort("cuda")
        on_card = lambda: tree_map(lambda t: t.to("cuda"), params)
        p_sync, l_sync = run_rounds(on_card(), cfg, fl, 2, data_fn,
                                    eval_every=0)
        p_async, l_async = run_async(on_card(), cfg, fl, 2,
                                     ParitySource(data_fn),
                                     acfg=AsyncConfig.parity(4), eval_every=0)
        check(l_sync == l_async and torch.equal(
            flat.flatten(index, p_sync), flat.flatten(index, p_async)),
            f"async {dtype} parity mode differs from run_rounds on the card: "
            f"losses {l_async} vs {l_sync}")
        out[dtype]["parity_losses"] = l_async
    return out


ASYNC_PER_MERGE = {"f32": {"scaled_accum": 2, "quantile_fused": 5,
                           "hist_level": 24},
                   "int8": {"scaled_accum": 1, "quant_accum": 1,
                            "quantile_fused": 5, "hist_level": 24}}


def async_path(kernels, update_dtype: str, ckpt=None) -> dict:
    """``run_fl(driver="async")`` at the CLI defaults and full size for 4
    merges (capacity 8, merge_k 4, staleness_max 4), every launch count
    reset just before: fails unless the losses are finite and each kernel
    of the path ran exactly its launches per merge (the resident round's at
    m = 8; free slots go through the kernels with weight 0).  Then, on the
    engine the run left: one merge alone (CUDA events) and one admission of
    4 clients (host clock).  Returns the history and the engine."""
    from repro_torch.core import async_round
    from repro_torch.launch import train

    engines, cls = [], async_round.AsyncEngine

    class Recorded(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    for k in kernels:
        k.reset()
    torch.cuda.reset_peak_memory_stats()
    async_round.AsyncEngine = Recorded
    t0 = time.perf_counter()
    try:
        hist = train.run_fl("smollm-135m", 4, 16, strategy="fedfa", batch=8,
                            seq_len=64, participation=0.5, local_steps=2,
                            lr=0.05, task="cls", eval_every=5,
                            driver="async", update_dtype=update_dtype,
                            ckpt=ckpt, full_size=True, device="cuda")
        torch.cuda.synchronize()
    finally:
        async_round.AsyncEngine = cls
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {k.symbol: k.launches for k in kernels}
    by_shape = {k.symbol: dict(k.by_shape) for k in kernels}
    (eng,) = engines
    check(len(hist["round_loss"]) == 4
          and bool(np.all(np.isfinite(hist["round_loss"]))),
          f"async {update_dtype} path losses {hist['round_loss']}")
    want = {k.symbol: 4 * ASYNC_PER_MERGE[update_dtype].get(k.symbol, 0)
            for k in kernels}
    check(launches == want, f"async {update_dtype} path launches {launches}, "
          f"expected {want} (4 merges)")

    # one merge alone, over the pool the run left, all rows weighted
    specs = [s or eng._pad_spec for s in eng.pool.specs]
    w = np.full(eng.rows, 150.0, np.float32)
    merge_ms = time_ms(lambda: eng.aggregate(w, specs), 3, warmup=1)
    # one admission of 4 clients into slots 0-3 (the global is unchanged)
    g_before = eng.g_buf.clone()
    res, t = None, eng.now
    while not res or not len(res[0]):    # the next clients available
        res, t = eng.source(eng.dispatch_idx, t, 4), t + 1.0
    specs, batches, _ = res
    eng._pending = (np.arange(len(specs)), specs, batches, eng.dispatch_idx)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng._materialize()
    torch.cuda.synchronize()
    admit_ms = (time.perf_counter() - t1) * 1e3
    check(torch.equal(g_before, eng.g_buf), "admission moved the global")
    return {"update_dtype": update_dtype, "round_loss": hist["round_loss"],
            "global_acc": hist["global_acc"], "launches": launches,
            "launches_per_merge": {k: v / 4 for k, v in launches.items()},
            "launches_by_shape": {
                sym: [[list(shape), n] for shape, n in c.items()]
                for sym, c in by_shape.items() if c},
            "merged_rows": eng.merged_rows, "dropped_rows": eng.dropped_rows,
            "dispatches": eng.dispatch_idx, "sim_time": eng.now,
            "seconds": seconds, "ms_per_merge": seconds * 1e3 / 4,
            "merge_ms": merge_ms, "admit_ms": admit_ms,
            "admit_clients": len(specs), "peak_gib": peak}, eng


def checkpoint_path(eng, prefix: str) -> dict:
    """The f32 async run's last checkpoint restored onto the card equals
    its final global; a checkpoint saved from CUDA tensors restores
    bit-equal on the CPU; ``save_from_buffer`` and ``restore_to_buffer``
    of the full model timed (host clock)."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import flat
    from repro_torch.tree import tree_map
    like = flat.unflatten(eng.index, eng.g_buf)
    _, buf, meta = ckpt.restore_to_buffer(prefix + "_m00003", like)
    check(buf.device.type == "cuda" and torch.equal(buf, eng.g_buf),
          "the last async checkpoint differs from the final global")
    check(meta["merge"] == 3 and meta["flat_n"] == eng.index.n,
          f"checkpoint meta {meta}")
    t0 = time.perf_counter()
    ckpt.save_from_buffer(prefix + "_card", eng.index, eng.g_buf,
                          meta={"merge": 3})
    save_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, buf, _ = ckpt.restore_to_buffer(prefix + "_card", like)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(torch.equal(buf, eng.g_buf), "card checkpoint does not restore")
    del buf
    _, cpu_buf, _ = ckpt.restore_to_buffer(
        prefix + "_card", tree_map(lambda t: t.cpu(), like))
    check(cpu_buf.device.type == "cpu"
          and torch.equal(cpu_buf, eng.g_buf.cpu()),
          "a checkpoint saved from the card does not restore on the CPU")
    return {"n_params": eng.index.n, "bytes": eng.index.n * 4,
            "save_s": save_s, "restore_s": restore_s}


def main_path(kernels, update_dtype: str, path_kernels) -> dict:
    """The CLI defaults at full size for 2 rounds at ``update_dtype``, with
    every launch count reset just before; returns the history, with each
    kernel's launches (``launches``, and by shape where its wrapper names
    one: ``by_shape``) and copies of the arguments of the first round's
    ``quantile_fused`` calls (``quantile_calls``)."""
    from repro_torch.kernels.fedfa_quantile import ops
    from repro_torch.launch import train
    _, single, _ = main_path_shapes(8)
    calls, wrapper = [], ops.quantile_fused

    def recording(rows, q, scale=None):
        if len(calls) < sum(single.values()):
            calls.append(tuple(None if a is None else a.clone()
                               for a in (rows, q, scale)))
        return wrapper(rows, q, scale)

    for k in kernels:
        k.reset()
    torch.cuda.reset_peak_memory_stats()
    ops.quantile_fused = recording
    t0 = time.perf_counter()
    try:
        hist = train.run_fl("smollm-135m", 2, 16, strategy="fedfa", batch=8,
                            seq_len=64, participation=0.5, local_steps=2,
                            lr=0.05, task="cls", eval_every=5,
                            driver="resident", update_dtype=update_dtype,
                            full_size=True, device="cuda")
        torch.cuda.synchronize()
    finally:
        ops.quantile_fused = wrapper
    hist["seconds"] = time.perf_counter() - t0
    hist["launches"] = {k.symbol: k.launches for k in kernels}
    hist["by_shape"] = {k.symbol: dict(k.by_shape) for k in kernels}
    hist["quantile_calls"] = calls
    hist["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    check(len(hist["round_loss"]) == 2
          and bool(np.all(np.isfinite(hist["round_loss"]))),
          f"{update_dtype} main path losses {hist['round_loss']}")
    check(all(k.launches > 0 for k in path_kernels),
          f"a kernel of the {update_dtype} main path never ran: "
          f"{hist['launches']}")
    return hist


def round_timing(update_dtype: str):
    """Local training, admission and aggregation of one full-size resident
    round (CUDA events), and the round's peak memory."""
    from repro_torch.launch import profile
    r = profile.full_round(8, device="cuda", update_dtype=update_dtype)
    out = {"update_dtype": update_dtype, "n_params": r["index"].n, "m": 8,
           **profile.breakdown(r)}
    return out, r["g_buf"]


def trimmed_norm_path(kernels, g: torch.Tensor) -> dict:
    """``trimmed_norm`` of a full-size global at its 0.95-quantile, counts
    reset just before; its square is held against the multilevel Σx²."""
    from repro_torch.kernels.fedfa_agg import ops as agg_ops
    from repro_torch.kernels.fedfa_quantile import ops
    t, ss = ops.row_trimmed_stats(g[None], torch.full((1,), 0.95,
                                                      device="cuda"))
    for k in kernels:
        k.reset()
    norm = agg_ops.trimmed_norm(g, t[0])
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in kernels}
    check(launches["trimmed_sumsq"] == 1, f"trimmed_norm: {launches}")
    torch.testing.assert_close(norm * norm, ss[0], rtol=1e-5, atol=0)
    return {"norm": float(norm), "launches": launches}


def model_index():
    """The FlatIndex of full-size smollm-135m, from shapes alone."""
    from repro_torch.core import flat
    from repro_torch.launch import train
    from repro_torch.models.transformer import _is_shape, param_shapes
    from repro_torch.tree import from_paths, leaves_with_path
    cfg = train.fl_config("smollm-135m", "cls", 10, full_size=True)
    leaves = list(leaves_with_path(param_shapes(cfg), is_leaf=_is_shape))
    return flat.FlatIndex(from_paths(
        [p for p, _ in leaves],
        [torch.empty(s, device="meta") for _, s in leaves]))


def main_path_shapes(m: int):
    """(N, single-pass row shapes, multilevel row shapes) of the main path:
    each leaf's rows (m·lead, rest), split by the JAX dispatch rule; each as
    {shape: number of leaves}, smallest first."""
    from repro_torch.kernels.fedfa_quantile.ops import _LANES, _SINGLE_PASS_ELEMS
    from repro_torch.launch import train
    from repro_torch.models.transformer import _is_shape, param_shapes
    from repro_torch.tree import leaves_with_path
    cfg = train.fl_config("smollm-135m", "cls", 10, full_size=True)
    leaves = list(leaves_with_path(param_shapes(cfg), is_leaf=_is_shape))
    n = sum(int(np.prod(s)) for _, s in leaves)
    rows = [(m * s[0], int(np.prod(s[1:]))) if path[0] == "stages"
            else (m, int(np.prod(s))) for path, s in leaves]
    shapes = sorted(set(rows), key=lambda r: r[0] * r[1])
    single = {r: rows.count(r) for r in shapes
              if -(-r[1] // _LANES) * _LANES <= _SINGLE_PASS_ELEMS}
    multi = {r: rows.count(r) for r in shapes if r not in single}
    return n, single, multi


def quantized_rows(dtype: str, R: int, L: int, gen, x=None):
    """(rows, per-row scales) as the admission stores them: int8 with
    scale max|x|/127, or bf16 with scale 1, of normal rows (or of ``x``)."""
    if x is None:
        x = torch.randn((R, L), generator=gen, device="cuda")
    if dtype == "bf16":
        return x.to(torch.bfloat16), torch.ones(R, device="cuda")
    s = x.abs().amax(1) / 127.0
    s = torch.where(s > 0, s, torch.ones_like(s))   # all-zero rows
    return torch.round(x / s[:, None]).clamp(-127, 127).to(torch.int8), s


# tests/test_torch_kernels.py's adversarial rows, and the shortest and the
# longest single-pass rows: (R, L, kind, levels)
QUANTILE_ADVERSARIAL = [
    (3, 2048, "ties", "path"), (4, 4099, "ties", "ends"),
    (2, 1500, "zeros", "path"), (3, 1 << 18, "zeros", "ends"),
    (3, 1537, "normal", "ends"), (2, 1, "ties", "ends"),
    (2, 2, "normal", "ends"), (4, 1, "normal", "path"),
    (3, 1 << 18, "normal", "path"), (3, 1 << 18, "ties", "ends")]


def quantile_rows(dtype: str, kind: str, R: int, L: int, gen):
    """(rows, scales) of ``kind``: normal; ties (few distinct magnitudes,
    both signs); zeros (every magnitude 0) — f32, or quantized as the
    admission stores them."""
    if kind == "normal":
        x = torch.randn((R, L), generator=gen, device="cuda")
    elif kind == "ties":
        x = torch.randint(-4, 5, (R, L), generator=gen,
                          device="cuda").float() * 0.25
    else:
        x = torch.zeros((R, L), device="cuda")
    if dtype == "f32":
        return x, None
    return quantized_rows(dtype, R, L, gen, x)


BYTES = {"f32": 4, "int8": 1, "bf16": 2}


def kernel_checks(launches: dict, shapes: dict, quantile_calls: dict) -> list:
    """Each kernel against its plain version at the main path's shapes;
    ``launches`` holds each path's counts and ``shapes`` its counts by
    shape, by admission dtype; ``quantile_calls`` the arguments of the
    first round's ``quantile_fused`` calls on each path."""
    from repro_torch.core import flat
    from repro_torch.kernels.fedfa_agg import ops as agg_ops
    from repro_torch.kernels.fedfa_agg import ref as agg_ref
    from repro_torch.kernels.fedfa_quantile import ops, ref
    from repro_torch.launch import ablate

    gen = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    out = []

    # scaled_accum: the (m, N) cohort of smollm-135m, m = 8 clients
    m = 8
    n, single, _ = main_path_shapes(m)
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
        "name": "scaled_accum", "dtype": "f32", "route": "cuda",
        "source": "src/repro_torch/csrc/scaled_accum.cu",
        "replaces": "src/repro/kernels/fedfa_agg/kernel.py:71",
        "launches": launches["f32"]["scaled_accum"],
        "max_abs_err": float(err.max()),
        "ms": time_ms(lambda: agg_ops.scaled_accum(x, w, mask), 10),
        "plain_ms": time_ms(lambda: agg_ref.scaled_accum_ref(x, w, mask), 5),
        "bound_ms": b, "bound_by": by,
        "library_ms": time_ms(lambda: torch.mv(x.t(), w) * mask, 5)})
    # the same cohort in bf16, upcast as the kernel reads it
    xb = x.to(torch.bfloat16)
    del x, got, want, mag, err
    got = agg_ops.scaled_accum(xb, w, mask)
    want = agg_ref.scaled_accum_ref(xb, w, mask)
    mag = agg_ref.scaled_accum_ref(xb.abs(), w.abs(), mask)
    err = (got - want).abs()
    check(bool((err <= 1e-5 * mag).all()), "scaled_accum bf16 disagrees")
    b, by = bound(m * n * 2 + m * 4 + 2 * n * 4, 2 * m * n + n)
    out.append({
        "name": "scaled_accum", "dtype": "bf16", "route": "cuda",
        "source": "src/repro_torch/csrc/scaled_accum.cu",
        "replaces": "src/repro/kernels/fedfa_agg/kernel.py:71",
        "launches": launches["f32"]["scaled_accum"],
        "max_abs_err": float(err.max()),
        "ms": time_ms(lambda: agg_ops.scaled_accum(xb, w, mask), 10),
        "plain_ms": time_ms(lambda: agg_ref.scaled_accum_ref(xb, w, mask), 5),
        "bound_ms": b, "bound_by": by, "library_ms": None})
    del xb, got, want, mag, err

    # quant_accum: the quantized (m, N) cohort with the model's segment map
    # and an (m, S) weight table
    index = model_index()
    seg = flat._device_seg_id(index, "cuda")
    wtab = torch.rand((m, index.n_segments), generator=gen,
                      device="cuda") * 1e-3
    for dtype in ("int8", "bf16"):
        if dtype == "int8":
            xq = torch.randint(-127, 128, (m, n), generator=gen,
                               device="cuda", dtype=torch.int8)
        else:
            xq = randn(m, n).to(torch.bfloat16)
        got = agg_ops.quant_accum(xq, wtab, seg, mask)
        want = agg_ref.quant_accum_ref(xq, wtab, seg, mask)
        mag = agg_ref.quant_accum_ref(xq.abs(), wtab, seg, mask)
        err = (got - want).abs()
        check(bool((err <= 1e-5 * mag).all()), f"quant_accum {dtype} "
              f"disagrees")
        b, by = bound(m * n * BYTES[dtype] + 12 * n + wtab.numel() * 4,
                      2 * m * n + n)
        out.append({
            "name": "quant_accum", "dtype": dtype, "route": "cuda",
            "source": "src/repro_torch/csrc/quant_accum.cu",
            "replaces": "src/repro/kernels/fedfa_agg/kernel.py:117",
            "launches": launches[dtype]["quant_accum"],
            "max_abs_err": float(err.max()),
            "ms": time_ms(lambda: agg_ops.quant_accum(xq, wtab, seg, mask),
                          10),
            "plain_ms": time_ms(
                lambda: agg_ref.quant_accum_ref(xq, wtab, seg, mask), 3),
            "bound_ms": b, "bound_by": by, "library_ms": None})
        del xq, got, want, mag, err

    # quantile_fused: every single-pass row shape of the main path (the
    # norms, wk/wv) and an odd length, f32 and quantized, then the CPU
    # tests' adversarial rows, each call twice with the same bits; then the
    # rows the main path's first round passed it, timed call by call.  The
    # f32 rows of the largest shape feed trimmed_sumsq below.
    def quantile_check(rows, q, s, what):
        t, ss = ops.quantile_fused(rows, q, s)
        t2, ss2 = ops.quantile_fused(rows, q, s)
        pt, pss = ref.row_trimmed_stats_ref(ref.dequantize_rows(rows, s), q)
        check(torch.equal(t.view(torch.int32), pt.view(torch.int32)),
              f"{what}: thresholds differ")
        torch.testing.assert_close(ss, pss, rtol=1e-5, atol=0,
                                   msg=f"{what}: sums differ")
        check(torch.equal(t.view(torch.int32), t2.view(torch.int32))
              and torch.equal(ss.view(torch.int32), ss2.view(torch.int32)),
              f"{what}: two calls differ")
        return float((ss - pss).abs().max())

    for dtype in ("f32", "int8", "bf16"):
        qerr = 0.0
        cases = [(R, L, "normal", "path")
                 for R, L in list(single) + [(16, 4099)]]
        cases += QUANTILE_ADVERSARIAL
        for R, L, kind, levels in cases:
            rows, s = quantile_rows(dtype, kind, R, L, gen)
            if levels == "path":
                q = 1.0 - 0.05 * torch.rand(R, generator=gen, device="cuda")
            else:   # the ends: q = 0 and 1 (and one between)
                q = torch.tensor(([0.0, 1.0, 0.5] * R)[:R], device="cuda")
            qerr = max(qerr, quantile_check(
                rows, q, s, f"quantile_fused {dtype} {kind} rows {(R, L)}, "
                            f"q {levels}"))
        # each single-pass shape: its launches on the main path (counted
        # by shape), times on the first of its calls there and on normal
        # rows; the round row adds the times of the first round's calls
        calls = quantile_calls[dtype]
        check(sorted(tuple(c[0].shape) for c in calls)
              == sorted(sh for sh, n in single.items() for _ in range(n)),
              f"quantile_fused {dtype}: the first round's calls were at "
              f"{[tuple(c[0].shape) for c in calls]}, expected {single}")
        timed = []
        for rows, q, s in calls:
            what = f"quantile_fused {dtype} main-path rows {tuple(rows.shape)}"
            qerr = max(qerr, quantile_check(rows, q, s, what))
            R, L = rows.shape
            b, by = bound(R * L * rows.element_size()
                          + (3 + (s is not None)) * R * 4, R * L)
            cand = ablate.quantile_candidates(rows, q, s)
            timed.append({
                "shape": (R, L), "bound_ms": b, "bound_by": by,
                "ms": time_ms(lambda: ops.quantile_fused(rows, q, s), 10),
                "plain_ms": time_ms(lambda: ref.row_trimmed_stats_ref(
                    ref.dequantize_rows(rows, s), q), 5),
                "ms_by_cluster": ablate.quantile_cluster_times(rows, q, s),
                "over": 0 if cand is None else int((cand[0] > cand[1]).sum()),
                "most": None if cand is None else int(cand[0].max()),
                "holds": None if cand is None else cand[1]})
        by_shape = shapes[dtype]["quantile_fused"]
        check(sum(by_shape.values()) == launches[dtype]["quantile_fused"]
              and all(by_shape.get(sh, 0) == 2 * leaves
                      for sh, leaves in single.items()),
              f"quantile_fused {dtype}: launches by shape {by_shape} in 2 "
              f"rounds, expected twice {single}")
        for R, L in single:
            rows, s = quantile_rows(dtype, "normal", R, L, gen)
            if dtype == "f32":
                f32_rows = rows     # the largest shape's, last
            q = 1.0 - 0.05 * torch.rand(R, generator=gen, device="cuda")
            mine = [c for c in timed if c["shape"] == (R, L)]
            first = mine[0]
            out.append({
                "name": "quantile_fused", "dtype": dtype, "shape": [R, L],
                "route": "cuda",
                "source": "src/repro_torch/csrc/quantile_fused.cu",
                "replaces": "src/repro/kernels/fedfa_quantile/kernel.py:85",
                "launches": by_shape[R, L], "max_abs_err": qerr,
                **{k: first[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by")},
                "library_ms": None,
                "normal_rows_ms": time_ms(
                    lambda: ops.quantile_fused(rows, q, s), 10),
                "ms_by_cluster": first["ms_by_cluster"],
                # the round's rows of this shape, those whose candidates
                # overflow CTA 0, and the most candidates of a row against
                # what CTA 0 holds
                "rows_in_round": R * len(mine),
                "rows_all_levels_over_cluster": sum(c["over"] for c in mine),
                "candidates_max": None if first["most"] is None else
                [max(c["most"] for c in mine), first["holds"]]})
        out.append({
            "name": "quantile_fused", "dtype": dtype, "shape": "round",
            "route": "cuda",
            "source": "src/repro_torch/csrc/quantile_fused.cu",
            "replaces": "src/repro/kernels/fedfa_quantile/kernel.py:85",
            "launches": launches[dtype]["quantile_fused"], "rounds": 2,
            "max_abs_err": qerr,
            **{k: sum(c[k] for c in timed)
               for k in ("ms", "plain_ms", "bound_ms")},
            "bound_by": "bytes", "library_ms": None,
            "calls_timed": len(timed)})
        del rows, timed

    # trimmed_sumsq: the (N,) f32 vector against its plain version, and
    # each row of the largest single-pass shape at the threshold
    # quantile_fused returned for it against that kernel's Σx²
    R, L = list(single)[-1]
    q = 1.0 - 0.05 * torch.rand(R, generator=gen, device="cuda")
    t, ss = ops.quantile_fused(f32_rows, q)
    for r in range(R):
        torch.testing.assert_close(agg_ops.trimmed_sumsq(f32_rows[r], t[r]),
                                   ss[r], rtol=1e-5, atol=0)
    wv = randn(n)
    tv = torch.tensor(2.0, device="cuda")
    got = agg_ops.trimmed_sumsq(wv, tv)
    want = agg_ref.trimmed_sumsq_ref(wv, tv)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    b, by = bound(4 * n + 8, 3 * n)
    out.append({
        "name": "trimmed_sumsq", "dtype": "f32", "route": "cuda",
        "source": "src/repro_torch/csrc/trimmed_sumsq.cu",
        "replaces": "src/repro/kernels/fedfa_agg/kernel.py:42",
        "launches": launches["trimmed_norm"]["trimmed_sumsq"],
        "max_abs_err": float((got - want).abs()),
        "ms": time_ms(lambda: agg_ops.trimmed_sumsq(wv, tv), 10),
        "plain_ms": time_ms(lambda: agg_ref.trimmed_sumsq_ref(wv, tv), 5),
        "bound_ms": b, "bound_by": by, "library_ms": None})
    wb = wv.to(torch.bfloat16)
    got = agg_ops.trimmed_sumsq(wb, tv)
    want = agg_ref.trimmed_sumsq_ref(wb, tv)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    b, by = bound(2 * n + 8, 3 * n)
    out.append({
        "name": "trimmed_sumsq", "dtype": "bf16", "route": "cuda",
        "source": "src/repro_torch/csrc/trimmed_sumsq.cu",
        "replaces": "src/repro/kernels/fedfa_agg/kernel.py:42",
        "launches": launches["trimmed_norm"]["trimmed_sumsq"],
        "max_abs_err": float((got - want).abs()),
        "ms": time_ms(lambda: agg_ops.trimmed_sumsq(wb, tv), 10),
        "plain_ms": time_ms(lambda: agg_ref.trimmed_sumsq_ref(wb, tv), 5),
        "bound_ms": b, "bound_by": by, "library_ms": None})
    return out


def hist_checks(launches: dict, shapes: dict) -> list:
    """``hist_level`` at every multilevel row shape of the main path (wq/wo,
    the FFN, the embedding; S = 1), f32 and quantized, at each of the four
    levels with the prefixes the plain level loop finds for those rows:
    counts equal to the plain version's, Σx² within rtol 1e-5; at the
    second level also with the ceil path's prefix moved to the next bin, so
    that the two planes differ; then the whole multilevel quantile against
    the sorting plain version, thresholds bit-equal.  Each (shape, level) is
    timed beside its launches on the main path (``shapes``, counted by
    shape), and one row per dtype adds them up over a round (launches × time
    against launches × bound, over the path's 2 rounds)."""
    from repro_torch.kernels.fedfa_quantile import multilevel, ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    _, _, multi = main_path_shapes(8)
    out = []
    for dtype in ("f32", "int8", "bf16"):
        total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0}
        for R, L in multi:
            if dtype == "f32":
                x, s = torch.randn((R, L), generator=gen, device="cuda"), None
            else:
                x, s = quantized_rows(dtype, R, L, gen)
            sc = None if s is None else s[:, None].contiguous()
            seg1 = torch.zeros(L, dtype=torch.int32, device="cuda")
            seg_len = torch.full((1,), L, dtype=torch.int64, device="cuda")
            q = 1.0 - 0.05 * torch.rand((R, 1), generator=gen, device="cuda")
            levels = multilevel.level_prefixes(x, seg1, seg_len, q, sc)
            for j, (shift, hi) in enumerate(levels):
                cases = [hi]
                if j == 1:
                    moved = hi.clone()
                    moved[:, 1] += 1
                    cases.append(moved)
                for h in cases:
                    cnt, sq = multilevel.hist_level(x, seg1, h, shift, sc)
                    pcnt, psq = ref.hist_level_ref(x, seg1, h, shift, sc)
                    what = (f"hist_level {dtype} {(R, L)} level {j}"
                            + ("" if h is hi else ", planes differing"))
                    check(torch.equal(cnt, pcnt), f"{what}: counts differ")
                    torch.testing.assert_close(sq, psq, rtol=1e-5, atol=0,
                                               msg=f"{what}: sums differ")
                    err = float((sq - psq).abs().max())
                    total["err"] = max(total["err"], err)
                b, by = bound(R * L * BYTES[dtype] + (L + R * 2) * 4
                              + (0 if sc is None else R * 4)
                              + R * 2 * 256 * 8, R * L)
                ms = time_ms(lambda: multilevel.hist_level(x, seg1, hi, shift,
                                                           sc), 10)
                plain = time_ms(lambda: ref.hist_level_ref(x, seg1, hi, shift,
                                                           sc), 2)
                n = shapes[dtype]["hist_level"].get((R, L, shift), 0)
                for key, val in (("ms", ms), ("plain_ms", plain),
                                 ("bound_ms", b)):
                    total[key] += n / 2 * val       # 2 rounds
                out.append({
                    "name": "hist_level", "dtype": dtype, "shape": [R, L],
                    "level": j, "route": "cuda",
                    "source": "src/repro_torch/csrc/hist_level.cu",
                    "replaces": "src/repro/kernels/fedfa_quantile/"
                                "multilevel.py:107",
                    "launches": n,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain,
                    "bound_ms": b, "bound_by": by, "library_ms": None})
            t, ss = multilevel.row_trimmed_stats_multilevel(x, q[:, 0], s)
            pt, pss = ref.row_trimmed_stats_ref(ref.dequantize_rows(x, s),
                                                q[:, 0])
            check(torch.equal(t.view(torch.int32), pt.view(torch.int32)),
                  f"multilevel {dtype} thresholds differ at {(R, L)}")
            torch.testing.assert_close(ss, pss, rtol=1e-5, atol=0)
            del x, levels, pt, pss
        # the round: each multilevel leaf once per level
        by_shape = shapes[dtype]["hist_level"]
        check(sum(by_shape.values()) == launches[dtype]["hist_level"]
              and by_shape == {(R, L, 24 - 8 * j): 2 * leaves
                               for (R, L), leaves in multi.items()
                               for j in range(4)},
              f"hist_level {dtype}: launches by (rows, shift) {by_shape} in "
              f"2 rounds, expected each leaf's 4 levels twice")
        out.append({
            "name": "hist_level", "dtype": dtype, "shape": "round",
            "route": "cuda", "source": "src/repro_torch/csrc/hist_level.cu",
            "replaces": "src/repro/kernels/fedfa_quantile/multilevel.py:107",
            "launches": launches[dtype]["hist_level"], "rounds": 2,
            "max_abs_err": total["err"],
            "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": total["bound_ms"], "bound_by": "bytes",
            "library_ms": None})
    return out


def serve_card_vs_cpu(flash) -> None:
    """The serving Engine on the card and on the CPU at the reduced sizes,
    same weights and prompts, greedy, 8 new tokens, with an f32 and a bf16
    cache: 4 prompts of 48 tokens for mamba2-130m and the 4-layer
    smollm-135m, then 2 prompts of 2,100 for smollm-135m, whose prefill
    takes blocked attention — ``flash`` (the ``flash_attention`` kernel)
    once per layer on the card, ``attend_blocked`` on the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic
    from repro_torch.launch import serve, train
    from repro_torch.models.model import init_params
    from repro_torch.tree import tree_map

    smollm = train.fl_config("smollm-135m", "cls", 10, full_size=False)
    cases = [("mamba2-130m", get_arch("mamba2-130m").reduced(), 4, 48, 0),
             ("smollm-135m", smollm, 4, 48, 0),
             ("smollm-135m", smollm, 2, 2100, smollm.n_layers)]
    for name, cfg, batch, prompt_len, flash_launches in cases:
        params = init_params(cfg, torch.Generator().manual_seed(0))
        prompts = synthetic.lm_stream(cfg.vocab_size, batch, prompt_len,
                                      seed=0)
        for cache in (torch.float32, torch.bfloat16):
            out = {}
            for dev in ("cuda", "cpu"):
                eng = serve.Engine(cfg, tree_map(lambda t: t.to(dev), params),
                                   capacity=prompt_len + 16,
                                   cache_dtype=cache)
                flash.reset()
                out[dev] = eng.generate(prompts, max_new=8,
                                        return_logits=True)
                want_launches = flash_launches if dev == "cuda" else 0
                check(flash.launches == want_launches,
                      f"{name} prompt {prompt_len} on {dev}: "
                      f"{flash.launches} flash_attention launches, "
                      f"expected {want_launches}")
            (tok, lg), (want_tok, want) = out["cuda"], out["cpu"]
            check(np.array_equal(tok, want_tok),
                  f"{name} prompt {prompt_len} {cache} serving: card tokens "
                  f"{tok.tolist()} != cpu {want_tok.tolist()}")
            # one bf16 step of the largest real logit (vocab padding reads
            # -1e30)
            real = float(np.abs(want[..., :cfg.vocab_size]).max())
            tol = (dict(rtol=1e-3, atol=1e-4) if cache == torch.float32 else
                   dict(rtol=0, atol=BF16_STEP * real))
            np.testing.assert_allclose(lg, want, **tol)
            log(f"serving card vs cpu, {name}, prompt {prompt_len}, {cache} "
                f"cache: tokens equal, logits max abs diff "
                f"{float(np.abs(lg - want).max()):.3g}")


def serve_path(kernels, arch: str, batch: int, prompt_len: int,
               max_new: int, expect: dict) -> dict:
    """``launch.serve`` at full size, every launch count reset just before;
    fails unless the counts are ``expect`` (0 for any kernel not named) and
    every token is in the vocabulary.  Then a second, warm generate on the
    same engine and prompts."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    for k in kernels:
        k.reset()
    t0 = time.perf_counter()
    out = serve.serve(arch, batch, prompt_len, max_new, full_size=True,
                      device="cuda")
    seconds = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in kernels}
    check(launches == {k.symbol: expect.get(k.symbol, 0) for k in kernels},
          f"{arch} serving path launches {launches}, expected {expect}")
    tok, vocab = out["tokens"], get_arch(arch).vocab_size
    check(tok.shape == (batch, max_new)
          and bool(((tok >= 0) & (tok < vocab)).all()),
          f"{arch} serving path tokens {tok.shape} out of [0, {vocab})")
    eng = out["engine"]
    eng.generate(out["prompts"], max_new=max_new)
    w = eng.timing
    return {"arch": arch, "batch": batch, "prompt_len": prompt_len,
            "max_new": max_new, "launches": launches, "seconds": seconds,
            **{k: out[k] for k in ("prefill_ms", "decode_ms_per_token",
                                   "tokens_per_s", "peak_gib")},
            "warm": {"prefill_ms": w["prefill_s"] * 1e3,
                     "decode_ms_per_token": w["decode_s"] * 1e3
                     / w["decode_steps"],
                     "tokens_per_s": batch * max_new
                     / (w["prefill_s"] + w["decode_s"])}}


def ssd_inputs(G, Q, nh, hp, N, dtype, gen):
    """x, dt (post-softplus), A, B, C on the card, as the JAX package's
    SSD sweep draws them."""
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x = (randn(G, Q, nh, hp) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(randn(G, Q, nh))
    A = -torch.exp(randn(nh) * 0.2)
    return x, dt, A, (randn(G, Q, N) * 0.3).to(dtype), \
        (randn(G, Q, N) * 0.3).to(dtype)


def ssd_checks(launches: int) -> list:
    """``ssd_intra_chunk`` against its plain version at the serving path's
    shape (batch 8 x prompt 1024 in chunks of 128: G = 64; 24 heads of 64,
    state 128), f32 and bf16 inputs: y and the state within 1e-4 + 1e-4·|w|,
    L bit-equal; the whole chunked SSD against its plain version; and the
    wrapper's refusal of inputs that need a gradient.  The bound is that of
    the kernel's route: the larger of the bytes and the tensor-core
    operations, the three products over their causal triangles as three
    TF32 products each at f32, and at bf16 C·Bᵀ as one bf16 product and
    M·x and the state as two TF32 products each."""
    from repro_torch.kernels.ssd import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    G, Q, nh, hp, N = 64, 128, 24, 64, 128
    out = []
    for dtype, nbytes in ((torch.float32, 4), (torch.bfloat16, 2)):
        a = ssd_inputs(G, Q, nh, hp, N, dtype, gen)
        got, want = ops.ssd_intra_chunk(*a), ref.ssd_intra_chunk_ref(*a)
        for what, g, w in zip(("y", "state"), got, want):
            check(bool(((g - w).abs() <= 1e-4 + 1e-4 * w.abs()).all()),
                  f"ssd_intra_chunk {dtype} {what} disagrees")
        check(torch.equal(got[2], want[2]),
              f"ssd_intra_chunk {dtype} L differs")
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        # operations, 2 per multiply-add: C·Bᵀ once per chunk, M·x and the
        # state per head, the causal products over their lower triangle
        # (s <= t: Q(Q+1)/2 entries); bytes: each input read and output
        # written once
        tri = Q * (Q + 1) // 2
        cb_ops = 2 * G * tri * N
        head_ops = 2 * G * nh * (tri * hp + Q * hp * N)
        ops_s = (3 * (cb_ops + head_ops) / TF32_OPS_PER_S if nbytes == 4 else
                 cb_ops / BF16_OPS_PER_S + 2 * head_ops / TF32_OPS_PER_S)
        bytes_n = (G * Q * nh * hp * nbytes + G * Q * nh * 4 + nh * 4
                   + 2 * G * Q * N * nbytes + G * Q * nh * hp * 4
                   + G * nh * hp * N * 4 + G * Q * nh * 4)
        b, by = bound(bytes_n, ops_s * TF32_OPS_PER_S, TF32_OPS_PER_S)
        out.append({
            "name": "ssd_intra_chunk",
            "dtype": "f32" if dtype == torch.float32 else "bf16",
            "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_intra_chunk.cu",
            "replaces": "src/repro/kernels/ssd/kernel.py:50",
            "launches": launches, "max_abs_err": err,
            "ms": time_ms(lambda: ops.ssd_intra_chunk(*a), 10),
            "plain_ms": time_ms(lambda: ref.ssd_intra_chunk_ref(*a), 3),
            "bound_ms": b, "bound_by": by,
            # the first version's bound, f32 on the CUDA cores
            "cuda_core_bound_ms": (cb_ops + head_ops) / F32_OPS_PER_S * 1e3,
            "library_ms": None})
        del a, got, want
    x, dt, A, B, C = ssd_inputs(8, 1024, nh, hp, N, torch.float32, gen)
    y, h = ops.ssd(x, dt, A, B, C, Q)
    ry, rh = ref.ssd_chunked_ref(x, dt, A, B, C, Q)
    torch.testing.assert_close(y, ry, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, rh, rtol=1e-4, atol=1e-4)
    try:
        ops.ssd_intra_chunk(x[:1, :Q].contiguous().requires_grad_(True),
                            dt[:1, :Q].contiguous(), A, B[:1, :Q].contiguous(),
                            C[:1, :Q].contiguous())
    except NotImplementedError:
        pass
    else:
        raise AssertionError("ssd_intra_chunk ran on inputs that need a "
                             "gradient")
    return out


# the JAX package's sweep (tests/test_kernels.py): (B, Sq, Sk, H, K, hd)
FLASH_SWEEP = [(2, 256, 256, 4, 2, 64), (1, 128, 128, 8, 8, 128),
               (2, 192, 192, 4, 1, 64), (1, 64, 320, 2, 2, 32)]


def attention_keep(Sq: int, Sk: int, causal: bool, window) -> np.ndarray:
    """The (Sq, Sk) mask of the (q, k) pairs attention keeps."""
    qpos, kpos = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    keep = np.ones((Sq, Sk), bool)
    if causal:
        keep &= kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    return keep


def flash_checks(launches: int) -> list:
    """``flash_attention`` against its plain version: at the serving path's
    shape (batch 8 x 4096 causal, 9 q and 3 kv heads of 64; f32 as the
    path runs it, and bf16), at the JAX package's sweep (f32 and bf16 x
    causal, window 96 and non-causal; causal cross-length is not used by
    the stack) and at a ragged shape; within 2e-5 at f32 and 5e-2 at bf16
    (atol and rtol, the JAX tests').  f32 is also held within 1e-5 of
    ``attention_split_tf32_ref``, the 3xTF32 arithmetic the kernel's f32
    route does (at the serving shape on its first two sequences; the two
    differ only in the order of f32 sums and in where p is split).  The
    bound counts the products of the pairs the mask keeps, three TF32
    products each at the TF32 tensor-core rate for f32 inputs and one at
    the bf16 rate for bf16 ones.  Then the wrapper's refusal of inputs that
    need a gradient."""
    from repro_torch.kernels.flash_attention import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [((8, 4096, 4096, 9, 3, 64), dt, True, None) for dt in (f32, bf16)]
    cases += [(shape, dt, causal, window) for shape in FLASH_SWEEP
              for dt in (f32, bf16)
              for causal, window in ((True, None), (True, 96), (False, None))
              if not (causal and shape[1] != shape[2])]
    cases.append(((2, 100, 100, 4, 2, 48), f32, True, None))
    out = []
    for (B, Sq, Sk, H, K, hd), dt, causal, window in cases:
        q, k, v = (randn(B, S, n, hd).to(dt)
                   for S, n in ((Sq, H), (Sk, K), (Sk, K)))
        kw = dict(causal=causal, window=window)
        got = ops.attention(q, k, v, **kw).float()
        want = ref.attention_ref(q, k, v, **kw).float()
        tol = 2e-5 if dt == f32 else 5e-2
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        split_err = None
        if dt == f32:
            n = min(B, 2)
            emul = ref.attention_split_tf32_ref(q[:n], k[:n], v[:n], **kw)
            torch.testing.assert_close(got[:n], emul, rtol=1e-5, atol=1e-5)
            split_err = float((got[:n] - emul).abs().max())
            del emul
        keep = attention_keep(Sq, Sk, causal, window)
        nb = q.element_size()
        products = 4 * B * H * hd * int(keep.sum())
        b, by = bound(2 * B * (Sq * H + Sk * K) * hd * nb,
                      *((3 * products, TF32_OPS_PER_S) if dt == f32
                        else (products, BF16_OPS_PER_S)))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = (None if window is None else
                torch.as_tensor(keep, device="cuda"))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)
        big = Sq * Sk > 2048 * 2048
        out.append({
            "name": "flash_attention",
            "dtype": "f32" if dt == f32 else "bf16",
            "shape": [B, Sq, Sk, H, K, hd], "causal": causal,
            "window": window, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:68",
            "launches": launches,
            "max_abs_err": float((got - want).abs().max()),
            "max_abs_err_vs_3xtf32": split_err,
            "ms": time_ms(lambda: ops.attention(q, k, v, **kw),
                          10 if big else 20),
            "plain_ms": time_ms(lambda: ref.attention_ref(q, k, v, **kw),
                                3 if big else 10),
            "bound_ms": b, "bound_by": by,
            "library_ms": time_ms(sdpa, 5 if big else 20)})
        del q, k, v, got, want
    x = randn(1, 64, 2, 32).requires_grad_(True)
    try:
        ops.attention(x, randn(1, 64, 1, 32), randn(1, 64, 1, 32))
    except NotImplementedError:
        pass
    else:
        raise AssertionError("flash_attention ran on inputs that need a "
                             "gradient")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        log("chip_smoke: src/repro_torch not found beside the script")
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import MAMBA2_130M, SMOLLM_135M
    from repro_torch.kernels import build
    from repro_torch.kernels.fedfa_agg.ops import (QUANT_ACCUM, SCALED_ACCUM,
                                                   TRIMMED_SUMSQ)
    from repro_torch.kernels.fedfa_quantile.multilevel import HIST_LEVEL
    from repro_torch.kernels.fedfa_quantile.ops import QUANTILE_FUSED
    from repro_torch.kernels.flash_attention.ops import FLASH_ATTENTION
    from repro_torch.kernels.ssd.ops import SSD_INTRA_CHUNK

    # full f32 products on the card, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    kernels = [SCALED_ACCUM, QUANTILE_FUSED, HIST_LEVEL, QUANT_ACCUM,
               TRIMMED_SUMSQ, SSD_INTRA_CHUNK, FLASH_ATTENTION]
    t0 = time.perf_counter()
    build.build_all(kernels)
    log(f"built {len(kernels)} kernels in {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        log(k.library.with_suffix(".log").read_text().strip()
            if k.library.with_suffix(".log").exists() else k.library.name)

    small_reference_check()
    for dtype in ("int8", "bf16"):
        small_quantized_check(dtype)
    print(json.dumps({"small_async": small_async_check()}), flush=True)
    f32_path = [SCALED_ACCUM, QUANTILE_FUSED, HIST_LEVEL]
    launches, shapes, quantile_calls = {}, {}, {}
    for dtype in ("f32", "int8", "bf16"):
        hist = main_path(kernels, dtype, f32_path if dtype == "f32"
                         else f32_path + [QUANT_ACCUM])
        launches[dtype] = hist["launches"]
        shapes[dtype] = hist["by_shape"]
        quantile_calls[dtype] = hist["quantile_calls"]
        print(json.dumps({"main_path": {"update_dtype": dtype, **{
            k: hist[k] for k in ("round_loss", "global_acc", "local_acc",
                                 "launches", "seconds", "peak_gib")},
            "launches_by_shape": {
                sym: [[list(shape), n] for shape, n in c.items()]
                for sym, c in hist["by_shape"].items() if c}}}), flush=True)
        del hist
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in ("f32", "int8"):
            res, eng = async_path(kernels, dtype, ckpt=tmp + "/async"
                                  if dtype == "f32" else None)
            launches[f"async-{dtype}"] = res["launches"]
            print(json.dumps({"async_path": res, "card": card}), flush=True)
            if dtype == "f32":
                print(json.dumps({"checkpoint": checkpoint_path(
                    eng, tmp + "/async"), "card": card}), flush=True)
            del eng
    for dtype in ("f32", "int8"):
        timing, g = round_timing(dtype)
        print(json.dumps({"round": timing, "card": card}), flush=True)
    tn = trimmed_norm_path(kernels, g)
    launches["trimmed_norm"] = tn["launches"]
    print(json.dumps({"trimmed_norm_path": tn}), flush=True)
    del g
    serve_card_vs_cpu(FLASH_ATTENTION)
    for arch, shape, expect in (
            ("mamba2-130m", (8, 1024, 32),     # one SSD launch per layer
             {"ssd_intra_chunk": MAMBA2_130M.n_layers}),
            ("smollm-135m", (8, 32, 32), {}),
            # 4096² > 2048²: blocked attention, one launch per layer
            ("smollm-135m", (8, 4096, 32),
             {"flash_attention": SMOLLM_135M.n_layers})):
        sp = serve_path(kernels, arch, *shape, expect)
        launches[f"{arch}@{shape[1]}"] = sp["launches"]
        print(json.dumps({"serve_path": sp, "card": card}), flush=True)
    print(json.dumps({"kernels": kernel_checks(launches, shapes,
                                               quantile_calls)
                      + hist_checks(launches, shapes) + ssd_checks(
        launches["mamba2-130m@1024"]["ssd_intra_chunk"]) + flash_checks(
        launches["smollm-135m@4096"]["flash_attention"])}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
