#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, all at once), then holds quantized admission's kernel
   against its plain version on the card bit for bit and times it
   (``quant_admit_checks``: the 4-layer layout, full-size segments, m = 16
   at full size; one JSON line).
3. Checks the port on the card against the port on the CPU at the 4-layer
   test size: two resident rounds with an attacker, same seed, same
   weights (losses and the global model at rtol 1e-3 / atol 1e-4: f32
   sums in another order, compounded by two rounds of SGD).  Then two
   quantized resident rounds each for int8 and bf16, each round started
   on the card from the CPU's global and quantized state, at the round
   test's tolerance (losses rtol 1e-4; the global within rtol 1e-4 /
   atol 1e-5 but at most 1e-4·N elements, each within one admission step
   of its segment, and relative L2 within 1e-4).  The same for
   mamba2-130m, for phi3.5-moe and for recurrentgemma-2b at the JAX CLI's
   4-layer cut (f32 free-running, int8 each round from the CPU's state).  A chunked
   prefill of phi3.5-moe's cut (``prefill_chunk`` 8, 2 prompts of 32) on
   the card and the CPU: the same experts picked by every MoE call (so
   the same tokens dropped), logits within one bf16 step of the largest
   real logit.  Three dense train steps
   (``launch.steps.make_train_step``) of every dense and moe registry
   entry on the card and the CPU (minicpm-2b with AdamW, WSD and
   grad_accum 2; smollm-135m also with grad_accum 2 and bf16 momentum;
   arctic-480b with its dense residual branch; recurrentgemma-2b's RG-LRU
   blocks and softcapped logits; whisper-base with numpy frames in every
   batch): losses rtol
   1e-3, SGD's weights rtol 1e-3 / atol 1e-4; AdamW's first step moves
   each weight by the rate times the sign of its gradient, so a weight
   whose gradient is at the f32 noise may move the other way on each
   device, and every later gradient then differs by more than the noise:
   each AdamW step is also taken on the card from the CPU's state and
   held at rtol 1e-3 / atol 1e-4 wherever the CPU's gradient lies above
   the noise (1e-5 of its leaf's largest), and the free-running weights
   above the first step's noise within 1e-3 of the update in relative
   L2.  whisper-base's and internvl2-76b's ``forward`` and ``loss_fn`` at
   ``reduced()`` at widths 1 and 0.5 (rtol 1e-3 / atol 1e-4; internvl2's
   numpy patches also in its dense steps).  A
   per-round ``--agg-engine tree`` round on the card against the CPU's
   (rtol 1e-3 / atol 1e-4) and against the card's flat round (rtol 1e-4
   / atol 1e-5), and a ``use_kernel=False`` round on the card: the kernel
   round's global at rtol 1e-4 / atol 1e-5 and no kernel launched.
4. Drives the main path — ``launch.train.run_fl`` with the CLI defaults
   (smollm-135m at full width and depth, 16 clients at participation 0.5,
   batch 8, sequence 64, 2 local steps, fedfa, cls) — for 2 rounds, with
   every kernel's launch count set to 0 just before and read just after;
   fails unless the losses are finite and every kernel of the path ran.
   Then the same with ``--update-dtype int8`` and with ``bf16``, each its
   own path with its own counts.  Every kernel must have run exactly its
   launches by shape (``fl_expected_launches``).  Then FL training of
   mamba2-130m at full size the same way, at f32 and int8, the first
   round's arguments of every aggregation wrapper recorded (in host
   memory) for step 9, with the first 2 ``ssd_intra_chunk`` calls of
   each shape; ``ssd_intra_chunk`` runs in the evaluation's forwards
   only (training takes the plain chunked SSD); the round and
   its aggregation timed.  Then FL training of phi3.5-moe at the CLI's
   4-layer cut the same way at f32 and int8: its expert rows are 2^18
   long, so ``quantile_fused`` takes every leaf and ``hist_level`` runs
   0 times; its kernels held on the rows it passed them in step 9.  The
   same for recurrentgemma-2b at the CLI's 4-layer cut (its rows at most
   131,072 long), with one round and its aggregation timed.  Then
   ``run_dense`` of smollm-135m at full size
   (batch 8 x 64): finite losses, no kernel, ms a step, peak memory.
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
   tolerances.  Then sliding windows through ring KV caches, at the same
   tolerances: recurrentgemma-2b ``reduced()`` (window 128, capacity 232)
   with 2 prompts of 200 and 24 new tokens, and tinyllama-1.1b
   ``reduced()`` at ``Engine(window=64)``, capacity 128, 2 prompts of 100
   and 24 new tokens: each ring wraps in prefill and again in decode.
   Then whisper-base with numpy frames, at the same tolerances:
   ``reduced()`` (64 frames) with 4 prompts of 48 and 8 new tokens, and at
   its published width cut to 2 decoder layers with 1 prompt of 2,816
   against 1,500 frames and 4 new tokens: on the card its prefill takes
   ``flash_attention`` 4 times (a layer's causal self attention, 2,816²,
   and non-causal cross attention, 2,816 × 1,500 > 2048²), on the CPU
   ``attend_blocked``.  Then internvl2-76b ``reduced()`` with numpy
   patches, at the same tolerances: 2 prompts of 32 behind 16 patches and
   8 new tokens, and 1 prompt of 2,040 behind them (2,056 positions, past
   2048² only with the patches) and 4 new tokens: on the card its prefill
   takes ``flash_attention`` once a layer, on the CPU ``attend_blocked``.
8. Drives the serving path at full size: ``launch.serve`` with
   ``--arch mamba2-130m --full-size --batch 8 --prompt-len 1024
   --max-new 32`` (counts reset just before; fails unless
   ``ssd_intra_chunk`` ran exactly once per layer, 24 times, no other
   kernel ran, and every token is in the vocabulary), then smollm-135m at
   the serve defaults (batch 8, prompt 32, 32 new tokens; no kernel
   launches), then smollm-135m with a long prompt (batch 8, prompt 4096,
   32 new tokens: ``flash_attention`` exactly once per layer, 30 times,
   and nothing else); prints prefill ms, decode ms per token, tokens/s and
   peak memory of each run and of a second, warm run of the same engine,
   then the achieved rate (``achieved_rates``): ``launch.costs``'
   whole-step FLOPs of the dense path's step and of this 8 x 4,096
   prefill (less the lm head at every position but the last, which the
   prefill does not compute) over their measured times, with the card's
   name and limit.
   Then phi3.5-moe at its published width cut to 4 layers (5.46B
   parameters, seeded random f32 weights on the card): a chunked prefill
   (``make_prefill_step``) of 2 prompts of 8,192 tokens in 8 chunks of
   1,024 — ``flash_attention`` exactly 32 times, at q offsets 0, 1,024,
   ..., 7,168, the first two launches at each offset held against
   ``attention_ref`` on the card, prefill ms and peak memory — then the
   serving Engine on 2 prompts of 4,096 with 16 new tokens (4 launches at
   offset 0; decode routes at capacity 1).  Then recurrentgemma-2b at its
   published size (3,549,934,080 parameters, seeded random f32 weights
   drawn on the card): the serving Engine on 2 prompts of 4,096 tokens and
   32 new — ``flash_attention`` exactly 8 times (once per attention
   layer) at hd 256 and window 2,048 and nothing else, the first two
   launches held against ``attention_ref`` on the card, every token in the
   vocabulary; prefill ms, decode ms a step, tokens/s and peak memory of a
   first and a warm request.  Then whisper-base at its published size
   (130,873,344 parameters, seeded random f32 weights drawn on the card):
   the Engine on 8 prompts of 4,096 tokens against 1,500 numpy frames and
   32 new — ``flash_attention`` exactly 12 times, all in prefill (6 causal
   at (4,096, 4,096), 6 non-causal at (4,096, 1,500)), nothing else, the
   first launch of each kind held against ``attention_ref`` on the card —
   timed as the others.  Then the aggregation engine
   (``flat.aggregate_buffers``, fedfa) twice on an m = 8 cohort of
   full-size whisper-base trees (4.2 GB f32; no FL driver: ``run_fl``
   raises for it, as the reference fails): exactly the launches by shape
   derived from its layout (30 ``quantile_fused``, 28 ``hist_level``, 2
   ``scaled_accum`` an aggregation), its kernels then held on the rows it
   passed them (as for mamba2-130m's path), one aggregation timed.  Then
   internvl2-76b at its published width cut to 2 layers (3,905,986,560
   parameters, seeded random f32 weights drawn on the card): the Engine on
   2 prompts of 3,072 tokens behind 1,024 numpy patches and 32 new —
   ``flash_attention`` exactly twice, both in prefill at q (2, 4096, 64,
   128) over k, v (2, 4096, 8, 128) causal, the first held against
   ``attention_ref`` on the card — timed as the others; the model is then
   freed.  Then the client-side NAS on the card against the CPU (three
   ZiCo scores at rtol 1e-3, the evolutionary search's choice equal), and
   the quickstart example's ``main`` on the card: its round against the
   same round with ``use_kernel=False`` and on the CPU, and its aggregation
   launches counted exactly.  Then the sharded FL server (``mesh_path``):
   a 1 x 1 mesh over NCCL in this process aggregates a fixed full-size
   smollm-135m cohort (m = 8 seeded rows) twice through the mesh code,
   with the unsharded aggregation's launches by shape, its collectives
   counted exactly, and its global bit-equal to the unsharded
   aggregation's, which is bit-equal to itself (``hist_level``'s planes
   are exact integers); then a 2 x 2 mesh of 4 spawned processes on the card
   (gloo, each on cuda:0) aggregates a seeded m = 7 cohort (one pad row)
   at f32 and int8, runs 2 resident rounds at m = 8 and one int8 async
   merge (parity mode), and writes a checkpoint from the model-sharded
   global and restores it bit-equal; each rank's launches by shape
   (``scaled_accum`` 2 on (4, 67,257,856), ``hist_level`` 4 levels of
   each 37-segment group holding its columns, no ``quantile_fused``) and
   collectives (one all-gather a round, 2 N/M all-reduces over ``data``,
   4 histogram all-reduces over ``model``) are checked exactly; then this
   process holds it against the unsharded runs: thresholds and int8
   scales bit-equal, Σx² bit-equal to the unsharded segmented search's
   (and at rtol 1e-5 to the per-leaf path's), the globals within 8 ulp of
   the sums' magnitude (the shards' partial sums of M' and Γ), the rounds
   and the merge through ``round_close``.
9. Holds each kernel against its plain PyTorch version at the main path's
   shapes (weighted sums within 1e-5 of the summed magnitudes; thresholds
   bit-equal; trimmed sums of squares at rtol 1e-5; the SSD's y and state
   within 1e-5 of the summed magnitudes and its L bit-equal; attention within
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
   (counts, integer Σx² planes and their f32 scaling equal to the plain
   version's; at the second level also with the two planes' prefixes
   differing), and its per-round total (the launches
   beside each shape are the wrappers' counts by shape on the main path);
   ``flash_attention`` also against the 3xTF32 emulation of its f32 route
   (within 1e-5), at the JAX package's sweep of shapes and masks, on a
   ragged shape, with q offsets 1, 37 and 128, at the chunked prefill's
   shape on the inputs that path passed it, at hd 256 on the sweep's masks
   and q offsets 1 and 128 and on the inputs recurrentgemma-2b's request
   passed it (f32 and bf16; SDPA timed with the window as a boolean mask),
   on the inputs whisper-base's request passed it (causal (8, 4,096, 8,
   64) and non-causal against (8, 1,500, 8, 64); f32 and bf16), on the
   inputs internvl2-76b's request passed it (64 q heads over 8; f32 and
   bf16), and
   refusing inputs that need a gradient or a negative offset; the
   aggregation kernels also on the arguments mamba2-130m's path passed
   them (``ssd_intra_chunk`` on the evaluation's inputs of each shape,
   half of every chunk padding, at the serving tolerance), and on each
   of that path's rows longer than 2^18 ``row_trimmed_stats`` with
   ``use_kernel=False`` launches no kernel and gives the kernels'
   thresholds bit for bit; times the kernel, the plain version and,
   where one PyTorch call computes the same function, that call.  Every phase that reads peak
   memory collects Python's garbage first.
10. The program contracts (``repro_torch.analysis``, ``analysis_phase``):
    the fixture programs of ``python -m repro_torch.analysis check`` in
    this process without a mesh (a warm-up run, then the measured one):
    every contract PASSes, each program's kernel launches equal the
    prediction from the fixture's layout and together the kernels' own
    counts, its row reads and sorts equal the same programs' on the CPU,
    and its allocator peak is printed beside the CPU's storage sweep.
    Then the contracts recorded on the way: one extra, untimed round and
    aggregation of the f32 and int8 main paths' state (step 4), one
    admission and merge of each async run's engine, the 1 x 1 NCCL mesh's
    aggregation and each 2 x 2 rank's aggregation, distributed norms
    pass, second round and one more int8 merge.  Three JSON lines, any
    FAIL failing the run.
11. Prints the kernels line, then ``{"ok": true, "device": {...}}`` last.

Any failure exits non-zero before the last line.  Without CUDA, or without
the repository around it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
import gc
import hashlib
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


def collect_garbage() -> None:
    """Free what earlier phases left in reference cycles (engines,
    closures) before a phase measures its peak memory: Python frees cycles
    only when its collector runs, and until then their dead tensors count
    in the next phase's peak."""
    gc.collect()


def small_reference_check(arch: str = "smollm-135m") -> None:
    """Two resident rounds of ``arch`` at the 4-layer size on the card and
    on the CPU."""
    from repro_torch.core import flat
    from repro_torch.core.round import run_rounds
    from repro_torch.core.server import FLConfig, make_client_specs
    from repro_torch.data import partition, pipeline, synthetic
    from repro_torch.launch import train
    from repro_torch.models.model import init_params
    from repro_torch.tree import tree_map

    cfg = train.fl_config(arch, "cls", 10, full_size=False)
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
    log(f"small {arch} check: cuda losses {out['cuda'][1]} cpu "
        f"{out['cpu'][1]}")


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


def small_quantized_check(update_dtype: str,
                          arch: str = "smollm-135m") -> None:
    """Two quantized resident rounds of ``arch`` at the 4-layer size on the
    card and on the CPU, each card round started from the CPU's global and
    state."""
    from repro_torch.core import flat
    from repro_torch.core.round import ResidentDriver, default_perms
    from repro_torch.core.server import FLConfig, make_client_specs
    from repro_torch.data import partition, pipeline, synthetic
    from repro_torch.launch import train
    from repro_torch.models.model import init_params

    cfg = train.fl_config(arch, "cls", 10, full_size=False)
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
                    f"small {arch} {update_dtype} check, round {r}")
        log(f"small {arch} {update_dtype} check round {r}: losses {loss}")


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
                            "quantile_fused": 5, "hist_level": 24,
                            "quant_admit": 3}}


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
    collect_garbage()
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


def recording(module, name: str, limit: int, calls: list, to=None,
              key=None):
    """Patch ``module.name`` to keep copies of the positional arguments of
    its first ``limit`` calls in ``calls`` (on device ``to``, or where they
    are), or, with ``key``, of its first ``limit`` calls for each value of
    ``key(*args)``; returns the original, for the caller to put back."""
    orig = getattr(module, name)
    seen: dict = {}

    def rec(*a, **kw):
        k = None if key is None else key(*a)
        if seen.get(k, 0) < limit:
            seen[k] = seen.get(k, 0) + 1
            calls.append(tuple(
                x.to(to, copy=True) if isinstance(x, torch.Tensor) and to
                else x.clone() if isinstance(x, torch.Tensor) else x
                for x in a))
        return orig(*a, **kw)
    setattr(module, name, rec)
    return orig


def main_path(kernels, update_dtype: str, path_kernels,
              arch: str = "smollm-135m", record_all: bool = False,
              full_size: bool = True, contracts=None) -> dict:
    """The CLI defaults at full size (``arch``: smollm-135m, the main path,
    or mamba2-130m; phi3.5-moe at the CLI's 4-layer cut, ``full_size``
    False) for 2 rounds at ``update_dtype``, with every launch
    count reset just before; returns the history, with each kernel's
    launches (``launches``, and by shape where its wrapper names one:
    ``by_shape``) and copies of the arguments of the first round's
    ``quantile_fused`` calls (``quantile_calls``).  With ``record_all``,
    also (in host memory, so that the path's peak is its own) the first
    round's multilevel quantiles, ``scaled_accum`` and ``quant_accum``
    calls, and the first ``SSD_PER_SHAPE`` ``ssd_intra_chunk`` calls of
    each shape (``calls``).  With ``contracts`` (a list), the program
    contracts of one more, untimed round of the state the run left
    (``round_contracts``) are appended to it."""
    from repro_torch.core import round as round_mod
    from repro_torch.kernels.fedfa_agg import ops as agg_ops
    from repro_torch.kernels.fedfa_quantile import multilevel, ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import train
    _, single, multi = main_path_shapes(8, arch, full_size)
    quantized = update_dtype != "f32"
    spec = {"quantile_fused": (ops, sum(single.values()), None, None)}
    if record_all:
        spec["row_trimmed_stats_multilevel"] = (multilevel,
                                                sum(multi.values()), "cpu",
                                                None)
        spec["scaled_accum"] = (agg_ops, 1 if quantized else 2, "cpu", None)
        if quantized:
            spec["quant_accum"] = (agg_ops, 1, "cpu", None)
        spec["ssd_intra_chunk"] = (ssd_ops, SSD_PER_SHAPE, "cpu",
                                   lambda x, *_: tuple(x.shape))
    calls = {name: [] for name in spec}

    drivers, resident = [], round_mod.ResidentDriver

    class Kept(resident):
        """The run's driver, keeping its last round's arguments."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            drivers.append(self)

        def round(self, g_buf, specs, batches, perms=None):
            self.last = (g_buf, specs, batches, perms)
            return super().round(g_buf, specs, batches, perms)

    for k in kernels:
        k.reset()
    collect_garbage()
    torch.cuda.reset_peak_memory_stats()
    origs = {name: recording(mod, name, limit, calls[name], to, key)
             for name, (mod, limit, to, key) in spec.items()}
    if contracts is not None:
        round_mod.ResidentDriver = Kept
    t0 = time.perf_counter()
    try:
        hist = train.run_fl(arch, 2, 16, strategy="fedfa", batch=8,
                            seq_len=64, participation=0.5, local_steps=2,
                            lr=0.05, task="cls", eval_every=5,
                            driver="resident", update_dtype=update_dtype,
                            full_size=full_size, device="cuda")
        torch.cuda.synchronize()
    finally:
        round_mod.ResidentDriver = resident
        for name, (mod, *_) in spec.items():
            setattr(mod, name, origs[name])
    hist["seconds"] = time.perf_counter() - t0
    hist["launches"] = {k.symbol: k.launches for k in kernels}
    hist["by_shape"] = {k.symbol: dict(k.by_shape) for k in kernels}
    hist["quantile_calls"] = calls["quantile_fused"]
    hist["calls"] = calls
    hist["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    check(len(hist["round_loss"]) == 2
          and bool(np.all(np.isfinite(hist["round_loss"]))),
          f"{arch} {update_dtype} path losses {hist['round_loss']}")
    check(all(k.launches > 0 for k in path_kernels),
          f"a kernel of the {arch} {update_dtype} path never ran: "
          f"{hist['launches']}")
    if contracts is not None:
        (driver,) = drivers
        contracts += round_contracts(driver, update_dtype)
    return hist


def round_contracts(driver, update_dtype: str) -> list:
    """The analysis phase's full-width part for the resident round: one
    more round of the state a main path left (its driver and pools, its
    global and its last cohort), untimed and recorded
    (``analysis.dispatch``), held to ``round_contract`` (f32) or
    ``quantized_round_contract`` (int8; its reads and sorts on the fused
    dequantize-accumulate over the pool's int8 rows, as the fixture's);
    then one aggregation of the same buffers held to
    ``accumulate_contract``.  Peaks are the allocator's.  Returns
    (name, report, seconds) triples."""
    from repro_torch.analysis import passes
    from repro_torch.analysis.dispatch import Recorder, Run
    from repro_torch.core import flat
    from repro_torch.core import round as round_mod
    from repro_torch.core.fedfa import STRATEGIES
    from repro_torch.core.server import stack_runtimes
    from repro_torch.kernels.fedfa_agg import ops as agg_ops
    g_buf, specs, batches, perms = driver.last
    cfg, fl, index = driver.cfg, driver.fl, driver.index
    m = len(specs)
    c_buf, qstate = driver.pool(m)
    runtimes = stack_runtimes(cfg, specs, "cuda")
    collect_garbage()
    out = []
    t0 = time.perf_counter()
    _, rec, held = passes.run_in_place(
        round_mod.flat_round, (g_buf, c_buf, cfg, fl, index, runtimes,
                               batches, perms, qstate, None), sweep=False)
    if qstate is None:
        rep = round_mod.round_contract(index, None, rows=m).check(
            rec.run(ops=[], in_place=held))
    else:
        with Recorder(row_elems=qstate[0].numel(), inputs=qstate[:2],
                      sweep=False) as acc:
            agg_ops.accumulate_quant(
                qstate[0], torch.ones(m, device="cuda"), qstate[1],
                flat._device_seg_id(index, "cuda"),
                torch.ones(index.n_padded, device="cuda"))
        rep = round_mod.quantized_round_contract(index, None, rows=m).check(
            Run(counts=acc.counts, row_elems=acc.row_elems, ops=[],
                memory=rec.memory, in_place=held))
    rep.measured["kernel_calls"] = rec.counts.kernels
    out.append((f"smollm-135m round ({update_dtype}, m = {m})", rep,
                time.perf_counter() - t0))
    masks, gates, gmaps, nd, _, _ = runtimes
    x = c_buf if qstate is None else qstate[0]
    extra = {} if qstate is None else dict(scales=qstate[1],
                                           pregrafted=True)
    t0 = time.perf_counter()
    with Recorder(inputs=(g_buf, x, runtimes) + tuple(extra.values()),
                  sweep=False) as agg:
        flat.aggregate_buffers(index, g_buf, x, cfg, masks, gates, gmaps, nd,
                               trim=fl.trim, use_kernel=fl.use_kernel,
                               **STRATEGIES[fl.strategy], **extra)
    rep = agg_ops.accumulate_contract(index.n_padded, None, rows=m,
                                      segs=index.n_segments).check(
        agg.run(ops=[]))
    rep.measured["kernel_calls"] = agg.counts.kernels
    out.append((f"smollm-135m aggregation ({update_dtype}, m = {m})", rep,
                time.perf_counter() - t0))
    driver.last = None
    return out


def async_contracts(eng, update_dtype: str) -> list:
    """The analysis phase's full-width part for the async engine: on the
    engine a full-size ``run_fl(driver="async")`` left, one admission of
    the next clients into slots 0.. and one merge of the rows ready then,
    each recorded and held to ``admit_contract`` (or
    ``quantized_admit_contract``) and ``merge_contract``.  It moves the
    engine's global: run it after anything that reads the run's end.
    Returns (name, report, seconds) triples."""
    from repro_torch.analysis import programs
    from repro_torch.core import async_round
    res, t = None, eng.now
    while not res or not len(res[0]):    # the next clients available
        res, t = eng.source(eng.dispatch_idx, t, 4), t + 1.0
    specs, batches, _ = res
    slots = np.arange(len(specs))
    eng.pool.admit(slots, specs, np.zeros(len(specs)), eng.now, eng.version)
    eng._pending = (slots, specs, batches, eng.dispatch_idx)
    collect_garbage()
    admit = async_round.admit_contract if update_dtype == "f32" \
        else async_round.quantized_admit_contract
    out = []
    for name, record, contract in (
            (f"async admission ({update_dtype}, {len(specs)} clients)",
             programs.record_admission, admit),
            (f"async merge ({update_dtype}, pool of {eng.rows})",
             programs.record_merge, async_round.merge_contract)):
        t0 = time.perf_counter()
        rec, held = record(eng, sweep=False)
        rep = contract(eng.index, None, rows=eng.rows).check(
            rec.run(ops=[], in_place=held))
        rep.measured["kernel_calls"] = rec.counts.kernels
        out.append((name, rep, time.perf_counter() - t0))
    return out


# ssd_intra_chunk calls of each shape that main_path(record_all=True) keeps
SSD_PER_SHAPE = 2

# run_fl's evaluation: one global forward of 256 sequences and one of 64
# for each of the first 4 clients, at every eval boundary (rounds 0 and 1
# of a 2-round run with eval_every 5)
EVAL_GLOBAL, EVAL_LOCAL, EVAL_CLIENTS, EVALS = 256, 64, 4, 2


def fl_expected_launches(arch: str, update_dtype: str, rounds: int = 2,
                         m: int = 8, seq: int = 64,
                         full_size: bool = True) -> dict:
    """Each kernel's launches by shape on ``main_path`` at full size:
    every single-pass leaf one ``quantile_fused`` and every multilevel leaf
    four ``hist_level`` levels a round; ``scaled_accum`` twice a round at
    f32 (M' and Γ) and once quantized, where ``quant_accum`` takes M' and
    admission takes ``quant_admit`` three times (int8) or once (bf16); for
    an SSD model ``ssd_intra_chunk`` once a layer in each forward without
    a gradient — the evaluation's; training takes the plain chunked SSD.
    At phi3.5-moe's 4-layer cut (``full_size`` False) every row is at most
    2^18 long, the expert leaves' exactly (4 × 256 × 256), so
    ``hist_level`` runs 0 times."""
    from repro_torch.configs import get_arch
    _, single, multi = main_path_shapes(m, arch, full_size)
    q = update_dtype != "f32"
    want = {
        "quantile_fused": {sh: rounds * n for sh, n in single.items()},
        "hist_level": {(R, L, 24 - 8 * j): rounds * n
                       for (R, L), n in multi.items() for j in range(4)},
        "scaled_accum": rounds * (1 if q else 2),
        "quant_accum": rounds if q else 0,
        "quant_admit": rounds * {"f32": 0, "int8": 3,
                                 "bf16": 1}[update_dtype],
        "trimmed_sumsq": 0, "flash_attention": 0, "ssd_intra_chunk": {}}
    cfg = get_arch(arch)
    if cfg.ssm is not None:
        s, nc = cfg.ssm, -(-seq // cfg.ssm.chunk)
        nh = s.n_heads(cfg.d_model)
        for b, n in ((EVAL_GLOBAL, 1), (EVAL_LOCAL, EVAL_CLIENTS)):
            want["ssd_intra_chunk"][(b * nc, s.chunk, nh, s.head_dim,
                                     s.d_state)] = EVALS * n * cfg.n_layers
    return want


def check_fl_launches(hist: dict, arch: str, update_dtype: str,
                      full_size: bool = True) -> None:
    """Fail unless every kernel ran exactly its expected launches (by shape
    where the wrapper names one) on the path."""
    want = fl_expected_launches(arch, update_dtype, full_size=full_size)
    for sym, w in want.items():
        got = hist["by_shape"][sym] if isinstance(w, dict) \
            else hist["launches"][sym]
        total = sum(w.values()) if isinstance(w, dict) else w
        check(got == w and hist["launches"][sym] == total,
              f"{arch} {update_dtype}: {sym} launched {got} "
              f"({hist['launches'][sym]} in all), expected {w}")


# dense train-step cases on the card against the CPU: (arch, overrides) —
# every dense, moe, hybrid and audio registry entry at its reduced() cut
# (the paper transformer at its published size: its cut cannot run),
# minicpm-2b through AdamW's generic accumulation and smollm-135m through
# SGD's fused momentum; arctic-480b with its dense residual branch;
# whisper-base with frames in every batch, internvl2-76b with patches
PHI = "phi3.5-moe-42b-a6.6b"
RG = "recurrentgemma-2b"
WHISPER = "whisper-base"
VLM = "internvl2-76b"
DENSE_CASES = [("smollm-135m", {}), ("tinyllama-1.1b", {}),
               ("codeqwen1.5-7b", {}), ("fedfa-paper-transformer", {}),
               ("minicpm-2b", {"grad_accum": 2}),
               ("smollm-135m", {"grad_accum": 2,
                                "momentum_dtype": "bfloat16"}),
               (PHI, {}), ("arctic-480b", {}), (RG, {}), (WHISPER, {}),
               (VLM, {})]


def numpy_inputs(cfg, batch: int, seed: int) -> dict:
    """The batch entries besides the tokens, at scale 0.02 from a numpy
    generator, as CPU tensors: an encoder-decoder's ``frames`` (batch,
    n_frames, d_model), a vision-language model's ``patches`` (batch,
    n_patches, vit_dim); none for the other families."""
    if cfg.encoder is not None:
        name, shape = "frames", (batch, cfg.encoder.n_frames, cfg.d_model)
    elif cfg.vision is not None:
        name, shape = "patches", (batch, cfg.vision.n_patches,
                                  cfg.vision.vit_dim)
    else:
        return {}
    return {name: torch.from_numpy(0.02 * np.random.default_rng(seed)
                                   .standard_normal(shape, dtype=np.float32))}


def flat_np(tree) -> np.ndarray:
    from repro_torch.tree import leaves
    return np.concatenate([x.detach().float().cpu().numpy().ravel()
                           for x in leaves(tree)])


def above_noise(grads) -> np.ndarray:
    """Where a gradient tree lies above the f32 summation noise of a
    backward pass: |g| > 1e-5 of its leaf's largest magnitude
    (tests/test_torch_dense.py)."""
    from repro_torch.tree import leaves
    out = []
    for g in leaves(grads):
        g = g.abs().float().cpu().numpy().ravel()
        out.append(g > 1e-5 * g.max())
    return np.concatenate(out)


def adamw_step_close(got, want, grads, what: str) -> None:
    """One AdamW step taken on the card from the CPU's state: rtol 1e-3 /
    atol 1e-4 on every element whose CPU gradient lies above the noise.
    AdamW's first step moves each element by the rate times the sign of
    its gradient, so one whose gradient is at the noise may move the other
    way on each device (tests/test_torch_dense.py)."""
    keep = above_noise(grads)
    d = np.abs(got - want)
    out = d > 1e-4 + 1e-3 * np.abs(want)
    log(f"{what}: {int(out.sum())} of {got.size} elements past rtol 1e-3 / "
        f"atol 1e-4, {int((out & keep).sum())} of them above the noise")
    check(not (out & keep).any(), f"{what} differs above the noise")


def adamw_update_close(got, want, start, keep, what: str) -> None:
    """Free-running AdamW steps: on the elements whose first gradient lies
    above the noise (``keep``), the difference within 1e-3 of the update
    in relative L2."""
    rel = float(np.linalg.norm((got - want)[keep])
                / np.linalg.norm(want - start))
    log(f"{what}: relative L2 of the update above the noise {rel:.3g}")
    check(rel <= 1e-3, f"{what} differs past 1e-3 of the update")


def small_dense_check() -> dict:
    """Three train steps (``launch.steps.make_train_step``, steps 1-3: WSD's
    warmup makes step 0's rate 0) of each ``DENSE_CASES`` entry on the card
    and on the CPU from the same weights and tokens (batch 4, sequence
    16; an encoder-decoder's frames or a vision-language model's patches
    from numpy, the same on both): losses
    at rtol 1e-3, SGD's parameters at rtol 1e-3 / atol 1e-4;
    with AdamW, each step also taken on the card from the CPU's state
    (``adamw_step_close``) and the free-running steps held by
    ``adamw_update_close``."""
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic
    from repro_torch.launch import steps
    from repro_torch.models.model import init_params, loss_and_grad
    from repro_torch.optim import init_opt
    from repro_torch.tree import tree_map
    out = {}
    for arch, over in DENSE_CASES:
        cfg = get_arch(arch)
        if arch != "fedfa-paper-transformer":
            cfg = cfg.reduced()
        cfg = cfg.replace(**over)
        params = init_params(cfg, torch.Generator().manual_seed(0))
        data = synthetic.lm_stream(cfg.vocab_size, 12, 16, seed=2)
        extras = [numpy_inputs(cfg, 4, seed=s) for s in range(1, 4)]
        mdt = torch.bfloat16 if cfg.momentum_dtype == "bfloat16" \
            else torch.float32
        adam = cfg.optimizer == "adamw"
        fn = steps.make_train_step(cfg, total_steps=4)
        name = arch + "".join(f" {k}={v}" for k, v in over.items())
        res, cpu_steps = {}, []
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev), params)
            st = init_opt(p, cfg.optimizer, momentum_dtype=mdt)
            losses = []
            for s in range(1, 4):
                tok = torch.as_tensor(data[(s - 1) * 4:s * 4],
                                      dtype=torch.int64, device=dev)
                batch = {"tokens": tok, **{k: v.to(dev) for k, v in
                                           extras[s - 1].items()}}
                if adam and dev == "cpu":   # the state and the gradient
                    cpu_steps.append((p, st, batch, loss_and_grad(
                        p, cfg, batch, task="lm")[1]))
                p, st, loss = fn(p, st, batch, s)
                if adam and dev == "cpu":
                    cpu_steps[-1] += (p,)
                losses.append(float(loss))
            res[dev] = (flat_np(p), losses)
        np.testing.assert_allclose(res["cuda"][1], res["cpu"][1], rtol=1e-3,
                                   err_msg=name)
        if adam:
            to_card = lambda t: tree_map(lambda x: x.cuda(), t)
            for s, (p0, st0, batch, g, p1) in enumerate(cpu_steps, 1):
                forced, _, _ = fn(to_card(p0), {"step": st0["step"],
                                                "m": to_card(st0["m"]),
                                                "v": to_card(st0["v"])},
                                  to_card(batch), s)
                adamw_step_close(flat_np(forced), flat_np(p1), g,
                                 f"dense {name} step {s} from the CPU's state")
            adamw_update_close(res["cuda"][0], res["cpu"][0], flat_np(params),
                               above_noise(cpu_steps[0][3]), f"dense {name}")
        else:
            np.testing.assert_allclose(res["cuda"][0], res["cpu"][0],
                                       rtol=1e-3, atol=1e-4, err_msg=name)
        out[name] = {"cuda": res["cuda"][1], "cpu": res["cpu"][1]}
    return out


def small_tree_check(kernels) -> dict:
    """A per-round round (``server.fl_round``) of the 4-layer smollm-135m
    with ``agg_engine="tree"`` on the card against the same on the CPU
    (losses rtol 1e-3, global rtol 1e-3 / atol 1e-4) and against the
    card's flat engine on the same inputs (rtol 1e-4 / atol 1e-5, the
    oracle's tolerance); then the flat round with ``use_kernel=False`` on
    the card: the kernel round's global at rtol 1e-4 / atol 1e-5 (the
    plain versions sum in another order), and no kernel launched."""
    from repro_torch.core import flat
    from repro_torch.core.round import default_perms
    from repro_torch.core.server import FLConfig, fl_round, make_client_specs
    from repro_torch.data import partition, pipeline, synthetic
    from repro_torch.launch import train
    from repro_torch.models.model import init_params
    from repro_torch.tree import tree_map

    cfg = train.fl_config("smollm-135m", "cls", 10, full_size=False)
    specs = make_client_specs(cfg, 4, archs=train.client_arch_pool(cfg, "both"),
                              malicious_frac=0.25, seed=0)
    parts = partition.iid_partition(4, 10, seed=0)
    profiles = synthetic.make_class_profiles(10, cfg.vocab_size, seed=0)
    b = pipeline.round_batches_cls(parts, list(range(4)), 10, cfg.vocab_size,
                                   local_steps=2, batch=2, seq_len=16,
                                   profiles=profiles, seed=100)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    perms = default_perms(0)(0, 4, 2 * 2)
    index = flat.FlatIndex(params)
    out, launches = {}, {}
    for name, dev, kw in (("tree-cuda", "cuda", {"agg_engine": "tree"}),
                          ("tree-cpu", "cpu", {"agg_engine": "tree"}),
                          ("flat-cuda", "cuda", {}),
                          ("plain-cuda", "cuda", {"use_kernel": False})):
        fl = FLConfig(local_steps=2, lr=0.05, strategy="fedfa", task="cls",
                      **kw)
        for k in kernels:
            k.reset()
        p, loss = fl_round(tree_map(lambda t: t.to(dev), params), cfg, fl,
                           specs, {k: torch.as_tensor(v, dtype=torch.int64,
                                                      device=dev)
                                   for k, v in b.items()},
                           perms=perms.to(dev))
        torch.cuda.synchronize()
        launches[name] = {k.symbol: k.launches for k in kernels}
        out[name] = (flat.flatten(index, tree_map(
            lambda t: t.cpu(), p)).numpy(), float(loss))
    np.testing.assert_allclose(out["tree-cuda"][1], out["tree-cpu"][1],
                               rtol=1e-3)
    np.testing.assert_allclose(out["tree-cuda"][0], out["tree-cpu"][0],
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(out["tree-cuda"][0], out["flat-cuda"][0],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["plain-cuda"][0], out["flat-cuda"][0],
                               rtol=1e-4, atol=1e-5)
    check(launches["flat-cuda"]["scaled_accum"] == 2,
          f"the card's flat round: {launches['flat-cuda']}")
    for name in ("tree-cuda", "plain-cuda"):
        check(not any(launches[name].values()),
              f"{name} launched kernels: {launches[name]}")
    log(f"small tree check: losses { {k: v[1] for k, v in out.items()} }")
    return {k: v[1] for k, v in out.items()}


def small_moe_prefill_check() -> dict:
    """A chunked prefill (``launch.steps.make_prefill_step``) of phi3.5-moe's
    4-layer cut with ``prefill_chunk`` 8 and 2 prompts of 32 tokens (4
    chunks), on the card and on the CPU from the same weights, with the
    default bf16 cache: the logits within one bf16 step of the largest
    real logit (ROADMAP queue 3 item 8), and every MoE call's expert
    choices equal on both, so that the same tokens are dropped (each
    chunk computes its own capacity)."""
    from repro_torch.data import synthetic
    from repro_torch.launch import steps, train
    from repro_torch.models import moe
    from repro_torch.models.model import init_params
    from repro_torch.tree import tree_map
    cfg = train.fl_config(PHI, "cls", 10, full_size=False).replace(
        prefill_chunk=8)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    prompts = synthetic.lm_stream(cfg.vocab_size, 2, 32, seed=0)
    orig, out = moe._top_k, {}
    for dev in ("cuda", "cpu"):
        picks = []

        def rec(gates, k):
            vals, idx = orig(gates, k)
            picks.append(idx.cpu())
            return vals, idx
        moe._top_k = rec
        try:
            with torch.no_grad():
                lg, _ = steps.make_prefill_step(cfg)(
                    tree_map(lambda t: t.to(dev), params),
                    {"tokens": torch.as_tensor(prompts, device=dev)})
        finally:
            moe._top_k = orig
        out[dev] = (lg.float().cpu().numpy(), picks)
    (lg, picks), (want, want_picks) = out["cuda"], out["cpu"]
    check(len(picks) == len(want_picks) == 4 * cfg.n_layers,
          f"phi chunked prefill: {len(picks)} MoE calls on the card, "
          f"{len(want_picks)} on the CPU, expected {4 * cfg.n_layers}")
    check(all(torch.equal(a, b) for a, b in zip(picks, want_picks)),
          "phi chunked prefill: the card's experts differ from the CPU's")
    E, N = cfg.moe.n_experts, 2 * 8
    C = max(1, int(cfg.moe.capacity_factor * cfg.moe.top_k * N / E))
    dropped = sum(int((torch.bincount(p.reshape(-1), minlength=E) - C)
                      .clamp(min=0).sum()) for p in picks)
    real = float(np.abs(want[..., :cfg.vocab_size]).max())
    np.testing.assert_allclose(lg, want, rtol=0, atol=BF16_STEP * real)
    err = float(np.abs(lg - want).max())
    log(f"phi chunked prefill card vs cpu: experts equal, {dropped} "
        f"assignments dropped on each, logits max abs diff {err:.3g}")
    return {"moe_calls": len(picks), "capacity": C, "dropped": dropped,
            "max_abs_diff": err}


def phi_full_width(kernels, card: str):
    """phi3.5-moe at its published width cut to 4 layers (one a section):
    16 experts of d_ff 6,400, d_model 4,096, 32 query and 8 kv heads of
    128, vocabulary 32,064 (32,128 padded), seeded random f32 weights on
    the card, shared by a chunked prefill (``chunked_prefill_path``) and
    serving (``moe_serve_path``).  Returns the results and the kernels
    row."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import init_params
    from repro_torch.tree import leaves
    cfg = get_arch(PHI).replace(n_layers=4)
    collect_garbage()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    out = {"arch": PHI, "n_layers": 4, "n_params": n,
           "weights_gb": n * 4 / 1e9, "init_s": time.perf_counter() - t0,
           "card": card}
    out["prefill"], row = chunked_prefill_path(kernels, cfg, params)
    out["serve"] = moe_serve_path(kernels, cfg, params)
    return out, row


def _offset_recorder(ops, calls: list, check_ref: dict = None):
    """Patch ``ops.attention`` to note each call's q offset (and, with
    ``check_ref``, to hold the first two calls at each offset against
    ``attention_ref`` on the card and keep the first call's inputs);
    returns the original."""
    from repro_torch.kernels.flash_attention import ref
    orig = ops.attention

    def rec(q, k, v, **kw):
        off = kw.get("q_offset", 0)
        calls.append(off)
        out = orig(q, k, v, **kw)
        if check_ref is not None and calls.count(off) <= 2:
            want = ref.attention_ref(q, k, v, **kw)
            err = float((out - want).abs().max())
            torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
            check_ref["err"] = max(check_ref.get("err", 0.0), err)
            check_ref.setdefault("inputs", {}).setdefault(off, (q, k, v))
            del want
        return out
    ops.attention = rec
    return orig


def chunked_prefill_path(kernels, cfg, params) -> tuple:
    """``make_prefill_step`` on 2 prompts of 8,192 tokens in 8 chunks of
    ``prefill_chunk`` 1,024, counts reset just before: fails unless
    ``flash_attention`` ran exactly once per layer and chunk (32 times) at
    q offsets 0, 1,024, ..., 7,168 in chunk order, no other kernel ran, and
    the logits are finite.  Timed twice on the host clock (the second warm)
    with peak memory; then run once more with the first two launches at
    each offset held against ``attention_ref`` (f32 within 2e-5), and the
    kernel timed at each offset on the inputs the path passed it, for its
    ``kernels`` row."""
    from repro_torch.data import synthetic
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import steps
    B, S, chunk = 2, 8192, cfg.prefill_chunk
    tok = torch.as_tensor(synthetic.lm_stream(cfg.vocab_size, B, S, seed=0),
                          device="cuda")
    step = steps.make_prefill_step(cfg)
    want_offsets = [c * chunk for c in range(S // chunk)
                    for _ in range(cfg.n_layers)]
    runs = []
    for run in range(2):
        calls = []
        for k in kernels:
            k.reset()
        collect_garbage()
        torch.cuda.reset_peak_memory_stats()
        orig = _offset_recorder(ops, calls)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                logits, caches = step(params, {"tokens": tok})
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            ops.attention = orig
        launches = {k.symbol: k.launches for k in kernels}
        runs.append({"ms": ms, "peak_gib": torch.cuda.max_memory_allocated()
                     / 2**30, "launches": launches, "offsets": calls})
        check(launches == {k.symbol: len(want_offsets)
                           if k.symbol == "flash_attention" else 0
                           for k in kernels},
              f"phi chunked prefill launches {launches}, expected "
              f"{len(want_offsets)} flash_attention launches")
        check(calls == want_offsets,
              f"phi chunked prefill q offsets {calls}, expected "
              f"{want_offsets}")
        check(logits.shape == (B, 1, cfg.padded_vocab)
              and bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()),
              f"phi chunked prefill logits {tuple(logits.shape)} not finite")
        del logits, caches
    checked, calls = {}, []
    orig = _offset_recorder(ops, calls, checked)
    try:
        with torch.no_grad():
            step(params, {"tokens": tok})
    finally:
        ops.attention = orig
    row = flash_offset_row(checked.pop("inputs"), checked["err"],
                           runs[0]["launches"]["flash_attention"])
    log(f"phi chunked prefill: {runs[1]['ms']:.1f} ms warm, peak "
        f"{runs[1]['peak_gib']:.2f} GiB, flash_attention over the 8 "
        f"offsets {row['ms']:.3f} ms (bound {row['bound_ms']:.3f})")
    return {"batch": B, "prompt_len": S, "chunk": chunk,
            "chunks": S // chunk, "first_run": runs[0], "warm": runs[1],
            "launches": runs[0]["launches"],
            "offsets": sorted(set(runs[0]["offsets"])),
            "kernel_ms": row["ms"], "kernel_bound_ms": row["bound_ms"],
            "checked_launches": 2 * S // chunk,
            "max_abs_err": checked["err"]}, row


def flash_offset_row(inputs: dict, err: float, launches: int) -> dict:
    """The ``kernels`` row of ``flash_attention`` at the chunked prefill's
    shape: the kernel, its plain version and SDPA (with the offset's
    causal mask) timed at every offset on the inputs the path passed it
    and summed over the offsets — one layer's chunks; the bound from the
    bytes each launch must move (q, o, and the keys and values up to its
    last query) and its kept (q, k) pairs, three TF32 products each at the
    TF32 rate."""
    from repro_torch.kernels.flash_attention import ops, ref
    ms = plain_ms = lib_ms = 0.0
    nbytes = products = 0
    for off, (q, k, v) in sorted(inputs.items()):
        B, Sq, H, hd = q.shape
        Sk, K = k.shape[1], k.shape[2]
        kw = dict(causal=True, q_offset=off)
        ms += time_ms(lambda: ops.attention(q, k, v, **kw), 5)
        plain_ms += time_ms(lambda: ref.attention_ref(q, k, v, **kw), 2,
                            warmup=1)
        keep = attention_keep(Sq, Sk, True, None, off)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = torch.as_tensor(keep, device="cuda")
        lib_ms += time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), 2, warmup=1)
        need = min(Sk, off + Sq)
        nbytes += (2 * B * Sq * H + 2 * B * need * K) * hd * 4
        products += 4 * B * H * hd * int(keep.sum())
        shape = [B, Sq, Sk, H, K, hd]
    b, by = bound(nbytes, 3 * products, TF32_OPS_PER_S)
    return {"name": "flash_attention", "dtype": "f32",
            "path": f"{PHI} chunked prefill (4 layers, published width)",
            "shape": shape, "causal": True, "window": None,
            "q_offset": sorted(inputs), "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:68",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": lib_ms}


def moe_serve_path(kernels, cfg, params, batch: int = 2,
                   prompt_len: int = 4096, max_new: int = 16) -> dict:
    """``launch.serve``'s Engine on the full-width model: 2 prompts of
    4,096 tokens, 16 greedy tokens, counts reset just before: fails unless
    ``flash_attention`` ran exactly once per layer, at offset 0 (the
    Engine prefills in one shot), no other kernel ran, and every token is
    in the vocabulary.  The 15 decode steps route 2 tokens each at a
    capacity of max(1, int(1.25·2·2/16)) = 1.  Then a second, warm
    generate."""
    from repro_torch.data import synthetic
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import serve
    eng = serve.Engine(cfg, params, capacity=prompt_len + max_new + 8)
    prompts = synthetic.lm_stream(cfg.vocab_size, batch, prompt_len, seed=1)
    out = {}
    for run in ("first", "warm"):
        calls = []
        for k in kernels:
            k.reset()
        collect_garbage()
        torch.cuda.reset_peak_memory_stats()
        orig = _offset_recorder(ops, calls)
        try:
            tok = eng.generate(prompts, max_new=max_new)
        finally:
            ops.attention = orig
        launches = {k.symbol: k.launches for k in kernels}
        check(launches == {k.symbol: cfg.n_layers if k.symbol ==
                           "flash_attention" else 0 for k in kernels}
              and calls == [0] * cfg.n_layers,
              f"phi serving launches {launches} at offsets {calls}")
        check(tok.shape == (batch, max_new)
              and bool(((tok >= 0) & (tok < cfg.vocab_size)).all()),
              f"phi serving tokens {tok.shape} out of [0, {cfg.vocab_size})")
        t = eng.timing
        out[run] = {"prefill_ms": t["prefill_s"] * 1e3,
                    "decode_ms_per_step": t["decode_s"] * 1e3
                    / t["decode_steps"],
                    "tokens_per_s": batch * max_new
                    / (t["prefill_s"] + t["decode_s"]),
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "launches": launches}
    log(f"phi serving: prefill {out['warm']['prefill_ms']:.1f} ms, decode "
        f"{out['warm']['decode_ms_per_step']:.2f} ms a step, "
        f"{out['warm']['tokens_per_s']:.1f} tokens/s warm")
    return {"batch": batch, "prompt_len": prompt_len, "max_new": max_new,
            **out}


def hybrid_full_size(kernels, card: str, batch: int = 2,
                     prompt_len: int = 4096, max_new: int = 32) -> tuple:
    """recurrentgemma-2b at its published size (26 layers, d_model 2,560,
    10 query heads and 1 kv head of 256, window 2,048, vocabulary 256,000;
    3,549,934,080 parameters), seeded random f32 weights drawn on the card,
    served by ``launch.serve``'s Engine: 2 prompts of 4,096 tokens and 32
    greedy tokens, counts reset just before each request: fails unless
    ``flash_attention`` ran exactly once per attention layer (8 times), at
    hd 256 and window 2,048, no other kernel ran, and every token is in the
    vocabulary.  Timed twice (the second warm), then a prefill alone with
    the first two launches held against ``attention_ref`` on the card (f32
    within 2e-5), whose first launch's inputs feed ``flash_rows``.
    Floors: a decode step reads the 14.2 GB of f32 weights once, 4.2 ms at
    3.35 TB/s; the prefill's f32 GEMMs are 36.7 TFLOP, 0.55 s at 67
    TFLOP/s."""
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import init_params
    from repro_torch.tree import leaves
    cfg = get_arch(RG)
    n_attn = sum(unit.count("attn") * reps for unit, reps in cfg.stages())
    collect_garbage()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    check(n == 3_549_934_080, f"{RG} has {n} parameters")
    out = {"arch": RG, "n_params": n, "weights_gb": n * 4 / 1e9,
           "init_s": time.perf_counter() - t0, "batch": batch,
           "prompt_len": prompt_len, "max_new": max_new, "card": card}
    eng = serve.Engine(cfg, params, capacity=prompt_len + max_new + 8)
    prompts = synthetic.lm_stream(cfg.vocab_size, batch, prompt_len, seed=1)
    orig = ops.attention
    for run in ("first", "warm"):
        calls = []

        def rec(q, k, v, **kw):
            calls.append((q.shape[-1], kw.get("window"), kw.get("q_offset")))
            return orig(q, k, v, **kw)
        for k in kernels:
            k.reset()
        collect_garbage()
        torch.cuda.reset_peak_memory_stats()
        ops.attention = rec
        try:
            tok = eng.generate(prompts, max_new=max_new)
        finally:
            ops.attention = orig
        launches = {k.symbol: k.launches for k in kernels}
        check(launches == {k.symbol: n_attn if k.symbol == "flash_attention"
                           else 0 for k in kernels}
              and calls == [(256, 2048, 0)] * n_attn,
              f"{RG} serving launches {launches}, calls {calls}")
        check(tok.shape == (batch, max_new)
              and bool(((tok >= 0) & (tok < cfg.vocab_size)).all()),
              f"{RG} serving tokens {tok.shape} out of [0, {cfg.vocab_size})")
        t = eng.timing
        out[run] = {"prefill_ms": t["prefill_s"] * 1e3,
                    "decode_ms_per_step": t["decode_s"] * 1e3
                    / t["decode_steps"],
                    "tokens_per_s": batch * max_new
                    / (t["prefill_s"] + t["decode_s"]),
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "launches": launches}
    checked, offsets = {}, []
    orig = _offset_recorder(ops, offsets, checked)
    try:
        eng.generate(prompts, max_new=1)
    finally:
        ops.attention = orig
    out["checked_launches"] = min(2, len(offsets))
    out["max_abs_err"] = checked["err"]
    log(f"{RG} serving 2 x {prompt_len}: prefill "
        f"{out['warm']['prefill_ms']:.1f} ms, decode "
        f"{out['warm']['decode_ms_per_step']:.2f} ms a step, "
        f"{out['warm']['tokens_per_s']:.1f} tokens/s warm, peak "
        f"{out['warm']['peak_gib']:.2f} GiB")
    return out, checked["inputs"][0], out["first"]["launches"][
        "flash_attention"]


def small_family_check(arch: str) -> dict:
    """``arch`` at ``reduced()`` on the card and on the CPU, same weights,
    tokens and numpy inputs (whisper-base: 2 layers, d_model 256, 64
    frames; internvl2-76b: 16 patches of width 128 in front of the
    tokens): ``forward``'s logits and ``loss_fn``'s loss at widths 1 and
    0.5 (rtol 1e-3 / atol 1e-4, vocabulary padding aside)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic
    from repro_torch.models.masks import width_masks
    from repro_torch.models.model import forward, init_params, loss_fn
    from repro_torch.tree import tree_map
    cfg = get_arch(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tok = torch.as_tensor(synthetic.lm_stream(cfg.vocab_size, 4, 32, seed=3),
                          dtype=torch.int64)
    extras = numpy_inputs(cfg, 4, seed=3)
    out = {}
    for w in (1.0, 0.5):
        res = {}
        for dev in ("cuda", "cpu"):
            batch = {"tokens": tok.to(dev),
                     **{k: v.to(dev) for k, v in extras.items()}}
            kw = dict(masks=width_masks(cfg, w).to(dev))
            p = tree_map(lambda t: t.to(dev), params)
            with torch.no_grad():
                logits = forward(p, cfg, batch, **kw)[0]
                loss = loss_fn(p, cfg, batch, task="lm", **kw)[0]
            res[dev] = (logits[..., :cfg.vocab_size].cpu().numpy(),
                        float(loss))
        np.testing.assert_allclose(res["cuda"][0], res["cpu"][0], rtol=1e-3,
                                   atol=1e-4, err_msg=f"{arch} logits w={w}")
        np.testing.assert_allclose(res["cuda"][1], res["cpu"][1], rtol=1e-3,
                                   err_msg=f"{arch} loss w={w}")
        out[f"w={w}"] = {"loss_cuda": res["cuda"][1],
                         "loss_cpu": res["cpu"][1],
                         "logits_max_abs_diff": float(np.abs(
                             res["cuda"][0] - res["cpu"][0]).max())}
    return out


def audio_full_size(kernels, card: str, batch: int = 8,
                    prompt_len: int = 4096, max_new: int = 32) -> tuple:
    """whisper-base at its published size (6 + 6 layers, d_model 512, 8
    heads of 64, vocabulary 51,865, a ``pos_embed`` of 65,536 rows;
    130,873,344 parameters), seeded random f32 weights drawn on the card,
    served by ``launch.serve``'s Engine: 8 prompts of 4,096 tokens against
    1,500 numpy frames each and 32 greedy tokens, counts reset just before
    each request.  Fails unless ``flash_attention`` ran exactly 12 times,
    all in prefill — once a decoder layer causal at (4,096, 4,096) and once
    non-causal at (4,096, 1,500) (the encoder's 1,500² stays dense, below
    2048², and decode's single query never takes it) — no other kernel
    ran, and every token is in the vocabulary.  Timed twice (the second
    warm), then a prefill alone with the first launch of each kind held
    against ``attention_ref`` on the card (f32 within 2e-5), whose inputs
    feed ``flash_rows``.  Floors: a decode step reads ≈ 0.28 GB of
    f32 weights (all but the embedding and position tables) and recomputes
    the cross k and v (75 GFLOP), 1.1 ms at 67 TFLOP/s; the prefill's f32
    GEMMs are 1.97 TFLOP (encoder 0.45, decoder 1.44 with its cross q and
    o, the cross k and v 0.08), 29 ms at 67 TFLOP/s."""
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.launch import serve
    from repro_torch.models.model import init_params
    from repro_torch.tree import leaves
    cfg = get_arch(WHISPER)
    T = cfg.encoder.n_frames
    collect_garbage()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    check(n == 130_873_344, f"{WHISPER} has {n} parameters")
    out = {"arch": WHISPER, "n_params": n, "weights_gb": n * 4 / 1e9,
           "init_s": time.perf_counter() - t0, "batch": batch,
           "prompt_len": prompt_len, "max_new": max_new, "n_frames": T,
           "card": card}
    eng = serve.Engine(cfg, params, capacity=prompt_len + max_new + 8)
    prompts = synthetic.lm_stream(cfg.vocab_size, batch, prompt_len, seed=1)
    frames = numpy_inputs(cfg, batch, seed=1)["frames"]
    kinds = {(prompt_len, prompt_len, True): cfg.n_layers,
             (prompt_len, T, False): cfg.n_layers}
    orig = ops.attention
    for run in ("first", "warm"):
        calls = []

        def rec(q, k, v, **kw):
            calls.append((q.shape[1], k.shape[1], kw.get("causal", True)))
            return orig(q, k, v, **kw)
        for k in kernels:
            k.reset()
        collect_garbage()
        torch.cuda.reset_peak_memory_stats()
        ops.attention = rec
        try:
            tok = eng.generate(prompts, max_new=max_new, frames=frames)
        finally:
            ops.attention = orig
        launches = {k.symbol: k.launches for k in kernels}
        by_kind = {key: calls.count(key) for key in set(calls)}
        check(launches == {k.symbol: 2 * cfg.n_layers
                           if k.symbol == "flash_attention" else 0
                           for k in kernels} and by_kind == kinds,
              f"{WHISPER} serving launches {launches}, by (Sq, Sk, causal) "
              f"{by_kind}, expected {kinds}")
        check(tok.shape == (batch, max_new)
              and bool(((tok >= 0) & (tok < cfg.vocab_size)).all()),
              f"{WHISPER} serving tokens {tok.shape} out of "
              f"[0, {cfg.vocab_size})")
        t = eng.timing
        out[run] = {"prefill_ms": t["prefill_s"] * 1e3,
                    "decode_ms_per_step": t["decode_s"] * 1e3
                    / t["decode_steps"],
                    "tokens_per_s": batch * max_new
                    / (t["prefill_s"] + t["decode_s"]),
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "launches": launches,
                    "launches_by_kind": [[list(key), c]
                                         for key, c in sorted(by_kind.items())]}
    inputs, errs = {}, []

    def check_first(q, k, v, **kw):
        o = orig(q, k, v, **kw)
        key = kw.get("causal", True)
        if key not in inputs:
            want = ref.attention_ref(q, k, v, **kw)
            torch.testing.assert_close(o, want, rtol=2e-5, atol=2e-5)
            errs.append(float((o - want).abs().max()))
            inputs[key] = (q, k, v)
            del want
        return o
    ops.attention = check_first
    try:
        eng.generate(prompts, max_new=1, frames=frames)
    finally:
        ops.attention = orig
    check(set(inputs) == {True, False},
          f"{WHISPER} prefill kinds {sorted(inputs)}")
    out["checked_launches"], out["max_abs_err"] = len(errs), max(errs)
    log(f"{WHISPER} serving {batch} x {prompt_len} against {T} frames: "
        f"prefill {out['warm']['prefill_ms']:.1f} ms, decode "
        f"{out['warm']['decode_ms_per_step']:.2f} ms a step, "
        f"{out['warm']['tokens_per_s']:.1f} tokens/s warm, peak "
        f"{out['warm']['peak_gib']:.2f} GiB")
    return out, inputs, cfg.n_layers


def audio_aggregation(kernels, card: str, m: int = 8) -> tuple:
    """The aggregation engine on an m = 8 cohort of full-size whisper-base
    trees (8 x 130,873,344 f32, 4.2 GB): ``flat.aggregate_buffers``, fedfa,
    the clients of the ``both`` pool (widths 0.25-1, section depths 1-2 of
    (2, 2, 1, 1): grafting fills stage 0's missing rows, never the
    encoder's), twice, counts reset just before.  No FL driver: ``run_fl``
    raises for whisper, as the reference fails (ROADMAP queue 3 item 25).
    Fails unless every kernel ran exactly its launches by shape, derived
    from the layout beforehand as ``fl_expected_launches`` derives them
    (``main_path_shapes``: a ``quantile_fused`` per single-pass leaf, four
    ``hist_level`` levels per longer leaf, two ``scaled_accum`` an
    aggregation) and the result is finite; the first aggregation's kernel
    arguments are recorded for ``fl_path_kernel_rows`` and the second
    aggregation is timed."""
    from repro_torch.core import flat
    from repro_torch.kernels.fedfa_agg import ops as agg_ops
    from repro_torch.kernels.fedfa_quantile import multilevel, ops
    from repro_torch.launch import train
    from repro_torch.models.masks import stack_masks
    from repro_torch.models.model import init_params
    cfg = train.fl_config(WHISPER, "cls", 10, full_size=True)
    n, single, multi = main_path_shapes(m, WHISPER)
    want = fl_expected_launches(WHISPER, "f32", m=m)
    gen = torch.Generator(device="cuda").manual_seed(2)
    collect_garbage()
    params = init_params(cfg, gen)
    index = flat.FlatIndex(params)
    check(index.n == n, f"{WHISPER} flat layout {index.n} != {n}")
    g = flat.flatten(index, params)
    del params
    x = g[None] + 0.01 * torch.randn((m, n), generator=gen, device="cuda")
    pool = train.client_arch_pool(cfg, "both")
    archs = [pool[c % len(pool)] for c in range(m)]
    masks = stack_masks([a.masks(cfg) for a in archs]).to("cuda")
    gates = torch.stack([a.gates(cfg) for a in archs]).cuda()
    gmaps = torch.stack([a.graft(cfg) for a in archs]).cuda()
    n_data = torch.arange(1, m + 1, dtype=torch.float32, device="cuda")
    spec = {"quantile_fused": (ops, sum(single.values()), None),
            "row_trimmed_stats_multilevel": (multilevel, sum(multi.values()),
                                             "cpu"),
            "scaled_accum": (agg_ops, 2, "cpu")}
    calls = {name: [] for name in spec}
    calls["ssd_intra_chunk"] = []
    for k in kernels:
        k.reset()
    torch.cuda.reset_peak_memory_stats()
    origs = {name: recording(mod, name, limit, calls[name], to)
             for name, (mod, limit, to) in spec.items()}
    try:
        new = flat.aggregate_buffers(index, g, x, cfg, masks, gates, gmaps,
                                     n_data)
        torch.cuda.synchronize()
    finally:
        for name, (mod, *_) in spec.items():
            setattr(mod, name, origs[name])
    t0 = time.perf_counter()
    new = flat.aggregate_buffers(index, g, x, cfg, masks, gates, gmaps, n_data)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    hist = {"launches": {k.symbol: k.launches for k in kernels},
            "by_shape": {k.symbol: dict(k.by_shape) for k in kernels},
            "calls": calls}
    check(bool(torch.isfinite(new).all()), f"{WHISPER} aggregate not finite")
    for sym, w in want.items():
        got = hist["by_shape"][sym] if isinstance(w, dict) \
            else hist["launches"][sym]
        total = sum(w.values()) if isinstance(w, dict) else w
        check(got == w and hist["launches"][sym] == total,
              f"{WHISPER} aggregation: {sym} launched {got} "
              f"({hist['launches'][sym]} in all), expected {w}")
    res = {"arch": WHISPER, "m": m, "n": n, "aggregations": 2,
           "aggregate_ms": ms,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": hist["launches"],
           "launches_by_shape": {
               sym: [[list(shape), c] for shape, c in by.items()]
               for sym, by in hist["by_shape"].items() if by},
           "card": card}
    del x, g, new
    log(f"{WHISPER} aggregation, m = {m}: {ms:.1f} ms, launches "
        f"{hist['launches']}")
    return res, hist


def vlm_full_width(kernels, card: str, batch: int = 2,
                   prompt_len: int = 3072, max_new: int = 32) -> tuple:
    """internvl2-76b at its published width cut to 2 layers (d_model 8,192,
    64 query and 8 kv heads of 128, d_ff 28,672, vocabulary 128,256, 1,024
    patches of width 3,200; 3,905,986,560 parameters), seeded random f32
    weights drawn on the card, served by ``launch.serve``'s Engine: 2
    prompts of 3,072 tokens behind 1,024 numpy patches each (4,096
    positions) and 32 greedy tokens, counts reset just before each
    request.  Fails unless ``flash_attention`` ran exactly twice, once a
    layer, at q (2, 4096, 64, 128) against k, v (2, 4096, 8, 128) causal,
    no other kernel ran, and every token is in the vocabulary.  Timed twice
    (the second warm), then a prefill alone (the same 2 launches, so decode
    launched none) with the first launch held against ``attention_ref`` on
    the card (f32 within 2e-5), whose inputs feed ``flash_rows``.
    Floors: a decode step reads the layers' 6.85 GB of f32 weights and
    ``lm_head``'s 4.2 GB, 3.3 ms at 3.35 TB/s; the prefill's f32 GEMMs are
    28.4 TFLOP, 0.42 s at 67 TFLOP/s."""
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.launch import serve
    from repro_torch.launch.steps import _prefill_capacity
    from repro_torch.models.model import init_params
    from repro_torch.tree import leaves
    cfg = get_arch(VLM).replace(n_layers=2)
    P = cfg.vision.n_patches
    collect_garbage()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    check(n == 3_905_986_560, f"{VLM} has {n} parameters")
    out = {"arch": VLM, "n_layers": cfg.n_layers, "n_params": n,
           "weights_gb": n * 4 / 1e9, "init_s": time.perf_counter() - t0,
           "batch": batch, "n_patches": P, "prompt_len": prompt_len,
           "max_new": max_new, "card": card}
    prompts = synthetic.lm_stream(cfg.vocab_size, batch, prompt_len, seed=1)
    patches = numpy_inputs(cfg, batch, seed=1)["patches"].numpy()
    eng = serve.Engine(cfg, params, capacity=_prefill_capacity(
        cfg, {"tokens": prompts}) + max_new + 8)
    S = P + prompt_len
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    want_calls = [((batch, S, H, hd), (batch, S, K, hd), True)] * cfg.n_layers
    orig = ops.attention

    def run(max_new_, check_first=None):
        calls = []

        def rec(q, k, v, **kw):
            calls.append((tuple(q.shape), tuple(k.shape),
                          kw.get("causal", True)))
            o = orig(q, k, v, **kw)
            if check_first is not None and len(calls) == 1:
                want = ref.attention_ref(q, k, v, **kw)
                torch.testing.assert_close(o, want, rtol=2e-5, atol=2e-5)
                check_first.update(err=float((o - want).abs().max()),
                                   inputs=(q, k, v))
                del want
            return o
        for k in kernels:
            k.reset()
        collect_garbage()
        torch.cuda.reset_peak_memory_stats()
        ops.attention = rec
        try:
            tok = eng.generate(prompts, max_new=max_new_, patches=patches)
        finally:
            ops.attention = orig
        launches = {k.symbol: k.launches for k in kernels}
        check(launches == {k.symbol: cfg.n_layers
                           if k.symbol == "flash_attention" else 0
                           for k in kernels} and calls == want_calls,
              f"{VLM} serving launches {launches}, calls {calls}")
        check(tok.shape == (batch, max_new_)
              and bool(((tok >= 0) & (tok < cfg.vocab_size)).all()),
              f"{VLM} serving tokens {tok.shape} out of "
              f"[0, {cfg.vocab_size})")
        return launches, calls

    for name in ("first", "warm"):
        launches, calls = run(max_new)
        t = eng.timing
        out[name] = {"prefill_ms": t["prefill_s"] * 1e3,
                     "decode_ms_per_step": t["decode_s"] * 1e3
                     / t["decode_steps"],
                     "tokens_per_s": batch * max_new
                     / (t["prefill_s"] + t["decode_s"]),
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "launches": launches,
                     "launches_by_shape": [[list(q), list(k), c, n] for
                                           (q, k, c), n in
                                           collections.Counter(
                                               calls).items()]}
    first = {}
    out["prefill_launches"] = run(1, first)[0]["flash_attention"]
    out["decode_launches"] = (out["first"]["launches"]["flash_attention"]
                              - out["prefill_launches"])
    out["max_abs_err"] = first["err"]
    log(f"{VLM} serving {batch} x ({P} patches + {prompt_len}), "
        f"{cfg.n_layers} layers: prefill {out['warm']['prefill_ms']:.1f} ms, "
        f"decode {out['warm']['decode_ms_per_step']:.2f} ms a step, "
        f"{out['warm']['tokens_per_s']:.1f} tokens/s warm, peak "
        f"{out['warm']['peak_gib']:.2f} GiB")
    # the model goes before the kernel rows: attention_ref at this shape
    # builds (2, 64, 4096, 4096) f32 scores, 8.6 GB
    del eng, params
    collect_garbage()
    return out, first["inputs"], out["first"]["launches"]["flash_attention"]


def flash_rows(inputs, launches: int, path: str, *, causal: bool = True,
               window=None) -> list:
    """``flash_attention`` on the inputs a path passed it: f32 as the path
    ran them and the same values in bf16, against ``attention_ref`` (2e-5,
    5e-2), f32 also within 1e-5 of its 3xTF32 emulation on the first
    sequence; the kernel, the plain version and SDPA (``enable_gqa`` where
    H > K; the window as a boolean mask, else ``is_causal``) timed.  The
    bound counts the kept (q, k) pairs, three TF32 products each for f32
    and one bf16 product for bf16, and q, k, v and o once."""
    from repro_torch.kernels.flash_attention import ops, ref
    out = []
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(dt) for t in inputs)
        B, Sq, H, hd = q.shape
        Sk, K = k.shape[1], k.shape[2]
        kw = dict(causal=causal, window=window)
        got = ops.attention(q, k, v, **kw).float()
        want = ref.attention_ref(q, k, v, **kw).float()
        tol = 2e-5 if dt == torch.float32 else 5e-2
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        err, split_err = float((got - want).abs().max()), None
        del want
        if dt == torch.float32:
            emul = ref.attention_split_tf32_ref(q[:1], k[:1], v[:1], **kw)
            torch.testing.assert_close(got[:1], emul, rtol=1e-5, atol=1e-5)
            split_err = float((got[:1] - emul).abs().max())
            del emul
        del got
        keep = attention_keep(Sq, Sk, causal, window)
        products = 4 * B * H * hd * int(keep.sum())
        b, by = bound(2 * B * (Sq * H + Sk * K) * hd * q.element_size(),
                      *((3 * products, TF32_OPS_PER_S)
                        if dt == torch.float32
                        else (products, BF16_OPS_PER_S)))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa_kw = (dict(attn_mask=torch.as_tensor(keep, device="cuda"))
                   if window is not None else dict(is_causal=causal))
        out.append({
            "name": "flash_attention",
            "dtype": "f32" if dt == torch.float32 else "bf16",
            "path": path, "shape": [B, Sq, Sk, H, K, hd], "causal": causal,
            "window": window, "q_offset": 0, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:68",
            "launches": launches if dt == torch.float32 else 0,
            "max_abs_err": err, "max_abs_err_vs_3xtf32": split_err,
            "ms": time_ms(lambda: ops.attention(q, k, v, **kw), 10),
            "plain_ms": time_ms(lambda: ref.attention_ref(q, k, v, **kw), 2,
                                warmup=1),
            "bound_ms": b, "bound_by": by,
            "library_ms": time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, enable_gqa=H != K, **sdpa_kw), 5,
                warmup=1)})
        log(f"flash_attention {list(q.shape)} over {K} kv heads "
            f"{out[-1]['dtype']}: {out[-1]['ms']:.3f} ms (bound {b:.3f}, "
            f"plain {out[-1]['plain_ms']:.2f}, SDPA "
            f"{out[-1]['library_ms']:.3f})")
        del q, k, v, qt, kt, vt, sdpa_kw
    return out


def nas_card_vs_cpu() -> dict:
    """The client-side NAS on the card and on the CPU, on
    ``examples/nas_client_selection``'s setup (the same weights and probe
    batches on both): ``zico_score`` of three architectures (full, half
    width and depth, and 0.75 with one repeat off) at rtol 1e-3, and
    ``evolutionary_search`` (population 6, generations 2, seed 0) picking
    the same architecture."""
    from repro_torch.core import nas
    from repro_torch.examples import nas_client_selection
    from repro_torch.models.masks import ClientArch
    archs = [ClientArch(1.0, (2, 2)), ClientArch(0.5, (1, 1)),
             ClientArch(0.75, (1, 2))]
    res = {}
    for dev in ("cuda", "cpu"):
        cfg, params, batches = nas_client_selection.setup(dev)
        t0 = time.perf_counter()
        scores = [nas.zico_score(cfg, a, params, batches) for a in archs]
        best = nas.evolutionary_search(cfg, params, batches, population=6,
                                       generations=2, seed=0)
        res[dev] = (scores, best, time.perf_counter() - t0)
    np.testing.assert_allclose(res["cuda"][0], res["cpu"][0], rtol=1e-3,
                               err_msg="zico_score card vs cpu")
    check(res["cuda"][1] == res["cpu"][1],
          f"NAS picked {res['cuda'][1]} on the card, {res['cpu'][1]} on the "
          "CPU")
    best = res["cuda"][1]
    return {"zico_cuda": res["cuda"][0], "zico_cpu": res["cpu"][0],
            "best": [best.width_mult, list(best.section_depths)],
            "seconds_cuda": res["cuda"][2], "seconds_cpu": res["cpu"][2]}


def quickstart_on_card(kernels) -> dict:
    """``examples/quickstart``'s ``main`` on the card (one FedFA round of
    four mixed clients through the aggregation kernels), its printed lines
    kept off standard output, counts reset just before.  Its ``fl_round``
    call is run twice more on the same inputs: on the card with
    ``use_kernel=False`` (the global at rtol 1e-4 / atol 1e-5, the plain
    versions sum in another order; no kernel launched) and on the CPU
    (loss rtol 1e-3, global rtol 1e-3 / atol 1e-4, as in
    ``small_tree_check``).  Fails unless the kernel round launched exactly
    ``scaled_accum`` twice (M' and Γ) and one ``quantile_fused`` a leaf at
    its row shape (m = 4; every row fits one pass), its printed loss is
    its loss and depth slot 1 moved."""
    import contextlib
    import dataclasses
    import io
    from repro_torch.core import flat
    from repro_torch.examples import quickstart
    from repro_torch.tree import tree_map
    orig, seen = quickstart.fl_round, {}

    def rec(params, cfg, fl, specs, batches, **kw):
        p, loss = orig(params, cfg, fl, specs, batches, **kw)
        torch.cuda.synchronize()
        seen.update(cfg=cfg, m=len(specs), index=flat.FlatIndex(params),
                    launches={k.symbol: k.launches for k in kernels},
                    by_shape={k.symbol: dict(k.by_shape) for k in kernels})
        seen["cuda"] = (p, loss)
        seen["plain"] = orig(params, cfg, dataclasses.replace(
            fl, use_kernel=False), specs, batches, **kw)
        seen["cpu"] = orig(tree_map(lambda t: t.cpu(), params), cfg, fl,
                           specs, {k: v.cpu() for k, v in batches.items()},
                           **kw)
        return p, loss

    for k in kernels:
        k.reset()
    buf = io.StringIO()
    quickstart.fl_round = rec
    try:
        with contextlib.redirect_stdout(buf):
            res = quickstart.main(["--device", "cuda"])
    finally:
        quickstart.fl_round = orig
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in kernels}
    lines = buf.getvalue().splitlines()
    log("quickstart: " + " | ".join(lines))
    check(launches == seen["launches"],
          f"quickstart's plain and CPU rounds launched kernels: {launches} "
          f"after the kernel round's {seen['launches']}")
    _, single, multi = fl_row_shapes(seen["cfg"], seen["m"])
    want = {"scaled_accum": 2, "quantile_fused": sum(single.values()),
            "hist_level": 4 * sum(multi.values())}
    got = {k: v for k, v in launches.items() if v}
    check(got == {k: v for k, v in want.items() if v}
          and seen["by_shape"]["quantile_fused"] == single,
          f"quickstart launches {got} by shape "
          f"{seen['by_shape']['quantile_fused']}, expected {want} by shape "
          f"{single}")
    index = seen["index"]
    g = {n: flat.flatten(index, tree_map(lambda t: t.cpu(),
                                         seen[n][0])).numpy()
         for n in ("cuda", "plain", "cpu")}
    np.testing.assert_allclose(g["plain"], g["cuda"], rtol=1e-4, atol=1e-5,
                               err_msg="quickstart: plain round vs kernels")
    np.testing.assert_allclose(g["cpu"], g["cuda"], rtol=1e-3, atol=1e-4,
                               err_msg="quickstart: CPU round vs card")
    np.testing.assert_allclose(float(seen["cpu"][1]), res["loss"], rtol=1e-3,
                               err_msg="quickstart: CPU loss vs card")
    said = [ln for ln in lines if ln.startswith("round done")]
    check(np.isfinite(res["loss"]) and res["delta_wq1"] > 0
          and said == [f"round done; mean local loss {res['loss']:.3f}"],
          f"quickstart on the card: loss {res['loss']}, lines {lines}")
    return {"loss": res["loss"], "loss_cpu": float(seen["cpu"][1]),
            "delta_embed": res["delta_embed"], "delta_wq1": res["delta_wq1"],
            "max_abs_diff_plain": float(np.abs(g["plain"] - g["cuda"]).max()),
            "max_abs_diff_cpu": float(np.abs(g["cpu"] - g["cuda"]).max()),
            "launches": got}


def dense_path(kernels, steps: int = 10) -> dict:
    """``run_dense("smollm-135m", full_size=True)`` at batch 8 x sequence
    64 for 1 + ``steps`` steps (counts reset just before): finite losses,
    no kernel launched (dense attention at 64 tokens), peak memory, and ms
    per step on the host clock as the difference between that run and a
    1-step run (both after a 1-step run that warms the libraries up), so
    that neither the set-up (weights drawn on the CPU) nor the first step
    counts."""
    from repro_torch.launch import train

    def run(n):
        t0 = time.perf_counter()
        res = train.run_dense("smollm-135m", n, 8, 64, full_size=True,
                              device="cuda")
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    run(1)
    _, one = run(1)
    for k in kernels:
        k.reset()
    collect_garbage()
    torch.cuda.reset_peak_memory_stats()
    res, seconds = run(1 + steps)
    launches = {k.symbol: k.launches for k in kernels}
    check(len(res["losses"]) == 1 + steps
          and bool(np.all(np.isfinite(res["losses"]))),
          f"dense path losses {res['losses']}")
    check(not any(launches.values()), f"the dense path launched {launches}")
    return {"arch": "smollm-135m", "steps": 1 + steps, "batch": 8,
            "seq_len": 64, "losses": res["losses"],
            "ms_per_step": (seconds - one) / steps * 1e3,
            "run_s": seconds, "one_step_run_s": one,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": launches,
            "minicpm-2b_full_size": dense_state_estimate("minicpm-2b")}


def achieved_rates(dense: dict, prefill: dict, card: str) -> dict:
    """``launch.costs.step_flops`` (the reference's analytic model) of the
    dense path's step (smollm-135m, a train step of 8 x 64) and of the
    smollm-135m 8 x 4,096 prefill, over the times those phases measured:
    the achieved TFLOP/s of each, the prefill's cold and warm.  The
    model's count puts the lm head at every position; ``prefill`` computes
    logits at the last one only, so the prefill's rate divides the count
    less the head at the other B·(S − 1) positions (``model_flops`` keeps
    the whole count)."""
    from repro_torch.configs import SMOLLM_135M
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import costs
    cfg = SMOLLM_135M
    train = costs.step_flops(cfg, InputShape(
        "dense", dense["seq_len"], dense["batch"], "train"))
    B, S = prefill["batch"], prefill["prompt_len"]
    model_pre = costs.step_flops(cfg, InputShape("prefill", S, B, "prefill"))
    pre = model_pre - 2.0 * B * (S - 1) * cfg.d_model * cfg.padded_vocab
    check((prefill["arch"], prefill["batch"], prefill["prompt_len"])
          == ("smollm-135m", 8, 4096), "achieved rate: not the 8 x 4,096 "
          "smollm-135m prefill")
    rate = lambda flops, ms: flops / (ms * 1e-3) / 1e12
    return {"card": card, "dense_step": {
        "flops": train, "ms": dense["ms_per_step"],
        "tflop_per_s": rate(train, dense["ms_per_step"])},
        "prefill_8x4096": {
            "flops": pre, "model_flops": model_pre,
            "ms": prefill["prefill_ms"],
            "tflop_per_s": rate(pre, prefill["prefill_ms"]),
            "warm_ms": prefill["warm"]["prefill_ms"],
            "warm_tflop_per_s": rate(pre, prefill["warm"]["prefill_ms"])}}


def dense_state_estimate(arch: str) -> dict:
    """What a full-size dense AdamW step of ``arch`` holds at its peak,
    counted from the parameter shapes (nothing allocated): f32 params,
    grads, m and v, and the update's new params, m and v before the old
    trees are freed — seven parameter-sized f32 trees, activations
    aside."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import _is_shape, param_shapes
    from repro_torch.tree import leaves_with_path
    n = sum(int(np.prod(sh)) for _, sh in leaves_with_path(
        param_shapes(get_arch(arch)), is_leaf=_is_shape))
    return {"params": n, "trees_gb": 7 * 4 * n / 1e9}


def round_timing(update_dtype: str, arch: str = "smollm-135m",
                 full_size: bool = True):
    """Local training, admission and aggregation of one resident round of
    ``arch`` (full size, or the CLI's 4-layer cut; CUDA events), and the
    round's peak memory."""
    from repro_torch.launch import profile
    collect_garbage()
    r = profile.full_round(8, device="cuda", update_dtype=update_dtype,
                           arch=arch, full_size=full_size)
    out = {"arch": arch, "update_dtype": update_dtype, "full_size": full_size,
           "n_params": r["index"].n, "m": 8, **profile.breakdown(r)}
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


def model_index(arch: str = "smollm-135m", pad_to: int = 1):
    """The FlatIndex of full-size ``arch``, from shapes alone (N padded to
    a multiple of ``pad_to``)."""
    from repro_torch.core import flat
    from repro_torch.launch import train
    from repro_torch.models.transformer import _is_shape, param_shapes
    from repro_torch.tree import from_paths, leaves_with_path
    cfg = train.fl_config(arch, "cls", 10, full_size=True)
    leaves = list(leaves_with_path(param_shapes(cfg), is_leaf=_is_shape))
    return flat.FlatIndex(from_paths(
        [p for p, _ in leaves],
        [torch.empty(s, device="meta") for _, s in leaves]), pad_to=pad_to)


def main_path_shapes(m: int, arch: str = "smollm-135m",
                     full_size: bool = True):
    """``fl_row_shapes`` of ``arch``'s FL path at full size (smollm-135m's
    is the main path), or at the CLI's 4-layer cut."""
    from repro_torch.launch import train
    return fl_row_shapes(train.fl_config(arch, "cls", 10,
                                         full_size=full_size), m)


def fl_row_shapes(cfg, m: int):
    """(N, single-pass row shapes, multilevel row shapes) of an FL round of
    ``m`` clients of ``cfg``: each leaf's rows (m·lead, rest; the decoder's
    and the encoder's depth-stacked leaves a row per layer), split by the
    JAX dispatch rule; each as {shape: number of leaves}, smallest first."""
    from repro_torch.core.flat import _path_stage_info
    from repro_torch.kernels.fedfa_quantile.ops import _LANES, _SINGLE_PASS_ELEMS
    from repro_torch.models.transformer import _is_shape, param_shapes
    from repro_torch.tree import leaves_with_path
    leaves = list(leaves_with_path(param_shapes(cfg), is_leaf=_is_shape))
    n = sum(int(np.prod(s)) for _, s in leaves)
    rows = [(m * s[0], int(np.prod(s[1:]))) if _path_stage_info(path)[0]
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


def quantile_check(rows, q, s, what: str) -> float:
    """``quantile_fused`` against its plain version on these rows, called
    twice: thresholds bit-equal, Σx² at rtol 1e-5, both calls the same
    bits; returns Σx²'s largest difference."""
    from repro_torch.kernels.fedfa_quantile import ops, ref
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
        for rows, q, s, *_ in calls:
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


ADMIT_M = 16           # the merge cell's cohort, for quant_admit's rows


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (a float's sign of zero and NaNs included)."""
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if a.dtype in view:
        a, b = a.view(view[a.dtype]), b.view(view[b.dtype])
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def admission_plain(fn):
    """``fn()`` with every ``quant_admit`` step on the plain version, on the
    card: the kernel's yardstick for the same tensors."""
    import functools
    from repro_torch.kernels.fedfa_agg import ops as agg_ops
    orig = agg_ops.quant_admit
    agg_ops.quant_admit = functools.partial(orig, use_kernel=False)
    try:
        return fn()
    finally:
        agg_ops.quant_admit = orig


def admit_specs(cfg, m: int):
    """A cohort of m clients of mixed width and depth (the "both" pool),
    so that stage-0 rows graft."""
    from repro_torch.core.server import make_client_specs
    from repro_torch.launch import train
    return make_client_specs(cfg, m, archs=train.client_arch_pool(cfg,
                                                                  "both"),
                             seed=0)


def admit_state(index, m: int, dtype: str, gen, width=None):
    """A residual state on the card: e_q drawn, e_s small, x_q and scales
    noise that admission overwrites."""
    from repro_torch.core import flat
    want = flat.update_dtype_of(dtype)
    w = index.n_padded if width is None else width
    e = torch.randn((m, w), generator=gen, device="cuda")
    e_q = (e * 40).round().clamp(-127, 127).to(want) if dtype == "int8" \
        else (1e-3 * e).to(want)
    del e
    e_s = torch.rand((m, index.n_segments), generator=gen,
                     device="cuda") * 1e-4
    if dtype == "bf16":
        e_s.fill_(1.0)
    return (torch.randint(-9, 9, (m, w), generator=gen, device="cuda")
            .to(want), torch.rand((m, index.n_segments), generator=gen,
                                  device="cuda"), e_q, e_s)


def admit_both(index, cfg, x, masks, gmaps, graft, state, dtype,
               cols=None) -> tuple:
    """``admit_quantized`` on the card through the kernel and through the
    plain version from the same state -> (kernel's state, plain state); a
    narrower ``cols`` without a mesh floors nothing (the all-reduce of the
    maxima is left out)."""
    from repro_torch.core import flat
    got = tuple(t.clone() for t in state)
    want = tuple(t.clone() for t in state)
    orig = flat.coll.all_reduce
    flat.coll.all_reduce = lambda t, *a, **kw: t
    try:
        flat.admit_quantized(index, cfg, x, masks, gmaps, graft, got, dtype,
                             None, cols)
        admission_plain(lambda: flat.admit_quantized(
            index, cfg, x, masks, gmaps, graft, want, dtype, None, cols))
    finally:
        flat.coll.all_reduce = orig
    torch.cuda.synchronize()
    return got, want


def quant_admit_checks(card: str) -> list:
    """``quant_admit`` (``csrc/quant_admit.cu``) against its plain version
    on the card, bit for bit: (a) whole admissions of the 4-layer smollm
    layout at int8 and bf16, graft on and off, and a padded layout cut
    inside the embedding's row and inside a stacked row (the scalar route);
    (b) at the wrapper, the full-size embedding segment (28,311,552
    elements a row, shared by thousands of blocks) and one full-size
    stacked leaf (``w_gate``, 30 x 884,736, grafted) with random 0/1 masks
    on both of its axes, and a piece cut 2 columns into the embedding's row;
    (c) the wrapper refusing a wrong dtype, device and shape; (d) m = 16
    admissions of full-size smollm-135m timed (each step, the three, the
    whole call and the plain version, CUDA events) against the bound of
    the bytes they need, the kernel's result bit-equal to the plain
    version's there too.  Prints one JSON line; returns the kernel rows."""
    from repro_torch.core import flat
    from repro_torch.core.server import stack_runtimes
    from repro_torch.kernels.fedfa_agg import ops as agg_ops
    from repro_torch.launch import train
    from repro_torch.models.model import init_params
    out = {"card": card}
    gen = torch.Generator("cuda").manual_seed(31)

    # (a) the 4-layer layout
    cfg = train.fl_config("smollm-135m", "cls", 10, full_size=False)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    masks, _, gmaps, *_ = stack_runtimes(cfg, admit_specs(cfg, 4), "cuda")
    check(bool((gmaps != torch.arange(gmaps.shape[1],
                                      device="cuda")).any()),
          "the admission cohort grafts no row")
    for pad, graft, cut in ((1, True, False), (1, False, False),
                            (4096, True, True)):
        index = flat.FlatIndex(params, pad_to=pad)
        x = torch.zeros((4, index.n_padded), device="cuda")
        x[:, :index.n] = 0.05 * torch.randn((4, index.n), generator=gen,
                                            device="cuda")
        x[1] = 0.0
        # client 2's final norm lands on halves after the division by its
        # scale 127 / 127 (its residual scale is zeroed below)
        fin = next(s for s in index.leaves if s.path[0] == "final_norm")
        halves = torch.tensor([127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -2.5,
                               126.5, -126.5, 3.5, 0.0, 64.5], device="cuda")
        x[2, fin.offset:fin.offset + fin.size] = halves.repeat(
            -(-fin.size // 12))[:fin.size]
        cols = None
        if cut:
            st = next(s for s in index.leaves if s.stacked and s.rest > 8)
            cols = slice(1002, st.offset + 2 * st.rest + 6)
        for dtype in ("int8", "bf16"):
            w = None if cols is None else cols.stop - cols.start
            state = admit_state(index, 4, dtype, gen, w)
            state[3][1] = 0.0                   # an all-zero client
            state[3][2, fin.seg0] = 0.0
            got, want = admit_both(index, cfg, x, masks, gmaps, graft, state,
                                   dtype, cols)
            if dtype == "int8" and cols is None:
                a = fin.offset
                check(got[0][2, a:a + 12].tolist() == [
                    127, -127, 0, 2, 2, 0, -2, 126, -126, 4, 0, 64],
                    f"quant_admit rounds halves to {got[0][2, a:a + 12]}")
            for name, g, wt in zip(("x_q", "scales", "e_q", "e_s"), got,
                                   want):
                check(same_bits(g, wt), f"quant_admit {dtype} (4-layer, pad "
                      f"{pad}, graft {graft}, cut {cut}): {name} differs "
                      f"from the plain version's")
    out["small"] = "bit-equal: int8, bf16; graft on, off; cut columns"

    # (b) full-size segments at the wrapper
    m, E, R, L = 4, 49152 * 576, 30, 576 * 1536
    F = 576 + 1536
    AP = agg_ops.AdmitPiece
    plan = agg_ops.AdmitPlan([
        AP(0, 1, E, 0, 0, 1, E, 0, 0, False, False, (49152, 576),
           ((0, 1, 576),)),
        AP(1, R, L, E, E, R, L, 0, 0, True, True, (R, 576, 1536),
           ((0, 1, 576), (576, 2, 1536))),
        AP(31, 1, 1_000_003, E + R * L, 0, 1, E, 0, 2, False, False,
           (49152, 576), ((0, 1, 576),))], F)
    W, S = E + R * L + 1_000_004, 32
    x = 0.05 * torch.randn((m, E + R * L), generator=gen, device="cuda")
    fac = (torch.rand((m, F), generator=gen, device="cuda") > 0.3).float()
    gm = torch.stack([torch.randperm(R, device="cuda") for _ in range(m)])
    for dtype in ("int8", "bf16"):
        want_t = flat.update_dtype_of(dtype)
        e_q = (torch.randn((m, W), generator=gen, device="cuda") * 40) \
            .round().clamp(-127, 127).to(want_t)
        e_s = torch.rand((m, S), generator=gen, device="cuda") * 1e-4
        res = []
        for use_kernel in (None, False):
            st = [torch.zeros((m, W), dtype=want_t, device="cuda"),
                  e_q.clone(), torch.zeros((m, S), device="cuda"),
                  torch.zeros((m, S), device="cuda")]
            steps = (1, 2, 3) if dtype == "int8" else (3,)
            for step in steps:
                agg_ops.quant_admit(step, x, gm, True, fac, st[1], e_s, st[0],
                                    st[2] if dtype == "int8" else None,
                                    st[3] if dtype == "int8" else None, plan,
                                    use_kernel=use_kernel)
            res.append(st)
        torch.cuda.synchronize()
        for name, g, wt in zip(("x_q", "e_q", "y_max", "e_max"), *res):
            check(same_bits(g, wt), f"quant_admit {dtype} at full-size "
                  f"segments: {name} differs from the plain version's")
        del res, e_q
    out["full_size_segments"] = {
        "embedding": [1, E], "w_gate": [R, L], "cut": [1, 1_000_003],
        "m": m, "bits": "equal, int8 and bf16"}
    # (c) refusals
    st = torch.zeros((m, W), dtype=torch.int8, device="cuda")
    tab = torch.zeros((m, S), device="cuda")
    for what, call, err in (
            ("f32 state", lambda: agg_ops.quant_admit(
                1, x, gm, True, fac, st.float(), tab, st.float(), tab, tab,
                plan), TypeError),
            ("scales on the CPU", lambda: agg_ops.quant_admit(
                1, x, gm, True, fac, st, tab.cpu(), st, tab, tab, plan),
             ValueError),
            ("a narrow state", lambda: agg_ops.quant_admit(
                1, x, gm, True, fac, st[:, :W - 8].contiguous(), tab,
                st[:, :W - 8].contiguous(), tab, tab, plan), ValueError),
            ("fac of 3 rows", lambda: agg_ops.quant_admit(
                1, x, gm, True, fac[:3].contiguous(), st, tab, st, tab, tab,
                plan), ValueError)):
        try:
            call()
        except err:
            continue
        raise AssertionError(f"quant_admit took {what}")
    out["refuses"] = "f32 state, a CPU table, a narrow state, a short fac"
    del x, fac, gm, st, tab
    collect_garbage()
    torch.cuda.empty_cache()

    # (d) m = 16 admissions of full-size smollm-135m, timed
    cfg = train.fl_config("smollm-135m", "cls", 10, full_size=True)
    index = model_index()
    masks, _, gmaps, *_ = stack_runtimes(cfg, admit_specs(cfg, ADMIT_M),
                                         "cuda")
    x = torch.stack([cohort_row(index, i) for i in range(ADMIT_M)])
    rows = []
    for dtype in ("int8", "bf16"):
        state = admit_state(index, ADMIT_M, dtype, gen)
        got, want = admit_both(index, cfg, x, masks, gmaps, True, state,
                               dtype)
        for name, g, wt in zip(("x_q", "scales", "e_q", "e_s"), got, want):
            check(same_bits(g, wt), f"quant_admit {dtype} (m = {ADMIT_M}, "
                  f"full size): {name} differs from the plain version's")
        del want
        fac, per_leaf = flat._admit_factors(cfg, index, masks, ADMIT_M,
                                            "cuda")
        plan = flat._admit_plan(index, slice(0, index.n_padded), per_leaf,
                                fac.shape[1])
        gm = gmaps.long()
        x_q, scales, e_q, e_s = got
        ymax, emax = (torch.zeros_like(scales) if dtype == "int8" else None
                      for _ in range(2))
        steps = (1, 2, 3) if dtype == "int8" else (3,)
        step_ms = {}
        for step in steps:
            step_ms[step] = time_ms(lambda: agg_ops.quant_admit(
                step, x, gm, True, fac, e_q, e_s, x_q, ymax, emax, plan), 5,
                warmup=1)
        admit = lambda st=got: flat.admit_quantized(
            index, cfg, x, masks, gmaps, True, st, dtype)
        call_ms = time_ms(admit, 5, warmup=1)
        plain_ms = time_ms(lambda: admission_plain(admit), 2, warmup=1)
        b = 1 if dtype == "int8" else 2
        n = plan.n_elems
        nbytes = (len(steps) * (4 + b) + 2 * b) * ADMIT_M * n
        bms, by = bound(nbytes, 0)
        rows.append({
            "name": "quant_admit", "dtype": dtype, "route": "cuda",
            "source": "src/repro_torch/csrc/quant_admit.cu",
            "replaces": "none (the reference admits in plain jnp)",
            "shape": [ADMIT_M, n], "pieces": len(plan.pieces),
            "launches_per_admission": len(steps),
            "step_ms": step_ms, "ms": sum(step_ms.values()),
            "admission_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "bound_bytes": nbytes,
            "library_ms": None})
        del got, state, fac, x_q, scales, e_q, e_s
        collect_garbage()
    del x
    collect_garbage()
    torch.cuda.empty_cache()
    out["rows"] = rows
    print(json.dumps({"quant_admit": out}), flush=True)
    return rows


def hist_level_rows(x, s, q, dtype: str, by_shape: dict, total: dict,
                    per_round: float = None, **extra) -> list:
    """``hist_level`` on the rows x (R, L) (per-row scales ``s`` if
    quantized) with levels q (R, 1), at each of the four levels with the
    prefixes the plain level loop finds for them: counts, exact integer
    Σx² planes and their f32 scaling equal to the plain version's; at the
    second level also with the ceil path's prefix moved to the next bin,
    so that the two planes differ; then the whole multilevel quantile
    against the sorting plain version, thresholds bit-equal.  Each level
    is timed beside its launches (``by_shape``, counted by shape over the
    path's 2 rounds) as the level loop calls it (``hist_level_planes``),
    its scaling to f32 (``ref.scale_sums``) beside it,
    and ``total`` sums launches × (kernel + scaling) time over a round, as
    the level loop pays it, and the scaling's share: ``per_round``
    launches of each level (x is one leaf's rows: 1), or by default
    every launch of x's shape in a round (x stands for all of them)."""
    from repro_torch.kernels.fedfa_quantile import multilevel, ref
    R, L = x.shape
    sc = None if s is None else s[:, None].contiguous()
    seg1 = torch.zeros(L, dtype=torch.int32, device="cuda")
    seg_len = torch.full((1,), L, dtype=torch.int64, device="cuda")
    levels = multilevel.level_prefixes(x, seg1, seg_len, q, sc)
    out = []
    for j, (shift, hi) in enumerate(levels):
        cases = [hi]
        if j == 1:
            moved = hi.clone()
            moved[:, 1] += 1
            cases.append(moved)
        for h in cases:
            cnt, iq = multilevel.hist_level_planes(x, seg1, h, shift, sc)
            pcnt, piq = ref.hist_level_planes_ref(x, seg1, h, shift, sc)
            what = (f"hist_level {dtype} {(R, L)} level {j}"
                    + ("" if h is hi else ", planes differing"))
            check(torch.equal(cnt, pcnt), f"{what}: counts differ")
            check(torch.equal(iq, piq), f"{what}: integer sums differ")
            sq = multilevel.hist_level(x, seg1, h, shift, sc)[1]
            psq = ref.hist_level_ref(x, seg1, h, shift, sc)[1]
            check(torch.equal(sq, psq), f"{what}: sums differ")
            err = float((sq - psq).abs().max())
            total["err"] = max(total["err"], err)
            del cnt, iq, sq, pcnt, piq, psq
        b, by = bound(R * L * BYTES[dtype] + (L + R * 2) * 4
                      + (0 if sc is None else R * 4)
                      + R * 2 * 256 * 12, R * L)
        ms = time_ms(lambda: multilevel.hist_level_planes(x, seg1, hi, shift,
                                                          sc), 10)
        plain = time_ms(lambda: ref.hist_level_planes_ref(x, seg1, hi, shift,
                                                          sc), 2)
        planes = multilevel.hist_level_planes(x, seg1, hi, shift, sc)[1]
        scale = time_ms(lambda: ref.scale_sums(planes, hi, shift), 10)
        del planes
        n = by_shape.get((R, L, shift), 0)
        # the level loop pays the kernel and the scaling
        for key, val in (("ms", ms + scale), ("scale_ms", scale),
                         ("plain_ms", plain), ("bound_ms", b)):
            total[key] += (n / 2 if per_round is None   # 2 rounds
                           else per_round) * val
        out.append({
            "name": "hist_level", "dtype": dtype, **extra, "shape": [R, L],
            "level": j, "route": "cuda",
            "source": "src/repro_torch/csrc/hist_level.cu",
            "replaces": "src/repro/kernels/fedfa_quantile/multilevel.py:107",
            "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "scale_to_f32_ms": scale})
    t, ss = multilevel.row_trimmed_stats_multilevel(x, q[:, 0], s)
    pt, pss = ref.row_trimmed_stats_ref(ref.dequantize_rows(x, s), q[:, 0])
    check(torch.equal(t.view(torch.int32), pt.view(torch.int32)),
          f"multilevel {dtype} thresholds differ at {(R, L)}")
    torch.testing.assert_close(ss, pss, rtol=1e-5, atol=0)
    return out


def hist_round_row(dtype: str, launches: int, total: dict,
                   **extra) -> dict:
    """The round's ``hist_level`` row: launches × time over the 2 rounds,
    each launch with its level's scaling to f32 (``scale_to_f32_ms`` of
    it)."""
    return {
        "name": "hist_level", "dtype": dtype, **extra, "shape": "round",
        "route": "cuda", "source": "src/repro_torch/csrc/hist_level.cu",
        "replaces": "src/repro/kernels/fedfa_quantile/multilevel.py:107",
        "launches": launches, "rounds": 2, "max_abs_err": total["err"],
        "ms": total["ms"], "scale_to_f32_ms": total["scale_ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"], "bound_by": "bytes",
        "library_ms": None}


def hist_checks(launches: dict, shapes: dict) -> list:
    """``hist_level`` at every multilevel row shape of the main path (wq/wo,
    the FFN, the embedding; S = 1), f32 and quantized, on normal rows
    (``hist_level_rows``), and the main path's launches by (rows, shift):
    each leaf's 4 levels twice in its 2 rounds; one row per dtype adds the
    levels up over a round (launches × time against launches × bound)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    _, _, multi = main_path_shapes(8)
    out = []
    for dtype in ("f32", "int8", "bf16"):
        total = {"ms": 0.0, "scale_ms": 0.0, "plain_ms": 0.0,
                 "bound_ms": 0.0, "err": 0.0}
        for R, L in multi:
            if dtype == "f32":
                x, s = torch.randn((R, L), generator=gen, device="cuda"), None
            else:
                x, s = quantized_rows(dtype, R, L, gen)
            q = 1.0 - 0.05 * torch.rand((R, 1), generator=gen, device="cuda")
            out += hist_level_rows(x, s, q, dtype,
                                   shapes[dtype]["hist_level"], total)
            del x
        # the round: each multilevel leaf once per level
        by_shape = shapes[dtype]["hist_level"]
        check(sum(by_shape.values()) == launches[dtype]["hist_level"]
              and by_shape == {(R, L, 24 - 8 * j): 2 * leaves
                               for (R, L), leaves in multi.items()
                               for j in range(4)},
              f"hist_level {dtype}: launches by (rows, shift) {by_shape} in "
              f"2 rounds, expected each leaf's 4 levels twice")
        out.append(hist_round_row(dtype, launches[dtype]["hist_level"],
                                  total))
    return out


def fl_path_kernel_rows(hist: dict, arch: str, dtype: str, kernels,
                        path: str = None) -> list:
    """Each kernel of ``arch``'s FL path held against its plain version on
    the arguments that path passed it (recorded by
    ``main_path(record_all=True)``) and timed there: ``scaled_accum`` (M'
    and Γ; within 1e-5 of the summed magnitudes), ``quant_accum`` (int8),
    ``quantile_fused`` per row shape (``quantile_check``), ``hist_level``
    per (row shape, level) (``hist_level_rows``) and ``ssd_intra_chunk``
    per shape (``ssd_row``), with the launches the path made.  On each
    multilevel leaf's rows (longer than 2^18) the dispatching
    ``row_trimmed_stats`` with ``use_kernel=False`` launches no kernel and
    gives the kernels' thresholds bit for bit (Σx² at rtol 1e-5).  ``path``
    names the path in the rows (``arch`` fl by default)."""
    from repro_torch.kernels.fedfa_agg import ops as agg_ops
    from repro_torch.kernels.fedfa_agg import ref as agg_ref
    from repro_torch.kernels.fedfa_quantile import ops, ref
    tag = {"path": path or f"{arch} fl"}
    launches, by_shape, calls = hist["launches"], hist["by_shape"], \
        hist["calls"]
    out = []
    for i, (x, w, mask, *_) in enumerate(calls["scaled_accum"]):
        x, w, mask = x.cuda(), w.cuda(), mask.cuda()
        m, n = x.shape
        got = agg_ops.scaled_accum(x, w, mask)
        want = agg_ref.scaled_accum_ref(x, w, mask)
        mag = agg_ref.scaled_accum_ref(x.abs(), w.abs(), mask)
        err = (got - want).abs()
        # f32 rounds sum M' then Γ; quantized ones Γ alone (quant_accum
        # takes M')
        what = ("M'", "Γ")[i] if dtype == "f32" else "Γ"
        check(bool((err <= 1e-5 * mag).all()),
              f"scaled_accum on the {arch} path's {what} disagrees")
        b, by = bound((m * n + m + 2 * n) * 4, 2 * m * n + n)
        out.append({
            "name": "scaled_accum", "dtype": dtype, **tag, "input": what,
            "shape": [m, n], "route": "cuda",
            "source": "src/repro_torch/csrc/scaled_accum.cu",
            "replaces": "src/repro/kernels/fedfa_agg/kernel.py:71",
            "launches": launches["scaled_accum"],
            "max_abs_err": float(err.max()),
            "ms": time_ms(lambda: agg_ops.scaled_accum(x, w, mask), 10),
            "plain_ms": time_ms(lambda: agg_ref.scaled_accum_ref(x, w, mask),
                                5),
            "bound_ms": b, "bound_by": by,
            "library_ms": time_ms(lambda: torch.mv(x.t(), w) * mask, 5)})
        del x, got, want, mag, err
    for xq, wtab, seg, mask, *_ in calls.get("quant_accum", []):
        xq, wtab, seg, mask = (t.cuda() for t in (xq, wtab, seg, mask))
        m, n = xq.shape
        got = agg_ops.quant_accum(xq, wtab, seg, mask)
        want = agg_ref.quant_accum_ref(xq, wtab, seg, mask)
        mag = agg_ref.quant_accum_ref(xq.abs(), wtab, seg, mask)
        err = (got - want).abs()
        check(bool((err <= 1e-5 * mag).all()),
              f"quant_accum on the {arch} path disagrees")
        b, by = bound(m * n * BYTES[dtype] + 12 * n + wtab.numel() * 4,
                      2 * m * n + n)
        out.append({
            "name": "quant_accum", "dtype": dtype, **tag, "shape": [m, n],
            "route": "cuda", "source": "src/repro_torch/csrc/quant_accum.cu",
            "replaces": "src/repro/kernels/fedfa_agg/kernel.py:117",
            "launches": launches["quant_accum"],
            "max_abs_err": float(err.max()),
            "ms": time_ms(lambda: agg_ops.quant_accum(xq, wtab, seg, mask),
                          10),
            "plain_ms": time_ms(
                lambda: agg_ref.quant_accum_ref(xq, wtab, seg, mask), 3),
            "bound_ms": b, "bound_by": by, "library_ms": None})
        del xq, got, want, mag, err
    # quantile_fused: each row shape's calls checked, the first one timed
    timed = {}
    for rows, q, s, *_ in calls["quantile_fused"]:
        R, L = rows.shape
        err = quantile_check(rows, q, s, f"quantile_fused {dtype} {arch} "
                                         f"path rows {(R, L)}")
        if (R, L) not in timed:
            b, by = bound(R * L * rows.element_size()
                          + (3 + (s is not None)) * R * 4, R * L)
            timed[R, L] = {
                "name": "quantile_fused", "dtype": dtype, **tag,
                "shape": [R, L], "route": "cuda",
                "source": "src/repro_torch/csrc/quantile_fused.cu",
                "replaces": "src/repro/kernels/fedfa_quantile/kernel.py:85",
                "launches": by_shape["quantile_fused"].get((R, L), 0),
                "max_abs_err": err,
                "ms": time_ms(lambda: ops.quantile_fused(rows, q, s), 10),
                "plain_ms": time_ms(lambda: ref.row_trimmed_stats_ref(
                    ref.dequantize_rows(rows, s), q), 5),
                "bound_ms": b, "bound_by": by, "library_ms": None}
        timed[R, L]["max_abs_err"] = max(timed[R, L]["max_abs_err"], err)
    out += list(timed.values())
    out.append({
        "name": "quantile_fused", "dtype": dtype, **tag, "shape": "round",
        "route": "cuda", "source": "src/repro_torch/csrc/quantile_fused.cu",
        "replaces": "src/repro/kernels/fedfa_quantile/kernel.py:85",
        "launches": launches["quantile_fused"], "rounds": 2,
        "max_abs_err": max(r["max_abs_err"] for r in timed.values()),
        **{k: sum(r[k] * r["launches"] / 2 for r in timed.values())
           for k in ("ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes", "library_ms": None})
    # hist_level on the multilevel leaves' rows (embedding, in_proj,
    # out_proj), at their levels
    total = {"ms": 0.0, "scale_ms": 0.0, "plain_ms": 0.0,
             "bound_ms": 0.0, "err": 0.0}
    for rows, q, s, *_ in calls["row_trimmed_stats_multilevel"]:
        rows, q = rows.cuda(), q.cuda()
        s = None if s is None else s.cuda()
        # one leaf's rows: its 4 levels once a round, whichever other
        # leaves share its shape
        out += hist_level_rows(rows, s, q[:, None], dtype,
                               by_shape["hist_level"], total, per_round=1,
                               **tag)
        for k in kernels:
            k.reset()
        pt, pss = ops.row_trimmed_stats(rows, q, s, use_kernel=False)
        torch.cuda.synchronize()
        ran = {k.symbol: k.launches for k in kernels if k.launches}
        check(not ran, f"use_kernel=False on the {arch} path's rows "
                       f"{tuple(rows.shape)} launched {ran}")
        t, ss = ops.row_trimmed_stats(rows, q, s)
        check(torch.equal(t.view(torch.int32), pt.view(torch.int32)),
              f"use_kernel=False thresholds differ at {tuple(rows.shape)}")
        torch.testing.assert_close(ss, pss, rtol=1e-5, atol=0)
        del rows, pt, pss, t, ss
    if calls["row_trimmed_stats_multilevel"]:
        out.append(hist_round_row(dtype, launches["hist_level"], total,
                                  **tag))
    # ssd_intra_chunk on the evaluation's inputs: sequence 64 in one chunk
    # of 128, so the upper half of every chunk is padding with dt = 0
    ssd_rows = {}
    for a in calls["ssd_intra_chunk"]:
        row = ssd_row(tuple(t.cuda() for t in a[:5]), by_shape[
            "ssd_intra_chunk"], f"the {arch} {dtype} path's", path=tag[
                "path"], update_dtype=dtype)
        key = tuple(row["shape"])
        if key in ssd_rows:
            row["max_abs_err"] = max(row["max_abs_err"],
                                     ssd_rows[key]["max_abs_err"])
        ssd_rows[key] = row
    check(set(ssd_rows) == set(by_shape["ssd_intra_chunk"]),
          f"ssd_intra_chunk shapes recorded {set(ssd_rows)}, launched "
          f"{set(by_shape['ssd_intra_chunk'])}")
    return out + list(ssd_rows.values())


def serve_card_vs_cpu(flash, family: str = "dense") -> None:
    """The serving Engine on the card and on the CPU at the reduced sizes,
    same weights and prompts, greedy, with an f32 and a bf16 cache: 4
    prompts of 48 tokens and 8 new for mamba2-130m and the 4-layer
    smollm-135m, then 2 prompts of 2,100 for smollm-135m, whose prefill
    takes blocked attention — ``flash`` (the ``flash_attention`` kernel)
    once per layer on the card, ``attend_blocked`` on the CPU.  With
    ``family`` "hybrid" instead the sliding windows, through ring KV caches
    that wrap in prefill and again in decode: recurrentgemma-2b ``reduced()``
    (window 128, capacity 232: a ring of 128) with 2 prompts of 200 and 24
    new tokens, and tinyllama-1.1b ``reduced()`` at ``Engine(window=64)``,
    capacity 128 (a ring of 64), 2 prompts of 100 and 24 new tokens.  With
    "audio" instead whisper-base with numpy frames: ``reduced()`` (2
    layers, d_model 256, 64 frames), 4 prompts of 48 and 8 new tokens; then
    at its published width cut to 2 decoder layers, 1 prompt of 2,816
    against 1,500 frames and 4 new tokens, whose prefill takes the flash
    route twice a layer on the card — causal self attention (2,816²) and
    non-causal cross attention (2,816 × 1,500 > 2048²) —, 4 launches, and
    ``attend_blocked`` on the CPU.  With "vlm" instead internvl2-76b
    ``reduced()`` with numpy patches: 2 prompts of 32 behind 16 patches and
    8 new tokens; then 1 prompt of 2,040 behind the 16 patches (2,056
    positions: the text alone stays under 2048², the patches carry it
    over) and 4 new tokens, the flash route once a layer on the card, 2
    launches, ``attend_blocked`` on the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic
    from repro_torch.launch import serve, train
    from repro_torch.models.model import init_params
    from repro_torch.tree import tree_map

    smollm = train.fl_config("smollm-135m", "cls", 10, full_size=False)
    # (name, cfg, batch, prompt, new tokens, capacity, window, launches)
    cases = [("mamba2-130m", get_arch("mamba2-130m").reduced(), 4, 48, 8,
              64, None, 0),
             ("smollm-135m", smollm, 4, 48, 8, 64, None, 0),
             ("smollm-135m", smollm, 2, 2100, 8, 2116, None,
              smollm.n_layers)]
    if family == "hybrid":
        cases = [(RG, get_arch(RG).reduced(), 2, 200, 24, 232, None, 0),
                 ("tinyllama-1.1b", get_arch("tinyllama-1.1b").reduced(), 2,
                  100, 24, 128, 64, 0)]
    if family == "audio":
        cases = [(WHISPER, get_arch(WHISPER).reduced(), 4, 48, 8, 64, None,
                  0),
                 (WHISPER, get_arch(WHISPER).replace(n_layers=2), 1, 2816, 4,
                  2828, None, 4)]
    if family == "vlm":
        vlm = get_arch(VLM).reduced()
        cases = [(VLM, vlm, 2, 32, 8, 64, None, 0),
                 (VLM, vlm, 1, 2040, 4, 2064, None, vlm.n_layers)]
    for (name, cfg, batch, prompt_len, max_new, capacity, window,
         flash_launches) in cases:
        params = init_params(cfg, torch.Generator().manual_seed(0))
        prompts = synthetic.lm_stream(cfg.vocab_size, batch, prompt_len,
                                      seed=0)
        extras = {k: v.numpy() for k, v in
                  numpy_inputs(cfg, batch, seed=0).items()}
        for cache in (torch.float32, torch.bfloat16):
            out = {}
            for dev in ("cuda", "cpu"):
                eng = serve.Engine(cfg, tree_map(lambda t: t.to(dev), params),
                                   capacity=capacity, window=window,
                                   cache_dtype=cache)
                flash.reset()
                out[dev] = eng.generate(prompts, max_new=max_new,
                                        return_logits=True, **extras)
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
            log(f"serving card vs cpu, {name}, prompt {prompt_len}, window "
                f"{window or cfg.attn_window}, {cache} cache: tokens equal, "
                f"logits max abs diff {float(np.abs(lg - want).max()):.3g}")


def serve_path(kernels, arch: str, batch: int, prompt_len: int,
               max_new: int, expect: dict) -> dict:
    """``launch.serve`` at full size, every launch count reset just before;
    fails unless the counts are ``expect`` (0 for any kernel not named) and
    every token is in the vocabulary.  Then a second, warm generate on the
    same engine and prompts."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    collect_garbage()
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


def ssd_bound(G: int, Q: int, nh: int, hp: int, N: int, nbytes: int):
    """(bound ms, what bounds it, the CUDA cores' f32 bound ms) of one
    ``ssd_intra_chunk`` launch on its route: the larger of the bytes and
    the tensor-core operations, the three products over their causal
    triangles as three TF32 products each at f32, and at bf16 C·Bᵀ as one
    bf16 product and M·x and the state as two TF32 products each."""
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
    return b, by, (cb_ops + head_ops) / F32_OPS_PER_S * 1e3


def ssd_exact(x, dt, A, B, C):
    """``ssd_intra_chunk_ref``'s y and state computed in f64: the values
    that the f32 kernel and the f32 plain version both approximate."""
    Q = x.shape[1]
    x, dt, A, B, C = (t.double() for t in (x, dt, A, B, C))
    L = torch.cumsum(dt * A[None, None, :], 1)
    diff = L[:, :, None, :] - L[:, None, :, :]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    M = torch.where(causal, torch.einsum("gtn,gsn->gts", C, B)[..., None]
                    * torch.exp(torch.where(causal, diff, 0.0)), 0.0)
    y = torch.einsum("gtsh,gshp->gthp", M * dt[:, None, :, :], x)
    w = dt * torch.exp(L[:, -1:, :] - L)
    return y, torch.einsum("gsn,gsh,gshp->ghpn", B, w, x)


def ssd_row(a, by_shape: dict, what: str, **extra) -> dict:
    """``ssd_intra_chunk`` on the inputs ``a`` (x, dt, A, B, C on the card)
    against its plain version — y and the state within 1e-4 + 1e-4·|w|
    elementwise, L bit-equal — timed, with the launches ``by_shape`` counts
    for its shape.  On the mamba2 path's trained inputs some sums cancel to
    a small part of their summed magnitudes (the plain version on |x|, dt,
    A, |B|, |C|); there both f32 versions miss the f64 values
    (``ssd_exact``) by more than that bound, and meet it against each other
    only at random (ROADMAP queue 3 item 22).  So an element past it passes
    only where the kernel lies within twice the plain version's own error
    from the f64 value: its error over the summed magnitude at most twice
    the plain version's largest such error in the tensor.  The row reports
    how many elements that admitted, and, for the kernel against the plain
    version and for each against the f64 values, the largest error over
    those magnitudes and the largest ratio to the elementwise bound."""
    from repro_torch.kernels.ssd import ops, ref
    x, dt, A, B, C = a
    G, Q, nh, hp = x.shape
    N = B.shape[2]
    name = f"ssd_intra_chunk {x.dtype} on {what} {(G, Q, nh, hp, N)}"
    got, want = ops.ssd_intra_chunk(*a), ref.ssd_intra_chunk_ref(*a)
    mag = [m.double().clamp_min(1e-30) for m in
           ref.ssd_intra_chunk_ref(x.abs(), dt, A, B.abs(), C.abs())[:2]]
    exact = ssd_exact(*a)
    admitted = 0
    for part, g, w, e, m in zip(("y", "state"), got, want, exact, mag):
        past = (g - w).abs() > 1e-4 + 1e-4 * w.abs()
        plain_err = float(((w.double() - e).abs() / m).max())
        near = (g.double() - e).abs() <= 2 * plain_err * m
        check(bool((near | ~past).all()), f"{name}: {part} disagrees")
        admitted += int(past.sum())
    # (over the magnitudes, over the elementwise bound) of each pair
    errs = {}
    for pair, (u, v) in (("kernel-plain", (got, want)),
                         ("kernel-f64", (got, exact)),
                         ("plain-f64", (want, exact))):
        errs[pair] = [max(float(((p.double() - q.double()).abs() / m).max())
                          for p, q, m in zip(u[:2], v[:2], mag)),
                      max(float(((p.double() - q.double()).abs()
                                 / (1e-4 + 1e-4 * q.double().abs())).max())
                          for p, q in zip(u[:2], v[:2]))]
    check(torch.equal(got[2], want[2]), f"{name}: L differs")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    del got, want, mag, exact
    b, by, cuda_core = ssd_bound(G, Q, nh, hp, N, x.element_size())
    return {
        "name": "ssd_intra_chunk",
        "dtype": "f32" if x.dtype == torch.float32 else "bf16", **extra,
        "shape": [G, Q, nh, hp, N], "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_intra_chunk.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:50",
        "launches": by_shape.get((G, Q, nh, hp, N), 0), "max_abs_err": err,
        "elements_past_elementwise_bound": admitted,
        "max_err_over_magnitude": {k: v[0] for k, v in errs.items()},
        "max_ratio_to_elementwise_1e-4": {k: v[1] for k, v in errs.items()},
        "ms": time_ms(lambda: ops.ssd_intra_chunk(*a), 10),
        "plain_ms": time_ms(lambda: ref.ssd_intra_chunk_ref(*a), 3),
        "bound_ms": b, "bound_by": by,
        # the first version's bound, f32 on the CUDA cores
        "cuda_core_bound_ms": cuda_core, "library_ms": None}


def ssd_checks(launches: int) -> list:
    """``ssd_intra_chunk`` against its plain version at the serving path's
    shape (batch 8 x prompt 1024 in chunks of 128: G = 64; 24 heads of 64,
    state 128), f32 and bf16 inputs (``ssd_row``, bound by ``ssd_bound``);
    the whole chunked SSD against its plain version; and the wrapper's
    refusal of inputs that need a gradient."""
    from repro_torch.kernels.ssd import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    G, Q, nh, hp, N = 64, 128, 24, 64, 128
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        a = ssd_inputs(G, Q, nh, hp, N, dtype, gen)
        out.append(ssd_row(a, {(G, Q, nh, hp, N): launches},
                           "the serving path's"))
        del a
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
# q offsets (chunked prefill): ragged Sq < Sk at offsets 1, 37 and 128 (a
# multiple of every kv tile), causal with and without a window
FLASH_OFFSET_SHAPE, FLASH_OFFSETS = (2, 100, 300, 4, 2, 64), (1, 37, 128)
# hd 256 (recurrentgemma-2b's heads: 10 query heads over 1 kv head): the
# sweep's masks, and q offsets 1 and 128 on a ragged Sq < Sk
FLASH_WIDE, FLASH_WIDE_OFFSET = (1, 192, 192, 10, 1, 256), \
    (2, 100, 300, 10, 1, 256)


# the narrow route's bit check: every hd <= 128 case of the sweep, the
# offsets and the serving shape, on inputs drawn with numpy, f32 and bf16
FLASH_BIT_CASES = [
    (shape, dt, causal, window, off)
    for shape, masks in [(s, ((True, None, 0), (True, 96, 0),
                              (False, None, 0))) for s in FLASH_SWEEP
                         if s[1] == s[2]]
    + [((1, 64, 320, 2, 2, 32), ((False, None, 0),)),
       (FLASH_OFFSET_SHAPE, tuple((True, w, o) for o in FLASH_OFFSETS
                                  for w in (None, 96))),
       ((2, 1024, 4096, 8, 2, 128), ((True, None, 3072),)),
       ((8, 4096, 4096, 9, 3, 64), ((True, None, 0),))]
    for causal, window, off in masks for dt in ("f32", "bf16")]
# sha256 of the outputs of FLASH_BIT_CASES in order, from the narrow
# kernel as it was before the hd-256 route was added (that commit's
# csrc/flash_attention.cu, built and run through flash_narrow_digest on an
# NVIDIA H100 80GB HBM3; PERF.md)
FLASH_NARROW_SHA256 = \
    "f944ca5665e497cc8335c4d4a77656a8f7c409ed659f65415dc4ddf57507f217"


def flash_narrow_digest(attention) -> str:
    """sha256 of ``attention(q, k, v, causal, window, q_offset)``'s output
    bits on every ``FLASH_BIT_CASES`` case, its inputs drawn with numpy
    (seed 0 for each case, so the digest depends on the kernel alone)."""
    h = hashlib.sha256()
    for (B, Sq, Sk, H, K, hd), dt, causal, window, off in FLASH_BIT_CASES:
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (B, S, n, hd), dtype=np.float32)).to("cuda").to(
            torch.float32 if dt == "f32" else torch.bfloat16)
            for S, n in ((Sq, H), (Sk, K), (Sk, K)))
        out = attention(q, k, v, causal, window, off)
        torch.cuda.synchronize()
        h.update(out.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def attention_keep(Sq: int, Sk: int, causal: bool, window,
                   q_offset: int = 0) -> np.ndarray:
    """The (Sq, Sk) mask of the (q, k) pairs attention keeps, query i at
    position q_offset + i."""
    qpos = np.arange(Sq)[:, None] + q_offset
    kpos = np.arange(Sk)[None, :]
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
    the bf16 rate for bf16 ones.  Also with q offsets (``FLASH_OFFSETS``,
    causal, with and without window 96, f32 and bf16, at the same
    tolerances; no path launches their shape, so their rows carry 0
    launches, the others ``launches``, the long-prompt request's).  At hd
    256 (the wide route, two warpgroups a q head) the sweep's masks and q
    offsets 1 and 128, f32 and bf16 (rows with 0 launches: the path's shape
    has its own rows, ``flash_rows``).  Then the wrapper's refusal of
    inputs that need a gradient and of a negative offset.  First, the
    narrow route (hd <= 128) gives the bits of the commit before the wide
    route was added (``FLASH_NARROW_SHA256``)."""
    from repro_torch.kernels.flash_attention import ops, ref
    digest = flash_narrow_digest(lambda q, k, v, causal, window, off:
                                 ops.attention(q, k, v, causal=causal,
                                               window=window, q_offset=off))
    check(digest == FLASH_NARROW_SHA256,
          f"flash_attention at hd <= 128 moved from the parent's bits: "
          f"sha256 {digest}, expected {FLASH_NARROW_SHA256}")
    log(f"flash_attention at hd <= 128: the parent's bits on "
        f"{len(FLASH_BIT_CASES)} cases (sha256 {digest[:16]}...)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [((8, 4096, 4096, 9, 3, 64), dt, True, None, 0)
             for dt in (f32, bf16)]
    cases += [(shape, dt, causal, window, 0) for shape in FLASH_SWEEP
              for dt in (f32, bf16)
              for causal, window in ((True, None), (True, 96), (False, None))
              if not (causal and shape[1] != shape[2])]
    cases.append(((2, 100, 100, 4, 2, 48), f32, True, None, 0))
    cases += [(FLASH_OFFSET_SHAPE, dt, True, window, off)
              for off in FLASH_OFFSETS for dt in (f32, bf16)
              for window in (None, 96)]
    cases += [(FLASH_WIDE, dt, causal, window, 0) for dt in (f32, bf16)
              for causal, window in ((True, None), (True, 96), (False, None))]
    cases += [(FLASH_WIDE_OFFSET, dt, True, window, off) for off in (1, 128)
              for dt in (f32, bf16) for window in (None, 96)]
    out = []
    for (B, Sq, Sk, H, K, hd), dt, causal, window, off in cases:
        q, k, v = (randn(B, S, n, hd).to(dt)
                   for S, n in ((Sq, H), (Sk, K), (Sk, K)))
        kw = dict(causal=causal, window=window, q_offset=off)
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
        keep = attention_keep(Sq, Sk, causal, window, off)
        nb = q.element_size()
        products = 4 * B * H * hd * int(keep.sum())
        b, by = bound(2 * B * (Sq * H + Sk * K) * hd * nb,
                      *((3 * products, TF32_OPS_PER_S) if dt == f32
                        else (products, BF16_OPS_PER_S)))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = (None if window is None and off == 0 else
                torch.as_tensor(keep, device="cuda"))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)
        big = Sq * Sk > 2048 * 2048
        out.append({
            "name": "flash_attention",
            "dtype": "f32" if dt == f32 else "bf16",
            "shape": [B, Sq, Sk, H, K, hd], "causal": causal,
            "window": window, "q_offset": off, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:68",
            "launches": 0 if off or hd > 128 else launches,
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
    x = x.detach()
    try:
        ops.attention(x, x[:, :, :1], x[:, :, :1], q_offset=-1)
    except ValueError:
        pass
    else:
        raise AssertionError("flash_attention took a negative q offset")
    return out


# ---------------------------------------------------------------------------
# the sharded FL server (mesh_path)
# ---------------------------------------------------------------------------

MESH_AGG_M = 7         # the 2 x 2 aggregation's cohort: one pad row
EPS32 = 2.0 ** -23


def fl_round_data(cfg, device: str):
    """``run_fl``'s rounds at the CLI defaults (16 clients, participation
    0.5: m = 8, batch 8 x 64, 2 local steps, cls), as data_fn(r) -> (specs,
    batches on ``device``); call it for r = 0, 1, ... in order."""
    from repro_torch.core.server import make_client_specs, select_clients
    from repro_torch.data import partition, pipeline, synthetic
    from repro_torch.launch import train
    parts = partition.iid_partition(16, 10, seed=0)
    specs = make_client_specs(cfg, 16,
                              archs=train.client_arch_pool(cfg, "width"),
                              seed=0)
    profiles = synthetic.make_class_profiles(10, cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)

    def data_fn(r):
        sel = select_clients(16, 0.5, rng)
        b = pipeline.round_batches_cls(
            parts, sel, 10, cfg.vocab_size, local_steps=2, batch=8,
            seq_len=64, profiles=profiles, seed=r)
        return [specs[i] for i in sel], {
            k: torch.as_tensor(v, dtype=torch.int64, device=device)
            for k, v in b.items()}
    return data_fn


def agg_specs(cfg, m: int):
    """The aggregation phases' cohort: m clients of the width pool, one an
    attacker (full width)."""
    from repro_torch.core.server import make_client_specs
    from repro_torch.launch import train
    return make_client_specs(cfg, m,
                             archs=train.client_arch_pool(cfg, "width"),
                             malicious_frac=1.0 / m, seed=0)


def cohort_row(index, i: int) -> torch.Tensor:
    """Client row i of the aggregation phases, drawn on the card from seed
    1000 + i (the same bits in every process), zero on the inert tail."""
    gen = torch.Generator("cuda").manual_seed(1000 + i)
    row = torch.zeros(index.n_padded, device="cuda")
    row[:index.n] = 0.02 * torch.randn(index.n, generator=gen, device="cuda")
    return row


def cohort_global(index) -> torch.Tensor:
    gen = torch.Generator("cuda").manual_seed(999)
    g = torch.zeros(index.n_padded, device="cuda")
    g[:index.n] = 0.02 * torch.randn(index.n, generator=gen, device="cuda")
    return g


def hist_groups_expected(index, cols: slice, m: int) -> dict:
    """``hist_level``'s launches by (rows, columns, shift) in one 2-D norms
    pass over the columns ``cols``, from the layout alone: segments in
    groups of 37 by id, one launch a level for each group with columns
    here."""
    from repro_torch.core import flat
    _, seg_len, _ = flat._segment_maps(index)
    start = np.concatenate([[0], np.cumsum(seg_len.astype(np.int64))])
    S = len(seg_len)
    want = collections.Counter()
    for g0 in range(0, S, 37):
        a = max(int(start[g0]), cols.start)
        b = min(int(start[min(g0 + 37, S)]), cols.stop)
        if b > a:
            for shift in (24, 16, 8, 0):
                want[(m, b - a, shift)] += 1
    return dict(want)


def mesh_counts(mesh) -> dict:
    return {f"{k} {a} {n}": c for (k, a, n), c in sorted(mesh.counts.items())}


def agg_counts_expected(n_cols: int, rows: int, S: int) -> dict:
    """The 2-D aggregation's collectives (f32 and quantized alike): one N/M
    all-reduce over ``data`` for each of M' and Γ, the α mean's (S + 1)
    sums, and one histogram all-reduce over ``model`` a level (count and
    integer Σx² planes in int64); no all-gather, no reduce-scatter."""
    return {f"all_reduce data {n_cols}": 2, f"all_reduce data {S + 1}": 1,
            f"all_reduce model {2 * rows * 2 * S * 256}": 4}


def mesh_one_rank(kernels, tmp: str) -> dict:
    """(a) A 1 x 1 mesh over NCCL in this process: two rounds' aggregation
    of a fixed full-size smollm-135m cohort (m = 8 seeded rows; no
    training, whose embedding backward is not bit-stable) through the mesh
    code, against the unsharded aggregation from the same global; the
    same launches by shape; the norms pass's thresholds bit-equal; the
    global bit-equal to the unsharded aggregation's, and that one to a
    second unsharded aggregation of the same inputs (``hist_level``'s
    planes are exact integers, summed in any order)."""
    import torch.distributed as dist
    from repro_torch.core import flat
    from repro_torch.core.fedfa import STRATEGIES
    from repro_torch.analysis.dispatch import Recorder
    from repro_torch.core.server import stack_runtimes
    from repro_torch.kernels.fedfa_agg.ops import accumulate_contract
    from repro_torch.launch.mesh import get_mesh
    from repro_torch.launch import train
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl1",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = get_mesh("1x1", "cuda")
        check(mesh.backend == "nccl", f"1 x 1 mesh backend {mesh.backend}")
        cfg = train.fl_config("smollm-135m", "cls", 10, full_size=True)
        index = model_index()
        specs = agg_specs(cfg, 8)
        masks, gates, gmaps, nd, _, _ = stack_runtimes(cfg, specs, "cuda")
        kw = dict(STRATEGIES["fedfa"], trim=0.95)
        g = cohort_global(index)
        rounds, contracts = [], []
        for rnd in range(2):
            x = torch.stack([cohort_row(index, 8 * rnd + i) for i in range(8)])

            def agg(gl, xs, **extra):
                for k in kernels:
                    k.reset()
                out = flat.aggregate_buffers(index, gl, xs, cfg, masks, gates,
                                             gmaps, nd, **kw, **extra)
                torch.cuda.synchronize()
                return out, {k.symbol: dict(k.by_shape) for k in kernels
                             if k.launches}
            mesh.counts.clear()
            mesh.ops.clear()
            with Recorder(inputs=(g, x), sweep=False) as rec:
                g_mesh, by_mesh = agg(g, x, mesh=mesh)
            counts = mesh_counts(mesh)
            if rnd == 0:    # the program contract of a one-device mesh
                contracts.append((
                    "1 x 1 NCCL mesh aggregation (m = 8)",
                    accumulate_contract(index.n_padded, mesh, rows=8,
                                        segs=index.n_segments).check(
                        rec.run(ops=list(mesh.ops))).to_json()))
            g_one, by_one = agg(g, x)
            g_again, _ = agg(g, x)
            # the norms pass's thresholds come from exact counts: bit-equal
            cols = flat.pool_cols(index, mesh, None)
            dens, fracs = flat._density_rows(cfg, index, masks, cols, "cuda")
            xm = flat._graft_flat(index, x, gmaps)[:, cols].mul_(dens)
            del x, dens
            t_mesh, _ = flat._cohort_stats(
                index, xm, fracs, 0.95, None, None, mesh,
                cols if flat.two_d(index, mesh, None) else None)
            t_one, _ = flat._cohort_stats(index, xm, fracs, 0.95)
            del xm
            check(torch.equal(t_mesh, t_one), f"1 x 1 mesh round {rnd}: "
                  f"thresholds not bit-equal to the unsharded pass")
            err = (g_mesh - g_one).abs()
            differ, self_differ = int((g_mesh != g_one).sum()), \
                int((g_again != g_one).sum())
            check(by_mesh == by_one, f"1 x 1 mesh launches {by_mesh} != "
                  f"unsharded {by_one}")
            check(counts == {f"all_reduce data {index.n_padded}": 2,
                             f"all_reduce data {index.n_segments + 1}": 1},
                  f"1 x 1 mesh collectives {counts}")
            check(self_differ == 0, f"1 x 1 mesh round {rnd}: two unsharded "
                  f"aggregations differ in {self_differ} elements")
            check(differ == 0, f"1 x 1 mesh round {rnd}: {differ} elements "
                  f"differ from the unsharded aggregation, largest "
                  f"{float(err.max()):.3g}")
            rounds.append({"bit_equal": differ == 0, "thresholds_bit_equal":
                           True, "elements_differing":
                           differ, "unsharded_self_differing": self_differ,
                           "max_abs_diff": float(err.max()),
                           "launches_by_shape": json_ready(by_mesh),
                           "collectives": counts})
            g = g_one      # round 2 from the unsharded round's global
            del g_mesh, g_again, err
        return {"mesh": "1x1", "backend": mesh.backend, "rounds": rounds,
                "contracts": contracts}
    finally:
        dist.destroy_process_group()


def mesh_rank(rank: int, tmp: str) -> None:
    """(b) One rank of the 2 x 2 mesh, spawned with three others on the
    one card (gloo: NCCL refuses two ranks on one device).  Saves its
    report and what the parent compares under ``tmp``."""
    import datetime
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/gloo",
                            rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=300))
    try:
        _mesh_rank(rank, tmp)
    finally:
        dist.destroy_process_group()


def _mesh_rank(rank: int, tmp: str) -> None:
    from repro_torch.analysis import passes, programs
    from repro_torch.analysis.dispatch import Recorder
    from repro_torch.core import flat
    from repro_torch.core.async_round import (AsyncConfig, AsyncEngine,
                                              merge_contract)
    from repro_torch.core.fedfa import STRATEGIES
    from repro_torch.core.round import (ResidentDriver, fresh_quant_state,
                                        round_contract)
    from repro_torch.core.server import FLConfig, stack_runtimes
    from repro_torch.checkpoint import checkpoint as ckpt_mod
    from repro_torch.kernels.fedfa_agg.ops import (QUANT_ACCUM, QUANT_ADMIT,
                                                   SCALED_ACCUM,
                                                   accumulate_contract)
    from repro_torch.kernels.fedfa_quantile.multilevel import (
        HIST_LEVEL, distributed_quantile_contract)
    from repro_torch.kernels.fedfa_quantile.ops import QUANTILE_FUSED
    from repro_torch.launch import train
    from repro_torch.launch.mesh import get_mesh
    from repro_torch.models.model import init_params
    from repro_torch.sharding import cohort as csh
    from repro_torch.sharding import collectives as coll
    from repro_torch.sim import ParitySource
    from repro_torch.tree import tree_map
    kernels = [SCALED_ACCUM, QUANTILE_FUSED, HIST_LEVEL, QUANT_ACCUM,
               QUANT_ADMIT]
    mesh = get_mesh("2x2", "cuda")
    cfg = train.fl_config("smollm-135m", "cls", 10, full_size=True)
    index = model_index(pad_to=csh.pad_unit(mesh))
    S, cols = index.n_segments, flat.pool_cols(index, mesh, None)
    width = cols.stop - cols.start
    out = {"rank": rank, "coord": mesh.coord, "backend": mesh.backend,
           "device": torch.cuda.current_device(), "n_padded": index.n_padded,
           "contracts": []}

    def measure(fn):
        for k in kernels:
            k.reset()
        mesh.counts.clear()
        mesh.ops.clear()
        mesh.staged_bytes = 0
        collect_garbage()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, {"ms": (time.perf_counter() - t0) * 1e3,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "launches_by_shape": {
                         k.symbol: {sh: n for sh, n in k.by_shape.items()}
                         for k in kernels if k.launches},
                     "collectives": mesh_counts(mesh),
                     "staged_bytes": mesh.staged_bytes}

    recs = {}

    def recorded(fn, inputs, row_elems=None):
        """``fn`` run under a ``Recorder`` (its peak the allocator's), kept
        in ``recs["last"]``."""
        def run():
            with Recorder(row_elems=row_elems, inputs=inputs,
                          sweep=False) as rec:
                res = fn()
            recs["last"] = rec
            return res
        return run

    def held_to(name, contract, rec, **kw):
        """This rank's ``contract`` on the run ``rec`` recorded."""
        rep = contract.check(rec.run(ops=list(mesh.ops), **kw))
        rep.measured["kernel_calls"] = rec.counts.kernels
        out["contracts"].append((name, rep.to_json()))

    def keep(name, t):
        """This rank's slice: its sha256, and the slice itself from the
        ranks of data index 0 (the data peers hold the same bits)."""
        t = t.contiguous()
        out[name + "_sha256"] = hashlib.sha256(
            t.cpu().numpy().tobytes()).hexdigest()
        if mesh.coord[0] == 0:
            torch.save(t.cpu(), f"{tmp}/{name}_{mesh.coord[1]}.pt")

    # aggregation of a seeded m = 7 cohort (one pad row), f32 and int8
    rows = csh.data_rows(mesh, MESH_AGG_M + 1)
    specs = agg_specs(cfg, MESH_AGG_M)
    runtimes, _ = csh.pad_cohort(stack_runtimes(cfg, specs, "cuda"), {}, 1)
    masks, gates, gmaps, nd, _, _ = (csh.rows_of(t, rows) for t in runtimes)
    x = torch.stack([cohort_row(index, i if i < MESH_AGG_M else 0)
                     for i in range(rows.start, rows.stop)])
    g = cohort_global(index)[csh.model_cols(mesh, index.n_padded)].clone()
    kw = dict(STRATEGIES["fedfa"], trim=0.95, mesh=mesh)
    # twice: the first call also loads the kernels and warms the groups;
    # the second recorded for its program contract
    def aggregate_f32():
        return flat.aggregate_buffers(index, g, x, cfg, masks, gates, gmaps,
                                      nd, **kw)
    for i in range(2):
        g_new, out["aggregate_f32"] = measure(
            recorded(aggregate_f32, (g, x)) if i else aggregate_f32)
        out.setdefault("aggregate_f32_cold_ms", out["aggregate_f32"]["ms"])
    held_to(f"2 x 2 aggregation (f32, m = {MESH_AGG_M})",
            accumulate_contract(index.n_padded, mesh, rows=MESH_AGG_M + 1,
                                segs=S), recs["last"])
    keep("agg_f32", g_new)
    dens, fracs = flat._density_rows(cfg, index, masks, cols, "cuda")
    xm = flat._graft_flat(index, x, gmaps)[:, cols] * dens
    del dens
    mesh.ops.clear()
    t, ss = recorded(lambda: flat._cohort_stats(
        index, xm, fracs, 0.95, None, None, mesh, cols), (xm, fracs),
        row_elems=xm.numel())()
    held_to("2 x 2 distributed trimmed quantile (f32)",
            distributed_quantile_contract(
                xm.shape[0], S, xm.numel() * xm.element_size()),
            recs["last"])
    del xm
    state = fresh_quant_state(index, rows.stop - rows.start, "int8", "cuda",
                              width)
    _, out["admit_int8"] = measure(lambda: flat.admit_quantized(
        index, cfg, x, masks, gmaps, True, state, "int8", mesh, cols))
    del x
    g_new, out["aggregate_int8"] = measure(lambda: flat.aggregate_buffers(
        index, g, state[0], cfg, masks, gates, gmaps, nd, scales=state[1],
        pregrafted=True, **kw))
    keep("agg_int8", g_new)
    tq, ssq = flat._cohort_stats(index, state[0], fracs, 0.95, state[1],
                                 None, mesh, cols)
    torch.save({"t": t.cpu(), "ss": ss.cpu(), "tq": tq.cpu(),
                "ssq": ssq.cpu(), "scales": state[1].cpu()},
               f"{tmp}/stats_{rank}.pt")
    del state, g_new, g

    # the gloo collectives alone: an N/M f32 all-reduce over data, the
    # global's all-gather over model
    buf = torch.ones(width, device="cuda")
    for name, fn in (("all_reduce_data_ms", lambda: coll.all_reduce(
            buf, mesh, csh.DATA_AXIS)), ("all_gather_model_ms", lambda:
            coll.all_gather(buf, mesh, csh.MODEL_AXIS))):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = times
    del buf

    # 2 resident rounds at m = 8 (the CLI defaults' cohort), f32
    params = tree_map(lambda a: a.to("cuda"), init_params(
        cfg, torch.Generator().manual_seed(0)))
    fl = FLConfig(participation=0.5, local_steps=2, lr=0.05,
                  strategy="fedfa", task="cls")
    driver = ResidentDriver(cfg, fl, index, "cuda", mesh)
    g_buf = flat.flatten(index, params)[csh.model_cols(
        mesh, index.n_padded)].clone()
    data_fn = fl_round_data(cfg, "cuda")
    out["rounds"] = []
    for r in range(2):
        specs_r, batches = data_fn(r)
        if r == 0:
            loss, rep = measure(lambda: float(driver.round(g_buf, specs_r,
                                                           batches)))
        else:   # recorded, with the buffers it holds in place
            (loss, rec, held), rep = measure(lambda: passes.run_in_place(
                lambda g_, c_: float(driver.round(g_, specs_r, batches)),
                (g_buf, driver.pool(len(specs_r))[0]), sweep=False))
            held_to(f"2 x 2 resident round (f32, m = {len(specs_r)})",
                    round_contract(index, mesh, rows=len(specs_r)), rec,
                    in_place=held)
        out["rounds"].append(dict(rep, loss=loss))
    del driver
    g_full = coll.gather_model(g_buf, mesh, index.n_padded)
    if rank == 0:
        torch.save(g_full.cpu(), f"{tmp}/rounds.pt")
    # a checkpoint from the model-sharded global, restored onto it
    t0 = time.perf_counter()
    ckpt_mod.save_from_buffer(f"{tmp}/mesh_ckpt", index, g_buf,
                              meta={"round": 1}, mesh=mesh)
    t1 = time.perf_counter()
    _, back, meta = ckpt_mod.restore_to_buffer(f"{tmp}/mesh_ckpt", params,
                                               mesh=mesh)
    out["checkpoint"] = {"restored_bit_equal": bool(torch.equal(back,
                                                               g_buf)),
                         "write_s": t1 - t0,
                         "read_s": time.perf_counter() - t1,
                         "meta": meta}
    del back, g_full

    # one async merge at int8 (parity mode: the 8 clients of round 0)
    fl8 = FLConfig(participation=0.5, local_steps=2, lr=0.05,
                   strategy="fedfa", task="cls", update_dtype="int8")
    g_loc = flat.flatten(index, params)[csh.model_cols(
        mesh, index.n_padded)].clone()
    eng = AsyncEngine(g_loc, cfg, fl8, index,
                      ParitySource(fl_round_data(cfg, "cuda")),
                      acfg=AsyncConfig.parity(8), mesh=mesh)

    def merge():
        while eng.merges < 1:
            loss = eng.step()
        return loss
    loss, rep = measure(merge)
    out["async_int8"] = dict(rep, loss=loss)
    g_full = coll.gather_model(eng.g_buf, mesh, index.n_padded)
    if rank == 0:
        torch.save(g_full.cpu(), f"{tmp}/async.pt")
    del g_full
    # one more merge of the pool the parity merge admitted (after the
    # global above was kept), recorded for its program contract
    specs0, _ = fl_round_data(cfg, "cuda")(0)
    eng.pool.admit(np.arange(len(specs0)), specs0, np.zeros(len(specs0)),
                   eng.now, eng.version)
    eng.pool.loss[:len(specs0)] = 0.0    # not trained again: no new loss
    collect_garbage()
    rec, held = programs.record_merge(eng, mesh, sweep=False)
    held_to(f"2 x 2 async merge (int8, pool of {eng.rows})",
            merge_contract(index, mesh, rows=eng.rows), rec, in_place=held)
    torch.save(out, f"{tmp}/mesh_rank{rank}.pt")


def mesh_two_by_two(tmp: str) -> list:
    """Spawn the 4 ranks of the 2 x 2 mesh on the card and wait for them;
    any rank's failure fails the run."""
    import torch.multiprocessing as mp
    torch.cuda.empty_cache()
    ctx = mp.start_processes(mesh_rank, args=(tmp,), nprocs=4, join=False,
                             start_method="spawn")
    while not ctx.join(timeout=600):
        pass
    return [torch.load(f"{tmp}/mesh_rank{r}.pt") for r in range(4)]


def mesh_references(ranks: list, tmp: str) -> dict:
    """The 2 x 2 mesh against this process's unsharded runs of the same
    work: thresholds bit-equal; Σx² bit-equal to the unsharded run of the
    2-D pass's search (the segmented multilevel quantile on whole rows:
    the shards' integer planes sum to its planes exactly) and at rtol 1e-5
    to the per-leaf path's; the quantized scales bit-equal, the merged
    globals within 8 ulp of the sums' magnitude (the shards' partial sums
    of M' and Γ); the rounds and the async merge through ``round_close``
    (f32: no admission step allowed)."""
    from repro_torch.core import flat
    from repro_torch.core.async_round import AsyncConfig, AsyncEngine
    from repro_torch.core.fedfa import STRATEGIES
    from repro_torch.core.round import fresh_quant_state, run_rounds
    from repro_torch.core.server import FLConfig, stack_runtimes
    from repro_torch.launch import train
    from repro_torch.models.model import init_params
    from repro_torch.sim import ParitySource
    from repro_torch.tree import tree_map
    cfg = train.fl_config("smollm-135m", "cls", 10, full_size=True)
    index = model_index()
    n = index.n
    report = {}
    for o in ranks:         # data peers hold the same global bits
        peer = next(p for p in ranks if p["coord"] == (1 - o["coord"][0],
                                                       o["coord"][1]))
        for key in ("agg_f32_sha256", "agg_int8_sha256"):
            check(o[key] == peer[key], f"2 x 2: data peers' {key} differ")
    specs = agg_specs(cfg, MESH_AGG_M)
    masks, gates, gmaps, nd, _, _ = stack_runtimes(cfg, specs, "cuda")
    x = torch.stack([cohort_row(index, i) for i in range(MESH_AGG_M)])
    g = cohort_global(index)
    kw = dict(STRATEGIES["fedfa"], trim=0.95)
    dens, fracs = flat._density_rows(cfg, index, masks, slice(0, n), "cuda")
    xm = flat._graft_flat(index, x, gmaps) * dens
    whole = slice(0, index.n_padded)
    t, ss = flat._cohort_stats(index, xm, fracs, 0.95)
    ss_seg = flat._cohort_stats(index, xm, fracs, 0.95, cols=whole)[1]
    del dens, xm
    state = fresh_quant_state(index, MESH_AGG_M, "int8", "cuda")
    flat.admit_quantized(index, cfg, x, masks, gmaps, True, state, "int8")
    tq, ssq = flat._cohort_stats(index, state[0], fracs, 0.95, state[1])
    ssq_seg = flat._cohort_stats(index, state[0], fracs, 0.95, state[1],
                                 cols=whole)[1]
    for o in ranks:
        got = torch.load(f"{tmp}/stats_{o['rank']}.pt")
        r0 = 4 * o["coord"][0]
        k = min(4, MESH_AGG_M - r0)
        for a, b, what in ((got["t"], t, "t"), (got["tq"], tq, "tq"),
                           (got["scales"], state[1], "scales"),
                           (got["ss"], ss_seg, "ss"),
                           (got["ssq"], ssq_seg, "ssq")):
            check(torch.equal(a[:k], b[r0:r0 + k].cpu()),
                  f"2 x 2 rank {o['rank']}: {what} not bit-equal")
        for a, b, what in ((got["ss"], ss, "ss"), (got["ssq"], ssq, "ssq")):
            check(torch.allclose(a[:k], b[r0:r0 + k].cpu(), rtol=1e-5,
                                 atol=0), f"2 x 2 rank {o['rank']}: {what}")
    for dt, xs, extra in (("f32", x, {}), ("int8", state[0], dict(
            scales=state[1], pregrafted=True))):
        want = flat.aggregate_buffers(index, g, xs, cfg, masks, gates, gmaps,
                                      nd, **kw, **extra)
        scale = flat.aggregate_buffers(index, torch.zeros_like(g), xs.abs(),
                                       cfg, masks, gates, gmaps, nd, **kw,
                                       **extra)
        got = torch.cat([torch.load(f"{tmp}/agg_{dt}_{k}.pt")
                         for k in range(2)]).cuda()
        check(not got[n:].any(), f"2 x 2 {dt}: the inert tail moved")
        err = (got[:n] - want).abs()
        ratio = float((err / (8 * EPS32 * scale).clamp_min(1e-38)).max())
        check(ratio <= 1.0, f"2 x 2 {dt} aggregation: {ratio:.3g} of the "
              f"8-ulp bound")
        report[f"aggregate_{dt}"] = {
            "max_abs_diff": float(err.max()), "of_8ulp_bound": ratio,
            "elements_differing": int((got[:n] != want).sum())}
        del want, scale, got, err
    del x, state
    params = tree_map(lambda a: a.to("cuda"), init_params(
        cfg, torch.Generator().manual_seed(0)))
    fl = FLConfig(participation=0.5, local_steps=2, lr=0.05,
                  strategy="fedfa", task="cls")
    p, losses = run_rounds(params, cfg, fl, 2, fl_round_data(cfg, "cuda"),
                           eval_every=0)
    want = flat.flatten(index, p).cpu().numpy()
    got = torch.load(f"{tmp}/rounds.pt")[:n].numpy()
    round_close(got, want, np.zeros_like(want), "2 x 2 resident rounds")
    report["rounds"] = {"losses": [o["loss"] for o in ranks[0]["rounds"]],
                        "unsharded_losses": losses,
                        "max_abs_diff": float(np.abs(got - want).max())}
    del p
    fl8 = FLConfig(participation=0.5, local_steps=2, lr=0.05,
                   strategy="fedfa", task="cls", update_dtype="int8")
    eng = AsyncEngine(flat.flatten(index, params), cfg, fl8, index,
                      ParitySource(fl_round_data(cfg, "cuda")),
                      acfg=AsyncConfig.parity(8))
    while eng.merges < 1:
        eng.step()
    want = eng.g_buf.cpu().numpy()
    steps = eng._c_buf[1].amax(0)[torch.as_tensor(
        index.row_of, device="cuda").long()].cpu().numpy()
    got = torch.load(f"{tmp}/async.pt")[:n].numpy()
    round_close(got, want, steps, "2 x 2 async int8 merge")
    report["async_int8"] = {"max_abs_diff": float(np.abs(got - want).max())}
    return report


def mesh_kernel_rows(ranks: list) -> list:
    """Kernels 1, 3 and 4 at the 2 x 2 mesh's shapes, timed on this card:
    ``scaled_accum`` and ``quant_accum`` on a rank's (4, N/M) slice,
    ``hist_level`` on the top level of rank 0's widest segment group; the
    launches are rank 0's in one aggregation (f32, and int8 for 4)."""
    from repro_torch.kernels.fedfa_agg import ops as agg_ops
    from repro_torch.kernels.fedfa_agg import ref as agg_ref
    from repro_torch.kernels.fedfa_quantile import multilevel
    from repro_torch.kernels.fedfa_quantile import ref as q_ref
    from repro_torch.core import flat
    from repro_torch.sharding import cohort as csh
    rank0 = next(o for o in ranks if o["rank"] == 0)
    index = model_index(pad_to=2 * csh.TILE)
    cols = slice(0, index.n_padded // 2)
    m, w = 4, cols.stop - cols.start
    gen = torch.Generator("cuda").manual_seed(5)
    x = torch.randn((m, w), generator=gen, device="cuda")
    wts = torch.rand(m, generator=gen, device="cuda")
    ones = torch.ones(w, device="cuda")
    rows, f32 = [], rank0["aggregate_f32"]["launches_by_shape"]
    out = agg_ops.scaled_accum(x, wts, ones)
    mag = agg_ref.scaled_accum_ref(x.abs(), wts.abs(), ones)
    err = (out - agg_ref.scaled_accum_ref(x, wts, ones)).abs()
    check(bool((err <= 1e-5 * mag).all()),
          "scaled_accum (mesh slice) disagrees")
    err = float(err.max())
    del out, mag
    ms = time_ms(lambda: agg_ops.scaled_accum(x, wts, ones), 10)
    b, by = bound((m * w + m + 2 * w) * 4, 2 * m * w + w)
    rows.append({"name": "scaled_accum", "dtype": "f32",
                 "path": "2 x 2 mesh, a rank's (m/D, N/M) slice",
                 "route": "cuda", "source": "src/repro_torch/csrc/scaled_accum.cu",
                 "replaces": "src/repro/kernels/fedfa_agg/kernel.py:71",
                 "shape": [m, w],
                 "launches": f32["scaled_accum"].get((m, w), 0),
                 "max_abs_err": err, "ms": ms,
                 "plain_ms": time_ms(lambda: agg_ref.scaled_accum_ref(
                     x, wts, ones), 3),
                 "bound_ms": b, "bound_by": by,
                 "library_ms": time_ms(lambda: torch.mv(x.t(), wts) * ones,
                                       10)})
    seg_id = flat._device_seg_id(index, "cuda")[cols]
    groups = [gr for gr in multilevel.segment_groups(seg_id,
                                                     index.n_segments)
              if gr[3] > gr[2]]
    g0, g1, c0, c1 = max(groups, key=lambda gr: gr[3] - gr[2])
    xs = x[:, c0:c1].contiguous()
    sg = (seg_id[c0:c1] - g0).to(torch.int32)
    hi = torch.zeros((m, 2, g1 - g0), dtype=torch.int32, device="cuda")
    cnt, sq = multilevel.hist_level(xs, sg, hi, 24)
    rc, rs = q_ref.hist_level_ref(xs, sg, hi, 24)
    check(torch.equal(cnt, rc), "hist_level (mesh group): counts differ")
    check(torch.equal(sq, rs), "hist_level (mesh group): Σx² differ")
    C, Sg = c1 - c0, g1 - g0
    b, by = bound(m * C * 4 + (C + m * 2 * Sg) * 4 + m * 2 * Sg * 256 * 12,
                  m * C)
    rows.append({"name": "hist_level", "dtype": "f32",
                 "path": f"2 x 2 mesh, rank 0's widest segment group "
                         f"(S = {Sg}), top level",
                 "route": "cuda", "source": "src/repro_torch/csrc/hist_level.cu",
                 "replaces": "src/repro/kernels/fedfa_quantile/multilevel.py:107",
                 "shape": [m, C], "level": 0,
                 "launches": f32["hist_level"].get((m, C, 24), 0),
                 "max_abs_err": float((sq - rs).abs().max()),
                 "ms": time_ms(lambda: multilevel.hist_level_planes(
                     xs, sg, hi, 24), 10),
                 "plain_ms": time_ms(lambda: q_ref.hist_level_planes_ref(
                     xs, sg, hi, 24), 2),
                 "bound_ms": b, "bound_by": by, "library_ms": None})
    del xs
    q = torch.randint(-127, 128, (m, w), generator=gen, device="cuda",
                      dtype=torch.int8)
    wtab = torch.rand((m, index.n_segments), generator=gen, device="cuda")
    seg32 = seg_id.contiguous()
    out = agg_ops.quant_accum(q, wtab, seg32, ones)
    mag = agg_ref.quant_accum_ref(q.abs(), wtab, seg32, ones)
    err = (out - agg_ref.quant_accum_ref(q, wtab, seg32, ones)).abs()
    check(bool((err <= 1e-5 * mag).all()),
          "quant_accum (mesh slice) disagrees")
    err = float(err.max())
    del out, mag
    b, by = bound(m * w + 12 * w + wtab.numel() * 4, 2 * m * w + w)
    rows.append({"name": "quant_accum", "dtype": "int8",
                 "path": "2 x 2 mesh, a rank's (m/D, N/M) slice",
                 "route": "cuda", "source": "src/repro_torch/csrc/quant_accum.cu",
                 "replaces": "src/repro/kernels/fedfa_agg/kernel.py:117",
                 "shape": [m, w],
                 "launches": rank0["aggregate_int8"]["launches_by_shape"]
                 .get("quant_accum", {}).get((m, w), 0),
                 "max_abs_err": err,
                 "ms": time_ms(lambda: agg_ops.quant_accum(q, wtab, seg32,
                                                           ones), 10),
                 "plain_ms": time_ms(lambda: agg_ref.quant_accum_ref(
                     q, wtab, seg32, ones), 3),
                 "bound_ms": b, "bound_by": by, "library_ms": None})
    return rows


def mesh_path(kernels, card: str) -> tuple:
    """The sharded FL server: (a) ``mesh_one_rank``; (b) the 2 x 2 mesh of
    4 processes on the card, each rank's launches and collectives checked
    exactly, then held against this process's unsharded runs
    (``mesh_references``); the kernels at the mesh's shapes."""
    from repro_torch.core import flat
    from repro_torch.sharding import cohort as csh
    # NCCL allocates outside PyTorch's caching allocator, so hand back what
    # the earlier phases' cache holds first
    collect_garbage()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"mesh_path: {free / 2**30:.1f} of {total / 2**30:.1f} GiB free")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        one = mesh_one_rank(kernels, tmp)
        t1 = time.perf_counter()
        ranks = mesh_two_by_two(tmp)
        t2 = time.perf_counter()
        index = model_index(pad_to=2 * csh.TILE)
        S = index.n_segments
        for o in ranks:
            d, k = o["coord"]
            check(o["backend"] == "gloo" and o["device"] == 0,
                  f"rank {o['rank']}: {o['backend']} on cuda:{o['device']}")
            cols = slice(k * index.n_padded // 2, (k + 1) * index.n_padded // 2)
            w = cols.stop - cols.start
            hist = hist_groups_expected(index, cols, 4)
            agg = {"scaled_accum": {(4, w): 2}, "hist_level": hist}
            aggq = {"scaled_accum": {(4, w): 1}, "quant_accum": {(4, w): 1},
                    "hist_level": hist}
            cc = agg_counts_expected(w, 4, S)
            # the rank's 4 rows admitted over its columns (the inert tail
            # left out): one launch a step
            admit = {"quant_admit": {
                (step, 4, min(cols.stop, index.n) - cols.start): 1
                for step in (1, 2, 3)}}
            for key, want_l, want_c in (
                    ("aggregate_f32", agg, cc), ("aggregate_int8", aggq, cc),
                    ("admit_int8", admit,
                     {f"all_reduce_max model {4 * S}": 2})):
                got = o[key]
                check(got["launches_by_shape"] == want_l,
                      f"rank {o['rank']} {key}: launches "
                      f"{got['launches_by_shape']}, expected {want_l}")
                check(got["collectives"] == want_c,
                      f"rank {o['rank']} {key}: collectives "
                      f"{got['collectives']}, expected {want_c}")
            for r, rep in enumerate(o["rounds"]):
                want_c = dict(cc, **{f"all_gather model {w}": 1,
                                     "all_reduce data 2": 1})
                check(rep["launches_by_shape"] == agg
                      and rep["collectives"] == want_c,
                      f"rank {o['rank']} round {r}: {rep['launches_by_shape']}"
                      f" {rep['collectives']}")
            want_c = dict(cc, **{f"all_gather model {w}": 1,
                                 "all_reduce data 2": 1,
                                 f"all_reduce_max model {4 * S}": 2})
            rep = o["async_int8"]
            check(rep["launches_by_shape"] == dict(aggq, **admit)
                  and rep["collectives"] == want_c,
                  f"rank {o['rank']} async merge: {rep['launches_by_shape']} "
                  f"{rep['collectives']}")
            check(o["checkpoint"]["restored_bit_equal"],
                  f"rank {o['rank']}: checkpoint not restored bit-equal")
            names = [name for name, _ in o["contracts"]]
            check(len(names) == 4, f"rank {o['rank']}: contracts {names}")
        ref = mesh_references(ranks, tmp)
        t3 = time.perf_counter()
    rows = mesh_kernel_rows(ranks)
    # the program contracts, every rank's (the analysis phase prints them)
    contracts = [(f"{name}, rank {o['rank']}", rep) for o in ranks
                 for name, rep in o.pop("contracts")]
    contracts = one.pop("contracts") + contracts
    report = {"one_rank_nccl": one,
              "two_by_two": {"ranks": json_ready(ranks),
                             "against_unsharded": ref},
              "seconds": {"one_rank": t1 - t0, "two_by_two_ranks": t2 - t1,
                          "references": t3 - t2,
                          "phase": time.perf_counter() - t0},
              "card": card}
    return report, rows, contracts


def fixture_launches() -> dict:
    """Each fixture program's kernel launches, predicted from the fixture's
    layout (``analysis.programs``): the norms pass launches
    ``quantile_fused`` once a leaf whose rows fit one pass and
    ``hist_level`` once a level for each longer leaf; M' and Γ one
    ``scaled_accum`` each (M' ``quant_accum`` at int8); an int8 admission
    ``quant_admit`` three times, an f32 one nothing; the quantile fixtures
    one ``quantile_fused`` each, or
    four ``hist_level`` levels for the long row."""
    from repro_torch.analysis import programs
    from repro_torch.core import flat
    _, _, params, _, _ = programs._fixture(1)
    index = flat.FlatIndex(params)
    one = sum(-(-lf.rest // 128) * 128 <= 1 << 18 for lf in index.leaves)
    norms = {"quantile_fused": one,
             "hist_level": 4 * (len(index.leaves) - one)}
    agg = dict(norms, scaled_accum=2)
    want = {"round/ms1": agg, "agg/1dev": agg, "async/merge": agg,
            "round/quant": dict(norms, scaled_accum=1, quant_accum=1,
                                quant_admit=3),
            "async/admit": {}, "async/admit-quant": {"quant_admit": 3},
            "quantile/fused": {"quantile_fused": 1}, "quantile/topk": {},
            "quantile/fused-pad": {"quantile_fused": 1},
            "quantile/topk-pad": {}, "quantile/multilevel": {"hist_level": 4}}
    return {k: {n: c for n, c in v.items() if c} for k, v in want.items()}


def analysis_phase(kernels, card: str, full_width: list,
                   mesh_contracts: list) -> None:
    """The program contracts (``repro_torch.analysis``), in three JSON
    lines, each failing the run on any FAIL:

    1. the fixture programs on the card (``programs.canonical_reports`` in
       one process, no mesh; once to warm up, then measured): every
       contract PASSes; each program's kernel calls equal the prediction
       (``fixture_launches``) and together the kernels' own launch counts;
       row reads and sorts equal the same programs' on the CPU; the
       card's allocator peak printed beside the CPU's storage sweep;
    2. the full-width contracts recorded on the main path's state
       (``round_contracts``, ``async_contracts``);
    3. the mesh contracts recorded in ``mesh_path`` (every rank's).
    """
    from repro_torch.analysis import programs
    t0 = time.perf_counter()
    programs.canonical_reports(device="cuda", meshes=False)    # warm-up
    for k in kernels:
        k.reset()
    collect_garbage()
    t1 = time.perf_counter()
    reports = programs.canonical_reports(device="cuda", meshes=False)
    t2 = time.perf_counter()
    launched = {k.symbol: k.launches for k in kernels if k.launches}
    cpu = {r.contract.name: r
           for r in programs.canonical_reports(device="cpu", meshes=False)}
    want = fixture_launches()
    rows, calls = [], collections.Counter()
    for rep in reports:
        name, got = rep.contract.name, rep.measured
        here = cpu[name].measured
        # the round's launches and those of round/quant's read count
        calls.update(got["kernel_calls"])
        calls.update(got.get("reads_kernel_calls", {}))
        check(rep.ok, f"analysis: {name} FAILs on the card: "
              f"{rep.violations}")
        check(cpu[name].ok, f"analysis: {name} FAILs on the CPU: "
              f"{cpu[name].violations}")
        check(got["kernel_calls"] == want[name],
              f"analysis: {name} launched {got['kernel_calls']}, predicted "
              f"{want[name]}")
        for key in ("row_reads", "sorts"):
            check(got.get(key) == here.get(key),
                  f"analysis: {name} {key} {got.get(key)} on the card, "
                  f"{here.get(key)} on the CPU")
        rows.append(dict(rep.to_json(),
                         card_peak_bytes=got["peak_live_bytes_per_device"],
                         cpu_sweep_peak_bytes=here[
                             "peak_live_bytes_per_device"]))
    check(dict(calls) == launched, f"analysis: the programs' kernel calls "
          f"{dict(calls)} differ from the kernels' launches {launched}")
    print(json.dumps({"analysis": {
        "part": "fixture programs on the card", "reports": rows,
        "launches": launched, "warmup_s": t1 - t0, "measured_s": t2 - t1,
        "cpu_s": time.perf_counter() - t2, "card": card}}), flush=True)
    full = [dict(rep.to_json(), run=name, seconds=sec)
            for name, rep, sec in full_width]
    print(json.dumps({"analysis": {
        "part": "full width (smollm-135m, m = 8)", "reports": full,
        "card": card}}), flush=True)
    mesh = [dict(rep, run=name) for name, rep in mesh_contracts]
    print(json.dumps({"analysis": {
        "part": "meshes (1 x 1 NCCL, 2 x 2 gloo)", "reports": mesh,
        "card": card}}), flush=True)
    for rep in full + mesh:
        check(rep["ok"], f"analysis: {rep['run']} {rep['program']} FAILs: "
              f"{rep['violations']}")
    check(len(full) == 8 and len(mesh) == 1 + 4 * 4,
          f"analysis: {len(full)} full-width and {len(mesh)} mesh "
          f"contracts")
    log(f"analysis phase: {time.perf_counter() - t0:.1f} s here, "
        f"{sum(sec for _, _, sec in full_width):.1f} s of full-width "
        f"recording")


def json_ready(obj):
    """``obj`` with every dict keyed by tuples (launches by shape) as a list
    of [list(key), value] pairs."""
    if isinstance(obj, dict):
        if any(isinstance(k, tuple) for k in obj):
            return [[list(k), json_ready(v)] for k, v in obj.items()]
        return {k: json_ready(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_ready(v) for v in obj]
    return obj


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
    from repro_torch.kernels.fedfa_agg.ops import (QUANT_ACCUM, QUANT_ADMIT,
                                                   SCALED_ACCUM,
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
               TRIMMED_SUMSQ, SSD_INTRA_CHUNK, FLASH_ATTENTION, QUANT_ADMIT]
    t0 = time.perf_counter()
    build.build_all(kernels)
    log(f"built {len(kernels)} kernels in {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        log(k.library.with_suffix(".log").read_text().strip()
            if k.library.with_suffix(".log").exists() else k.library.name)

    admit_rows = quant_admit_checks(card)
    small_reference_check()
    for dtype in ("int8", "bf16"):
        small_quantized_check(dtype)
    print(json.dumps({"small_async": small_async_check()}), flush=True)
    small_reference_check("mamba2-130m")
    small_quantized_check("int8", "mamba2-130m")
    small_reference_check(PHI)
    small_quantized_check("int8", PHI)
    small_reference_check(RG)
    small_quantized_check("int8", RG)
    print(json.dumps({"small_moe_prefill": small_moe_prefill_check()}),
          flush=True)
    print(json.dumps({"small_dense": small_dense_check()}), flush=True)
    print(json.dumps({"small_audio": small_family_check(WHISPER)}),
          flush=True)
    print(json.dumps({"small_vlm": small_family_check(VLM)}), flush=True)
    print(json.dumps({"small_tree": small_tree_check(kernels)}), flush=True)
    f32_path = [SCALED_ACCUM, QUANTILE_FUSED, HIST_LEVEL]
    launches, shapes, quantile_calls = {}, {}, {}
    full_width = []     # the analysis phase's full-width contracts
    for dtype in ("f32", "int8", "bf16"):
        hist = main_path(kernels, dtype, f32_path if dtype == "f32"
                         else f32_path + [QUANT_ACCUM, QUANT_ADMIT],
                         contracts=full_width if dtype != "bf16" else None)
        check_fl_launches(hist, "smollm-135m", dtype)
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
    # FL training of mamba2-130m at full size through the aggregation
    # kernels, and its kernels on the rows it passed them
    fl_rows = []
    for dtype in ("f32", "int8"):
        hist = main_path(kernels, dtype, f32_path if dtype == "f32"
                         else f32_path + [QUANT_ACCUM, QUANT_ADMIT],
                         arch="mamba2-130m",
                         record_all=True)
        check_fl_launches(hist, "mamba2-130m", dtype)
        print(json.dumps({"fl_path": {"arch": "mamba2-130m",
                                      "update_dtype": dtype, **{
            k: hist[k] for k in ("round_loss", "global_acc", "local_acc",
                                 "launches", "seconds", "peak_gib")},
            "launches_by_shape": {
                sym: [[list(shape), n] for shape, n in c.items()]
                for sym, c in hist["by_shape"].items() if c}},
            "card": card}), flush=True)
        fl_rows += fl_path_kernel_rows(hist, "mamba2-130m", dtype, kernels)
        del hist
    # FL training of phi3.5-moe at the CLI's 4-layer cut through the
    # aggregation kernels (its expert rows are 2^18 long: quantile_fused,
    # no hist_level), and its kernels on the rows it passed them
    for dtype in ("f32", "int8"):
        hist = main_path(kernels, dtype, [SCALED_ACCUM, QUANTILE_FUSED]
                         + ([QUANT_ACCUM, QUANT_ADMIT] if dtype == "int8"
                            else []),
                         arch=PHI, record_all=True, full_size=False)
        check_fl_launches(hist, PHI, dtype, full_size=False)
        print(json.dumps({"fl_path": {"arch": PHI, "cut": "4 layers",
                                      "update_dtype": dtype, **{
            k: hist[k] for k in ("round_loss", "global_acc", "local_acc",
                                 "launches", "seconds", "peak_gib")},
            "launches_by_shape": {
                sym: [[list(shape), n] for shape, n in c.items()]
                for sym, c in hist["by_shape"].items() if c}},
            "card": card}), flush=True)
        fl_rows += fl_path_kernel_rows(hist, PHI, dtype, kernels,
                                       path=f"{PHI} fl (4-layer cut)")
        del hist
    # FL training of recurrentgemma-2b at the CLI's 4-layer cut (stage 1 a
    # lone rglru block; every row at most 2^18: quantile_fused, no
    # hist_level), its kernels on the rows it passed them, and one round
    # and its aggregation timed
    for dtype in ("f32", "int8"):
        hist = main_path(kernels, dtype, [SCALED_ACCUM, QUANTILE_FUSED]
                         + ([QUANT_ACCUM, QUANT_ADMIT] if dtype == "int8"
                            else []),
                         arch=RG, record_all=True, full_size=False)
        check_fl_launches(hist, RG, dtype, full_size=False)
        print(json.dumps({"fl_path": {"arch": RG, "cut": "4 layers",
                                      "update_dtype": dtype, **{
            k: hist[k] for k in ("round_loss", "global_acc", "local_acc",
                                 "launches", "seconds", "peak_gib")},
            "launches_by_shape": {
                sym: [[list(shape), n] for shape, n in c.items()]
                for sym, c in hist["by_shape"].items() if c}},
            "card": card}), flush=True)
        fl_rows += fl_path_kernel_rows(hist, RG, dtype, kernels,
                                       path=f"{RG} fl (4-layer cut)")
        del hist
        timing, g = round_timing(dtype, RG, full_size=False)
        print(json.dumps({"round": timing, "card": card}), flush=True)
        del g
    for dtype in ("f32", "int8"):
        timing, g = round_timing(dtype, "mamba2-130m")
        print(json.dumps({"round": timing, "card": card}), flush=True)
        del g
    dense = dense_path(kernels)
    print(json.dumps({"dense_path": dense, "card": card}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in ("f32", "int8"):
            res, eng = async_path(kernels, dtype, ckpt=tmp + "/async"
                                  if dtype == "f32" else None)
            launches[f"async-{dtype}"] = res["launches"]
            print(json.dumps({"async_path": res, "card": card}), flush=True)
            if dtype == "f32":
                print(json.dumps({"checkpoint": checkpoint_path(
                    eng, tmp + "/async"), "card": card}), flush=True)
            full_width += async_contracts(eng, dtype)
            del eng
    for dtype in ("f32", "int8"):
        timing, g = round_timing(dtype)
        print(json.dumps({"round": timing, "card": card}), flush=True)
    tn = trimmed_norm_path(kernels, g)
    launches["trimmed_norm"] = tn["launches"]
    print(json.dumps({"trimmed_norm_path": tn}), flush=True)
    del g
    serve_card_vs_cpu(FLASH_ATTENTION)
    serve_card_vs_cpu(FLASH_ATTENTION, "hybrid")
    serve_card_vs_cpu(FLASH_ATTENTION, "audio")
    serve_card_vs_cpu(FLASH_ATTENTION, "vlm")
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
    # the whole-step FLOP counts over the dense step's and the long
    # prefill's measured times
    print(json.dumps({"achieved_rate": achieved_rates(dense, sp, card)}),
          flush=True)
    # phi3.5-moe at its published width, 4 layers: chunked prefill through
    # flash_attention at q offsets, then serving
    phi, phi_row = phi_full_width(kernels, card)
    print(json.dumps({"phi_full_width": phi}), flush=True)
    del phi
    # recurrentgemma-2b at its published size: serving 2 x 4,096 through
    # flash_attention at hd 256 and window 2,048, then the kernel's rows on
    # the inputs that request passed it
    rg, rg_inputs, rg_launches = hybrid_full_size(kernels, card)
    print(json.dumps({"hybrid_full_size": rg}), flush=True)
    rg_rows = flash_rows(rg_inputs, rg_launches,
                         f"{RG} serving (published size, 2 x 4,096)",
                         window=2048)
    del rg_inputs
    # whisper-base at its published size: serving 8 x 4,096 against 1,500
    # frames, 6 causal and 6 non-causal flash_attention launches, then the
    # kernel's rows on the inputs that request passed it; then the
    # aggregation kernels on an m = 8 cohort of its trees
    audio, audio_inputs, audio_launches = audio_full_size(kernels, card)
    print(json.dumps({"audio_full_size": audio}), flush=True)
    audio_rows = [row for causal, kind in ((True, "self"), (False, "cross"))
                  for row in flash_rows(
                      audio_inputs[causal], audio_launches,
                      f"{WHISPER} serving (published size, 8 x 4,096, "
                      f"{kind} attention)", causal=causal)]
    del audio_inputs
    agg, agg_hist = audio_aggregation(kernels, card)
    print(json.dumps({"audio_aggregation": agg}), flush=True)
    audio_rows += fl_path_kernel_rows(
        agg_hist, WHISPER, "f32", kernels,
        path=f"{WHISPER} aggregation (m = 8, published size)")
    del agg_hist
    # internvl2-76b at its published width, 2 layers: serving 2 x (1,024
    # patches + 3,072 tokens), 2 flash_attention launches at 64 q heads over
    # 8, then the kernel's rows on the inputs that request passed it
    vlm, vlm_inputs, vlm_launches = vlm_full_width(kernels, card)
    print(json.dumps({"vlm_full_width": vlm}), flush=True)
    vlm_rows = flash_rows(vlm_inputs, vlm_launches,
                          f"{VLM} serving (published width, 2 layers, 2 x "
                          "(1,024 patches + 3,072 tokens))")
    del vlm_inputs
    print(json.dumps({"nas": nas_card_vs_cpu(), "card": card}), flush=True)
    print(json.dumps({"quickstart": quickstart_on_card(kernels),
                      "card": card}), flush=True)
    # the sharded FL server: a 1 x 1 NCCL mesh in this process, then a
    # 2 x 2 mesh of 4 processes on the card
    mesh_report, mesh_rows, mesh_contracts = mesh_path(kernels, card)
    print(json.dumps({"mesh_path": mesh_report}), flush=True)
    # the program contracts: the fixture programs on the card, then the
    # full-width and mesh contracts recorded above
    analysis_phase(kernels, card, full_width, mesh_contracts)
    for row in admit_rows:      # the main path's launches of its 2 rounds
        row["launches"] = launches[row["dtype"]]["quant_admit"]
    print(json.dumps({"kernels": kernel_checks(launches, shapes,
                                               quantile_calls) + admit_rows
                      + hist_checks(launches, shapes) + fl_rows + ssd_checks(
        launches["mamba2-130m@1024"]["ssd_intra_chunk"]) + flash_checks(
        launches["smollm-135m@4096"]["flash_attention"]) + [phi_row]
        + rg_rows + audio_rows + vlm_rows + mesh_rows}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
