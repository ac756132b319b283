"""Where a resident round's, or a serving request's, time goes on the GPU.

    python -m repro_torch.launch.profile [--clients 8] [--top 15]
        [--update-dtype f32|bf16|int8] [--arch smollm-135m|mamba2-130m]
    python -m repro_torch.launch.profile --serve mamba2-130m|internvl2-76b|...
        [--prompt-len 1024] [--batch 8] [--n-layers L] [--top 15]
    python -m repro_torch.launch.profile --chunked --arch ARCH
        [--prompt-len 1024] [--batch 8] [--n-layers L] [--top 15]
    python -m repro_torch.launch.profile --dense smollm-135m [--top 15]

Builds one round of the main path at full size (smollm-135m, 8 clients of
the width pool, batch 8, sequence 64, 2 local steps, fedfa), runs one
warm-up round, then times local training (``server.cohort_update``), the
quantized admission (``flat.admit_quantized``, int8 and bf16 only) and
aggregation (``flat.aggregate_buffers``) from the program's spans over
one ``round.flat_round``, with every span's totals, and traces one more
round with ``torch.profiler``: the operators with the most device time,
the number of device kernels, and the device's busy share of the traced
window (the union of the kernels' intervals).  With ``--serve`` it traces
instead ``launch.serve``'s engine at full size: the prefill of ``--batch``
prompts and then 8 decode steps (after a warm-up request).  With
``--chunked`` it traces one ``make_prefill_step`` of ``--arch`` at full
size, in chunks of its ``prefill_chunk`` (after a warm-up step).  Both
take ``--n-layers`` to cut the full-size model's depth.  With ``--dense``
it traces one full-size ``--mode dense`` train step (batch 8, sequence
64, after a warm-up step) and its forward and backward alone, the rest
being the optimizer.
Prints one JSON object.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch

from repro_torch import resolve_device

BATCH, DECODE_STEPS = 8, 8  # a serving trace's prompts and decode steps


def full_round(m: int = 8, seed: int = 1, device=None,
               update_dtype: str = "f32", arch: str = "smollm-135m",
               full_size: bool = True) -> dict:
    """Everything one resident round of ``arch`` needs, on ``device``: at
    full size, or at the CLI's 4-layer cut unless ``full_size``."""
    from repro_torch.core import flat
    from repro_torch.core.round import fresh_quant_state
    from repro_torch.core.server import (FLConfig, make_client_specs,
                                         stack_runtimes)
    from repro_torch.data import partition, pipeline, synthetic
    from repro_torch.launch import train
    from repro_torch.models.model import init_params
    from repro_torch.tree import tree_map

    dev = resolve_device(device)
    cfg = train.fl_config(arch, "cls", 10, full_size=full_size)
    params = tree_map(lambda t: t.to(dev), init_params(
        cfg, torch.Generator().manual_seed(seed)))
    specs = make_client_specs(cfg, m, archs=train.client_arch_pool(cfg, "width"),
                              seed=seed)
    parts = partition.iid_partition(m, 10, seed=seed)
    profiles = synthetic.make_class_profiles(10, cfg.vocab_size, seed=seed)
    b = pipeline.round_batches_cls(parts, list(range(m)), 10, cfg.vocab_size,
                                   local_steps=2, batch=8, seq_len=64,
                                   profiles=profiles, seed=seed)
    fl = FLConfig(local_steps=2, lr=0.05, strategy="fedfa", task="cls",
                  update_dtype=update_dtype)
    index = flat.FlatIndex(params)
    runtimes = stack_runtimes(cfg, specs, dev)
    return dict(
        cfg=cfg, fl=fl, index=index, g_buf=flat.flatten(index, params),
        c_buf=torch.empty((m, index.n), device=dev), runtimes=runtimes,
        qstate=None if update_dtype == "f32" else fresh_quant_state(
            index, m, update_dtype, dev),
        batches={k: torch.as_tensor(v, dtype=torch.int64, device=dev)
                 for k, v in b.items()})


def _round(r: dict) -> torch.Tensor:
    """One ``round.flat_round`` on ``r``'s resident state."""
    from repro_torch.core.round import flat_round
    return flat_round(r["g_buf"], r["c_buf"], r["cfg"], r["fl"], r["index"],
                      r["runtimes"], r["batches"], qstate=r["qstate"])


def breakdown(r: dict) -> dict:
    """Stream time (ms) of one round and of its phases — training, the
    quantized admission (int8 and bf16 only) and aggregation — from the
    program's spans (``repro_torch.tracing``) over a ``round.flat_round``
    after one warm-up round; every span's totals (``spans``: parent,
    calls, stream and host ms, counts); and the peak device memory of the
    traced round (GiB)."""
    from repro_torch import tracing
    _round(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tracing.start("cuda")
    try:
        with tracing.span("round"):
            _round(r)
    finally:
        rec = tracing.stop()
    spans = rec.tree()
    phases = ["train"] + (["admit"] if "admit" in spans else []) \
        + ["aggregate", "round"]
    out = {f"{name}_ms": spans[name]["stream_ms"] for name in phases}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["spans"] = spans
    return out


def trace(r: dict, top: int) -> dict:
    """One traced round: top operators by device time and the busy share."""
    return _report(_trace([lambda: _round(r)]), top)


def _busy_us(intervals) -> float:
    """The time (us) the union of [start, end) intervals covers: kernels
    that overlap count once."""
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return busy


def _trace(fns) -> dict:
    """Trace one call of each of ``fns``, in order: wall and device busy
    time (ms; busy the union of the kernels' intervals), the device
    kernels, and each operator's calls and device ms."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    return {"wall_ms": wall_ms,
            "device_busy_ms": _busy_us((e.time_range.start, e.time_range.end)
                                       for e in kernels) / 1e3,
            "device_kernels": len(kernels),
            "ops": {e.key: (e.count, dev_us(e) / 1e3)
                    for e in prof.key_averages()}}


def _minus(a: dict, b: dict) -> dict:
    """What trace ``a`` holds beyond trace ``b``; operators whose calls
    did not grow are left out."""
    ops = {k: (c - b["ops"].get(k, (0, 0.0))[0],
               ms - b["ops"].get(k, (0, 0.0))[1])
           for k, (c, ms) in a["ops"].items()}
    return {**{k: a[k] - b[k] for k in ("wall_ms", "device_busy_ms",
                                        "device_kernels")},
            "ops": {k: v for k, v in ops.items() if v[0] > 0}}


def _report(t: dict, top: int) -> dict:
    """A trace's busy share and its ``top`` operators by device time."""
    rows = sorted(t["ops"].items(), key=lambda kv: kv[1][1], reverse=True)
    return {"wall_ms": t["wall_ms"], "device_busy_ms": t["device_busy_ms"],
            "device_busy_share": t["device_busy_ms"] / t["wall_ms"],
            "device_kernels": t["device_kernels"],
            "top_ops": [{"op": k, "calls": c, "device_ms": ms}
                        for k, (c, ms) in rows[:top]]}


def serving(arch: str, prompt_len: int, top: int, batch: int = BATCH,
            n_layers: Optional[int] = None) -> dict:
    """Traces of ``launch.serve`` at full size (its weights, prompts and,
    for an encoder-decoder, frames, for a vision-language model, patches;
    ``n_layers``, if given, cuts its depth), after its own untraced
    request:
    the prefill is one ``generate`` of one token; the decode is one
    ``generate`` of 1 + ``DECODE_STEPS`` tokens less that prefill's
    trace."""
    from repro_torch.launch import serve
    out = serve.serve(arch, batch, prompt_len, 1 + DECODE_STEPS,
                      full_size=True, n_layers=n_layers)
    gen = lambda n: lambda: out["engine"].generate(
        out["prompts"], max_new=n, frames=out["frames"],
        patches=out["patches"])
    prefill = _trace([gen(1)])
    both = _trace([gen(1 + DECODE_STEPS)])
    return {"prefill": _report(prefill, top),
            "decode": {**_report(_minus(both, prefill), top),
                       "steps": DECODE_STEPS}}


def chunked(arch: str, prompt_len: int, top: int, batch: int = BATCH,
            n_layers: Optional[int] = None) -> dict:
    """The trace of one ``make_prefill_step`` (in chunks of
    ``prefill_chunk``) of ``batch`` synthetic prompts of ``prompt_len`` on
    ``launch.serve``'s full-size model (``n_layers``, if given, cuts its
    depth), after an untraced one."""
    from repro_torch.data import synthetic
    from repro_torch.launch import serve, steps
    cfg, params = serve.build(arch, full_size=True, n_layers=n_layers)
    tok = torch.as_tensor(synthetic.lm_stream(cfg.vocab_size, batch,
                                              prompt_len, seed=0),
                          device="cuda")
    step = steps.make_prefill_step(cfg)

    @torch.no_grad()
    def run():
        step(params, {"tokens": tok})
    run()
    return {**_report(_trace([run]), top), "chunk": cfg.prefill_chunk}


def dense(arch: str, top: int, batch: int = 8, seq_len: int = 64) -> dict:
    """Traces of one full-size dense train step of ``arch`` (as
    ``launch.train.run_dense`` runs it: one microbatch, its optimizer and
    schedule) after one warm-up step, and of its forward and backward
    alone; the optimizer is the step less the gradient."""
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic
    from repro_torch.launch import steps
    from repro_torch.models.model import init_params, loss_and_grad
    from repro_torch.optim import init_opt
    from repro_torch.tree import tree_map
    cfg = get_arch(arch).replace(grad_accum=1)
    params = tree_map(lambda t: t.to("cuda"), init_params(
        cfg, torch.Generator().manual_seed(0)))
    st = {"p": params, "opt": init_opt(params, cfg.optimizer)}
    fn = steps.make_train_step(cfg, total_steps=100)
    batch = {"tokens": torch.as_tensor(synthetic.lm_stream(
        cfg.vocab_size, batch, seq_len, seed=0), dtype=torch.int64,
        device="cuda")}

    def step():
        st["p"], st["opt"], _ = fn(st["p"], st["opt"], batch, 1)
    step()
    full = _trace([step])
    grad = _trace([lambda: loss_and_grad(st["p"], cfg, batch, task="lm")])
    return {"step": _report(full, top), "grad": _report(grad, top),
            "optimizer": _report(_minus(full, grad), top)}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--update-dtype", choices=["f32", "bf16", "int8"],
                    default="f32")
    ap.add_argument("--serve", default=None,
                    help="trace serving this arch instead of a round")
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--arch", default="smollm-135m",
                    help="the model of the traced round")
    ap.add_argument("--dense", default=None,
                    help="trace a dense train step of this arch instead")
    ap.add_argument("--chunked", action="store_true",
                    help="trace a chunked prefill of --arch instead")
    ap.add_argument("--batch", type=int, default=BATCH,
                    help="prompts of --serve and --chunked")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut --serve's and --chunked's model to this depth")
    args = ap.parse_args(argv)
    if args.chunked:
        out = {"card": torch.cuda.get_device_name(0), "arch": args.arch,
               "batch": args.batch, "prompt_len": args.prompt_len,
               "n_layers": args.n_layers,
               **chunked(args.arch, args.prompt_len, args.top, args.batch,
                         args.n_layers)}
    elif args.dense:
        out = {"card": torch.cuda.get_device_name(0), "arch": args.dense,
               "batch": BATCH, "seq_len": 64, **dense(args.dense, args.top)}
    elif args.serve:
        out = {"card": torch.cuda.get_device_name(0), "arch": args.serve,
               "batch": args.batch, "prompt_len": args.prompt_len,
               "n_layers": args.n_layers,
               **serving(args.serve, args.prompt_len, args.top, args.batch,
                         args.n_layers)}
    else:
        r = full_round(args.clients, update_dtype=args.update_dtype,
                       arch=args.arch)
        out = {"card": torch.cuda.get_device_name(0), "arch": args.arch,
               "n_params": r["index"].n, "m": args.clients,
               "update_dtype": args.update_dtype, **breakdown(r),
               "trace": trace(r, args.top)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
