"""Where a resident round's time goes on the GPU.

    python -m repro_torch.launch.profile [--clients 8] [--top 15]
        [--update-dtype f32|bf16|int8]

Builds one round of the main path at full size (smollm-135m, 8 clients of
the width pool, batch 8, sequence 64, 2 local steps, fedfa), runs one
warm-up round, then times local training (``server.cohort_update``), the
quantized admission (``flat.admit_quantized``, int8 and bf16 only) and
aggregation (``flat.aggregate_buffers``) with CUDA events, and traces one
more round with ``torch.profiler``: the operators with the most device
time, the number of device kernels, and the device's busy share of the
traced window.  Prints one JSON object.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch

from repro_torch import resolve_device


def full_round(m: int = 8, seed: int = 1, device=None,
               update_dtype: str = "f32") -> dict:
    """Everything one full-size resident round needs, on ``device``."""
    from repro_torch.core import flat
    from repro_torch.core.round import fresh_quant_state
    from repro_torch.core.server import (FLConfig, default_class_masks,
                                         make_client_specs, stack_runtimes)
    from repro_torch.data import partition, pipeline, synthetic
    from repro_torch.launch import train
    from repro_torch.models.model import init_params
    from repro_torch.tree import tree_map

    dev = resolve_device(device)
    cfg = train.fl_config("smollm-135m", "cls", 10, full_size=True)
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
        cms=default_class_masks(runtimes[4], cfg, fl, m, dev),
        batches={k: torch.as_tensor(v, dtype=torch.int64, device=dev)
                 for k, v in b.items()})


def _phases(r: dict):
    """The named phases of one round, as ``round.flat_round`` runs them:
    train, (admit,) aggregate."""
    from repro_torch.core import flat
    from repro_torch.core.fedfa import STRATEGIES
    from repro_torch.core.server import cohort_update
    cfg, fl, index, qstate = r["cfg"], r["fl"], r["index"], r["qstate"]
    masks, gates, gmaps, nd, _, mal = r["runtimes"]
    kw = STRATEGIES[fl.strategy]

    def train():
        cohort_update(flat.unflatten(index, r["g_buf"]), cfg, fl, index, masks,
                      gates, r["batches"], r["cms"], mal, None, r["c_buf"])

    def admit():
        flat.admit_quantized(index, cfg, r["c_buf"], masks, gmaps,
                             bool(kw.get("graft", False)), qstate,
                             fl.update_dtype)

    def aggregate():
        if qstate is None:
            g_new = flat.aggregate_buffers(
                index, r["g_buf"], r["c_buf"], cfg, masks, gates, gmaps, nd,
                trim=fl.trim, **kw)
        else:
            g_new = flat.aggregate_buffers(
                index, r["g_buf"], qstate[0], cfg, masks, gates, gmaps, nd,
                trim=fl.trim, scales=qstate[1], pregrafted=True, **kw)
        r["g_buf"].copy_(g_new)
    if qstate is None:
        return [("train", train), ("aggregate", aggregate)]
    return [("train", train), ("admit", admit), ("aggregate", aggregate)]


def breakdown(r: dict) -> dict:
    """Device time of each phase of one round (ms), after one warm-up
    round, and the peak device memory of the timed round (GiB)."""
    phases = _phases(r)
    for _, fn in phases:
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(phases) + 1)]
    ev[0].record()
    for i, (_, fn) in enumerate(phases):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    out = {f"{name}_ms": ev[i].elapsed_time(ev[i + 1])
           for i, (name, _) in enumerate(phases)}
    out["round_ms"] = ev[0].elapsed_time(ev[-1])
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def trace(r: dict, top: int) -> dict:
    """One traced round: top operators by device time and the busy share."""
    from torch.profiler import ProfilerActivity, profile
    phases = _phases(r)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _, fn in phases:
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    rows = sorted(prof.key_averages(), key=dev_us, reverse=True)
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms, "device_kernels": len(kernels),
            "top_ops": [{"op": e.key, "calls": e.count,
                         "device_ms": dev_us(e) / 1e3} for e in rows[:top]]}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--update-dtype", choices=["f32", "bf16", "int8"],
                    default="f32")
    args = ap.parse_args(argv)
    r = full_round(args.clients, update_dtype=args.update_dtype)
    out = {"card": torch.cuda.get_device_name(0), "n_params": r["index"].n,
           "m": args.clients, "update_dtype": args.update_dtype,
           **breakdown(r), "trace": trace(r, args.top)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
