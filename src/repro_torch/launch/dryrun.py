"""Dry run of one (architecture x input shape) step on the production mesh,
planned in one process on the CPU: what each rank would hold and compute.

    python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod]
        [--variant baseline]

The reference lowers and compiles the step for 256 (``16x16``) or 512
(``2x16x16``) host devices and reads XLA's analyses.  The port compiles no
program: it plans the same meshes, spec for spec, from
``sharding.specs`` (sanitized against the mesh's ``{axis: size}`` map)
and the parameters, optimizer state, caches and batches as tensors on the
meta device, so no process group is created and nothing is allocated at
full size.  It writes the reference's JSON keys:

  * filled: ``memory.argument_bytes`` and ``output_bytes`` per rank (each
    leaf's bytes over its sanitized spec's shard count), ``cost.flops``
    per rank (``launch.costs.step_flops`` over the chips), the roofline's
    ``compute_s`` and ``memory_s`` (the argument bytes read once) at the
    H100's rates (``HW``), ``model_flops`` and ``useful_flops_ratio``,
    ``head_padding``, and the skip of ``long_500k`` for ``skip`` models;
  * ``null``, each with its reason under ``null_reasons``: whatever comes
    from XLA's compiled program (``temp_bytes``, ``peak_bytes``,
    ``collectives``, ``hlo_bytes``, ``lower_compile_s``, ``bytes
    accessed``, ``transcendentals``, ``collective_s``,
    ``hlo_flops_global``).

Each JSON also records the activation policy (``sharding.hints``) and the
card whose constants the roofline uses.
"""
from __future__ import annotations

import argparse
import json
import os
import traceback
from typing import Any, Dict, Mapping, Optional

import torch

from repro_torch.configs import ASSIGNED, INPUT_SHAPES, get_arch
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch import costs
from repro_torch.launch import steps as steps_mod
from repro_torch.models.transformer import abstract_params
from repro_torch.sharding import hints
from repro_torch.sharding.padding import pad_heads_for_serving
from repro_torch.sharding.specs import (P, batch_axes, batch_specs,
                                        bytes_per_rank, cache_specs,
                                        opt_state_specs, param_specs)
from repro_torch.tree import tree_map

# one NVIDIA H100 80GB HBM3 (SXM): dense bf16 tensor-core peak and device
# memory rate, from the card's data sheet
HW = dict(card="NVIDIA H100 80GB HBM3 (SXM)", peak_flops=989e12,
          hbm_bw=3.35e12)
# the reference's production meshes, as {axis: size}
MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}

_XLA = ("read from XLA's compiled program in the reference; the port "
        "compiles no program")
NULL_REASONS = {
    "lower_compile_s": _XLA + " (nothing is lowered or compiled)",
    "memory.temp_bytes": _XLA + " (its buffer assignment)",
    "memory.peak_bytes": "argument bytes plus temp_bytes, and temp_bytes "
                         "is not known",
    "cost.bytes accessed": _XLA + " (HloCostAnalysis)",
    "cost.transcendentals": _XLA + " (HloCostAnalysis)",
    "collectives": _XLA + " (its partitioned HLO)",
    "hlo_bytes": _XLA + " (its HLO text)",
    "roofline.collective_s": "no collective is counted",
    "roofline.hlo_flops_global": "no HLO; the analytic global count is "
                                 "cost.flops x chips",
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _long_window(cfg: ArchConfig, shape: InputShape) -> Optional[int]:
    if shape.name == "long_500k" and cfg.long_context_mode == "window":
        return 4096
    return None


def model_flops(cfg: ArchConfig, shape: InputShape) -> float:
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def abstract_opt_state(cfg: ArchConfig, params) -> Dict[str, Any]:
    """The optimizer state ``optim.init_opt`` builds for ``params``, on the
    meta device, its step an int32 scalar as the reference keeps it."""
    mdt = torch.bfloat16 if cfg.momentum_dtype == "bfloat16" \
        else torch.float32
    meta_like = lambda dt: (lambda p: _meta(p.shape, dt))
    st = {"step": _meta((), torch.int32), "m": tree_map(meta_like(mdt),
                                                        params)}
    if cfg.optimizer == "adamw":
        st["v"] = tree_map(meta_like(torch.float32), params)
    return st


def lower_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
                variant: str = "opt",
                axis_sizes: Optional[Mapping[str, int]] = None
                ) -> Dict[str, Any]:
    """The plan of one step.  variant='baseline': the paper-faithful
    configuration (no vocab padding, FSDP also while serving, no head
    padding); 'opt': the optimized one.  ``axis_sizes`` replaces the
    production mesh ({axis: size})."""
    cfg = get_arch(arch)
    shape = INPUT_SHAPES[shape_name]
    sizes = dict(axis_sizes or MESHES[multi_pod])
    rec: Dict[str, Any] = dict(arch=arch, shape=shape_name, variant=variant,
                               mesh="x".join(str(v) for v in sizes.values()))
    if variant == "baseline":
        cfg = cfg.replace(pad_vocab=False)
    if shape.name == "long_500k" and cfg.long_context_mode == "skip":
        rec["status"] = "skipped"
        rec["reason"] = ("enc-dec ASR model: 524k-token autoregressive decode "
                         "is not a meaningful workload")
        return rec

    window = _long_window(cfg, shape)
    masks = None
    if shape.kind in ("prefill", "decode") and variant != "baseline":
        cfg, masks = pad_heads_for_serving(cfg, sizes.get("model", 1))
        rec["head_padding"] = masks is not None
    fsdp_flag = cfg.fsdp if (shape.kind == "train" or variant == "baseline") \
        else cfg.serve_fsdp
    chips = 1
    for v in sizes.values():
        chips *= v
    b = batch_axes(multi_pod)
    baxes = b if len(b) > 1 else b[0]
    B = shape.global_batch
    V = cfg.padded_vocab
    pspecs = param_specs(cfg, fsdp=fsdp_flag, multi_pod=multi_pod)
    params = abstract_params(cfg)
    bspecs = batch_specs(cfg, multi_pod, shape.kind)
    on_rank = lambda specs, tree: bytes_per_rank(specs, tree, sizes)
    with hints.policy(hints.megatron_policy(b)):
        rec["policy"] = {k: list(v) for k, v in
                         hints.current_policy().items()}
        param_bytes = on_rank(pspecs, params)
        batch = steps_mod.input_specs(cfg, shape, window=window)
        batch_bytes = on_rank({k: bspecs[k] for k in batch}, batch)
        logits = _meta((B, 1, V), torch.bfloat16)
        logits_bytes = on_rank(P(baxes, None, "model"), logits)
        if shape.kind == "train":
            opt = abstract_opt_state(cfg, params)
            opt_bytes = on_rank(opt_state_specs(
                cfg, pspecs, cfg.optimizer == "adamw"), opt)
            # params, optimizer state, batch and the step number in; the
            # new params and state and the loss out
            args = param_bytes + opt_bytes + batch_bytes + 4
            outs = param_bytes + opt_bytes + 4
        elif shape.kind == "prefill":
            # the prompt's positions (the patches' and the text's)
            caches = steps_mod.abstract_caches(cfg, B, shape.seq_len,
                                               window=window)
            outs = logits_bytes + on_rank(cache_specs(cfg, multi_pod), caches)
            if cfg.encoder is not None:
                outs += on_rank(P(baxes, None, None), _meta(
                    (B, cfg.encoder.n_frames, cfg.d_model), torch.bfloat16))
            args = param_bytes + batch_bytes
        else:
            caches = steps_mod.decode_cache_specs(cfg, shape, window=window)
            cache_bytes = on_rank(cache_specs(cfg, multi_pod), caches)
            args = param_bytes + cache_bytes + batch_bytes
            if cfg.encoder is not None:
                args += on_rank(P(baxes, None, None), _meta(
                    (B, cfg.encoder.n_frames, cfg.d_model), torch.bfloat16))
            outs = logits_bytes + cache_bytes

    rec["lower_compile_s"] = None
    rec["memory"] = dict(argument_bytes=args, output_bytes=outs,
                         temp_bytes=None, peak_bytes=None)
    flops = costs.step_flops(cfg, shape, window=window) / chips
    rec["cost"] = {"flops": flops, "bytes accessed": None,
                   "transcendentals": None}
    rec["collectives"] = None
    rec["hlo_bytes"] = None
    mf = model_flops(cfg, shape)
    rec["roofline"] = dict(
        chips=chips,
        compute_s=flops / HW["peak_flops"],
        memory_s=args / HW["hbm_bw"],
        collective_s=None,
        model_flops=mf,
        hlo_flops_global=None,
        useful_flops_ratio=(mf / (flops * chips)) if flops else None,
    )
    rec["roofline"]["bottleneck"] = max(
        ("compute_s", "memory_s"), key=lambda k: rec["roofline"][k])
    rec["null_reasons"] = NULL_REASONS
    rec["hardware"] = HW
    rec["status"] = "ok"
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="production-mesh dry run "
                                             "(planned, nothing compiled)")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--variant", default="opt", choices=["opt", "baseline"])
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = ASSIGNED if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    for a in archs:
        for s in shapes:
            tag = f"{a}_{s}_{'2x16x16' if args.multi_pod else '16x16'}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[skip] {tag} (cached)")
                continue
            print(f"[dryrun] {tag} ...", flush=True)
            try:
                rec = lower_combo(a, s, multi_pod=args.multi_pod,
                                  variant=args.variant)
            except Exception as e:
                rec = dict(arch=a, shape=s, status="error",
                           error=f"{type(e).__name__}: {e}",
                           trace=traceback.format_exc()[-2000:])
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            mem = rec.get("memory", {}).get("argument_bytes")
            print(f"  -> {rec['status']} (arguments "
                  f"{'-' if mem is None else f'{mem / 2**30:.2f} GiB'} a "
                  f"rank; bottleneck="
                  f"{rec.get('roofline', {}).get('bottleneck', '-')})",
                  flush=True)


if __name__ == "__main__":
    main()
