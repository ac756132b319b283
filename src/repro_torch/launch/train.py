"""Training driver, as the JAX package's ``launch/train.py``:

  * ``--mode fl`` — synthetic federated rounds with heterogeneous client
    architectures, FedFA (or baseline) aggregation and optional backdoor
    attackers, with the resident, the per-round or the async driver;
  * ``--mode dense`` — plain pretraining of one architecture for
    ``--steps`` steps on a synthetic token stream.

    python -m repro_torch.launch.train --mode fl [--arch ARCH] [--full-size]
        [--device cpu] [--update-dtype f32|bf16|int8] [--ckpt PREFIX]
        [--agg-engine flat|tree] [--use-kernel auto|on|off] [--interpret]
        [--driver async [--merge-k K] [--staleness-max S]
                        [--async-deadline T]]
        [--mesh none|host|production|DxM] [--mesh-shape DxM]
    python -m repro_torch.launch.train --mode dense [--arch ARCH]
        [--steps N] [--full-size] [--device cpu]

With ``--driver async``, ``--rounds`` counts merges.  ``--agg-engine tree``
runs the per-round driver (the resident and async drivers are flat-native,
as in the reference).  ``--use-kernel on`` runs the CUDA kernels (and
raises on the CPU), ``off`` or ``--interpret`` their plain PyTorch versions
on any device; ``auto`` takes the kernels on the card.

Runs on ``cuda`` unless ``--device`` says otherwise.  By default the model
is cut to the JAX CLI's size (fl: 4 layers, 2 sections, a 64-entry untied
vocabulary on the cls task; dense: ``reduced()``); ``--full-size`` runs the
published configuration.

``--mesh`` / ``--mesh-shape`` shard the resident and async drivers over a
(data, model) mesh of ranks (``launch.mesh``), one process each:

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --mesh-shape 2x2 [--device cpu] ...

Every rank runs the same rounds on its share; rank 0 prints the history
and writes ``--out``.  The per-round driver runs unsharded.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import tree_map


def run_dense(arch: str, steps: int, batch: int, seq_len: int,
              log_every: int = 10, full_size: bool = False, seed: int = 0,
              device=None, params=None) -> dict:
    """Plain pretraining of ``arch`` for ``steps`` steps of ``batch``
    sequences of ``seq_len`` tokens (one microbatch a step, as the
    reference); an encoder-decoder's frames (batch, n_frames, d_model) or a
    vision-language model's patches (batch, n_patches, vit_dim) are drawn
    each step at scale 0.02 from a CPU generator seeded by ``seed``.
    ``params``: the initial weights (for instance the reference's, through
    ``params_from_numpy``); drawn from ``seed`` on the CPU if None."""
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as model_mod
    from repro_torch.optim import init_opt

    dev = resolve_device(device)
    cfg = get_arch(arch)
    if not full_size:
        cfg = cfg.reduced()
    cfg = cfg.replace(grad_accum=1)
    if params is None:
        params = tree_map(lambda t: t.to(dev), model_mod.init_params(
            cfg, torch.Generator().manual_seed(seed)))
    opt = init_opt(params, cfg.optimizer)
    step_fn = make_train_step(cfg, total_steps=steps)
    data = synthetic.lm_stream(cfg.vocab_size, steps * batch, seq_len,
                               seed=seed)
    frame_gen = torch.Generator().manual_seed(seed)
    losses = []
    t0 = time.time()
    for s in range(steps):
        batch_d = {"tokens": torch.as_tensor(data[s * batch:(s + 1) * batch],
                                             dtype=torch.int64, device=dev)}
        if cfg.encoder is not None:
            batch_d["frames"] = (0.02 * torch.randn(
                (batch, cfg.encoder.n_frames, cfg.d_model),
                generator=frame_gen)).to(dev)
        if cfg.vision is not None:
            batch_d["patches"] = (0.02 * torch.randn(
                (batch, cfg.vision.n_patches, cfg.vision.vit_dim),
                generator=frame_gen)).to(dev)
        params, opt, loss = step_fn(params, opt, batch_d, s)
        losses.append(float(loss))
        if s % log_every == 0:
            print(f"step {s:4d}  loss {losses[-1]:.4f}  "
                  f"({(time.time() - t0) / (s + 1):.2f}s/step)", flush=True)
    return {"arch": arch, "losses": losses,
            "first": float(np.mean(losses[:5])),
            "last": float(np.mean(losses[-5:]))}


def client_arch_pool(cfg, mode: str, fracs=(0.25, 0.5, 0.75, 1.0)):
    """Paper's three flexibility regimes: depth-only (vs FlexiFed),
    width-only (vs HeteroFL), both (vs NeFL)."""
    from repro_torch.models.masks import ClientArch, max_section_depths
    maxd = max_section_depths(cfg)
    depths = lambda f: tuple(max(1, int(np.ceil(f * m))) for m in maxd)
    if mode == "width":
        return [ClientArch(w, maxd) for w in fracs]
    if mode == "depth":
        return [ClientArch(1.0, depths(f)) for f in fracs]
    return [ClientArch(w, depths(f)) for w, f in
            [(0.25, 0.5), (0.5, 0.5), (0.5, 1.0), (0.75, 0.75), (1.0, 1.0)]]


def fl_config(arch: str, task: str, n_classes: int, full_size: bool):
    """The model configuration of an FL run (the JAX CLI's cut unless
    ``full_size``)."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    if full_size:
        return cfg
    # 4 layers / 2 sections so depth flexibility is real
    cfg = cfg.reduced().replace(n_layers=4, n_sections=2)
    if task == "cls":
        cfg = cfg.replace(vocab_size=max(64, n_classes), tie_embeddings=False)
    return cfg


def run_fl(arch: str, rounds: int, n_clients: int, *, strategy: str = "fedfa",
           malicious_frac: float = 0.0, attack_lambda: float = 1.0,
           noniid: bool = False, local_steps: int = 2, batch: int = 4,
           seq_len: int = 32, n_classes: int = 10, lr: float = 0.05,
           participation: float = 0.5, seed: int = 0, eval_every: int = 5,
           task: str = "cls", width_mults=(0.25, 0.5, 0.75, 1.0),
           arch_mode: str = "width", agg_engine: str = "flat",
           driver: str = "resident", merge_k: int = 0,
           staleness_max: int = 4, async_deadline: float = float("inf"),
           use_kernel: Optional[bool] = None, interpret: bool = False,
           update_dtype: str = "f32", ckpt: Optional[str] = None,
           full_size: bool = False, device=None, params=None,
           quiet: bool = False, mesh: Optional[str] = None) -> dict:
    """``params``: the initial global (for instance the reference's, through
    ``params_from_numpy``); drawn from ``seed`` on the CPU if None.
    ``mesh``: a ``launch.mesh.get_mesh`` name (none, host, production or
    DxM); the resident and async drivers then run sharded, every rank but
    0 is quiet, and the process group the mesh starts, if any, ends with
    the run."""
    from repro_torch.core.masking import apply_mask_tree, axis_mask_tree
    from repro_torch.core.server import (FLConfig, fl_round, make_client_specs,
                                         select_clients)
    from repro_torch.data import partition as part_mod
    from repro_torch.data import pipeline, synthetic
    from repro_torch.models import model as model_mod

    if driver not in ("resident", "per-round", "async"):
        raise ValueError(f"unknown driver {driver!r}")
    cfg = fl_config(arch, task, n_classes, full_size)
    if cfg.encoder is not None:
        # the reference's rounds build no frames and fail with KeyError:
        # 'frames' (ROADMAP queue 3 item 25)
        raise ValueError(f"{arch}: FL batches carry no 'frames' for its "
                         "encoder (the reference fails there too)")
    if cfg.vision is not None:
        # nor patches: KeyError: 'patches' (ROADMAP queue 3 item 27)
        raise ValueError(f"{arch}: FL batches carry no 'patches' for its "
                         "projector (the reference fails there too)")
    from repro_torch.launch.mesh import get_mesh
    mesh = shard = get_mesh(mesh, device)
    try:
        dev = resolve_device(device) if mesh is None else mesh.device
        quiet = quiet or (mesh is not None and mesh.rank != 0)
        rng = np.random.default_rng(seed)
        if params is None:
            # drawn on the CPU, so a seed gives the same weights on every
            # device
            params = tree_map(lambda t: t.to(dev), model_mod.init_params(
                cfg, torch.Generator().manual_seed(seed)))

        archs = client_arch_pool(cfg, arch_mode, width_mults)
        parts = (part_mod.noniid_partition(n_clients, n_classes, seed=seed)
                 if noniid else part_mod.iid_partition(n_clients, n_classes,
                                                       seed=seed))
        class_masks = [part_mod.client_class_mask(p, cfg.padded_vocab)
                       for p in parts] if noniid else None
        specs = make_client_specs(cfg, n_clients, archs=archs,
                                  malicious_frac=malicious_frac,
                                  class_masks=class_masks, seed=seed)
        profiles = synthetic.make_class_profiles(n_classes, cfg.vocab_size,
                                                 seed=seed)
        fl = FLConfig(participation=participation, local_steps=local_steps,
                      lr=lr, attack_lambda=attack_lambda, strategy=strategy,
                      task=task, agg_engine=agg_engine, use_kernel=use_kernel,
                      interpret=interpret, update_dtype=update_dtype,
                      seed=seed)
        if driver in ("resident", "async") and agg_engine != "flat":
            if not quiet:
                print(f"{driver} driver is flat-native; falling back to the "
                      "per-round driver for agg_engine=tree", flush=True)
            driver = "per-round"
        if update_dtype != "f32" and driver == "per-round":
            # as the reference CLI: quantized admission lives in the resident
            # driver's cohort pool, which the per-round driver does not keep
            if not quiet:
                print(f"--update-dtype {update_dtype} needs the resident or "
                      "async driver; running the per-round driver at f32",
                      flush=True)
            fl = dataclasses.replace(fl, update_dtype="f32")
        if mesh is not None and driver not in ("resident", "async"):
            if not quiet:
                print("--mesh shards the resident/async drivers' cohort axis; "
                      "the per-round driver runs unsharded", flush=True)
            shard = None
        to_dev = lambda d: {k: torch.as_tensor(v, dtype=torch.int64,
                                               device=dev)
                            for k, v in d.items()}

        hist = {"round": [], "loss": [], "global_acc": [], "local_acc": []}
        test = to_dev(pipeline.eval_batch_cls(n_classes, cfg.vocab_size, 256,
                                              seq_len, profiles,
                                              seed=seed + 99))
        local_eval = [(ci, to_dev(pipeline.eval_batch_cls(
            n_classes, cfg.vocab_size, 64, seq_len, profiles,
            classes=parts[ci]["classes"], seed=seed + 300 + ci)))
            for ci in range(min(4, n_clients))]

        @torch.no_grad()
        def global_acc(p):
            logits, _ = model_mod.forward(p, cfg, {"tokens": test["tokens"]})
            pred = torch.argmax(torch.mean(logits[..., :n_classes], dim=1), -1)
            return float(torch.mean((pred == test["labels"])
                                    .to(torch.float32)))

        @torch.no_grad()
        def local_acc(p):
            accs = []
            for ci, d in local_eval:
                s = specs[ci]
                masks = s.arch.masks(cfg).to(dev)
                pm = apply_mask_tree(p, axis_mask_tree(cfg, masks))
                logits, _ = model_mod.forward(pm, cfg, {"tokens": d["tokens"]},
                                              masks=masks,
                                              gates=s.arch.gates(cfg).to(dev))
                lg = torch.mean(logits[..., :n_classes], dim=1)
                if s.class_mask is not None:
                    cm = torch.as_tensor(s.class_mask[:n_classes], device=dev)
                    lg = torch.where(cm[None] > 0, lg,
                                     torch.full((), -1e30, device=dev))
                accs.append(float(torch.mean(
                    (torch.argmax(lg, -1) == d["labels"]).to(torch.float32))))
            return float(np.mean(accs))

        def round_data(r):
            """Host-side cohort selection and batch synthesis for round r."""
            sel = select_clients(n_clients, participation, rng)
            b = pipeline.round_batches_cls(
                parts, sel, n_classes, cfg.vocab_size, local_steps=local_steps,
                batch=batch, seq_len=seq_len, profiles=profiles,
                seed=seed * 1000 + r)
            return [specs[i] for i in sel], to_dev(b)

        def record_eval(r, loss, p):
            acc, lacc = global_acc(p), local_acc(p)
            hist["round"].append(r)
            hist["loss"].append(loss)
            hist["global_acc"].append(acc)
            hist["local_acc"].append(lacc)
            if not quiet:
                print(f"[{strategy}/{arch_mode}] round {r:3d} loss {loss:.4f} "
                      f"global_acc {acc:.3f} local_acc {lacc:.3f}", flush=True)

        if driver == "resident":
            from repro_torch.core.round import run_rounds
            params, hist["round_loss"] = run_rounds(
                params, cfg, fl, rounds, round_data, eval_every=eval_every,
                eval_fn=record_eval, ckpt_path=ckpt, mesh=shard)
        elif driver == "async":
            # continuous arrivals from the trace-driven population simulator:
            # clients keep their specs, but when they arrive comes from hashed
            # device-class latency and availability traces, and merges fire on
            # merge_k arrivals or the deadline (rounds counts merges)
            from repro_torch.core.async_round import AsyncConfig, run_async
            from repro_torch.sim import ClientPopulation, PopulationSource
            population = ClientPopulation(n_clients, seed=seed)
            capacity = max(1, int(round(participation * n_clients)))

            def batch_fn(d, ids):
                return to_dev(pipeline.round_batches_cls(
                    parts, ids, n_classes, cfg.vocab_size,
                    local_steps=local_steps, batch=batch, seq_len=seq_len,
                    profiles=profiles, seed=seed * 1000 + d))

            source = PopulationSource(
                population, lambda ids: [specs[int(i)] for i in ids], batch_fn)
            acfg = AsyncConfig(
                capacity=capacity,
                merge_k=merge_k if merge_k > 0 else max(1, capacity // 2),
                staleness_max=staleness_max, deadline=async_deadline)
            params, hist["round_loss"] = run_async(
                params, cfg, fl, rounds, source, acfg=acfg,
                eval_every=eval_every, eval_fn=record_eval, ckpt_path=ckpt,
                mesh=shard)
        else:
            from repro_torch.checkpoint import checkpoint as ckpt_mod
            from repro_torch.core.round import (default_perms, eval_boundary,
                                                label_count)
            perm_fn = default_perms(seed)
            hist["round_loss"] = []
            for r in range(rounds):
                sel_specs, batches = round_data(r)
                perms = None
                if any(s.malicious for s in sel_specs):
                    perms = perm_fn(r, len(sel_specs),
                                    label_count(batches, task)).to(dev)
                params, loss = fl_round(params, cfg, fl, sel_specs, batches,
                                        perms=perms)
                hist["round_loss"].append(float(loss))
                if eval_boundary(r, rounds, eval_every):
                    record_eval(r, float(loss), params)
                    if ckpt is not None:
                        ckpt_mod.save(f"{ckpt}_r{r:05d}", params,
                                      meta={"round": r, "strategy": strategy})
        hist["final_acc"] = (hist["global_acc"][-1] if hist["global_acc"]
                             else None)
        hist["final_local_acc"] = (hist["local_acc"][-1] if hist["local_acc"]
                                   else None)
        return hist
    finally:
        if mesh is not None:
            mesh.close()


def _rank() -> int:
    """This process's rank: of the process group where one is running,
    else torchrun's, else 0."""
    if torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return int(os.environ.get("RANK", "0"))


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["fl", "dense"], default="fl")
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--strategy", default="fedfa")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--malicious-frac", type=float, default=0.0)
    ap.add_argument("--attack-lambda", type=float, default=1.0)
    ap.add_argument("--noniid", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--participation", type=float, default=0.5)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--arch-mode", choices=["width", "depth", "both"],
                    default="width")
    ap.add_argument("--task", choices=["cls", "lm"], default="cls")
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--agg-engine", choices=["flat", "tree"], default="flat")
    ap.add_argument("--driver", choices=["resident", "async", "per-round"],
                    default="resident")
    ap.add_argument("--merge-k", type=int, default=0)
    ap.add_argument("--staleness-max", type=int, default=4)
    ap.add_argument("--async-deadline", type=float, default=float("inf"))
    ap.add_argument("--mesh", default="none",
                    help="none | host (every rank on data) | production "
                         "(16x16) | DxM: shard the resident and async "
                         "drivers over a (data, model) mesh of ranks")
    ap.add_argument("--mesh-shape", default=None, metavar="DxM",
                    help="explicit (data, model) mesh shape; overrides "
                         "--mesh")
    ap.add_argument("--use-kernel", choices=["auto", "on", "off"],
                    default="auto")
    ap.add_argument("--interpret", action="store_true")
    ap.add_argument("--update-dtype", choices=["f32", "bf16", "int8"],
                    default="f32")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--full-size", action="store_true",
                    help="run the published model configuration instead of "
                         "the 4-layer cut")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.mode == "dense":
        res = run_dense(args.arch, args.steps, args.batch, args.seq_len,
                        full_size=args.full_size, device=args.device)
    else:
        res = run_fl(
            args.arch, args.rounds, args.clients, strategy=args.strategy,
            malicious_frac=args.malicious_frac,
            attack_lambda=args.attack_lambda, noniid=args.noniid,
            batch=args.batch, seq_len=args.seq_len,
            participation=args.participation, local_steps=args.local_steps,
            lr=args.lr, arch_mode=args.arch_mode, task=args.task,
            eval_every=args.eval_every, agg_engine=args.agg_engine,
            driver=args.driver, merge_k=args.merge_k,
            staleness_max=args.staleness_max,
            async_deadline=args.async_deadline,
            use_kernel={"auto": None, "on": True,
                        "off": False}[args.use_kernel],
            interpret=args.interpret, update_dtype=args.update_dtype,
            ckpt=args.ckpt, full_size=args.full_size, device=args.device,
            mesh=args.mesh_shape or args.mesh)
    if args.out and _rank() == 0:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
