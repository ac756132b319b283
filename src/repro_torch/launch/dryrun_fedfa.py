"""Dry run of the paper's core workload, planned in one process on the CPU:
one FedFA round of 16 heterogeneous clients (local SGD, layer grafting,
scalable aggregation) on the 16x16 production mesh, the client axis over
``data`` and the parameter axis over ``model``.

    python -m repro_torch.launch.dryrun_fedfa [--arch smollm-135m]
        [--clients 16]

The reference lowers and compiles the round for 256 host devices.  The
port plans it from its own layout of a sharded round
(``sharding.cohort``): a rank holds its ``data_rows`` x ``model_cols``
block of the (m, N) f32 cohort buffer (the client axis padded with
``pad_rows``, N with ``pad_unit``), the whole bf16 global, and its rows of
the token batches.  That layout is the flat engine's, the only one a
sharded round has, so the record's ``agg_engine`` is always "flat" and the
reference's ``--agg-engine`` flag is not taken.  FLOPs are Σ over the clients of local_steps x 2 x
``costs.macs_per_client``; a rank trains its own rows' clients (model
peers train the same ones), so ``cost.flops`` is the largest rank's
share.  What only XLA's compiled program gives is ``null``, with its
reason under ``null_reasons`` (as in ``launch.dryrun``).  No process group
is created and nothing is allocated.
"""
from __future__ import annotations

import argparse
import json
import math
import os
from typing import Any, Dict, Tuple

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import costs
from repro_torch.launch.dryrun import HW, NULL_REASONS
from repro_torch.models.masks import ClientArch, max_section_depths
from repro_torch.models.transformer import abstract_params
from repro_torch.sharding import cohort as csh
from repro_torch.tree import leaves


class PlanMesh:
    """The (data, model) shape of a mesh and one rank's coordinates on it,
    all that ``sharding.cohort``'s layout functions read: a plan, with no
    process group behind it."""

    def __init__(self, shape: Tuple[int, int],
                 coord: Tuple[int, int] = (0, 0)):
        self.shape, self.coord = tuple(shape), tuple(coord)


def client_pool(cfg: ArchConfig):
    """The reference's four client architectures (width, share of each
    section's depth)."""
    maxd = max_section_depths(cfg)
    return [ClientArch(w, tuple(max(1, int(np.ceil(f * m))) for m in maxd))
            for w, f in [(0.25, 0.5), (0.5, 0.75), (0.75, 1.0), (1.0, 1.0)]]


def plan_round(cfg: ArchConfig, clients: int = 16, local_steps: int = 4,
               batch: int = 16, seq_len: int = 512,
               mesh_shape: Tuple[int, int] = (16, 16)) -> Dict[str, Any]:
    """Bytes and FLOPs a rank of ``mesh_shape`` takes in one round."""
    pool = client_pool(cfg)
    archs = [pool[i % len(pool)] for i in range(clients)]
    params = abstract_params(cfg)
    n = sum(t.numel() for t in leaves(params))
    global_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    D = mesh_shape[0]
    unit = csh.pad_unit(PlanMesh(mesh_shape))
    n_padded = n + (-n) % unit
    m = clients + csh.pad_rows(clients, PlanMesh(mesh_shape))
    client_flops = [local_steps * 2 * costs.macs_per_client(
        cfg, a.width_mult, a.section_depths, B=batch, S=seq_len)
        for a in archs]
    per_rank = []
    for d in range(D):
        mesh = PlanMesh(mesh_shape, (d, 0))
        rows = csh.data_rows(mesh, m)
        cols = csh.model_cols(mesh, n_padded)
        # pad rows repeat row 0
        flops = sum(client_flops[i if i < clients else 0]
                    for i in range(rows.start, rows.stop))
        per_rank.append(dict(
            rows=rows.stop - rows.start, cols=cols.stop - cols.start,
            flops=flops))
    r0 = per_rank[0]
    cohort_bytes = r0["rows"] * r0["cols"] * 4
    token_bytes = r0["rows"] * local_steps * batch * seq_len * 4
    return dict(n=n, n_padded=n_padded, m_padded=m, rows=r0["rows"],
                cols=r0["cols"], cohort_bytes=cohort_bytes,
                global_bytes=global_bytes, token_bytes=token_bytes,
                flops_global=float(sum(client_flops)),
                flops_rank=float(max(r["flops"] for r in per_rank)))


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description="FedFA round dry run (planned, "
                                             "nothing compiled)")
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).replace(grad_accum=1)
    mesh_shape = (16, 16)
    plan = plan_round(cfg, args.clients, args.local_steps, args.batch,
                      args.seq_len, mesh_shape)
    chips = math.prod(mesh_shape)
    arguments = plan["global_bytes"] + plan["token_bytes"]
    rec = dict(arch=args.arch, workload="fedfa_round", mesh="16x16",
               clients=args.clients, agg_engine="flat",
               lower_compile_s=None)
    rec["memory"] = dict(argument_bytes=arguments, temp_bytes=None,
                         peak_bytes=None,
                         cohort_bytes=plan["cohort_bytes"],
                         bytes_per_rank=arguments + plan["cohort_bytes"])
    rec["cost"] = {"flops": plan["flops_rank"], "bytes accessed": None,
                   "flops_global": plan["flops_global"]}
    rec["collectives"] = None
    rec["layout"] = {k: plan[k] for k in ("n", "n_padded", "m_padded",
                                          "rows", "cols")}
    rec["roofline"] = dict(chips=chips,
                           compute_s=plan["flops_rank"] / HW["peak_flops"],
                           memory_s=rec["memory"]["bytes_per_rank"]
                           / HW["hbm_bw"])
    rec["null_reasons"] = {k: v for k, v in NULL_REASONS.items()
                           if k in ("lower_compile_s", "memory.temp_bytes",
                                    "memory.peak_bytes", "cost.bytes accessed",
                                    "collectives")}
    rec["hardware"] = HW
    rec["status"] = "ok"
    path = os.path.join(args.out, f"fedfa_round_{args.arch}_16x16.json")
    os.makedirs(args.out, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"fedfa_round[{args.arch} x{args.clients} clients]: "
          f"{rec['memory']['bytes_per_rank'] / 2**30:.3f} GiB a rank "
          f"(cohort {plan['rows']} x {plan['cols']} f32), "
          f"{plan['flops_rank'] / 1e12:.2f} TFLOP on the busiest rank")
    return rec


if __name__ == "__main__":
    main()
