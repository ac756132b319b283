"""Readings that set a cell's limits, at the cell's own size: the plain
reference against itself with a lower precision (the control) or with a
fault planted in it, compared by the numbers a run compares.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3
        [--variants control,half_batch] [--rounds R] [--out F]

Round cells: "control" (the reference with TF32 matrix products),
"half_batch" (each client's local batches cut to their first half, the
loss a mean over the rest), and two witnesses of how the numbers read
after a change of rounding alone: "reversed" (the merge's sums over the
clients in the reverse order) and "fused" (each term added with one
rounding, as ``scaled_accum`` sums); ``--rounds`` follows more rounds than
the cell's limits reach.  Merge cells: "control" (the merge in bfloat16;
quantized, admission at 4 bits), "half_cohort" (the first half of the
cohort merged alone) and "unchanged" (the global handed back as it
came).  Prints one JSON line per (seed, variant); needs the card, as the
runs do."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


ROUND_VARIANTS = ("control", "half_batch")
MERGE_VARIANTS = ("control", "half_cohort", "unchanged")


def round_readings(h, variants, rounds=None):
    from bench.entries import round as rnd
    from bench.reference.config import ModelConfig
    cfg = ModelConfig.from_json(h.config["model"])
    data = rnd.inputs(h, cfg)
    K = rounds or rnd.checked_rounds(h)
    base = rnd.reference(cfg, h.traffic, data, h.seed, h.device, K)
    for v in variants:
        got = rnd.reference(cfg, h.traffic, data, h.seed, h.device, K,
                            tf32=v == "control",
                            half_batch=v == "half_batch",
                            order=v if v in ("reversed", "fused")
                            else "clients")
        yield v, rnd.numbers(base, got["losses"], got["update"],
                             got["change1"], got["change"])


def merge_readings(h, variants):
    from bench.entries import common, merge as mg
    from bench.reference import fl as ref_fl
    from bench.reference.config import ModelConfig
    cfg = ModelConfig.from_json(h.config["model"])
    t, dev = h.traffic, h.device
    quant = t["update_dtype"] != "f32"
    g0 = common.weights(cfg, h.seed, dev)
    data = mg.inputs(h, cfg, g0)
    clients = [[ref_fl.Client(cfg, w, d, n, dev) for w, d, n in c]
               for c in data["cohorts"]]
    m = t["cohort"]

    def chain(variant):
        g = g0
        st = mg.fresh_state(cfg, m, g0.shape[0], dev) if quant else None
        out = []
        for j in range(t["checked_merges"]):
            k = j % 2
            x, cl = data["uploads"][k], clients[k]
            if variant == "half_cohort":
                x, cl = x[:m // 2], cl[:m // 2]
                sub = None if st is None else [s[:m // 2] for s in st]
            else:
                sub = st
            if variant == "unchanged":
                g_new = g.clone()
            else:
                g_new = mg.reference_merge(
                    cfg, t, g, x, cl, sub,
                    variant=("int4" if quant else "bf16")
                    if variant == "control" else "")
            if sub is not None and sub is not st:
                for s, part in zip(st, sub):
                    s[:m // 2] = part
            out.append((g, g_new, None if st is None
                        else [s.clone() for s in st]))
            g = g_new
        return out

    base = chain("")
    for v in variants:
        got = chain(v)
        gaps = {"global": max(common.diff_gap(cfg, gv, gr, gi)
                              for (gi, gr, _), (_, gv, _) in zip(base, got))}
        if quant:
            for name, (qi, si) in (("rows", (0, 1)), ("residual", (2, 3))):
                gaps[name] = max(mg.quant_gap(cfg, sv, sr, qi, si)
                                 for (_, _, sr), (_, _, sv) in zip(base, got))
        yield v, gaps


def main(argv=None) -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default=None)
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from bench import harness
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        h = harness.Harness(args.workload, seed, 0.0, False,
                            time.perf_counter())
        rounds = h.traffic["entry"] == "round"
        variants = (args.variants.split(",") if args.variants else
                    ROUND_VARIANTS if rounds else MERGE_VARIANTS)
        it = (round_readings(h, variants, args.rounds) if rounds
              else merge_readings(h, variants))
        for variant, gaps in it:
            line = {"workload": args.workload, "seed": seed,
                    "variant": variant, "readings": gaps,
                    "kind": torch.cuda.get_device_name(0)}
            lines.append(line)
            print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
