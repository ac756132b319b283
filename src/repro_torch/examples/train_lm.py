"""End-to-end driver: train a ~100M-class architecture (SmolLM-135M
family, ``reduced()``) for a few hundred steps of plain pretraining and
watch the loss drop.

Run:  python -m repro_torch.examples.train_lm [--steps 200] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional

from repro_torch.launch.train import run_dense


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    res = run_dense(args.arch, args.steps, args.batch, args.seq_len,
                    device=args.device)
    print(f"loss: first5={res['first']:.3f} -> last5={res['last']:.3f}")
    if not res["last"] < res["first"]:
        raise RuntimeError(f"loss should decrease: {res['first']:.3f} -> "
                           f"{res['last']:.3f}")
    print("OK: model is learning.")
    return res


if __name__ == "__main__":
    main()
