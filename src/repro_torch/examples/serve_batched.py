"""Batched serving example: prefill + KV-cache decode with the Engine,
including a sliding-window (long-context variant) run.

Run:  python -m repro_torch.examples.serve_batched [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

from repro_torch import resolve_device
from repro_torch.data import synthetic
from repro_torch.launch.serve import Engine, build

RUNS = (("smollm-135m", None), ("mamba2-130m", None), ("tinyllama-1.1b", 64))


def main(argv: Optional[list] = None) -> dict:
    """Each arch at ``reduced()``, weights of seed 0: 4 prompts of 24, 16
    tokens sampled at temperature 0.8.  Returns the tokens by arch."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    dev = resolve_device(ap.parse_args(argv).device)
    outs = {}
    for arch, window in RUNS:
        cfg, params = build(arch, device=dev)
        eng = Engine(cfg, params, capacity=128,
                     window=window or cfg.attn_window)
        prompts = synthetic.lm_stream(cfg.vocab_size, 4, 24, seed=0)
        t0 = time.time()
        out = eng.generate(prompts, max_new=16, temperature=0.8)
        dt = time.time() - t0
        print(f"{arch:16s} window={window}  out={out.shape}  "
              f"{4*16/dt:6.1f} tok/s (reduced config on {dev.type})")
        outs[arch] = out
    return outs


if __name__ == "__main__":
    main()
