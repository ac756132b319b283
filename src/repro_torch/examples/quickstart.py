"""Quickstart: one heterogeneous FedFA round end to end.

Four clients pick different widths/depths, train locally on synthetic
streams, the server grafts + scale-aggregates, and we inspect the result.

Run:  python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.core.server import ClientSpec, FLConfig, fl_round
from repro_torch.data import synthetic
from repro_torch.models import model as model_mod
from repro_torch.models.masks import ClientArch
from repro_torch.tree import leaves, tree_map


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1) global architecture: a reduced SmolLM-family decoder (2 sections)
    cfg = get_arch("smollm-135m").reduced().replace(
        n_layers=4, n_sections=2, vocab_size=64)
    params = tree_map(lambda t: t.to(dev), model_mod.init_params(
        cfg, torch.Generator().manual_seed(0)))
    print(f"global model: {cfg.n_layers} layers, d_model={cfg.d_model}, "
          f"{sum(x.numel() for x in leaves(params)) / 1e6:.1f}M params")

    # 2) clients choose architectures for their budget (Alg. 1 line 2)
    specs = [
        ClientSpec(arch=ClientArch(0.25, (1, 1)), n_data=120),   # tiny phone
        ClientSpec(arch=ClientArch(0.5, (1, 2)), n_data=200),    # tablet
        ClientSpec(arch=ClientArch(0.75, (2, 1)), n_data=160),   # laptop
        ClientSpec(arch=ClientArch(1.0, (2, 2)), n_data=240),    # server
    ]

    # 3) local data (synthetic LM streams; each client its own domain)
    E, B, S = 2, 4, 32
    toks = np.stack([
        synthetic.lm_stream(cfg.vocab_size, E * B, S, seed=i).reshape(E, B, S)
        for i in range(len(specs))])
    batches = {"tokens": torch.as_tensor(toks, dtype=torch.int64,
                                         device=dev)}

    # 4) one FedFA round: local updates -> graft -> scale -> aggregate
    fl = FLConfig(local_steps=E, lr=0.05, strategy="fedfa", task="lm")
    new_params, mean_loss = fl_round(params, cfg, fl, specs, batches)
    print(f"round done; mean local loss {float(mean_loss):.3f}")

    # 5) the global model changed everywhere (complete aggregation) ...
    delta_embed = float(torch.abs(new_params["embed"] - params["embed"]).max())
    wq = new_params["stages"][0][0]["attn"]["wq"]
    slot1 = float(torch.abs(
        wq[1] - params["stages"][0][0]["attn"]["wq"][1]).max())
    print("max |delta| embed:", delta_embed)
    print("depth slot 1 was missing from 3 of 4 clients, but grafting kept it "
          f"fully aggregated: |wq[1]-old| = {slot1:.4f}")
    return {"loss": float(mean_loss), "delta_embed": delta_embed,
            "delta_wq1": slot1, "params": new_params}


if __name__ == "__main__":
    main()
