"""ZiCo NAS demo (paper §5.1): a client searches the (width x
section-depth) candidate grid with the zero-shot ZiCo proxy + evolutionary
search and reports the architecture it would register with the server.

Run:  python -m repro_torch.examples.nas_client_selection [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.core.nas import SearchSpace, evolutionary_search, zico_score
from repro_torch.models import model as model_mod
from repro_torch.models.masks import ClientArch, max_section_depths
from repro_torch.tree import tree_map


def setup(device) -> tuple:
    """(cfg, params, batches) of the demo on ``device``: a reduced
    SmolLM-family decoder of 4 layers in 2 sections over a 64-entry
    vocabulary, weights of seed 0, and 3 probe minibatches of 2 × 16
    tokens drawn from a numpy generator of seed 1."""
    cfg = get_arch("smollm-135m").reduced().replace(
        n_layers=4, n_sections=2, vocab_size=64)
    params = tree_map(lambda t: t.to(device), model_mod.init_params(
        cfg, torch.Generator().manual_seed(0)))
    # a couple of probe minibatches of this client's local data
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 2, 16))
    return cfg, params, {"tokens": torch.as_tensor(tokens, device=device)}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    cfg, params, batches = setup(resolve_device(ap.parse_args(argv).device))

    full = ClientArch(1.0, max_section_depths(cfg))
    s_full = zico_score(cfg, full, params, batches)
    s_half = zico_score(cfg, ClientArch(0.5, (1, 1)), params, batches)
    print("ZiCo(full model)   =", f"{s_full:.3f}")
    print("ZiCo(0.5x, half-depth) =", f"{s_half:.3f}")

    best = evolutionary_search(cfg, params, batches, population=6,
                               generations=2, space=SearchSpace(), seed=0)
    print(f"selected architecture: width={best.width_mult} "
          f"depths={best.section_depths}")
    print("the client reports this to the server (Alg. 1 line 2); the server "
          "extracts the matching sub-model every round (Alg. 3).")
    return {"zico_full": s_full, "zico_half": s_half, "best": best}


if __name__ == "__main__":
    main()
