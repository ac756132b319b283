"""Backdoor robustness demo (paper Fig. 3, miniature).

Runs the same federated classification workload under FedFA and under
NeFL-style partial aggregation, with 20% malicious clients at attack
intensity lambda=20, and prints the accuracy drop of each.

Run:  python -m repro_torch.examples.backdoor_robustness [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.launch.train import run_fl

ROUNDS, CLIENTS = 12, 8
STRATEGIES = ("fedfa", "nefl")


def main(rounds: int = ROUNDS, clients: int = CLIENTS, device=None) -> dict:
    """The four runs (clean and attacked, under each strategy); returns
    their final global accuracies."""
    common = dict(arch_mode="both", local_steps=2, batch=4, seq_len=32,
                  lr=0.05, eval_every=max(1, rounds // 2), seed=0,
                  device=device, quiet=True)
    print("=== clean runs ===")
    clean = {s: run_fl("smollm-135m", rounds, clients, strategy=s,
                       **common)["final_acc"] for s in STRATEGIES}
    print(clean)

    print("=== attacked runs (20% malicious, lambda=20) ===")
    attacked = {s: run_fl("smollm-135m", rounds, clients, strategy=s,
                          malicious_frac=0.2, attack_lambda=20.0,
                          **common)["final_acc"] for s in STRATEGIES}
    print(attacked)

    for s in STRATEGIES:
        print(f"{s:6s} clean={clean[s]:.3f} attacked={attacked[s]:.3f} "
              f"drop={clean[s]-attacked[s]:+.3f}")
    print("expected (paper Table 1): FedFA's drop is smaller — layer "
          "grafting closes the incomplete-aggregation weak point.")
    return {"clean": clean, "attacked": attacked}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    main(device=ap.parse_args().device)
