"""Federated data partitioning (paper §5.1).

IID: every client sees all classes; sample counts vary uniformly such that
the minimum can be up to half the maximum.
Non-IID: each client holds 20% of the classes with equal samples per class;
during local training absent-class logits are zeroed (class masks).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def iid_partition(n_clients: int, n_classes: int, *,
                  n_data_range: Tuple[int, int] = (100, 250), seed: int = 0):
    """Returns per-client (classes, n_data, class_mask=None)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_clients):
        out.append(dict(classes=np.arange(n_classes),
                        n_data=int(rng.integers(*n_data_range)),
                        class_mask=None))
    return out


def noniid_partition(n_clients: int, n_classes: int, *,
                     class_frac: float = 0.2,
                     n_data_range: Tuple[int, int] = (100, 250),
                     seed: int = 0):
    """Each client gets ``class_frac`` of the classes + a logit mask."""
    rng = np.random.default_rng(seed)
    k = max(1, int(round(class_frac * n_classes)))
    out = []
    for _ in range(n_clients):
        classes = rng.choice(n_classes, size=k, replace=False)
        mask = np.zeros(n_classes, np.float32)
        mask[classes] = 1.0
        out.append(dict(classes=np.sort(classes),
                        n_data=int(rng.integers(*n_data_range)),
                        class_mask=mask))
    return out


def client_class_mask(part: dict, vocab: int) -> Optional[np.ndarray]:
    """Extend an n_classes mask to the model's vocab-sized logit mask."""
    if part["class_mask"] is None:
        return None
    m = np.zeros(vocab, np.float32)
    m[: len(part["class_mask"])] = part["class_mask"]
    return m
