"""Batching: build per-round stacked client batches for the SPMD FL round."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.data import synthetic


def round_batches_cls(parts: Sequence[dict], selected: Sequence[int],
                      n_classes: int, vocab: int, *, local_steps: int,
                      batch: int, seq_len: int, profiles: np.ndarray,
                      seed: int = 0) -> Dict[str, np.ndarray]:
    """Classification task: {'tokens': (m,E,B,S), 'labels': (m,E,B)} drawn
    from each selected client's class distribution."""
    rng = np.random.default_rng(seed)
    toks, labs = [], []
    for ci in selected:
        classes = parts[ci]["classes"]
        n = local_steps * batch
        labels = rng.choice(classes, size=n).astype(np.int32)
        d = synthetic.classification(n_classes, vocab, n, seq_len,
                                     profiles=profiles, labels=labels,
                                     seed=int(rng.integers(2**31)))
        toks.append(d["tokens"].reshape(local_steps, batch, seq_len))
        labs.append(d["labels"].reshape(local_steps, batch))
    return {"tokens": np.stack(toks), "labels": np.stack(labs)}


def round_batches_lm(selected: Sequence[int], vocab: int, *, local_steps: int,
                     batch: int, seq_len: int, domain_T, client_domains,
                     seed: int = 0) -> Dict[str, np.ndarray]:
    """LM task: each client samples from its own domain (non-IID text)."""
    rng = np.random.default_rng(seed)
    toks = []
    for ci in selected:
        T = [domain_T[client_domains[ci]]]
        d = synthetic.lm_stream(vocab, local_steps * batch, seq_len,
                                domain_T=T, seed=int(rng.integers(2**31)))
        toks.append(d.reshape(local_steps, batch, seq_len))
    return {"tokens": np.stack(toks)}


def eval_batch_cls(n_classes: int, vocab: int, n: int, seq_len: int,
                   profiles: np.ndarray, *, classes=None, seed: int = 1):
    rng = np.random.default_rng(seed)
    pool = np.arange(n_classes) if classes is None else np.asarray(classes)
    labels = rng.choice(pool, size=n).astype(np.int32)
    return synthetic.classification(n_classes, vocab, n, seq_len,
                                    profiles=profiles, labels=labels,
                                    seed=seed + 1)
