"""Synthetic datasets (generated from a seed; distributions mirror the paper's).

* ``lm_stream``      — mixture-of-bigram language data with Zipf unigram
                       marginals; per-domain bigram structure gives models
                       something real to learn (perplexity drops with
                       training), standing in for WikiText-2 (Table 3).
* ``classification`` — class-conditional token sequences standing in for
                       CIFAR-10/100 / Fashion-MNIST: class c draws tokens
                       from softmax(z_c) so a mean-pool classifier can
                       separate classes (Table 1 analog).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def _zipf_probs(vocab: int, a: float = 1.2) -> np.ndarray:
    p = 1.0 / np.arange(1, vocab + 1) ** a
    return p / p.sum()


def make_bigram_lm(vocab: int, n_domains: int = 4, seed: int = 0):
    """Returns (sample_fn, domain transition matrices)."""
    rng = np.random.default_rng(seed)
    base = _zipf_probs(vocab)
    trans = []
    for d in range(n_domains):
        # sparse-ish domain-specific bigram: each token strongly predicts a
        # few successors, mixed with the zipf marginal
        nxt = rng.integers(0, vocab, size=(vocab, 4))
        T = np.tile(base, (vocab, 1)) * 0.3
        for j in range(4):
            T[np.arange(vocab), nxt[:, j]] += 0.175
        T /= T.sum(-1, keepdims=True)
        trans.append(T)
    return trans


class _BigramRows:
    """The rows of one domain's ``make_bigram_lm`` matrix, each built when
    it is asked for, with the same arithmetic, so a full-size vocabulary
    needs no (vocab, vocab) matrix."""

    def __init__(self, base: np.ndarray, nxt: np.ndarray):
        self.base, self.nxt = base, nxt

    def __getitem__(self, t: int) -> np.ndarray:
        row = self.base * 0.3
        for j in range(4):
            row[self.nxt[t, j]] += 0.175
        return row / row.sum()


def lm_stream(vocab: int, n_seqs: int, seq_len: int, *, domain_T=None,
              n_domains: int = 4, seed: int = 0) -> np.ndarray:
    """(n_seqs, seq_len) int32 token sequences from random domains."""
    rng = np.random.default_rng(seed)
    base = _zipf_probs(vocab)
    if domain_T is None:
        # make_bigram_lm's draws, its rows built on demand
        succ = np.random.default_rng(seed + 7)
        domain_T = [_BigramRows(base, succ.integers(0, vocab, size=(vocab, 4)))
                    for _ in range(n_domains)]
    out = np.empty((n_seqs, seq_len), np.int32)
    for i in range(n_seqs):
        T = domain_T[rng.integers(len(domain_T))]
        t = rng.choice(vocab, p=base)
        for s in range(seq_len):
            out[i, s] = t
            t = rng.choice(vocab, p=T[t])
    return out


def make_class_profiles(n_classes: int, vocab: int, sharpness: float = 2.0,
                        seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n_classes, vocab)) * sharpness
    p = np.exp(z - z.max(-1, keepdims=True))
    return p / p.sum(-1, keepdims=True)


def classification(n_classes: int, vocab: int, n_samples: int, seq_len: int,
                   *, profiles: Optional[np.ndarray] = None,
                   labels: Optional[np.ndarray] = None,
                   seed: int = 0) -> Dict[str, np.ndarray]:
    """{'tokens': (N, S) int32, 'labels': (N,) int32}."""
    rng = np.random.default_rng(seed)
    if profiles is None:
        profiles = make_class_profiles(n_classes, vocab, seed=seed + 13)
    if labels is None:
        labels = rng.integers(0, n_classes, size=n_samples).astype(np.int32)
    toks = np.empty((n_samples, seq_len), np.int32)
    for i, c in enumerate(labels):
        toks[i] = rng.choice(vocab, size=seq_len, p=profiles[c])
    return {"tokens": toks, "labels": labels.astype(np.int32)}
