"""The one traffic generator: everything a run feeds the program, made from
``--seed`` and the parameters of a traffic file (``bench/traffic/*.json``).

* ``population``: the FL client population as ``make_client_specs`` draws
  it — half the clients take the smallest architecture of the pool, the
  others one drawn from it, each with a data count in [lo, hi].
* ``cohorts``: the clients each round or merge takes, without repeats.
* ``lm_tokens``: local batches of the LM task.  Each client has its own
  bigram domain: a token is followed by a Zipf(1.2) draw with probability
  0.3, else by one of 4 successors of its own, each 0.175 (the mixture of
  ``data.synthetic.lm_stream``, drawn for all sequences at once).
* ``uploads``: client models a server receives, the global plus a normal
  perturbation, zero outside the client's width and depth.

Every stream has its own generator, keyed by (seed, stream), so the same
seed gives the same inputs whatever else a traffic file asks for."""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from bench.reference import masks as mk
from bench.reference import model as md
from bench.reference.config import ModelConfig

Member = Tuple[float, Tuple[int, ...], int]   # (width, section depths, n_data)


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for stream ``stream`` of run ``seed``."""
    s = np.random.SeedSequence([int(seed), int(stream)])
    return int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))


def population(cfg: ModelConfig, spec: dict, seed: int) -> List[Member]:
    """spec: {"clients", "arch_pool": [[width, depth fraction], ...],
    "n_data": [lo, hi]}."""
    maxd = cfg.max_section_depths()
    archs = [(float(w), tuple(max(1, int(math.ceil(f * d))) for d in maxd))
             for w, f in spec["arch_pool"]]
    smallest = min(archs, key=lambda a: (a[0], sum(a[1])))
    r = rng(seed, 1)
    lo, hi = spec["n_data"]
    out = []
    for i in range(spec["clients"]):
        arch = smallest if i % 2 == 0 else archs[int(r.integers(len(archs)))]
        out.append(arch + (int(r.integers(lo, hi, endpoint=True)),))
    return out


def cohorts(n_clients: int, m: int, count: int, seed: int) -> np.ndarray:
    """(count, m) client ids, each row without repeats."""
    r = rng(seed, 2)
    return np.stack([r.choice(n_clients, size=m, replace=False)
                     for _ in range(count)])


def zipf_cdf(vocab: int, a: float = 1.2) -> np.ndarray:
    p = 1.0 / np.arange(1, vocab + 1) ** a
    return np.cumsum(p / p.sum())


def lm_tokens(vocab: int, ids: np.ndarray, steps: int, batch: int,
              seq_len: int, seed: int) -> np.ndarray:
    """(count, m, steps, batch, seq_len) int64 tokens for the cohorts
    ``ids`` (count, m): each sequence from its client's bigram domain."""
    n_clients = int(ids.max()) + 1
    succ = rng(seed, 3).integers(0, vocab, size=(n_clients, vocab, 4))
    cdf = zipf_cdf(vocab)
    r = rng(seed, 4)
    dom = np.repeat(ids.reshape(-1), steps * batch)           # (n_seqs,)
    n = dom.shape[0]
    out = np.empty((n, seq_len), np.int64)
    t = np.minimum(np.searchsorted(cdf, r.random(n)), vocab - 1)
    for s in range(seq_len):
        out[:, s] = t
        zipf = np.minimum(np.searchsorted(cdf, r.random(n)), vocab - 1)
        nxt = succ[dom, t, r.integers(0, 4, size=n)]
        t = np.where(r.random(n) < 0.3, zipf, nxt)
    return out.reshape(ids.shape + (steps, batch, seq_len))


def client_mask_rows(cfg: ModelConfig, member: Member, device,
                     depth: bool = True):
    """[(offset, size, shape, mask)] of one client: each leaf's 0/1 mask of
    width, times (with ``depth``) the depth gate on the rows of the first
    stage."""
    width, depths, _ = member
    masks = mk.width_masks(cfg, width, device)
    axes = mk.axis_masks(cfg, masks)
    gates = mk.depth_gates(cfg, depths, device)
    out = []
    for path, shape, off, size, lead, rest, stage0 in md.leaf_layout(cfg):
        d = mk.density(shape, axes[path]).to(device)
        if stage0 and depth:
            d = d * gates.reshape((-1,) + (1,) * (len(shape) - 1))
        out.append((off, size, shape, d))
    return out


def uploads(cfg: ModelConfig, g: torch.Tensor, members: Sequence[Member],
            sigma: float, seed: int, stream: int) -> torch.Tensor:
    """(m, N) f32 uploads on g's device: row c is (g + sigma·noise) with
    every element outside client c's width and depth zero."""
    gen = torch.Generator(device=g.device).manual_seed(
        stream_seed(seed, stream))
    x = torch.empty((len(members), g.shape[0]), dtype=torch.float32,
                    device=g.device)
    for c, member in enumerate(members):
        torch.randn(g.shape, generator=gen, device=g.device, out=x[c])
        x[c].mul_(sigma).add_(g)
        for off, size, shape, d in client_mask_rows(cfg, member, g.device):
            x[c, off:off + size].view(shape).mul_(d)
    return x
