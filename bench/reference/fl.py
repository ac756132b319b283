"""The plain reference of a FedFA round (Alg. 1): each client's local SGD
on its sub-model, layer grafting (Alg. 2), trimmed-norm scaling factors
(§4.3), the weighted merge that keeps the global where no client holds an
element (γ = 0), and quantized admission with server-side error feedback.
Leaf by leaf and client by client, on {path: tensor} dicts
(``model.unflatten``)."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from bench.reference import masks as mk
from bench.reference import model as md
from bench.reference.config import ModelConfig

Params = Dict[Tuple, torch.Tensor]


class Client:
    """A client's sub-model, worked out from its (width, section depths)
    and data count."""

    def __init__(self, cfg: ModelConfig, width: float, depths, n_data: int,
                 device):
        self.masks = mk.width_masks(cfg, width, device)
        self.axes = mk.axis_masks(cfg, self.masks)
        self.gates = mk.depth_gates(cfg, depths, device)
        self.graft = mk.graft_map(cfg, depths, device)
        self.n_data = float(n_data)


def local_update(g: Params, cfg: ModelConfig, client: Client,
                 tokens: torch.Tensor, lr: float):
    """E steps of SGD with momentum and weight decay on the client's
    masked sub-model; tokens (E, B, S).  Returns (params, (E,) losses)."""
    p = mk.apply_masks(g, client.axes)
    mom = {k: torch.zeros_like(v) for k, v in p.items()}
    losses = []
    for e in range(tokens.shape[0]):
        loss, grads = md.loss_and_grad(p, cfg, tokens[e], client.masks,
                                       client.gates)
        grads = mk.apply_masks(grads, client.axes)
        with torch.no_grad():
            for k in p:
                geff = grads[k] + cfg.weight_decay * p[k]
                mom[k] = cfg.momentum * mom[k] + geff
                p[k] = p[k] - lr * mom[k]
            p = mk.apply_masks(p, client.axes)
        losses.append(loss)
    return p, torch.stack(losses)


def graft(p: Params, gmap: torch.Tensor) -> Params:
    """Alg. 2: a missing block of the first stage takes its section's last
    active block."""
    return {k: (v.index_select(0, gmap) if k[:2] == ("stages", 0) else v)
            for k, v in p.items()}


def interpolation_ranks(q, n):
    p = q.to(torch.float32) * (n - 1).to(torch.float32)
    i0 = torch.floor(p)
    r0 = i0.to(torch.int64)
    return r0, torch.minimum(r0 + 1, (n - 1).to(torch.int64)), p - i0


def interpolate(v0, v1, frac):
    """v0·(1−frac) + v1·frac with the second product fused into the add
    (one rounding), as jnp.quantile computes it."""
    c = (v0 * (1.0 - frac)).to(torch.float64)
    ab = v1.to(torch.float64) * frac.to(torch.float64)
    s = ab + c
    bb = s - ab
    err = (ab - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.to(torch.float32)


def trimmed_norms(p: Params, axes, trim: float) -> Dict[Tuple, torch.Tensor]:
    """Per row (a stacked leaf) or per leaf: sqrt Σ w²·[|w| <= t], t the
    1 − (1 − trim)·f quantile of |w| over the zero-padded row (f the
    active fraction), from a sort."""
    out = {}
    for k, w in p.items():
        stacked = k[0] == "stages"
        q = 1.0 - (1.0 - trim) * mk.active_fraction(axes[k]).to(w.device)
        a = torch.abs(w.reshape(w.shape[0] if stacked else 1, -1))
        r0, r1, frac = interpolation_ranks(q, torch.tensor(a.shape[1],
                                                           device=a.device))
        srt = torch.sort(a, dim=-1).values
        t = interpolate(srt[:, r0], srt[:, r1], frac)
        n = torch.sqrt(torch.sum(torch.where(a <= t[:, None], a * a, 0.0),
                                 dim=-1))
        out[k] = n if stacked else n[0]
    return out


def aggregate(g: Params, uploads: Sequence[Params], clients: Sequence[Client],
              trim: float, eps: float = 1e-12, pregrafted: bool = False,
              order: str = "clients") -> Params:
    """FedFA's merge (graft, scale, γ = 0) of the clients' uploads into a
    new global.  ``uploads[c]`` is client c's model (views are fine);
    ``pregrafted`` rows (quantized admission's) are not grafted again.
    M′ and Γ are sums over the clients, each term rounded and then added
    (``order`` "clients", the reference's), in the reverse order
    ("reversed"), or each term n·(u·α) added with one rounding, client by
    client ("fused": a fused multiply-add, as ``scaled_accum`` sums)."""
    prepared = [mk.apply_masks(u if pregrafted else graft(u, c.graft), c.axes)
                for u, c in zip(uploads, clients)]
    norms = [trimmed_norms(u, c.axes, trim)
             for u, c in zip(prepared, clients)]
    valid = torch.tensor([float(c.n_data > 0) for c in clients])
    denom = torch.clamp_min(torch.sum(valid), 1.0)
    out = {}
    for k, gk in g.items():
        nk = torch.stack([n[k] for n in norms])           # (m,) or (m, R)
        w = valid.to(nk.device).reshape((-1,) + (1,) * (nk.dim() - 1))
        alpha = (torch.sum(w * nk, dim=0, keepdim=True) / denom) \
            / torch.clamp_min(nk, eps)
        Mp = torch.zeros_like(gk)
        Gm = torch.zeros_like(gk)
        cs = list(enumerate(zip(prepared, clients)))
        for c, (u, cl) in (cs[::-1] if order == "reversed" else cs):
            dens = mk.density(tuple(gk.shape), cl.axes[k]).to(gk.device)
            a = alpha[c].reshape(tuple(alpha[c].shape)
                                 + (1,) * (gk.dim() - alpha[c].dim()))
            if order == "fused":
                # exact in f64 (an 8-bit count times a 24-bit value), then
                # one rounding to f32
                Mp = (Mp.double() + cl.n_data * (u[k] * a).double()).float()
            else:
                Mp += cl.n_data * (u[k] * a)
            Gm += cl.n_data * dens * torch.ones_like(gk)
        out[k] = torch.where(Gm > 0, Mp / torch.clamp_min(Gm, eps), gk)
    return out


def quantize_rows(y: torch.Tensor, qmax: int):
    """Symmetric per-row quantization of y (m, lead, rest): scale =
    max|y| / qmax (0 on an all-zero row), values rounded half to even."""
    seg_max = torch.amax(torch.abs(y), dim=2)
    scales = seg_max / float(qmax)
    safe = torch.where(seg_max > 0, scales, 1.0)
    q = torch.clamp(torch.round(y / safe[..., None]), -qmax, qmax)
    return q, scales


def admit(cfg: ModelConfig, x: torch.Tensor, clients: Sequence[Client],
          state: List[torch.Tensor], qmax: int = 127):
    """Quantized admission of the f32 uploads x (m, N), in place on
    ``state`` = [q (m, N), scales (m, S), e (m, N), e_scales (m, S)], the
    quantized values held as int8: graft, y = (x + e·e_s)·dens,
    (q, s) = quantize(y), (e, e_s) = quantize(y − q·s), each segment (a
    leaf's row) on its own scale."""
    q_all, s_all, e_all, es_all = state
    m = x.shape[0]
    seg = 0
    for path, shape, off, size, lead, rest, stage0 in md.leaf_layout(cfg):
        xl = x[:, off:off + size].view(m, lead, rest)
        if stage0:
            xl = torch.stack([xl[c, cl.graft] for c, cl in enumerate(clients)])
        e = e_all[:, off:off + size].view(m, lead, rest) \
            * es_all[:, seg:seg + lead, None]
        dens = torch.stack([torch.broadcast_to(
            mk.density(shape, cl.axes[path]).to(x.device), shape)
            for cl in clients]).reshape(m, lead, rest)
        y = (xl + e) * dens
        q, s = quantize_rows(y, qmax)
        eq, es = quantize_rows(y - q * s[..., None], qmax)
        q_all[:, off:off + size] = q.reshape(m, size)
        s_all[:, seg:seg + lead] = s
        e_all[:, off:off + size] = eq.reshape(m, size)
        es_all[:, seg:seg + lead] = es
        seg += lead


def dequantize(cfg: ModelConfig, q: torch.Tensor, scales: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(m, N) f32 of quantized rows and their (m, S) scales."""
    m = q.shape[0]
    out = torch.empty_like(q, dtype=torch.float32) if out is None else out
    seg = 0
    for _, _, off, size, lead, rest, _ in md.leaf_layout(cfg):
        out[:, off:off + size] = (q[:, off:off + size].view(m, lead, rest)
                                  * scales[:, seg:seg + lead, None]
                                  ).reshape(m, size)
        seg += lead
    return out
