"""FedFA server-side machinery on parameter trees: layer grafting (Alg. 2),
global model distribution (Alg. 3) and the tree engine of Alg. 1.

The tree engine (``aggregate(engine="tree")``) is the differential oracle
of the flat engine (``repro_torch.core.flat``, ``engine="flat"``, the
default everywhere): an Alg. 1 written independently of it, leaf by leaf
with the clients in order, holding two global-sized accumulators (M' and
Γ) whatever the cohort size.  Its trimmed quantiles come from a sort,
never from ``torch.quantile`` (which differs from ``jnp.quantile`` in the
last bit); it runs the plain PyTorch arithmetic on every device.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.masking import (active_fraction, apply_mask_tree,
                                      axis_mask_tree, mask_density)
from repro_torch.kernels.fedfa_quantile.ref import (interpolate,
                                                    interpolation_ranks)
from repro_torch.models.masks import WidthMasks
from repro_torch.tree import from_paths, leaves_with_path, tree_map

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Alg. 2 — layer grafting (a gather along the repeat axis)
# ---------------------------------------------------------------------------

def graft_stage0(params: Params, graft_map: torch.Tensor) -> Params:
    """Replicate the last active block of each section into missing slots."""
    st = params["stages"]
    s0 = tree_map(lambda x: x.index_select(0, graft_map.to(x.device)), st[0])
    return dict(params, stages=(s0,) + tuple(st[1:]))


# ---------------------------------------------------------------------------
# Alg. 3 — global model distribution (width masking; depth via gates)
# ---------------------------------------------------------------------------

def extract_client_model(global_params: Params, cfg: ArchConfig,
                         masks: WidthMasks) -> Params:
    """Server -> client: zero the channels outside the client's width.
    Depth is positional (clients run the first d_s blocks of each
    section), so no parameter surgery is needed beyond the width mask."""
    return apply_mask_tree(global_params, axis_mask_tree(cfg, masks))


# ---------------------------------------------------------------------------
# §4.3 — trimmed norms and scaling factors
# ---------------------------------------------------------------------------

def _path_stage_info(path) -> Tuple[bool, Optional[int]]:
    """(is_depth_stacked, stage index) of a parameter path: the encoder's
    blocks are depth-stacked with stage None (a segment per row, never
    grafted or gated)."""
    if path[0] == "stages":
        return True, path[1]
    if path[0] == "encoder" and path[1] == "blocks":
        return True, None
    return False, None


def _trimmed_sq_norm(w: torch.Tensor, q: torch.Tensor,
                     stacked: bool) -> torch.Tensor:
    """sqrt(Σ w²·[|w| <= t]) per row (R,) of a stacked leaf, or a scalar,
    with t = quantile(|row|, q): the order statistics from a sort, the
    interpolation fused as the reference's compiled quantile computes it."""
    lead = w.shape[0] if stacked else 1
    wf = torch.abs(w.reshape(lead, -1).to(torch.float32))
    L = torch.tensor(wf.shape[1], device=wf.device)
    r0, r1, frac = interpolation_ranks(q.to(wf.device), L)
    srt = torch.sort(wf, dim=-1).values
    t = interpolate(srt[:, r0], srt[:, r1], frac)
    n = torch.sqrt(torch.sum(torch.where(wf <= t[:, None], wf * wf, 0.0),
                             dim=-1))
    return n if stacked else n[0]


def trimmed_sq_norms(params: Params, axtree: Params,
                     trim: float = 0.95) -> Params:
    """Per-layer L2 norm of the weights with |w| below the ``trim``
    quantile of the active entries: with active fraction f, that is the
    1 − (1 − trim)·f quantile of the zero-padded leaf.  (R,) per
    depth-stacked leaf, a scalar otherwise."""
    ax = dict(leaves_with_path(axtree))
    out = []
    for path, w in leaves_with_path(params):
        q = 1.0 - (1.0 - trim) * active_fraction(ax[path])
        out.append((path, _trimmed_sq_norm(w, q, _path_stage_info(path)[0])))
    return from_paths([p for p, _ in out], [n for _, n in out])


def scaling_factors(norms_stacked: Params, eps: float = 1e-12,
                    n_data: Optional[torch.Tensor] = None) -> Params:
    """α_c^(l) = mean_κ ||M95,κ^(l)|| / ||M95,c^(l)|| from norms stacked
    over clients (leading axis).  With ``n_data`` the mean is over the
    clients with data only, so zero-weight rows do not shift α."""
    if n_data is not None:
        valid = (n_data > 0).to(torch.float32)
        denom = torch.clamp_min(torch.sum(valid), 1.0)

    def f(n):
        if n_data is None:
            mean = torch.mean(n, dim=0, keepdim=True)
        else:
            w = valid.reshape((-1,) + (1,) * (n.dim() - 1))
            mean = torch.sum(w * n, dim=0, keepdim=True) / denom
        return mean / torch.clamp_min(n, eps)
    return tree_map(f, norms_stacked)


# ---------------------------------------------------------------------------
# Alg. 1 — aggregation
# ---------------------------------------------------------------------------

def _weighted_contribution(cfg: ArchConfig, p_c: Params, masks_c: WidthMasks,
                           gmap_c, gate_c, nd_c, alpha_c: Optional[Params],
                           graft: bool):
    """One client's (N_c·α_c·M_c, N_c·mask) pair of trees, masked and
    grafted."""
    ax = dict(leaves_with_path(axis_mask_tree(cfg, masks_c)))
    al = None if alpha_c is None else dict(leaves_with_path(alpha_c))
    if graft:
        p_c = graft_stage0(p_c, gmap_c)
        depthw = torch.ones_like(gate_c)
    else:
        depthw = gate_c
    paths, contrib, gamma = [], [], []
    for path, w in leaves_with_path(p_c):
        stacked, stage = _path_stage_info(path)
        dw = (depthw.reshape((-1,) + (1,) * (w.dim() - 1))
              if stacked and stage == 0
              else torch.ones((), dtype=torch.float32, device=w.device))
        dens = mask_density(tuple(w.shape), ax[path]).to(w.device)
        wf = w.to(torch.float32) * dens
        if al is not None:
            a = al[path]
            wf = wf * a.reshape(tuple(a.shape) + (1,) * (w.dim() - a.dim()))
        paths.append(path)
        contrib.append(nd_c * dw * wf)
        gamma.append((nd_c * dw * dens)
                     * torch.ones(w.shape, dtype=torch.float32,
                                  device=w.device))
    return from_paths(paths, contrib), from_paths(paths, gamma)


def _client(stacked: Params, c: int) -> Params:
    return tree_map(lambda x: x[c], stacked)


def aggregate(global_params: Params, stacked_params: Params, cfg: ArchConfig,
              masks: WidthMasks, gates: torch.Tensor, gmaps: torch.Tensor,
              n_data: torch.Tensor, *, graft: bool = True, scale: bool = True,
              trim: float = 0.95, eps: float = 1e-12, engine: str = "tree",
              use_kernel: Optional[bool] = None) -> Params:
    """FedFA Alg. 1 lines 11-24 (graft=scale=True) and the partial-
    aggregation baselines (graft=scale=False) on trees: ``stacked_params``,
    ``masks``, ``gates``, ``gmaps`` and ``n_data`` carry a leading client
    axis m.  Elements no client updated keep their global value (γ = 0).

    engine="flat" runs the flat engine (``flat.aggregate_buffers``) on the
    packed trees, with the kernel choice ``use_kernel``;
    engine="tree" is the per-leaf oracle."""
    if engine == "flat":
        from repro_torch.core import flat
        index = flat.FlatIndex(global_params)
        g_new = flat.aggregate_buffers(
            index, flat.flatten(index, global_params),
            flat.flatten_stacked(index, stacked_params), cfg, masks, gates,
            gmaps, n_data, graft=graft, scale=scale, trim=trim, eps=eps,
            use_kernel=use_kernel)
        return flat.unflatten(index, g_new)
    if engine != "tree":
        raise ValueError(f"unknown aggregation engine {engine!r}")
    m = n_data.shape[0]
    alphas: List[Optional[Params]] = [None] * m
    if scale:
        norms = []
        for c in range(m):
            ax = axis_mask_tree(cfg, masks.client(c))
            p = _client(stacked_params, c)
            p = graft_stage0(p, gmaps[c]) if graft else p
            norms.append(trimmed_sq_norms(apply_mask_tree(p, ax), ax, trim))
        stacked_norms = tree_map(lambda *ns: torch.stack(ns), *norms)
        al = scaling_factors(stacked_norms, eps, n_data=n_data)
        alphas = [_client(al, c) for c in range(m)]

    zeros = lambda x: torch.zeros(x.shape[1:], dtype=torch.float32,
                                  device=x.device)
    Mp, Gm = tree_map(zeros, stacked_params), tree_map(zeros, stacked_params)
    for c in range(m):
        contrib, gamma = _weighted_contribution(
            cfg, _client(stacked_params, c), masks.client(c), gmaps[c],
            gates[c], n_data[c], alphas[c], graft)
        tree_map(lambda acc, x: acc.add_(x), Mp, contrib)
        tree_map(lambda acc, x: acc.add_(x), Gm, gamma)

    def finish(g_old, mp, gm):
        upd = mp / torch.clamp_min(gm, eps)
        return torch.where(gm > 0, upd, g_old.to(torch.float32)) \
            .to(g_old.dtype)
    return tree_map(finish, global_params, Mp, Gm)


# Strategy presets ----------------------------------------------------------

STRATEGIES = {
    # paper's method, all three flexibility modes share the same aggregation
    "fedfa": dict(graft=True, scale=True),
    # prior work: partial (incomplete) aggregation, no grafting, no scaling
    "heterofl": dict(graft=False, scale=False),
    "flexifed": dict(graft=False, scale=False),
    "nefl": dict(graft=False, scale=False),
    "fedavg": dict(graft=False, scale=False),
    # ablations
    "fedfa-graft-only": dict(graft=True, scale=False),
    "fedfa-scale-only": dict(graft=False, scale=True),
}


def aggregate_strategy(name: str, *args, **kw) -> Params:
    return aggregate(*args, **STRATEGIES[name], **kw)
