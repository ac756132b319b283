"""Mixture-of-experts FFN with sort-based capacity dispatch (the port of
``repro.models.moe``), in plain PyTorch: the JAX package has no TPU kernel
for it.

Token-to-expert assignments are sorted by expert id and scattered into a
fixed (E, C, D) buffer, C tokens an expert; tokens past an expert's
capacity are dropped (they keep only their residual).  FedFA's width
flexibility reaches the expert axis: a weak client holds a prefix of the
experts (``expert_mask``); ``d_ff_expert`` stays whole (the reference's
stack passes no ``d_ff`` mask here).  The order of operations is the
reference's, so that the same experts are picked and the same tokens
dropped.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import ACTIVATIONS, matmul


def moe_param_shapes(d_model: int, cfg: MoEConfig) -> Dict:
    """The leaves of one block's MoE FFN: an f32 router, stacked expert
    matrices, and the dense residual branch (``d_ff_expert`` wide) only
    with ``dense_residual``."""
    E, Fe = cfg.n_experts, cfg.d_ff_expert
    p = {"router": (d_model, E), "w_gate": (E, d_model, Fe),
         "w_up": (E, d_model, Fe), "w_down": (E, Fe, d_model)}
    if cfg.dense_residual:
        p["dense"] = {"w_gate": (d_model, Fe), "w_up": (d_model, Fe),
                      "w_down": (Fe, d_model)}
    return p


def _top_k(gates: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest gates of each row and their experts, ties to the lower
    expert index (as ``jax.lax.top_k``): the first k of a stable descending
    sort.  ``torch.topk`` promises no order on ties."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def moe_ffn(params: Dict, x: torch.Tensor, cfg: MoEConfig, act_name: str,
            expert_mask: Optional[torch.Tensor] = None,
            capacity: Optional[int] = None):
    """x (B, S, D) -> (out (B, S, D), {'lb_loss', 'z_loss'}).

    The capacity is computed per call from N = B·S tokens (so a decode
    step of batch B has N = B), unless ``capacity`` is given."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    N = B * S
    act = ACTIVATIONS[act_name]
    xf = x.reshape(N, D)

    logits = matmul(xf.to(torch.float32), params["router"])         # (N, E)
    if expert_mask is not None:
        logits = torch.where(expert_mask[None, :] > 0, logits,
                             torch.full((), -1e30, device=x.device))
    gates = torch.softmax(logits, dim=-1)
    top_g, top_e = _top_k(gates, k)                                 # (N, k)
    top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)

    # aux losses: Switch-style load balance and the router z-loss
    me = torch.mean(gates, dim=0)                                   # (E,)
    ce = torch.mean(torch.nn.functional.one_hot(top_e[:, 0], E)
                    .to(torch.float32), dim=0)
    n_active = E if expert_mask is None else \
        torch.clamp(expert_mask.sum(), min=1.0)
    lb_loss = n_active * torch.sum(me * ce) * cfg.load_balance_loss
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) \
        * cfg.router_z_loss

    # sort-based dispatch: the stable sort keeps each expert's tokens in
    # flat (token, choice) order, so the lower flat index survives a full
    # expert, as in the reference
    C = capacity or max(1, int(cfg.capacity_factor * k * N / E))
    flat_e = top_e.reshape(-1)                                      # (N·k,)
    flat_g = top_g.reshape(-1)
    flat_tok = torch.arange(N, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, sg, stok = flat_e[order], flat_g[order], flat_tok[order]
    seg_start = torch.searchsorted(se, torch.arange(E, device=x.device))
    pos_in_e = torch.arange(N * k, device=x.device) - seg_start[se]
    keep = pos_in_e < C
    slot = se * C + torch.where(keep, pos_in_e, torch.zeros_like(pos_in_e))

    # gather the tokens into (E·C, D); a dropped token adds zeros into
    # its expert's slot 0
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    buf = torch.zeros((E * C, D), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, slot, torch.where(keep[:, None], xf[stok], zero))
    buf = buf.reshape(E, C, D)

    # the experts: (E, C, D) x (E, D, Fe)
    h = act(matmul(buf, params["w_gate"])) * matmul(buf, params["w_up"])
    y = matmul(h, params["w_down"]).reshape(E * C, D)

    # combine: the weighted scatter-add back onto the tokens.  With top_k
    # 2 a token gets two terms added onto zero, a sum that is the same in
    # either order, so index_add_'s order (CUDA atomics included) keeps the
    # bits; top_k > 2 would lose that.
    contrib = torch.where(keep[:, None], y[slot] * sg[:, None].to(y.dtype),
                          torch.zeros((), dtype=y.dtype, device=y.device))
    out = torch.zeros((N, D), dtype=x.dtype, device=x.device).index_add(
        0, stok, contrib.to(x.dtype))

    if cfg.dense_residual and "dense" in params:
        d = params["dense"]
        out = out + matmul(act(matmul(xf, d["w_gate"]))
                           * matmul(xf, d["w_up"]), d["w_down"])

    return out.reshape(B, S, D), {"lb_loss": lb_loss, "z_loss": z_loss}
