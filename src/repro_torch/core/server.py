"""Federated server: client specs, cohort runtimes and local training of a
selected cohort (Alg. 1 lines 4-10), plus the per-round driver.

The cohort is a loop over clients; each client's updated model is packed
straight into its row of the (m, N) cohort buffer, so no stacked tree of
client models is ever built.  On a mesh (``round.flat_round``) a rank
trains its m/D clients against the global gathered over ``model``; its
model peers train the same clients, as the reference's model-replicated
training does, and each keeps its own columns of the rows.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.core import attacks as attacks_mod
from repro_torch.core import fedfa, flat
from repro_torch.core.client import local_update
from repro_torch.models.masks import (ClientArch, WidthMasks, full_client,
                                      stack_masks)

Params = Dict[str, Any]


@dataclass
class ClientSpec:
    arch: ClientArch
    n_data: int
    malicious: bool = False
    class_mask: Optional[np.ndarray] = None   # (V,) non-IID logit zeroing


@dataclass
class FLConfig:
    participation: float = 0.1          # C
    local_steps: int = 5                # E
    lr: float = 0.01
    attack_lambda: float = 1.0          # λ in Eq. 1
    strategy: str = "fedfa"
    task: str = "lm"
    trim: float = 0.95
    agg_engine: str = "flat"            # "flat" (fused buffer) | "tree"
    use_kernel: Optional[bool] = None   # kernels (None: on the card only)
    interpret: bool = False             # the plain versions: use_kernel False
    update_dtype: str = "f32"           # cohort admission dtype: f32|bf16|int8
    seed: int = 0

    def __post_init__(self):
        # the port's interpret mode is the kernels' plain versions, so the
        # one choice threaded below is ``use_kernel``
        if self.interpret:
            self.use_kernel = False


def select_clients(n_clients: int, frac: float,
                   rng: np.random.Generator) -> np.ndarray:
    m = max(1, int(round(frac * n_clients)))
    return rng.choice(n_clients, size=m, replace=False)


def stack_runtimes(cfg: ArchConfig, specs: Sequence[ClientSpec], device):
    """(masks, gates (m, R), gmaps (m, R), n_data (m,), class masks (m, V)
    or None, malicious flags (m,)) of a cohort, on ``device``."""
    masks = stack_masks([s.arch.masks(cfg) for s in specs]).to(device)
    gates = torch.stack([s.arch.gates(cfg) for s in specs]).to(device)
    gmaps = torch.stack([s.arch.graft(cfg) for s in specs]).to(device)
    nd = torch.tensor([float(s.n_data) for s in specs], dtype=torch.float32,
                      device=device)
    cms = None
    if any(s.class_mask is not None for s in specs):
        V = cfg.padded_vocab
        cms = torch.stack([
            torch.as_tensor(s.class_mask if s.class_mask is not None
                            else np.ones(V, np.float32)) for s in specs]
        ).to(device)
    mal = torch.tensor([s.malicious for s in specs], device=device)
    return masks, gates, gmaps, nd, cms, mal


def default_class_masks(cms: Optional[torch.Tensor], cfg: ArchConfig,
                        fl: FLConfig, m: int, device) -> Optional[torch.Tensor]:
    """All-ones class masks on the cls task when no client restricts its
    classes; None on tasks without class masking."""
    if cms is not None or fl.task != "cls":
        return cms
    return torch.ones((m, cfg.padded_vocab), dtype=torch.float32, device=device)


def cohort_update(global_params: Params, cfg: ArchConfig, fl: FLConfig,
                  index: flat.FlatIndex, masks: WidthMasks,
                  gates: torch.Tensor, client_batches: Dict[str, torch.Tensor],
                  cms: Optional[torch.Tensor], mal: torch.Tensor,
                  perms: Optional[torch.Tensor],
                  out: torch.Tensor) -> torch.Tensor:
    """Local training of every client of the cohort (Alg. 1 lines 7-10),
    with the malicious label-shuffle branch for attackers.  Client i's
    updated model is flattened into ``out[i]``; returns the (m,) mean local
    losses.  ``perms`` (m, E·B) permutes the attackers' labels."""
    with tracing.span("train"):
        losses = []
        for i in range(out.shape[0]):
            with tracing.span("train/client", client=i):
                batches = {k: v[i] for k, v in client_batches.items()}
                kw = dict(masks=masks.client(i), gates=gates[i], lr=fl.lr,
                          task=fl.task,
                          class_mask=None if cms is None else cms[i],
                          optimizer=cfg.optimizer, momentum=cfg.momentum,
                          weight_decay=cfg.weight_decay)
                params, step_losses = local_update(global_params, cfg,
                                                   batches, **kw)
                with tracing.span("train/client/pack"):
                    if tracing.to_host(mal[i], bool):
                        poisoned = attacks_mod.shuffle_labels(
                            batches, perms[i], fl.task)
                        bad, _ = local_update(global_params, cfg, poisoned,
                                              **kw)
                        params = attacks_mod.combine_malicious(
                            global_params, params, bad, fl.attack_lambda)
                    flat.flatten(index, params, out=out[i])
                    losses.append(torch.mean(step_losses))
        return torch.stack(losses)


def fl_round(global_params: Params, cfg: ArchConfig, fl: FLConfig,
             specs: Sequence[ClientSpec], client_batches, *,
             perms: Optional[torch.Tensor] = None) -> Tuple[Params, torch.Tensor]:
    """One round over the selected clients without resident buffers (the
    per-round driver), aggregated by ``fl.agg_engine``: the flat engine on
    the cohort buffer, or the tree engine on the client-stacked trees
    viewed out of it.  Returns (new global params, mean local loss)."""
    device = global_params["embed"].device
    masks, gates, gmaps, nd, cms, mal = stack_runtimes(cfg, specs, device)
    index = flat.FlatIndex(global_params)
    x = torch.empty((len(specs), index.n_padded), dtype=torch.float32,
                    device=device)
    losses = cohort_update(global_params, cfg, fl, index, masks, gates,
                           client_batches,
                           default_class_masks(cms, cfg, fl, len(specs), device),
                           mal, perms, x)
    if fl.agg_engine == "tree":
        return fedfa.aggregate_strategy(
            fl.strategy, global_params, flat.unflatten_stacked(index, x), cfg,
            masks, gates, gmaps, nd, trim=fl.trim, engine="tree"), \
            torch.mean(losses)
    if fl.agg_engine != "flat":
        raise ValueError(f"unknown aggregation engine {fl.agg_engine!r}")
    g_new = flat.aggregate_buffers(
        index, flat.flatten(index, global_params), x, cfg, masks, gates,
        gmaps, nd, trim=fl.trim, use_kernel=fl.use_kernel,
        **fedfa.STRATEGIES[fl.strategy])
    return flat.unflatten(index, g_new), torch.mean(losses)


def fl_round_flat(g_buf: torch.Tensor, cfg: ArchConfig, fl: FLConfig,
                  specs: Sequence[ClientSpec], client_batches, *,
                  index: Optional[flat.FlatIndex] = None, c_buf=None,
                  perms: Optional[torch.Tensor] = None):
    """Flat-native counterpart of ``fl_round``: one round on the resident
    (N,) global buffer, in place, through ``round.flat_round``.  ``c_buf``
    is the cohort state a previous call returned: the (m, N) f32 training
    buffer, or with a quantized ``fl.update_dtype`` the pair (training
    buffer, quantized state); None (or one of another shape) allocates a
    fresh one.  Returns (g_buf, c_buf to pass back next round, mean local
    loss).  For many rounds prefer ``round.run_rounds``."""
    from repro_torch.core import round as round_mod
    if index is None:
        raise ValueError("fl_round_flat needs the FlatIndex the resident "
                         "buffer was flattened with (flat.FlatIndex(params))")
    m, device = len(specs), g_buf.device
    qmode = fl.update_dtype != "f32"
    buf, qstate = (c_buf if qmode and isinstance(c_buf, tuple)
                   else (c_buf, None))
    want = flat.update_dtype_of(fl.update_dtype)
    if (not isinstance(buf, torch.Tensor)
            or tuple(buf.shape) != (m, index.n_padded)):
        buf = torch.empty((m, index.n_padded), dtype=torch.float32,
                          device=device)
    if qmode and (qstate is None or qstate[0].dtype != want
                  or qstate[0].shape[0] != m):
        qstate = round_mod.fresh_quant_state(index, m, fl.update_dtype,
                                             device)
    loss = round_mod.flat_round(g_buf, buf, cfg, fl, index,
                                stack_runtimes(cfg, specs, device),
                                client_batches, perms, qstate)
    return g_buf, ((buf, qstate) if qmode else buf), loss


def make_client_specs(cfg: ArchConfig, n_clients: int, *,
                      archs: Sequence[ClientArch],
                      malicious_frac: float = 0.0,
                      n_data_range: Tuple[int, int] = (100, 250),
                      class_masks: Optional[Sequence[np.ndarray]] = None,
                      seed: int = 0) -> List[ClientSpec]:
    """Half the clients take the smallest architecture (paper §5.1), the
    rest the supplied ones; attackers take the largest (paper §3.1).
    ``n_data_range`` is inclusive on both ends."""
    rng = np.random.default_rng(seed)
    smallest = min(archs, key=lambda a: (a.width_mult, sum(a.section_depths)))
    n_mal = int(round(malicious_frac * n_clients))
    mal_ids = set(rng.choice(n_clients, size=n_mal, replace=False).tolist()) \
        if n_mal else set()
    specs = []
    for i in range(n_clients):
        if i in mal_ids:
            arch = full_client(cfg)
        elif i % 2 == 0:
            arch = smallest
        else:
            arch = archs[int(rng.integers(len(archs)))]
        specs.append(ClientSpec(
            arch=arch,
            n_data=int(rng.integers(*n_data_range, endpoint=True)),
            malicious=i in mal_ids,
            class_mask=None if class_masks is None else class_masks[i]))
    return specs
