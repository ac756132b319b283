"""What the entries share: the program's configuration and weights from the
benchmark's own, the layout check between the two, and the numbers the
comparison with the reference reads (per-leaf norms and their gaps)."""
from __future__ import annotations

import dataclasses
import gc
import typing
from typing import List, Sequence

import torch

from bench import traffic as tr
from bench.reference import model as md
from bench.reference.config import ModelConfig

WEIGHTS_STREAM = 5


def _dataclass_in(hint):
    """The dataclass that a field's type hint names (``Optional[X]``
    included), else None."""
    for t in (hint,) + typing.get_args(hint):
        if dataclasses.is_dataclass(t):
            return t
    return None


def program_config(model: dict):
    """The program's ``ArchConfig`` holding every key of the
    configuration file's ``model`` object that it has; a field whose type
    is a dataclass (``ssm``, ``moe``, ``rglru``, ...) built from its
    object."""
    from repro_torch.configs.base import ArchConfig
    hints = typing.get_type_hints(ArchConfig)
    kw = {k: v for k, v in model.items()
          if k in ArchConfig.__dataclass_fields__}
    kw["layer_pattern"] = tuple(kw.get("layer_pattern", ("attn",)))
    for k, v in kw.items():
        sub = _dataclass_in(hints[k])
        if sub is not None and v is not None:
            kw[k] = sub(**v)
    return ArchConfig(**kw)


def weights(cfg: ModelConfig, seed: int, device) -> torch.Tensor:
    return md.init_flat(cfg, tr.stream_seed(seed, WEIGHTS_STREAM), device)


def program_weights(cfg: ModelConfig, g: torch.Tensor):
    """(FlatIndex, (N,) global buffer) of the program, built by the
    program from the benchmark's weights; raises unless its layout is the
    benchmark's, leaf for leaf."""
    from repro_torch.core import flat
    from repro_torch.tree import from_paths
    views = md.unflatten(cfg, g)
    params = from_paths(list(views), list(views.values()))
    index = flat.FlatIndex(params)
    mine = [(p, tuple(s), off) for p, s, off, *_ in md.leaf_layout(cfg)]
    theirs = [(s.path, tuple(s.shape), s.offset) for s in index.leaves]
    if mine != theirs or index.n_padded != g.shape[0]:
        raise RuntimeError("the program's flat layout is not the "
                           "benchmark's")
    return index, flat.flatten(index, params)


def program_specs(members: Sequence[tr.Member]):
    from repro_torch.core.server import ClientSpec
    from repro_torch.models.masks import ClientArch
    return [ClientSpec(arch=ClientArch(w, tuple(d)), n_data=n)
            for w, d, n in members]


def leaf_norms(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Per-leaf L2 norms of (N,) or (m, N) -> (L,) or (m, L), on the
    CPU."""
    cols = [torch.linalg.vector_norm(x[..., off:off + size], dim=-1)
            for _, _, off, size, *_ in md.leaf_layout(cfg)]
    return torch.stack(cols, dim=-1).double().cpu()


def width_masked(cfg: ModelConfig, g: torch.Tensor,
                 members: Sequence[tr.Member]) -> torch.Tensor:
    """(m, N): the global zeroed outside each client's width (what each
    client starts its local training from)."""
    out = g.expand(len(members), -1).clone()
    for c, mem in enumerate(members):
        for off, size, shape, d in tr.client_mask_rows(cfg, mem, g.device,
                                                       depth=False):
            out[c, off:off + size].view(shape).mul_(d)
    return out


def leaf_gaps(prog: torch.Tensor, ref: torch.Tensor) -> List[torch.Tensor]:
    """Per row of per-leaf norms (the last axis): |prog − ref| / max(ref,
    the median leaf's ref), leaves whose reference norm is under a
    thousandth of the median's left out (they move by rounding alone);
    inf where the program's norm is not finite."""
    ref, prog = ref.reshape(-1, ref.shape[-1]), prog.reshape(-1, ref.shape[-1])
    out = []
    for p, r in zip(prog, ref):
        med = float(torch.median(r))
        keep = r >= 1e-3 * med
        gap = torch.abs(p - r)[keep] / torch.clamp_min(r[keep], med)
        out.append(torch.where(torch.isfinite(p[keep]), gap,
                               torch.full_like(gap, float("inf"))))
    return out


def norm_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst leaf's gap (``leaf_gaps``) over every row."""
    return max(float(torch.max(g)) if g.numel() else 0.0
               for g in leaf_gaps(prog, ref))


def median_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The median leaf's gap (``leaf_gaps``) of (L,) per-leaf norms."""
    (g,) = leaf_gaps(prog, ref)
    return float(torch.quantile(g, 0.5, interpolation="lower"))


def diff_gap(cfg: ModelConfig, prog: torch.Tensor, ref: torch.Tensor,
             base: torch.Tensor) -> float:
    """Worst per-leaf ‖prog − ref‖ / max(‖ref − base‖, the median leaf's)
    of (N,) or (m, N) buffers: how far an answer is off, as a share of the
    change it makes."""
    err = leaf_norms(cfg, prog - ref).reshape(-1)
    scale = leaf_norms(cfg, ref - base).reshape(-1)
    if not torch.isfinite(err).all():
        return float("inf")
    med = float(torch.median(scale))
    return float(torch.max(err / torch.clamp_min(scale, max(med, 1e-30))))


def free(device) -> None:
    """Return what freed program state held to the device."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def peak(device) -> int:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def p95(values: List[float]) -> float:
    """The nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, -(-95 * len(s) // 100) - 1)]
