"""Plain PyTorch versions of the aggregation kernels: the CPU paths of
their wrappers in ``ops`` and the references the CUDA kernels are held
against."""
from __future__ import annotations

import torch


def scaled_accum_ref(x: torch.Tensor, weights: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """out[n] = Σ_c weights[c]·x[c, n]·mask[n]; x (m, n) -> (n,) f32."""
    return torch.einsum("mn,m->n", x.to(torch.float32),
                        weights.to(torch.float32)) * mask.to(torch.float32)


def quant_accum_ref(x: torch.Tensor, wtab: torch.Tensor, seg: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """out[n] = Σ_c x[c, n]·wtab[c, seg[n]]·mask[n]; x (m, n) int8 or bf16,
    wtab (m, S); seg = −1 columns contribute 0 (ids past S − 1 read the
    last column, as the JAX reference clips them)."""
    valid = (seg >= 0).to(torch.float32)
    w = wtab.to(torch.float32)[:, seg.clamp(0, wtab.shape[1] - 1).long()] \
        * valid[None, :]
    return torch.sum(x.to(torch.float32) * w, dim=0) * mask.to(torch.float32)


def trimmed_sumsq_ref(w: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Σ w²·[|w| <= t] over all of ``w`` -> 0-d f32."""
    wf = w.to(torch.float32)
    return torch.sum(torch.where(torch.abs(wf) <= t, wf * wf, 0.0))
