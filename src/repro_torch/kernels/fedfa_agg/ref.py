"""Plain PyTorch version of the aggregation kernel: the CPU path of
``ops.scaled_accum`` and the reference the CUDA kernel is held against."""
from __future__ import annotations

import torch


def scaled_accum_ref(x: torch.Tensor, weights: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """out[n] = Σ_c weights[c]·x[c, n]·mask[n]; x (m, n) -> (n,) f32."""
    return torch.einsum("mn,m->n", x.to(torch.float32),
                        weights.to(torch.float32)) * mask.to(torch.float32)
