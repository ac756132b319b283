"""PyTorch + CUDA port of the FedFA server (the JAX package ``repro`` is the
reference).  Same module layout as ``repro``; hand-written CUDA kernels live
in ``csrc/`` and are built on first use (``repro_torch.kernels.build``)."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another one.  Without a GPU and without an explicit device this raises —
    the port never carries on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
