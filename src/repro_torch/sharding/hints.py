"""Activation-sharding hints: which layout each kind of activation should
take on the production mesh.

The reference's model code calls ``constrain(x, kind)`` at layout-critical
points, and its launcher installs a policy mapping kinds to partition
specs before lowering.  The port keeps the policy (``policy``,
``megatron_policy``) so that its dry run can state the plan it assumes
and record it; its models make no ``constrain`` calls.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

from repro_torch.sharding.specs import P

_state = threading.local()


def current_policy() -> Optional[Dict[str, P]]:
    return getattr(_state, "policy", None)


@contextlib.contextmanager
def policy(mapping: Dict[str, P]):
    prev = current_policy()
    _state.policy = mapping
    try:
        yield
    finally:
        _state.policy = prev


def constrain(x, kind: str):
    """``x`` unchanged.  The reference pins x's layout here for XLA's
    sharding propagation; eager PyTorch has no propagation to steer (each
    rank holds what its code puts there, ``sharding.cohort``), so there is
    nothing to constrain."""
    return x


def megatron_policy(batch_axes=("data",), model_axis="model") -> Dict[str, P]:
    """Residual replicated over model; heads / ffn / experts sharded over
    model."""
    b = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    return {
        "residual": P(b, None, None),
        "heads": P(b, None, model_axis, None),
        "ffn": P(b, None, model_axis),
        "experts": P(model_axis, None, None),
        "tokens": P(b, None),
        "logits": P(b, None, model_axis),
    }
