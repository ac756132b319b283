"""Registry of the ported architectures (own copy of the dense entries of
``repro.configs.registry``)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig

SMOLLM_135M = ArchConfig(
    name="smollm-135m", family="dense", citation="hf:HuggingFaceTB/SmolLM-135M",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536,
    vocab_size=49_152, d_head=64, tie_embeddings=True,
)

ARCHS = {a.name: a for a in (SMOLLM_135M,)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is not yet ported; ported: {sorted(ARCHS)}")
    return ARCHS[name]
