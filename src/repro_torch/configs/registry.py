"""Registry of the ported architectures (own copy of the dense and ssm
entries of ``repro.configs.registry``)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, SSMConfig

SMOLLM_135M = ArchConfig(
    name="smollm-135m", family="dense", citation="hf:HuggingFaceTB/SmolLM-135M",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536,
    vocab_size=49_152, d_head=64, tie_embeddings=True,
)

MAMBA2_130M = ArchConfig(
    name="mamba2-130m", family="ssm", citation="arXiv:2405.21060",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50_280, layer_pattern=("ssd",),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=128),
    tie_embeddings=True, norm="rmsnorm",
    long_context_mode="native",
)

ARCHS = {a.name: a for a in (SMOLLM_135M, MAMBA2_130M)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is not yet ported; ported: {sorted(ARCHS)}")
    return ARCHS[name]
