"""Registry of the architectures (own copy of ``repro.configs.registry``,
field for field)."""
from __future__ import annotations

from repro_torch.configs.base import (ArchConfig, EncoderConfig, MoEConfig,
                                     RGLRUConfig, SSMConfig, VisionConfig)

MINICPM_2B = ArchConfig(
    name="minicpm-2b", family="dense", citation="arXiv:2404.06395",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab_size=122_753, d_head=64, tie_embeddings=True,
    schedule="wsd", optimizer="adamw", learning_rate=1e-2,
    fsdp=True, grad_accum=4,
)

SMOLLM_135M = ArchConfig(
    name="smollm-135m", family="dense", citation="hf:HuggingFaceTB/SmolLM-135M",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536,
    vocab_size=49_152, d_head=64, tie_embeddings=True,
)

ARCTIC_480B = ArchConfig(
    name="arctic-480b", family="moe", citation="hf:Snowflake/snowflake-arctic-base",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab_size=32_000, d_head=128,
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864, dense_residual=True),
    fsdp=True, serve_fsdp=True, grad_accum=128, optimizer="sgd",
    prefill_chunk=2048,
)

RECURRENTGEMMA_2B = ArchConfig(
    name="recurrentgemma-2b", family="hybrid", citation="arXiv:2402.19427",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab_size=256_000, d_head=256, attn_window=2048,
    layer_pattern=("rglru", "rglru", "attn"),
    rglru=RGLRUConfig(expand=1.0),          # RG-2B lru_width == d_model (2560)
    act="gelu", logit_softcap=30.0, fsdp=True, grad_accum=4,
    long_context_mode="native",
)

MAMBA2_130M = ArchConfig(
    name="mamba2-130m", family="ssm", citation="arXiv:2405.21060",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50_280, layer_pattern=("ssd",),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=128),
    tie_embeddings=True, norm="rmsnorm",
    long_context_mode="native",
)

TINYLLAMA_1B = ArchConfig(
    name="tinyllama-1.1b", family="dense", citation="arXiv:2401.02385",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=5632,
    vocab_size=32_000, d_head=64,
    fsdp=True, grad_accum=2,
)

PHI35_MOE = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe", citation="hf:microsoft/Phi-3.5-MoE-instruct",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    vocab_size=32_064, d_head=128,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400),
    fsdp=True, grad_accum=8, prefill_chunk=1024,
)

INTERNVL2_76B = ArchConfig(
    name="internvl2-76b", family="vlm", citation="arXiv:2404.16821",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab_size=128_256, d_head=128,
    vision=VisionConfig(n_patches=1024, vit_dim=3200),
    fsdp=True, serve_fsdp=True, grad_accum=16,
)

CODEQWEN_7B = ArchConfig(
    name="codeqwen1.5-7b", family="dense", citation="hf:Qwen/CodeQwen1.5-7B",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=13440,
    vocab_size=92_416, d_head=128, fsdp=True, grad_accum=4,
)

WHISPER_BASE = ArchConfig(
    name="whisper-base", family="audio", citation="arXiv:2212.04356",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab_size=51_865, d_head=64, norm="layernorm", act="gelu",
    encoder=EncoderConfig(n_layers=6, n_frames=1500),
    rope_theta=0.0,                  # learned positions
    grad_accum=4,
    max_seq_len=65_536,              # the learned position table's rows
    long_context_mode="skip",
)

# The paper's own Transformer LM (Table 4 rightmost column, WikiText-2).
# Its reduced() cut keeps 3 query heads and 2 kv heads, which neither
# package can run (3 is not a multiple of 2); its published size runs.
FEDFA_PAPER_TRANSFORMER = ArchConfig(
    name="fedfa-paper-transformer", family="dense", citation="FedFA Table 4",
    n_layers=4, d_model=192, n_heads=3, n_kv_heads=3, d_ff=768,
    vocab_size=28_782, d_head=64, max_seq_len=512, n_sections=1,
    optimizer="sgd", learning_rate=0.1, weight_decay=0.0,
)

ARCHS = {a.name: a for a in (MINICPM_2B, SMOLLM_135M, ARCTIC_480B,
                             RECURRENTGEMMA_2B, MAMBA2_130M, TINYLLAMA_1B,
                             PHI35_MOE, INTERNVL2_76B, CODEQWEN_7B,
                             WHISPER_BASE,
                             FEDFA_PAPER_TRANSFORMER)}


# every registry entry but the paper's own transformer
ASSIGNED = [a for a in ARCHS if a != "fedfa-paper-transformer"]


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is not in the registry; known: {sorted(ARCHS)}")
    return ARCHS[name]
