"""Architecture configuration (own copy of ``repro.configs.base``: the
dense, ssm, moe, hybrid, audio and vlm families) and the assigned input
shapes.  The field values, derived properties and ``reduced()`` are held
equal to the JAX package's by ``tests/test_torch_static.py``, the
parameter counts and shapes by ``tests/test_torch_costs.py``."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    # Snowflake-Arctic style: a dense FFN residual branch in parallel with MoE.
    dense_residual: bool = False
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block configuration."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU block configuration."""
    d_conv: int = 4
    expand: float = 1.5          # d_rnn = expand * d_model (RG uses lru_width)
    c: float = 8.0               # a = a_param ** (c * r_t)

    def d_rnn(self, d_model: int) -> int:
        return int(self.expand * d_model)


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack of the encoder-decoder (whisper).  The conv / mel
    frontend is a stub: the encoder takes precomputed frame embeddings
    (B, n_frames, d_model)."""
    n_layers: int = 6
    n_frames: int = 1500


@dataclass(frozen=True)
class VisionConfig:
    """Frontend of the vision-language model (internvl2).  The vision
    encoder is a stub: the model takes precomputed patch embeddings
    (B, n_patches, vit_dim), and a trainable MLP projector maps them to
    d_model."""
    n_patches: int = 1024
    vit_dim: int = 3200


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    citation: str = ""

    d_head: int = 0                  # 0 -> d_model // n_heads
    max_seq_len: int = 524_288
    rope_theta: float = 10_000.0     # 0: learned positions (pos_embed)
    attn_window: Optional[int] = None
    layer_pattern: Tuple[str, ...] = ("attn",)
    act: str = "silu"
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    logit_softcap: Optional[float] = None

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionConfig] = None

    # --- FedFA ---
    n_sections: int = 4              # contiguous groups of scan repeats
    pad_vocab: bool = True           # embedding rows padded to 128

    # --- runtime policy ---
    dtype: str = "bfloat16"
    fsdp: bool = False
    serve_fsdp: bool = False
    remat: bool = True
    grad_accum: int = 1
    optimizer: str = "sgd"
    momentum_dtype: str = "float32"
    learning_rate: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 1e-4
    schedule: str = "constant"
    long_context_mode: str = "window"
    prefill_chunk: Optional[int] = None

    @property
    def padded_vocab(self) -> int:
        if not self.pad_vocab:
            return self.vocab_size
        return (self.vocab_size + 127) // 128 * 128

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(self.n_heads, 1))

    def stages(self) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
        """Decompose n_layers into stages: [(pattern_unit, n_repeats)]."""
        unit = self.layer_pattern
        full, rem = divmod(self.n_layers, len(unit))
        out = []
        if full:
            out.append((unit, full))
        if rem:
            out.append((unit[:rem], 1))
        return tuple(out)

    @property
    def n_repeats(self) -> int:
        return sum(r for _, r in self.stages())

    def section_bounds(self) -> Tuple[Tuple[int, int], ...]:
        """FedFA sections over the repeat axis of stage 0."""
        reps = self.stages()[0][1]
        n_sec = min(self.n_sections, reps)
        base, extra = divmod(reps, n_sec)
        bounds, start = [], 0
        for s in range(n_sec):
            size = base + (1 if s < extra else 0)
            bounds.append((start, start + size))
            start += size
        return tuple(bounds)

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks + head), the
        reference's arithmetic as it stands: its SSD term keeps a
        ``2 * d_state * 0`` and the encoder-decoder's cross attention is
        counted roughly, per encoder layer."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, K, hd = self.n_heads, self.n_kv_heads, self.head_dim
        per: dict = {}
        per["attn"] = D * (H * hd) + 2 * D * (K * hd) + (H * hd) * D + 2 * D
        per["mlp"] = 3 * D * F + 2 * D
        if self.moe:
            e = self.moe
            per["moe"] = (e.n_experts * 3 * D * e.d_ff_expert
                          + D * e.n_experts
                          + (3 * D * F if e.dense_residual else 0) + 2 * D)
        if self.ssm:
            s = self.ssm
            di = s.d_inner(D)
            per["ssd"] = (D * (2 * di + 2 * s.d_state * 0 + s.n_heads(D))
                          + di * (2 * s.d_state) + s.d_conv * di + di * D
                          + 2 * D)
        if self.rglru:
            r = self.rglru
            dr = r.d_rnn(D)
            per["rglru"] = (D * dr * 2 + r.d_conv * dr + 3 * dr + dr * D
                            + 2 * D)
        total = 0
        for unit, reps in self.stages():
            for kind in unit:
                blk = {"attn": per["attn"] + per.get("moe", per["mlp"])
                       if self.moe else per["attn"] + per["mlp"],
                       "ssd": per.get("ssd", 0),
                       "rglru": per.get("rglru", 0) + per["mlp"]}[kind]
                total += blk * reps
        total += V * D * (1 if self.tie_embeddings else 2) + D
        if self.vision:
            total += self.vision.vit_dim * D + D * D
        if self.encoder:
            enc_blk = per["attn"] + per["mlp"]
            # + the decoder's cross attention, counted roughly
            total += self.encoder.n_layers * (enc_blk + per["attn"])
        return total

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top_k experts of all)."""
        if not self.moe:
            return self.param_count()
        e = self.moe
        n = self.n_repeats_total_layers()
        all_expert = n * e.n_experts * 3 * self.d_model * e.d_ff_expert
        act_expert = n * e.top_k * 3 * self.d_model * e.d_ff_expert
        return self.param_count() - all_expert + act_expert

    def n_repeats_total_layers(self) -> int:
        return self.n_layers

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: <=2 layers, d_model<=256, <=4 experts."""
        kw = dict(
            n_layers=min(self.n_layers, 2 * len(self.layer_pattern)),
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            d_head=64 if self.d_head else 0,
            max_seq_len=512,
            n_sections=2,
            grad_accum=1,
            fsdp=False,
        )
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                d_ff_expert=min(self.moe.d_ff_expert, 256))
        if self.ssm:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=32, head_dim=32,
                                            chunk=32)
        if self.encoder:
            kw["encoder"] = dataclasses.replace(self.encoder, n_layers=2,
                                                n_frames=64)
        if self.vision:
            kw["vision"] = dataclasses.replace(self.vision, n_patches=16,
                                               vit_dim=128)
        if self.attn_window:
            kw["attn_window"] = min(self.attn_window, 128)
        return self.replace(**kw)


@dataclass(frozen=True)
class InputShape:
    """One assigned input shape: sequence length, global batch and kind
    (train | prefill | decode)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                    LONG_500K)}
