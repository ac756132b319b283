"""Analytic FLOP model per (architecture x input shape): matmul-level
accounting of one step, with the attention quadratic term, MoE top-k
routing and the SSD's chunk algebra.  The port's copy of the reference's
model, line for line (``tests/test_torch_costs.py`` holds every count
equal to it); the dry runs take their compute term from it, and a
measured step time over ``step_flops`` gives an achieved rate.

Pure Python: no tensor is built.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ArchConfig, InputShape


def _attn_block_flops(cfg: ArchConfig, B: float, S: float,
                      kv_len: Optional[float] = None,
                      window: Optional[int] = None,
                      cross_len: float = 0.0) -> float:
    D, hd = cfg.d_model, cfg.head_dim
    H, K = cfg.n_heads, cfg.n_kv_heads
    proj = 2 * B * S * D * (H + 2 * K) * hd + 2 * B * S * H * hd * D
    if kv_len is None:                      # full self-attention over S
        eff = min(S, window) if window else S
        att_len = eff / 2 if (not window or S <= window) else eff
    else:                                   # decode against a cache
        att_len = min(kv_len, window) if window else kv_len
    attn = 2 * 2 * B * S * att_len * H * hd
    ffn = 0.0
    if cfg.moe:
        e = cfg.moe
        ffn += 2 * B * S * D * e.n_experts                      # router
        ffn += 2 * 3 * B * S * e.top_k * D * e.d_ff_expert      # experts
        if e.dense_residual:
            ffn += 2 * 3 * B * S * D * e.d_ff_expert
    else:
        ffn = 2 * 3 * B * S * D * cfg.d_ff
    x = 0.0
    if cross_len:
        x = (2 * B * S * D * (H + 2 * K) * hd + 2 * B * S * H * hd * D
             + 2 * 2 * B * S * cross_len * H * hd)
    return proj + attn + ffn + x


def _ssd_block_flops(cfg: ArchConfig, B: float, S: float) -> float:
    s = cfg.ssm
    D = cfg.d_model
    di = s.d_inner(D)
    nh, hp, N, Q = s.n_heads(D), s.head_dim, s.d_state, s.chunk
    proj = 2 * B * S * D * (2 * di + 2 * N + nh)
    conv = 2 * B * S * (di + 2 * N) * s.d_conv
    nc = max(S // Q, 1)
    intra = B * nc * nh * (2 * Q * Q * N + 2 * Q * Q * hp + 2 * Q * N * hp)
    inter = B * nc * nh * 2 * Q * N * hp
    out = 2 * B * S * di * D
    return proj + conv + intra + inter + out


def _rglru_block_flops(cfg: ArchConfig, B: float, S: float) -> float:
    D = cfg.d_model
    dr = cfg.rglru.d_rnn(D)
    proj = 2 * 2 * B * S * D * dr
    conv = 2 * B * S * dr * cfg.rglru.d_conv
    gates = 2 * 2 * B * S * dr * dr
    scan = 10 * B * S * dr                   # elementwise recurrence
    out = 2 * B * S * dr * D
    ffn = 2 * 3 * B * S * D * cfg.d_ff
    return proj + conv + gates + scan + out + ffn


def forward_flops(cfg: ArchConfig, shape: InputShape, *,
                  window: Optional[int] = None) -> float:
    """One forward pass (token-level) over the given shape."""
    B = shape.global_batch
    decode = shape.kind == "decode"
    S = 1.0 if decode else float(shape.seq_len)
    kv = float(shape.seq_len) if decode else None
    total = 0.0
    cross = 0.0
    if cfg.vision is not None and not decode:
        total += 2 * B * cfg.vision.n_patches * (
            cfg.vision.vit_dim * cfg.d_model + cfg.d_model * cfg.d_model)
    if cfg.encoder is not None:
        cross = cfg.encoder.n_frames
        if not decode:
            total += cfg.encoder.n_layers * _attn_block_flops(
                cfg, B, cross)               # encoder runs in prefill/train
    win = window if window is not None else cfg.attn_window
    for unit, reps in cfg.stages():
        for kind in unit:
            if kind == "attn":
                f = _attn_block_flops(cfg, B, S, kv_len=kv, window=win,
                                      cross_len=cross)
            elif kind == "ssd":
                f = _ssd_block_flops(cfg, B, S)
            else:
                f = _rglru_block_flops(cfg, B, S)
            total += f * reps
    total += 2 * B * S * cfg.d_model * cfg.padded_vocab  # lm head
    return total


def step_flops(cfg: ArchConfig, shape: InputShape, *,
               window: Optional[int] = None) -> float:
    """One step: a forward, and for a train shape its backward (3x)."""
    f = forward_flops(cfg, shape, window=window)
    return 3.0 * f if shape.kind == "train" else f


def macs_per_client(cfg: ArchConfig, width_mult: float, section_depths,
                    B: int, S: int) -> float:
    """Paper Table 2 analog: MACs (= flops/2) for one client's local model
    forward+backward on one batch."""
    from repro_torch.models.masks import width_spec
    sp = width_spec(cfg, width_mult)
    sub = cfg.replace(d_model=sp.d_model, n_heads=max(sp.n_heads, 1),
                      n_kv_heads=max(sp.n_kv_heads, 1),
                      d_ff=max(sp.d_ff, 1),
                      n_layers=max(int(sum(section_depths)
                                       * len(cfg.layer_pattern)), 1))
    shp = InputShape("local", S, B, "train")
    return step_flops(sub, shp) / 2.0
