"""A pre-norm decoder block: grouped-query attention with rotary positions
(causal softmax over the whole sequence), then a gated SiLU FFN, each
after an RMSNorm with ``1 + scale``.  Its flexible dimensions are the
heads (whole kv groups), the kv heads and the FFN's width."""
from __future__ import annotations

import torch.nn.functional as F

from bench.reference import masks as mk
from bench.reference import model as md
from bench.reference.config import ModelConfig


def flex(cfg: ModelConfig, w: float) -> dict:
    H, K, Fd = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    kv = max(1, int(round(w * K))) if K else 0
    heads = kv * (H // K) if K else 0
    d_ff = max(8, int(w * Fd) // 8 * 8) if (Fd and w < 1.0) else Fd
    return {"heads": (H, heads), "kv_heads": (K, kv), "d_ff": (Fd, d_ff)}


def shapes(cfg: ModelConfig, r: int) -> dict:
    D = cfg.d_model
    H, K, hd, Fd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    return {("ln1", "scale"): (r, D), ("ln2", "scale"): (r, D),
            ("attn", "wq"): (r, D, H * hd), ("attn", "wk"): (r, D, K * hd),
            ("attn", "wv"): (r, D, K * hd), ("attn", "wo"): (r, H * hd, D),
            ("ffn", "w_gate"): (r, D, Fd), ("ffn", "w_up"): (r, D, Fd),
            ("ffn", "w_down"): (r, Fd, D)}


def init_rule(leaf, shape):
    """RMSNorm scales 0 (entering as 1 + scale), matrices fan-in normal."""
    if leaf[-1] == "scale":
        return "fill", 0.0
    return "normal", md.fan_in_std(shape)


def axes(cfg: ModelConfig, m) -> dict:
    dm = m["d_model"]
    h = mk.repeat_mask(m["heads"], cfg.head_dim)
    kv = mk.repeat_mask(m["kv_heads"], cfg.head_dim)
    return {("ln1", "scale"): (dm,), ("ln2", "scale"): (dm,),
            ("attn", "wq"): (dm, h), ("attn", "wk"): (dm, kv),
            ("attn", "wv"): (dm, kv), ("attn", "wo"): (h, dm),
            ("ffn", "w_gate"): (dm, m["d_ff"]), ("ffn", "w_up"): (dm, m["d_ff"]),
            ("ffn", "w_down"): (m["d_ff"], dm)}


def attn(p, x, cfg: ModelConfig, m):
    """The attention branch (before its gate) of x (B, S, D)."""
    B, S, _ = x.shape
    hd, H, K = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dm = m["d_model"]
    h = md.rms_norm(x, p[("ln1", "scale")], dm, cfg.norm_eps)
    q = md.rope((h @ p[("attn", "wq")]).reshape(B, S, H, hd), cfg.rope_theta)
    k = md.rope((h @ p[("attn", "wk")]).reshape(B, S, K, hd), cfg.rope_theta)
    v = (h @ p[("attn", "wv")]).reshape(B, S, K, hd)
    return md.attention(q, k, v, m["heads"]).reshape(B, S, H * hd) \
        @ p[("attn", "wo")]


def ffn(p, h, m):
    g = F.silu(h @ p[("ffn", "w_gate")]) * (h @ p[("ffn", "w_up")])
    if m["d_ff"] is not None:
        g = g * m["d_ff"]
    return g @ p[("ffn", "w_down")]


def forward(p, x, cfg: ModelConfig, m, gate):
    x = x + gate * attn(p, x, cfg, m)
    h = md.rms_norm(x, p[("ln2", "scale")], m["d_model"], cfg.norm_eps)
    return x + gate * ffn(p, h, m), 0.0


def attn_flops(cfg: ModelConfig, sizes, B, S) -> float:
    """The attention branch: projections and causal scores."""
    D, hd = sizes["d_model"], cfg.head_dim
    H, K = sizes["heads"], sizes["kv_heads"]
    proj = 2 * B * S * D * (H + 2 * K) * hd + 2 * B * S * H * hd * D
    return proj + 2 * 2 * B * S * (S / 2) * H * hd


def flops(cfg: ModelConfig, sizes, B, S) -> float:
    ffn = 2 * 3 * B * S * sizes["d_model"] * sizes["d_ff"]
    return attn_flops(cfg, sizes, B, S) + ffn
