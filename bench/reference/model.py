"""The plain reference model: the forward pass, next-token loss and
gradients of the two families the benchmark runs, in float32 PyTorch with
no kernel, cache or batching beyond the batch itself.

* ``dense``: pre-norm decoder blocks of grouped-query attention with
  rotary positions (causal softmax over the whole sequence) and a gated
  SiLU FFN, RMSNorm with ``1 + scale``, a tied or untied head.
* ``ssm``: Mamba-2 SSD blocks (input projection, causal depthwise conv,
  the chunked state-space dual form, gated RMSNorm, output projection).

FedFA's client sub-models enter as width masks (channels outside the
client's width are zeroed and norms count active channels only) and depth
gates (a gated-off block adds nothing to the residual).  Parameters are a
dict {leaf path: tensor} in the flatten order of a parameter tree (dict
keys sorted, sequences in order)."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from bench.reference.config import ModelConfig

Params = Dict[Tuple, torch.Tensor]


# ---------------------------------------------------------------------------
# Shapes and weights
# ---------------------------------------------------------------------------

def _block_shapes(kind: str, cfg: ModelConfig, r: int) -> dict:
    D = cfg.d_model
    if kind == "ssd":
        s = cfg.ssm
        di, nh, N = s.d_inner(D), s.n_heads(D), s.d_state
        conv = di + 2 * N
        return {("ln", "scale"): (r, D),
                ("ssd", "in_proj"): (r, D, 2 * di + 2 * N + nh),
                ("ssd", "conv_w"): (r, s.d_conv, conv),
                ("ssd", "conv_b"): (r, conv), ("ssd", "A_log"): (r, nh),
                ("ssd", "D"): (r, nh), ("ssd", "dt_bias"): (r, nh),
                ("ssd", "norm"): (r, di), ("ssd", "out_proj"): (r, di, D)}
    H, K, hd, Fd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    return {("ln1", "scale"): (r, D), ("ln2", "scale"): (r, D),
            ("attn", "wq"): (r, D, H * hd), ("attn", "wk"): (r, D, K * hd),
            ("attn", "wv"): (r, D, K * hd), ("attn", "wo"): (r, H * hd, D),
            ("ffn", "w_gate"): (r, D, Fd), ("ffn", "w_up"): (r, D, Fd),
            ("ffn", "w_down"): (r, Fd, D)}


def param_shapes(cfg: ModelConfig) -> Dict[Tuple, Tuple[int, ...]]:
    """{path: shape} in flatten order."""
    out = {("embed",): (cfg.padded_vocab, cfg.d_model),
           ("final_norm", "scale"): (cfg.d_model,)}
    if not cfg.tie_embeddings:
        out[("lm_head",)] = (cfg.d_model, cfg.padded_vocab)
    for i, (unit, reps) in enumerate(cfg.stages()):
        for j, kind in enumerate(unit):
            for sub, shp in _block_shapes(kind, cfg, reps).items():
                out[("stages", i, j) + sub] = shp
    return {p: out[p] for p in sorted(out)}


def init_rule(path: Tuple, shape) -> Tuple[str, float]:
    """How a leaf is drawn: ("normal", std) with the fan-in rule
    (std = scale / sqrt(fan_in), scale 3 for the SSD's conv), or
    ("fill", value): RMSNorm scales (entering as 1 + scale), the SSD's
    A_log, dt_bias, conv bias and gated norm 0, its D 1."""
    name = path[-1]
    if name in ("scale", "A_log", "dt_bias", "conv_b", "norm"):
        return "fill", 0.0
    if name == "D":
        return "fill", 1.0
    fan_in = shape[0] if len(shape) == 2 else shape[-2]
    scale = 3.0 if name == "conv_w" else 1.0
    return "normal", scale / math.sqrt(max(fan_in, 1))


def leaf_layout(cfg: ModelConfig):
    """[(path, shape, offset, size, lead, rest, stage0)] of the flat (N,)
    layout: leaves back to back in flatten order, a leaf's rows its
    leading repeat axis where it has one."""
    out, off = [], 0
    for path, shape in param_shapes(cfg).items():
        size = math.prod(shape)
        stacked = path[0] == "stages"
        lead = shape[0] if stacked else 1
        out.append((path, shape, off, size, lead, size // lead,
                    stacked and path[1] == 0))
        off += size
    return out


def init_flat(cfg: ModelConfig, seed: int, device) -> torch.Tensor:
    """The global weights as one (N,) f32 buffer drawn from ``seed`` on
    ``device``: one normal draw for all of it, then each leaf scaled to its
    rule or filled."""
    layout = leaf_layout(cfg)
    n = layout[-1][2] + layout[-1][3]
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    for path, shape, off, size, *_ in layout:
        kind, v = init_rule(path, shape)
        if kind == "fill":
            buf[off:off + size].fill_(v)
        else:
            buf[off:off + size].mul_(v)
    return buf


def unflatten(cfg: ModelConfig, buf: torch.Tensor) -> Params:
    """Views of an (N,) buffer, or (m, N) rows (a leading client axis), as
    {path: tensor}."""
    lead = tuple(buf.shape[:-1])
    return {path: buf[..., off:off + size].view(lead + tuple(shape))
            for path, shape, off, size, *_ in leaf_layout(cfg)}


def flatten(cfg: ModelConfig, params: Params, out: torch.Tensor) -> torch.Tensor:
    for path, shape, off, size, *_ in leaf_layout(cfg):
        out[..., off:off + size] = params[path].reshape(
            out.shape[:-1] + (size,))
    return out


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def rms_norm(x, scale, mask, eps):
    """RMSNorm over the active channels, scaled by 1 + scale."""
    if mask is not None:
        x = x * mask
        n = torch.clamp_min(torch.sum(mask), 1.0)
    else:
        n = x.shape[-1]
    var = torch.sum(x ** 2, dim=-1, keepdim=True) / n
    y = x * torch.rsqrt(var + eps) * (1.0 + scale)
    return y * mask if mask is not None else y


def rope(x, theta: float):
    """Rotary positions 0.. over x (B, S, H, hd), halves rotated."""
    S, half = x.shape[1], x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = (torch.arange(S, device=x.device, dtype=torch.float32)[:, None]
           * freqs)[None, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, head_mask):
    """Causal softmax attention; each kv head serves n_heads / n_kv q
    heads."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    causal = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    logits = torch.where(causal, logits, torch.full((), -2.0 ** 30,
                                                    device=q.device))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)
    if head_mask is not None:
        out = out * head_mask[None, None, :, None]
    return out


def _attn_block(p, x, cfg: ModelConfig, m):
    B, S, _ = x.shape
    hd, H, K = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dm = m["d_model"]
    h = rms_norm(x, p[("ln1", "scale")], dm, cfg.norm_eps)
    q = rope((h @ p[("attn", "wq")]).reshape(B, S, H, hd), cfg.rope_theta)
    k = rope((h @ p[("attn", "wk")]).reshape(B, S, K, hd), cfg.rope_theta)
    v = (h @ p[("attn", "wv")]).reshape(B, S, K, hd)
    return attention(q, k, v, m["heads"]).reshape(B, S, H * hd) \
        @ p[("attn", "wo")]


def _ffn(p, h, m):
    g = F.silu(h @ p[("ffn", "w_gate")]) * (h @ p[("ffn", "w_up")])
    if m["d_ff"] is not None:
        g = g * m["d_ff"]
    return g @ p[("ffn", "w_down")]


# -- Mamba-2 SSD ------------------------------------------------------------

def _cumsum16(x, dim):
    """Inclusive prefix sum along ``dim`` in tiles of 16: a sequential sum
    within each tile plus the prefix of the tiles' totals."""
    a = x.movedim(dim, -1)
    n = a.shape[-1]
    if n <= 16:
        out = a.clone()
        for i in range(1, n):
            out[..., i] = out[..., i - 1] + a[..., i]
        return out.movedim(-1, dim)
    tiles = F.pad(a, (0, (-n) % 16)).reshape(*a.shape[:-1], -1, 16)
    inner = _cumsum16(tiles, -1)
    before = _cumsum16(inner[..., -1], -1)[..., :-1]
    inner = torch.cat([inner[..., :1, :], inner[..., 1:, :]
                       + before[..., None]], dim=-2)
    return inner.reshape(*a.shape[:-1], -1)[..., :n].movedim(-1, dim)


def _ssd_intra(x, dt, A, B, C):
    """One chunk's diagonal block and end state: x (G, Q, nh, hp), dt
    (G, Q, nh), B, C (G, Q, N)."""
    Q = x.shape[1]
    L = _cumsum16(dt * A[None, None, :], 1)
    CB = torch.einsum("gtn,gsn->gts", C, B)
    diff = L[:, :, None, :] - L[:, None, :, :]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    zero = torch.zeros((), device=x.device)
    M = torch.where(causal, CB[..., None] * torch.exp(
        torch.where(causal, diff, zero)), zero) * dt[:, None, :, :]
    y = torch.einsum("gtsh,gshp->gthp", M, x)
    dB = B[:, :, None, :] * (dt * torch.exp(L[:, -1:, :] - L))[..., None]
    return y, torch.einsum("gshn,gshp->ghpn", dB, x), L


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """The SSD over the sequence: chunks of ``chunk`` positions (zero
    padded, dt = 0 there), the state carried across chunks in order."""
    b, S, nh, hp = x.shape
    N, Q = B.shape[-1], chunk
    pad = (-S) % Q
    if pad:
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        B, C = F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad))
    nc = (S + pad) // Q
    y_in, state, L = _ssd_intra(x.reshape(b * nc, Q, nh, hp),
                                dt.reshape(b * nc, Q, nh), A,
                                B.reshape(b * nc, Q, N),
                                C.reshape(b * nc, Q, N))
    y_in = y_in.reshape(b, nc, Q, nh, hp)
    state = state.reshape(b, nc, nh, hp, N)
    L = L.reshape(b, nc, Q, nh)
    Cc = C.reshape(b, nc, Q, N)
    decay = torch.exp(L[:, :, -1, :])
    h = torch.zeros((b, nh, hp, N), device=x.device)
    y_out = []
    for c in range(nc):
        y_out.append(torch.einsum("btn,bhpn,bth->bthp", Cc[:, c], h,
                                  torch.exp(L[:, c])))
        h = decay[:, c, :, None, None] * h + state[:, c]
    y = (y_in + torch.stack(y_out, 1)).reshape(b, nc * Q, nh, hp)
    return y[:, :S]


def _ssd_block(p, x, cfg: ModelConfig, m):
    s = cfg.ssm
    D = cfg.d_model
    di, nh, hp, N = s.d_inner(D), s.n_heads(D), s.head_dim, s.d_state
    hm, dm = m["ssm_heads"], m["d_model"]
    u = rms_norm(x, p[("ln", "scale")], dm, cfg.norm_eps)
    z, xBC, dt_raw = torch.split(u @ p[("ssd", "in_proj")],
                                 [di, di + 2 * N, nh], dim=-1)
    w, S = p[("ssd", "conv_w")], xBC.shape[1]
    xp = torch.cat([xBC.new_zeros(xBC.shape[:1] + (s.d_conv - 1,)
                                  + xBC.shape[2:]), xBC], dim=1)
    conv = xp[:, 0:S] * w[0][None, None]
    for i in range(1, s.d_conv):
        conv = conv + xp[:, i:i + S] * w[i][None, None]
    xBC = F.silu(conv + p[("ssd", "conv_b")][None, None])
    xs, B, C = torch.split(xBC, [di, N, N], dim=-1)
    dt = torch.logaddexp(dt_raw + p[("ssd", "dt_bias")],
                         torch.zeros((), device=x.device))
    A = -torch.exp(p[("ssd", "A_log")])
    xh = xs.reshape(*xs.shape[:2], nh, hp)
    if hm is not None:
        xh = xh * hm[None, None, :, None]
        dt = dt * hm[None, None, :]
    y = ssd_chunked(xh, dt, A, B, C, s.chunk)
    y = (y + p[("ssd", "D")][None, None, :, None] * xh).reshape(
        *y.shape[:2], di)
    inner = None if hm is None else torch.repeat_interleave(hm, hp)
    y = rms_norm(y * F.silu(z), p[("ssd", "norm")], inner, cfg.norm_eps)
    out = y @ p[("ssd", "out_proj")]
    return out * dm if dm is not None else out


# ---------------------------------------------------------------------------
# Forward, loss, gradients
# ---------------------------------------------------------------------------

def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, m,
            gates: torch.Tensor) -> torch.Tensor:
    """Logits (B, S, padded vocab) of a client sub-model: masks ``m``
    (``masks.width_masks``), gates (R,) over the first stage's repeats."""
    dm = m["d_model"]
    x = params[("embed",)][tokens] * dm
    for i, (unit, reps) in enumerate(cfg.stages()):
        g = gates if i == 0 else torch.ones(reps, device=x.device)
        for r in range(reps):
            for j, kind in enumerate(unit):
                pre = ("stages", i, j)
                p = {path[3:]: w[r] for path, w in params.items()
                     if path[:3] == pre}
                if kind == "ssd":
                    x = x + g[r] * _ssd_block(p, x, cfg, m)
                else:
                    x = x + g[r] * _attn_block(p, x, cfg, m)
                    h = rms_norm(x, p[("ln2", "scale")], dm, cfg.norm_eps)
                    x = x + g[r] * _ffn(p, h, m)
    x = rms_norm(x, params[("final_norm", "scale")], dm, cfg.norm_eps)
    w = (params[("embed",)].t() if cfg.tie_embeddings
         else params[("lm_head",)])
    logits = x @ w
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(pad, logits, torch.full((), -1e30,
                                                     device=x.device))
    return logits


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    lp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -torch.mean(torch.gather(lp, -1, tokens[:, 1:, None])[..., 0])


def loss_and_grad(params: Params, cfg: ModelConfig, tokens, m, gates):
    """(loss, {path: gradient}) of the next-token loss."""
    leaves = {p: w.detach().requires_grad_(True) for p, w in params.items()}
    loss = lm_loss(forward(leaves, cfg, tokens, m, gates), tokens)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))
