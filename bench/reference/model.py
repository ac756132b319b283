"""The plain reference model: the forward pass, next-token loss and
gradients of a configuration's blocks between an embedding and a tied or
untied head, in float32 PyTorch with no kernel, cache or batching beyond
the batch itself.  Each layer kind's block is a module of
``bench/reference/blocks/``, found by name; the layers the blocks share
(RMSNorm with ``1 + scale``, rotary positions, causal attention, the
tiled prefix sum) are here.

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

from bench.reference import blocks
from bench.reference.config import ModelConfig

Params = Dict[Tuple, torch.Tensor]


# ---------------------------------------------------------------------------
# Shapes and weights
# ---------------------------------------------------------------------------

def param_shapes(cfg: ModelConfig) -> Dict[Tuple, Tuple[int, ...]]:
    """{path: shape} in flatten order."""
    out = {("embed",): (cfg.padded_vocab, cfg.d_model),
           ("final_norm", "scale"): (cfg.d_model,)}
    if not cfg.tie_embeddings:
        out[("lm_head",)] = (cfg.d_model, cfg.padded_vocab)
    for i, (unit, reps) in enumerate(cfg.stages()):
        for j, kind in enumerate(unit):
            for sub, shp in blocks.of(cfg, kind).shapes(cfg, reps).items():
                out[("stages", i, j) + sub] = shp
    return {p: out[p] for p in sorted(out)}


def fan_in_std(shape, scale: float = 1.0) -> float:
    """scale / sqrt(fan_in): fan_in a matrix's first axis, a stacked
    leaf's second to last."""
    fan_in = shape[0] if len(shape) == 2 else shape[-2]
    return scale / math.sqrt(max(fan_in, 1))


def init_rule(cfg: ModelConfig, path: Tuple, shape) -> Tuple[str, float]:
    """How a leaf is drawn: ("normal", std) or ("fill", value).  A block's
    leaf by its block's rule; the final RMSNorm scale 0 (entering as
    1 + scale); the embedding and the head fan-in normal."""
    if path[0] == "stages":
        kind = cfg.stages()[path[1]][0][path[2]]
        return blocks.of(cfg, kind).init_rule(path[3:], shape)
    if path[-1] == "scale":
        return "fill", 0.0
    return "normal", fan_in_std(shape)


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
        rule, v = init_rule(cfg, path, shape)
        if rule == "fill":
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


# ---------------------------------------------------------------------------
# Forward, loss, gradients
# ---------------------------------------------------------------------------

def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, m,
            gates: torch.Tensor):
    """(logits (B, S, padded vocab), the blocks' auxiliary loss) of a
    client sub-model: masks ``m`` (``masks.width_masks``), gates (R,) over
    the first stage's repeats."""
    dm = m["d_model"]
    x = params[("embed",)][tokens] * dm
    aux = 0.0
    for i, (unit, reps) in enumerate(cfg.stages()):
        g = gates if i == 0 else torch.ones(reps, device=x.device)
        mods = [blocks.of(cfg, kind) for kind in unit]
        for r in range(reps):
            for j, mod in enumerate(mods):
                pre = ("stages", i, j)
                p = {path[3:]: w[r] for path, w in params.items()
                     if path[:3] == pre}
                x, a = mod.forward(p, x, cfg, m, g[r])
                aux = aux + a
    x = rms_norm(x, params[("final_norm", "scale")], dm, cfg.norm_eps)
    w = (params[("embed",)].t() if cfg.tie_embeddings
         else params[("lm_head",)])
    logits = x @ w
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(pad, logits, torch.full((), -1e30,
                                                     device=x.device))
    return logits, aux


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    lp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -torch.mean(torch.gather(lp, -1, tokens[:, 1:, None])[..., 0])


def loss_and_grad(params: Params, cfg: ModelConfig, tokens, m, gates):
    """(loss, {path: gradient}) of the next-token loss plus the blocks'
    auxiliary loss."""
    leaves = {p: w.detach().requires_grad_(True) for p, w in params.items()}
    logits, aux = forward(leaves, cfg, tokens, m, gates)
    loss = lm_loss(logits, tokens) + aux
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))
