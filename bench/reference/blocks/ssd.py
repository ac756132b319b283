"""A Mamba-2 SSD block: RMSNorm, the input projection, a causal depthwise
conv, the chunked state-space dual form, a gated RMSNorm and the output
projection.  It reads the ``ssm`` sub-configuration of the ``model``
object; its flexible dimension is the SSD's heads."""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from bench.reference import masks as mk
from bench.reference import model as md
from bench.reference.config import ModelConfig


@dataclass(frozen=True)
class SSM:
    d_state: int
    d_conv: int
    expand: int
    head_dim: int
    chunk: int

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


def ssm(cfg: ModelConfig) -> SSM:
    return SSM(**cfg.extra["ssm"])


def flex(cfg: ModelConfig, w: float) -> dict:
    nh = ssm(cfg).n_heads(cfg.d_model)
    return {"ssm_heads": (nh, max(1, int(round(w * nh))))}


def shapes(cfg: ModelConfig, r: int) -> dict:
    s, D = ssm(cfg), cfg.d_model
    di, nh, N = s.d_inner(D), s.n_heads(D), s.d_state
    conv = di + 2 * N
    return {("ln", "scale"): (r, D),
            ("ssd", "in_proj"): (r, D, 2 * di + 2 * N + nh),
            ("ssd", "conv_w"): (r, s.d_conv, conv),
            ("ssd", "conv_b"): (r, conv), ("ssd", "A_log"): (r, nh),
            ("ssd", "D"): (r, nh), ("ssd", "dt_bias"): (r, nh),
            ("ssd", "norm"): (r, di), ("ssd", "out_proj"): (r, di, D)}


_FILL = {"scale": 0.0, "A_log": 0.0, "dt_bias": 0.0, "conv_b": 0.0,
         "norm": 0.0, "D": 1.0}


def init_rule(leaf, shape):
    """The RMSNorm scale, A_log, dt_bias, the conv's bias and the gated
    norm 0, D 1; projections fan-in normal, the conv at scale 3."""
    name = leaf[-1]
    if name in _FILL:
        return "fill", _FILL[name]
    return "normal", md.fan_in_std(shape, 3.0 if name == "conv_w" else 1.0)


def axes(cfg: ModelConfig, m) -> dict:
    s, dm = ssm(cfg), m["d_model"]
    inner = mk.repeat_mask(m["ssm_heads"], s.head_dim)
    ones = torch.ones(s.d_state, device=dm.device)
    proj = torch.cat([inner, inner, ones, ones, m["ssm_heads"]])
    conv = torch.cat([inner, ones, ones])
    return {("ln", "scale"): (dm,),
            ("ssd", "in_proj"): (dm, proj), ("ssd", "conv_w"): (None, conv),
            ("ssd", "conv_b"): (conv,), ("ssd", "A_log"): (m["ssm_heads"],),
            ("ssd", "D"): (m["ssm_heads"],),
            ("ssd", "dt_bias"): (m["ssm_heads"],),
            ("ssd", "norm"): (inner,), ("ssd", "out_proj"): (inner, dm)}


def _ssd_intra(x, dt, A, B, C):
    """One chunk's diagonal block and end state: x (G, Q, nh, hp), dt
    (G, Q, nh), B, C (G, Q, N)."""
    Q = x.shape[1]
    L = md._cumsum16(dt * A[None, None, :], 1)
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


def ssd(p, x, cfg: ModelConfig, m):
    """The block's branch (before its gate) of x (B, S, D)."""
    s = ssm(cfg)
    D = cfg.d_model
    di, nh, hp, N = s.d_inner(D), s.n_heads(D), s.head_dim, s.d_state
    hm, dm = m["ssm_heads"], m["d_model"]
    u = md.rms_norm(x, p[("ln", "scale")], dm, cfg.norm_eps)
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
    y = md.rms_norm(y * F.silu(z), p[("ssd", "norm")], inner, cfg.norm_eps)
    out = y @ p[("ssd", "out_proj")]
    return out * dm if dm is not None else out


def forward(p, x, cfg: ModelConfig, m, gate):
    return x + gate * ssd(p, x, cfg, m), 0.0


def flops(cfg: ModelConfig, sizes, B, S) -> float:
    """At the active d_model: the inner width, and with it the heads,
    narrow with it (the port's analytic count, ``launch/costs.py``)."""
    s, D = ssm(cfg), sizes["d_model"]
    di = s.d_inner(D)
    nh, hp, N, Q = s.n_heads(D), s.head_dim, s.d_state, s.chunk
    proj = 2 * B * S * D * (2 * di + 2 * N + nh)
    conv = 2 * B * S * (di + 2 * N) * s.d_conv
    nc = max(S // Q, 1)
    intra = B * nc * nh * (2 * Q * Q * N + 2 * Q * Q * hp + 2 * Q * N * hp)
    inter = B * nc * nh * 2 * Q * N * hp
    return proj + conv + intra + inter + 2 * B * S * di * D
