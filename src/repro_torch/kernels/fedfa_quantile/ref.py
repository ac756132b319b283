"""Plain PyTorch versions of the trimmed-quantile kernels: the CPU paths of
their wrappers and the references the CUDA kernels are held against.

No ``torch.quantile`` here: it differs from ``jnp.quantile`` in the last
bit and refuses rows above 2^24 elements.  The order statistics come from
a sort and the interpolation repeats the kernels' f32 arithmetic.
"""
from __future__ import annotations

from typing import Optional

import torch


def interpolation_ranks(q: torch.Tensor, n: torch.Tensor):
    """Sort positions of ``quantile(·, q)`` over n elements, in f32 as
    jnp.quantile: p = q·(n−1) -> (floor rank, ceil rank, frac)."""
    p = q.to(torch.float32) * (n - 1).to(torch.float32)
    i0 = torch.floor(p)
    r0 = i0.to(torch.int64)
    return r0, torch.minimum(r0 + 1, (n - 1).to(torch.int64)), p - i0


def interpolate(v0: torch.Tensor, v1: torch.Tensor,
                frac: torch.Tensor) -> torch.Tensor:
    """jnp.quantile's linear interpolation ``v0·(1−frac) + v1·frac`` as XLA
    compiles it on the CPU: ``fma(v1, frac, v0·(1−frac))``, the second
    product fused into the add.  Computed exactly: that product is exact in
    f64, the f64 sum is turned into round-to-odd with its TwoSum error, and
    rounding that to f32 gives the correctly rounded fused result."""
    c = (v0 * (1.0 - frac)).to(torch.float64)
    ab = v1.to(torch.float64) * frac.to(torch.float64)
    s = ab + c
    bb = s - ab
    err = (ab - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.to(torch.float32)


def dequantize_rows(rows: torch.Tensor,
                    scale: Optional[torch.Tensor]) -> torch.Tensor:
    """rows (R, L) as f32, times the per-row dequant scale (R,) if given:
    the kernels' |x·s| is the |.| of this product, rounded once."""
    rows = rows.to(torch.float32)
    return rows if scale is None else rows * scale.to(torch.float32)[:, None]


def row_trimmed_stats_ref(rows: torch.Tensor, q: torch.Tensor):
    """(t, ss) per row: t[r] = quantile(|rows[r]|, q[r]) and
    ss[r] = Σ rows[r]²·[|rows[r]| <= t[r]].  rows (R, L), q (R,)."""
    a = torch.abs(rows.to(torch.float32))
    L = torch.tensor(a.shape[1], device=a.device)
    r0, r1, frac = interpolation_ranks(q, L)
    srt = torch.sort(a, dim=1).values
    v0 = torch.gather(srt, 1, r0[:, None])[:, 0]
    v1 = torch.gather(srt, 1, r1[:, None])[:, 0]
    t = interpolate(v0, v1, frac)
    ss = torch.sum(torch.where(a <= t[:, None], a * a, 0.0), dim=1)
    return t, ss


def hist_level_ref(x: torch.Tensor, seg_id: torch.Tensor, hi: torch.Tensor,
                   shift: int, sc: Optional[torch.Tensor] = None):
    """One multilevel refinement level.  x (m, C), seg_id (C,) int32 with −1
    inert, hi (m, 2, S) int32 resolved prefixes -> counts (m, 2, S, 256)
    int32 and Σx² (m, 2, S, 256) f32 of byte (bits(|x|) >> shift) & 0xFF
    over in-bracket elements.  ``sc`` (m, S) dequantizes quantized rows
    per segment first.  The sums accumulate in f64."""
    m, C = x.shape
    S = hi.shape[2]
    valid = seg_id >= 0
    seg = seg_id.clamp(min=0).to(torch.int64)
    a = x.to(torch.float32)
    if sc is not None:
        a = a * sc.to(torch.float32)[:, seg]
    a = torch.abs(a)
    bits = a.view(torch.int32)
    binv = ((bits >> shift) & 0xFF).to(torch.int64)
    hb = bits >> min(shift + 8, 31)
    a2 = (a * a).to(torch.float64)
    rows = torch.arange(m, device=x.device)[:, None]
    n = m * 2 * S * 256
    cnt = torch.zeros(n, dtype=torch.int64, device=x.device)
    sq = torch.zeros(n, dtype=torch.float64, device=x.device)
    for p in range(2):
        inb = (hb == hi[:, p, :][:, seg]) & valid[None, :]
        idx = (((rows * 2 + p) * S + seg[None, :]) * 256 + binv)[inb]
        cnt += torch.bincount(idx, minlength=n)
        sq += torch.bincount(idx, weights=a2[inb], minlength=n)
    return (cnt.view(m, 2, S, 256).to(torch.int32),
            sq.view(m, 2, S, 256).to(torch.float32))
