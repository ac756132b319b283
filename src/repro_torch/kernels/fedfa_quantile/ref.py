"""Plain PyTorch versions of the trimmed-quantile kernels: the CPU paths of
their wrappers and the references the CUDA kernels are held against.

No ``torch.quantile`` here: it differs from ``jnp.quantile`` in the last
bit and refuses rows above 2^24 elements.  The order statistics come from
a sort and the interpolation repeats the kernels' f32 arithmetic.
"""
from __future__ import annotations

import functools
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


# The count planes are int32, so a row holds fewer than MAX_ROW elements.
# A square in its bin's units is below 2^(KFRAC + 5) (``fixed_square``),
# so a bin's exact integer sum over such a row stays below 2^60 in its
# int64 plane.
KFRAC = 24
MAX_ROW = 1 << 31


def check_row_length(n: int) -> None:
    """Raise unless a bin's count over ``n`` elements fits int32 (and so
    its integer sum fits int64)."""
    if n >= MAX_ROW:
        raise ValueError(f"hist_level counts a bin of up to {n} elements in "
                         f"an int32 plane: rows must be shorter than 2^31")


def fixed_square(a: torch.Tensor, ef: torch.Tensor) -> torch.Tensor:
    """a² (a f32, finite, >= 0) as an exact int64 in units of
    2^(2 ef − 254 − KFRAC), ``ef`` the lowest exponent field of a's bin:
    the integer the CUDA kernel adds for a (its ``fixed_square``).  The f32
    square keeps all its bits; squares below the f32 range are 0."""
    b = (a * a).view(torch.int32).to(torch.int64)
    ea = b >> 23
    mant = (b & 0x7FFFFF) | torch.where(ea > 0, 0x800000, 0)
    sh = (ea.clamp(min=1) + KFRAC + 104 - 2 * ef).clamp(min=0)
    return torch.where(mant > 0, mant << sh, 0)


@functools.lru_cache(maxsize=None)
def _bin_units(shift: int, device: torch.device) -> torch.Tensor:
    """(256,) f64: 2^(2 eb − 254 − KFRAC), eb the exponent field bits that
    bin b's own byte (b << shift) sets."""
    eb = (torch.arange(256, dtype=torch.int64) << shift) >> 23
    return ((2 * eb + (1023 - 254 - KFRAC)) << 52).view(
        torch.float64).to(device)


@functools.lru_cache(maxsize=None)
def _f64_bits(exp: int, device: torch.device) -> torch.Tensor:
    """(1,) int64: the bits of the f64 2^exp."""
    return torch.tensor([(exp + 1023) << 52], dtype=torch.int64,
                        device=device)


def scale_sums(sq: torch.Tensor, hi: torch.Tensor, shift: int) -> torch.Tensor:
    """The exact int64 Σx² planes (m, 2, S, 256) of one level as f32: each
    bin's integer times its unit 2^(2 ef − 254 − KFRAC), in f64, rounded
    once to f32.  A bin's ``ef`` is the exponent field of its lowest bit
    pattern, the prefix hi (m, 2, S) above the byte and the bin at it.
    The one scaling step of both the kernel's planes and the plain ones.

    The prefix sits on bits >= shift + 8 and the byte below them, so
    ef = eh + eb, each one's own exponent bits: the unit is a per-bin table
    at the top level (no prefix), a per-bin table times 2^(2 eh) at the
    second, and 2^(2 eh − 254 − KFRAC) below (the byte sets no exponent
    bit).  Products of powers of two are exact in f64 (no overflow or
    underflow here), so each is the single product rounded once, in one
    launch at the top level and three below; the f64 2^(2 eh) is built
    from its bits, eh << 53 added to the exponent's bias."""
    out = torch.empty(sq.shape, dtype=torch.float32, device=sq.device)
    hs = shift + 8
    if hs >= 31:           # eh = 0
        return torch.mul(sq, _bin_units(shift, sq.device), out=out)
    if hs >= 23:           # eh = hi << (hs − 23), and the byte sets eb
        pow_h = torch.add(_f64_bits(0, sq.device), hi, alpha=1 << (hs + 30))
        return torch.mul(sq * _bin_units(shift, sq.device),
                         pow_h.view(torch.float64)[..., None], out=out)
    unit = torch.add(_f64_bits(-254 - KFRAC, sq.device), hi >> (23 - hs),
                     alpha=1 << 53)
    return torch.mul(sq, unit.view(torch.float64)[..., None], out=out)


def hist_level_planes_ref(x: torch.Tensor, seg_id: torch.Tensor,
                          hi: torch.Tensor, shift: int,
                          sc: Optional[torch.Tensor] = None):
    """One multilevel refinement level.  x (m, C), seg_id (C,) int32 with −1
    inert, hi (m, 2, S) int32 resolved prefixes -> counts (m, 2, S, 256)
    int32 and exact Σx² (m, 2, S, 256) int64 in each bin's units
    (``fixed_square``; ``scale_sums`` turns them into f32) of byte
    (bits(|x|) >> shift) & 0xFF over in-bracket elements.  ``sc`` (m, S)
    dequantizes quantized rows per segment first.  Integer sums: the same
    planes in any order of the columns, and added over any split of them."""
    m, C = x.shape
    S = hi.shape[2]
    check_row_length(C)
    valid = seg_id >= 0
    seg = seg_id.clamp(min=0).to(torch.int64)
    a = x.to(torch.float32)
    if sc is not None:
        a = a * sc.to(torch.float32)[:, seg]
    a = torch.abs(a)
    bits = a.view(torch.int32)
    binv = ((bits >> shift) & 0xFF).to(torch.int64)
    hb = bits >> min(shift + 8, 31)
    a2 = fixed_square(a, (bits & ~((1 << shift) - 1)).to(torch.int64) >> 23)
    rows = torch.arange(m, device=x.device)[:, None]
    n = m * 2 * S * 256
    cnt = torch.zeros(n, dtype=torch.int64, device=x.device)
    sq = torch.zeros(n, dtype=torch.int64, device=x.device)
    for p in range(2):
        inb = (hb == hi[:, p, :][:, seg]) & valid[None, :]
        idx = (((rows * 2 + p) * S + seg[None, :]) * 256 + binv)[inb]
        cnt += torch.bincount(idx, minlength=n)
        sq.index_add_(0, idx, a2[inb])
    return (cnt.view(m, 2, S, 256).to(torch.int32),
            sq.view(m, 2, S, 256))


def hist_level_ref(x: torch.Tensor, seg_id: torch.Tensor, hi: torch.Tensor,
                   shift: int, sc: Optional[torch.Tensor] = None):
    """``hist_level_planes_ref`` with its Σx² planes scaled to f32
    (``scale_sums``): counts (m, 2, S, 256) int32, Σx² (m, 2, S, 256) f32."""
    cnt, sq = hist_level_planes_ref(x, seg_id, hi, shift, sc)
    return cnt, scale_sums(sq, hi, shift)
