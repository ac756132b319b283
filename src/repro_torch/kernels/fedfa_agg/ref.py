"""Plain PyTorch versions of the aggregation kernels: the CPU paths of
their wrappers in ``ops`` and the references the CUDA kernels are held
against."""
from __future__ import annotations

import torch


def scaled_accum_ref(x: torch.Tensor, weights: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """out[n] = Σ_c weights[c]·x[c, n]·mask[n]; x (m, n) -> (n,) f32."""
    return torch.einsum("mn,m->n", x.to(torch.float32),
                        weights.to(torch.float32)) * mask.to(torch.float32)


def quant_accum_ref(x: torch.Tensor, wtab: torch.Tensor, seg: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """out[n] = Σ_c x[c, n]·wtab[c, seg[n]]·mask[n]; x (m, n) int8 or bf16,
    wtab (m, S); seg = −1 columns contribute 0 (ids past S − 1 read the
    last column, as the JAX reference clips them)."""
    valid = (seg >= 0).to(torch.float32)
    w = wtab.to(torch.float32)[:, seg.clamp(0, wtab.shape[1] - 1).long()] \
        * valid[None, :]
    return torch.sum(x.to(torch.float32) * w, dim=0) * mask.to(torch.float32)


def trimmed_sumsq_ref(w: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Σ w²·[|w| <= t] over all of ``w`` -> 0-d f32."""
    wf = w.to(torch.float32)
    return torch.sum(torch.where(torch.abs(wf) <= t, wf * wf, 0.0))


def admit_rows(x: torch.Tensor, gmaps: torch.Tensor, fac: torch.Tensor,
               e_q: torch.Tensor, e_s: torch.Tensor, p,
               graft: bool) -> torch.Tensor:
    """y = (x + e_q·e_s)·dens on one piece ``p`` (``ops.AdmitPiece``), as
    (m, k, rest) f32: x (m, ldx) the f32 rows, grafted by a row gather
    (row r of client c reads row ``gmaps[c, r]``) on a stage-0 leaf when
    ``graft``; e_q (m, W) and e_s (m, S) the residual and its scales;
    ``fac`` (m, F) the width-mask vectors whose product along the leaf's
    axes is the density."""
    m = x.shape[0]
    xl = x[:, p.leaf_off:p.leaf_off + p.lead * p.row_len] \
        .view(m, p.lead, p.row_len)
    if graft and p.stage0:
        rows = torch.arange(m, device=x.device)[:, None]
        xl = xl[rows, gmaps[:, p.j0:p.j0 + p.k]]
    else:
        xl = xl[:, p.j0:p.j0 + p.k]
    eq = e_q[:, p.a:p.a + p.k * p.rest].view(m, p.k, p.rest)
    y = xl[..., p.c0:p.c0 + p.rest] \
        + eq.to(torch.float32) * e_s[:, p.s0:p.s0 + p.k, None]
    if not p.factors:
        return y
    dens = None
    for col, axis, dim in p.factors:
        shape = [m] + [1] * len(p.shape)
        shape[1 + axis] = dim
        f = fac[:, col:col + dim].reshape(shape)
        dens = f if dens is None else dens * f
    if (p.k, p.rest) == (p.lead, p.row_len):              # the whole leaf
        return (y.view((m,) + p.shape) * dens).view(y.shape)
    return y * torch.broadcast_to(dens, (m,) + p.shape).reshape(
        m, p.lead, p.row_len)[:, p.j0:p.j0 + p.k, p.c0:p.c0 + p.rest]


def int8_rows(v: torch.Tensor, seg_max: torch.Tensor):
    """(q, scales) of (m, k, rest) rows v with their (m, k) maxima: scale =
    max/127 (0 on an all-zero row, which quantizes to zeros), q =
    clamp(round(v / scale), ±127) rounded half to even, as f32."""
    scales = seg_max / 127.0
    safe = torch.where(seg_max > 0, scales, 1.0)
    return torch.clamp(torch.round(v / safe[..., None]), -127.0, 127.0), \
        scales


def quant_admit_ref(step: int, x: torch.Tensor, gmaps: torch.Tensor,
                    graft: bool, fac: torch.Tensor, e_q: torch.Tensor,
                    e_s: torch.Tensor, x_q: torch.Tensor,
                    y_max: torch.Tensor, e_max: torch.Tensor,
                    pieces) -> None:
    """One step of ``quant_admit`` over ``pieces``, piece by piece.  int8
    (e_q's dtype): step 1 raises ``y_max`` (m, S) to max|y| of each
    (client, segment), step 2 ``e_max`` to max|e| with e = y − q·s, and
    step 3 writes x_q = q and e_q = quantize(e) with the scales of those
    maxima; bf16 (step 3 alone): x_q = bf16(y), e_q = bf16(y − x_q)."""
    m = x.shape[0]
    for p in pieces:
        segs = slice(p.s0, p.s0 + p.k)
        cols = slice(p.a, p.a + p.k * p.rest)
        y = admit_rows(x, gmaps, fac, e_q, e_s, p, graft)
        if e_q.dtype == torch.bfloat16:
            q = y.to(torch.bfloat16)
            x_q[:, cols] = q.view(m, -1)
            e_q[:, cols] = (y - q.to(torch.float32)).to(torch.bfloat16) \
                .view(m, -1)
            continue
        if step == 1:
            y_max[:, segs] = torch.maximum(y_max[:, segs],
                                           torch.amax(torch.abs(y), dim=2))
            continue
        q, s = int8_rows(y, y_max[:, segs])
        e = y - q * s[..., None]
        if step == 2:
            e_max[:, segs] = torch.maximum(e_max[:, segs],
                                           torch.amax(torch.abs(e), dim=2))
            continue
        x_q[:, cols] = q.to(torch.int8).view(m, -1)
        e_q[:, cols] = int8_rows(e, e_max[:, segs])[0].to(torch.int8) \
            .view(m, -1)
