"""Plain PyTorch versions of the SSD intra-chunk kernel and of the whole
chunked SSD (the counterparts of ``repro.kernels.ssd.ref`` and
``repro.models.ssm.ssd_chunked_ref``).  They run the CPU path of
``kernels/ssd/ops.py`` and are what ``chip_smoke.py`` holds the CUDA kernel
against on the card."""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ref import split_tf32_product


# XLA's CPU compiler rewrites a cumulative sum (``jnp.cumsum`` lowers to a
# reduce-window) into tiles of this many elements: a sequential sum within
# each tile, plus the exclusive prefix of the tiles' totals, scanned the
# same way
_XLA_SCAN_BASE = 16


def cumsum_like_jax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sum along ``dim``, added in the order the JAX
    reference's CPU code adds (tiles of 16), so it has the reference's
    bits; ``torch.cumsum`` adds in another order."""
    a = x.movedim(dim, -1)
    n = a.shape[-1]
    if n <= _XLA_SCAN_BASE:
        out = a.clone()
        for i in range(1, n):
            out[..., i] = out[..., i - 1] + a[..., i]
        return out.movedim(-1, dim)
    tiles = F.pad(a, (0, (-n) % _XLA_SCAN_BASE)).reshape(
        *a.shape[:-1], -1, _XLA_SCAN_BASE)
    inner = cumsum_like_jax(tiles, -1)
    before = cumsum_like_jax(inner[..., -1], -1)[..., :-1]
    inner[..., 1:, :] += before[..., None]
    return inner.reshape(*a.shape[:-1], -1)[..., :n].movedim(-1, dim)


def ssd_intra_chunk_ref(x, dt, A, B, C):
    """Same contract as ``kernels/ssd/ops.py::ssd_intra_chunk``: x
    (G, Q, nh, hp), dt (G, Q, nh), A (nh,), B and C (G, Q, N) ->
    y_intra (G, Q, nh, hp), state (G, nh, hp, N), L (G, Q, nh), all f32."""
    Q = x.shape[1]
    xf, dtf = x.to(torch.float32), dt.to(torch.float32)
    Bf = B.to(torch.float32)
    L = cumsum_like_jax(dtf * A[None, None, :], 1)            # (G, Q, nh)
    CB = torch.einsum("gtn,gsn->gts", C.to(torch.float32), Bf)
    diff = L[:, :, None, :] - L[:, None, :, :]                # (G, t, s, nh)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    # the exponent is guarded before exp: above the diagonal diff > 0 can
    # overflow, and inf * 0 is NaN
    zero = torch.zeros((), device=x.device)
    M = torch.where(causal, CB[..., None] * torch.exp(
        torch.where(causal, diff, zero)), zero)
    M = M * dtf[:, None, :, :]
    y = torch.einsum("gtsh,gshp->gthp", M, xf)
    decay_end = torch.exp(L[:, -1:, :] - L)                   # (G, Q, nh)
    dB = Bf[:, :, None, :] * (dtf * decay_end)[..., None]     # (G, Q, nh, N)
    state = torch.einsum("gshn,gshp->ghpn", dB, xf)
    return y, state, L


def ssd_intra_chunk_split_tf32_ref(x, dt, A, B, C, terms: int = 3):
    """``ssd_intra_chunk_ref`` with its three products taken as the CUDA
    kernel's tensor-core route takes them (``split_tf32_product``: lo·hi′ +
    hi·lo′ + hi·hi′ of TF32 halves): C·Bᵀ, y = M·x and the state as
    (x·w)·B, w = dt·exp(L_{Q-1} − L).  bf16 inputs are exact in TF32
    (their lo halves are 0), so for them C·Bᵀ is exact and M·x and the
    state are two TF32 products, as on the card.  ``terms=1`` takes hi·hi′
    alone."""
    Q = x.shape[1]
    xf, dtf = x.to(torch.float32), dt.to(torch.float32)
    Bf = B.to(torch.float32)
    L = cumsum_like_jax(dtf * A[None, None, :], 1)
    CB = split_tf32_product("gtn,gsn->gts", C.to(torch.float32), Bf, terms)
    diff = L[:, :, None, :] - L[:, None, :, :]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    zero = torch.zeros((), device=x.device)
    M = torch.where(causal, CB[..., None] * torch.exp(
        torch.where(causal, diff, zero)), zero)
    M = M * dtf[:, None, :, :]
    y = split_tf32_product("gtsh,gshp->gthp", M, xf, terms)
    w = dtf * torch.exp(L[:, -1:, :] - L)                     # (G, Q, nh)
    state = split_tf32_product("gshp,gsn->ghpn", xf * w[..., None], Bf,
                               terms)
    return y, state, L


Intra = Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def chunked_ssd(x, dt, A, B, C, chunk: int, intra: Intra):
    """The chunked SSD around an intra-chunk function: pad S to a multiple
    of ``chunk`` with zeros (dt = 0 there, so padded positions add
    nothing), run ``intra`` on the (batch·chunks) layout, then carry the
    state across chunks in order.  x (b, S, nh, hp); dt (b, S, nh)
    post-softplus; A (nh,) negative; B, C (b, S, N) shared over heads ->
    y (b, S, nh, hp) in x's dtype and the final state (b, nh, hp, N) f32."""
    b, S, nh, hp = x.shape
    N = B.shape[-1]
    Q = chunk
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (S + pad) // Q
    y_intra, state, L = intra(x.reshape(b * nc, Q, nh, hp).contiguous(),
                              dt.reshape(b * nc, Q, nh).contiguous(), A,
                              B.reshape(b * nc, Q, N).contiguous(),
                              C.reshape(b * nc, Q, N).contiguous())
    y_intra = y_intra.reshape(b, nc, Q, nh, hp)
    state = state.reshape(b, nc, nh, hp, N)
    L = L.reshape(b, nc, Q, nh)
    Cc = C.reshape(b, nc, Q, N).to(torch.float32)
    chunk_decay = torch.exp(L[:, :, -1, :])                   # (b, nc, nh)
    # inter-chunk carry, chunk by chunk: h <- decay_c · h + state_c
    h = torch.zeros((b, nh, hp, N), dtype=torch.float32, device=x.device)
    y_inter = []
    for c in range(nc):
        y_inter.append(torch.einsum("btn,bhpn,bth->bthp", Cc[:, c], h,
                                    torch.exp(L[:, c])))
        h = chunk_decay[:, c, :, None, None] * h + state[:, c]
    y = (y_intra + torch.stack(y_inter, 1)).reshape(b, nc * Q, nh, hp)
    return y[:, :S].to(x.dtype), h


def ssd_chunked_ref(x, dt, A, B, C, chunk: int):
    """The whole chunked SSD in plain PyTorch."""
    return chunked_ssd(x, dt, A, B, C, chunk, ssd_intra_chunk_ref)
