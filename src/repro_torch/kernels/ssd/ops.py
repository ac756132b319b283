"""Wrapper of the CUDA SSD intra-chunk kernel (``csrc/ssd_intra_chunk.cu``)
and the chunked SSD around it.

On a CUDA tensor ``ssd_intra_chunk`` launches its kernel or raises; on a
CPU tensor it runs the plain version in ``ref``.  The kernel has no
backward, so inputs on the card that require grad raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (DTYPE_CODES, CudaKernel, check_input,
                                       kernel_scope, stream_of)
from repro_torch.kernels.ssd import ref

SSD_INTRA_CHUNK = CudaKernel(
    "ssd_intra_chunk.cu", "ssd_intra_chunk",
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 6 + [ctypes.c_void_p])

# the kernel's limits (its shared-memory tiles, padded to these)
_MAX_Q, _MAX_N, _MAX_HP = 128, 128, 64


def heads_per_block(G: int, Q: int, nh: int, hp: int, N: int, sms: int,
                    itemsize: int = 4) -> int:
    """The divisor hg of nh for the fewest bytes through the busiest SM.
    A block takes one SM (its shared memory), reads B and C of its chunk
    once (2·Q·N elements) and, for each of its hg heads, x (Q·hp) and dt,
    and writes y, the state and L in f32; the G·nh/hg blocks run in waves
    of ``sms``.  ``itemsize`` is the bytes of an x, B or C element."""
    def cost(hg):
        waves = -(-(G * nh // hg) // sms)
        head = Q * hp * itemsize + 4 * (Q + Q * hp + hp * N + Q)
        return waves * (2 * Q * N * itemsize + hg * head)
    return min((hg for hg in range(1, nh + 1) if nh % hg == 0), key=cost)


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor):
    """The SSD within each chunk (G = batch·chunks): x (G, Q, nh, hp) and
    B, C (G, Q, N) f32 or bf16 (one dtype), dt (G, Q, nh) and A (nh,) f32
    -> y_intra (G, Q, nh, hp), chunk state (G, nh, hp, N), L = cumsum(dt·A)
    (G, Q, nh), all f32."""
    if x.dim() != 4 or B.dim() != 3:
        raise ValueError(f"ssd_intra_chunk takes x (G, Q, nh, hp) and B "
                         f"(G, Q, N), got {tuple(x.shape)} and "
                         f"{tuple(B.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ssd_intra_chunk takes f32 or bf16 x, got {x.dtype}")
    G, Q, nh, hp = x.shape
    N = B.shape[-1]
    check_input("x", x, x.dtype, (G, Q, nh, hp), x.device)
    check_input("dt", dt, torch.float32, (G, Q, nh), x.device)
    check_input("A", A, torch.float32, (nh,), x.device)
    check_input("B", B, x.dtype, (G, Q, N), x.device)
    check_input("C", C, x.dtype, (G, Q, N), x.device)
    with kernel_scope("ssd_intra_chunk", x, dt, A, B, C):
        if x.device.type == "cpu":
            return ref.ssd_intra_chunk_ref(x, dt, A, B, C)
        if any(t.requires_grad for t in (x, dt, A, B, C)):
            raise NotImplementedError("ssd_intra_chunk's kernel has no "
                                      "backward: training takes the plain "
                                      "chunked SSD (models/ssm.py)")
        if not (4 <= Q <= _MAX_Q and 4 <= N <= _MAX_N and 4 <= hp <= _MAX_HP
                and Q % 4 == N % 4 == hp % 4 == 0):
            raise ValueError(f"ssd_intra_chunk's kernel takes Q <= {_MAX_Q}, "
                             f"N <= {_MAX_N} and hp <= {_MAX_HP}, each a "
                             f"multiple of 4; got Q={Q}, N={N}, hp={hp}")
        # the kernel's 16-byte copies need x, B and C aligned: copy a view
        # that starts inside a vector
        x, B, C = (t.clone() if t.data_ptr() % 16 else t for t in (x, B, C))
        f32 = dict(dtype=torch.float32, device=x.device)
        y = torch.empty((G, Q, nh, hp), **f32)
        state = torch.empty((G, nh, hp, N), **f32)
        L = torch.empty((G, Q, nh), **f32)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        SSD_INTRA_CHUNK.launch(x.data_ptr(), DTYPE_CODES[x.dtype],
                               dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                               C.data_ptr(), y.data_ptr(), state.data_ptr(),
                               L.data_ptr(), G, Q, nh, hp, N,
                               heads_per_block(G, Q, nh, hp, N, sms,
                                               x.element_size()),
                               stream_of(x), shape=(G, Q, nh, hp, N))
        return y, state, L


def ssd(x, dt, A, B, C, chunk: int):
    """The chunked SSD: x (b, S, nh, hp); dt (b, S, nh) post-softplus;
    A (nh,) negative; B, C (b, S, N) -> (y (b, S, nh, hp), final state
    (b, nh, hp, N)).  The intra-chunk term is ``ssd_intra_chunk``; the
    carry across chunks stays in PyTorch, as the JAX package keeps it
    outside its kernel."""
    return ref.chunked_ssd(x, dt, A, B, C, chunk, ssd_intra_chunk)
