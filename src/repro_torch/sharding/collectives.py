"""The collectives of the sharded FL server, over one axis of a
``launch.mesh.Mesh``: what ``shard_map``'s ``psum``, ``psum_scatter`` and
``all_gather`` lower to in the reference.

Each call adds one to ``mesh.counts[(kind, axis, elements)]``, the
per-rank element count of its input, and appends an
``analysis.comms.CollectiveOp`` to ``mesh.ops`` with its result's size
and the ``repro_torch`` file and line that issued it (the first frame
outside this module), so that tests, ``chip_smoke.py`` and the program
contracts (``analysis.contracts``) can hold a round to the reference's
``accumulate_contract``: no all-gather in the aggregation, one N/M
all-reduce over ``data`` for each of M' and Γ, and every other
all-reduce no larger than the histogram planes.  A call is issued even
over an axis of one rank, so that a 1 x 1 mesh runs the same collectives
as a larger one.

Every rank of a group must issue the same calls in the same order: a rank
that skips one leaves its peers waiting.  Gloo takes each of these
collectives on CUDA tensors as well as on the CPU (torch 2.11, checked on
an H100), so this module never copies a tensor off the card itself; gloo
does, though: its CUDA path copies the input to pinned host memory, runs
the exchange there and copies the result back.  ``mesh.staged_bytes``
counts those bytes (input plus result) for every collective that a gloo
mesh issues on CUDA tensors; NCCL and CPU tensors stage none.
"""
from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist

from repro_torch.analysis.comms import KIND_OF, CollectiveOp

_HERE = os.path.abspath(__file__)
_PORT = os.path.dirname(os.path.dirname(_HERE)) + os.sep


def _issuer():
    """(file, line) of the first frame outside this module that lies in
    ``repro_torch``, or (None, None)."""
    f = sys._getframe(2)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if fn != _HERE and fn.startswith(_PORT):
            return fn, f.f_lineno
        f = f.f_back
    return None, None


def _count(mesh, kind: str, axis: str, x: torch.Tensor,
           out: torch.Tensor) -> None:
    mesh.counts[(kind, axis, x.numel())] += 1
    mesh.ops.append(CollectiveOp(KIND_OF[kind], axis, out.numel(),
                                 out.numel() * out.element_size(),
                                 *_issuer()))
    if mesh.backend == "gloo" and x.is_cuda:
        mesh.staged_bytes += (x.numel() * x.element_size()
                              + out.numel() * out.element_size())


def all_reduce(x: torch.Tensor, mesh, axis: str, op: str = "sum"
               ) -> torch.Tensor:
    """In place: x becomes the sum (``op="max"``: the maximum) of x over
    the ranks of ``axis``; returns x."""
    _count(mesh, "all_reduce" if op == "sum" else f"all_reduce_{op}", axis,
           x, x)
    dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX}[op],
                    group=mesh.group(axis))
    return x


def reduce_scatter(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of x (n,) over the ranks of ``axis``, of which this rank
    keeps its n/size block (n must divide)."""
    size = mesh.size(axis)
    if x.shape[0] % size:
        raise ValueError(f"reduce_scatter of {x.shape[0]} elements over "
                         f"{size} ranks")
    out = torch.empty((x.shape[0] // size,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _count(mesh, "reduce_scatter", axis, x, out)
    dist.reduce_scatter_tensor(out, x.contiguous(), group=mesh.group(axis))
    return out


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The blocks x of the ranks of ``axis``, concatenated along dim 0 in
    their order on the axis."""
    out = torch.empty((x.shape[0] * mesh.size(axis),) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _count(mesh, "all_gather", axis, x, out)
    dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.group(axis))
    return out


def gather_model(x: torch.Tensor, mesh, n: int) -> torch.Tensor:
    """The whole (n,) axis of x, this rank's ``cohort.model_cols`` block of
    it: x itself where it is whole already (no mesh, no model shards),
    else one all-gather over ``model``."""
    if mesh is None or x.shape[0] == n:
        return x
    from repro_torch.sharding.cohort import MODEL_AXIS
    return all_gather(x, mesh, MODEL_AXIS)
