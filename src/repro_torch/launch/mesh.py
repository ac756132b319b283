"""Mesh construction over ``torch.distributed``: one process per position
of a 2-D ``(data, model)`` mesh.

Built by ``get_mesh`` (nothing at import), which validates the requested
shape against the ranks running and raises a ValueError naming both.  The ranks come from ``torchrun``
(``torchrun --standalone --nproc-per-node K -m repro_torch.launch.train
--mesh-shape DxM ...``) or from a process group the caller initialised;
without either there is one rank.  Rank r sits at
``(r // M, r % M)``, as ``jax.make_mesh`` lays devices out.

Backend and device: gloo with every rank on the CPU for ``device="cpu"``;
NCCL with rank r on ``cuda:LOCAL_RANK`` where the node has a card for each
of its ranks; otherwise gloo with every rank on ``cuda:0`` (NCCL refuses
two ranks on one card), and rank 0 says so.
"""
from __future__ import annotations

import collections
import os
import re
import socket
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.sharding.cohort import DATA_AXIS, MODEL_AXIS


class Mesh:
    """This rank's view of a ``(data, model)`` mesh: the world's (D, M)
    shape, this rank's ``coord`` (data index, model index), the process
    group of each axis it lies on (the ranks that share its data index
    form its ``model`` group, those that share its model index its
    ``data`` group), its device and backend, ``counts`` of the
    collectives issued, their records in ``ops`` (``analysis.comms``) and
    the ``staged_bytes`` that gloo copied between the card and the host
    for them (``sharding.collectives``)."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, shape: Tuple[int, int], coord: Tuple[int, int],
                 groups: Dict[str, object], device: torch.device,
                 backend: str, owns_world: bool):
        self.shape, self.coord, self.groups = shape, coord, groups
        self.device, self.backend = device, backend
        self.owns_world = owns_world
        self.counts: collections.Counter = collections.Counter()
        self.ops: list = []
        self.staged_bytes = 0

    @property
    def rank(self) -> int:
        return self.coord[0] * self.shape[1] + self.coord[1]

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self.groups[axis]

    def close(self) -> None:
        """Destroy the process group if this mesh initialised it."""
        if self.owns_world and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_world = False


def _ranks_running() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _placement(device, world: int) -> Tuple[str, torch.device]:
    """(backend, this rank's device) for ``world`` ranks on ``device``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "gloo", dev
    local = int(os.environ.get("LOCAL_RANK",
                               dist.get_rank() if dist.is_initialized()
                               else 0))
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if per_node <= torch.cuda.device_count():
        return "nccl", torch.device("cuda", local)
    return "gloo", torch.device("cuda", 0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _validated_mesh(shape, device=None) -> Mesh:
    D, M = (int(s) for s in shape)
    need, have = D * M, _ranks_running()
    if need != have:
        raise ValueError(
            f"mesh shape {(D, M)} over axes {Mesh.axis_names} needs {need} "
            f"ranks but {have} {'is' if have == 1 else 'are'} running "
            f"(WORLD_SIZE == {have}); pick a shape whose product is {have} "
            f"or launch {need} ranks (torchrun --nproc-per-node {need})")
    backend, dev = _placement(device, have)
    owns = not dist.is_initialized()
    if owns:
        if "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:    # one rank of its own
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{_free_port()}",
                world_size=1, rank=0)
    else:
        backend = dist.get_backend()
        if backend == "gloo" and dev.type == "cuda":
            dev = torch.device("cuda", 0)
    rank = dist.get_rank()
    coord = (rank // M, rank % M)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "gloo" and rank == 0:
            print(f"mesh {D}x{M}: {have} ranks share "
                  f"{torch.cuda.device_count()} card(s), so they exchange "
                  f"over gloo on cuda:0", flush=True)
    groups = {}
    # every rank creates every group, in one order
    for d in range(D):
        g = dist.new_group([d * M + k for k in range(M)])
        if d == coord[0]:
            groups[MODEL_AXIS] = g
    for k in range(M):
        g = dist.new_group([d * M + k for d in range(D)])
        if k == coord[1]:
            groups[DATA_AXIS] = g
    return Mesh((D, M), coord, groups, dev, backend, owns)


def parse_mesh_shape(s: str) -> Tuple[int, int]:
    """``"DxM"`` -> (n_data, n_model), e.g. ``"2x2"`` -> (2, 2)."""
    m = re.fullmatch(r"(\d+)x(\d+)", s.strip().lower())
    if not m or int(m.group(1)) < 1 or int(m.group(2)) < 1:
        raise ValueError(f"mesh shape {s!r} is not of the form DxM "
                         f"(positive ints, e.g. 2x2)")
    return int(m.group(1)), int(m.group(2))


def get_mesh(name, device=None) -> Optional[Mesh]:
    """CLI-level mesh selection: ``none`` | ``host`` | ``production`` | an
    explicit ``DxM`` shape (e.g. ``2x2``).  ``host`` puts every rank on
    the data axis; ``production`` is the reference's 16 x 16 pod mesh."""
    if name is None or name == "none":
        return None
    if name == "host":
        return _validated_mesh((_ranks_running(), 1), device)
    if name == "production":
        return _validated_mesh((16, 16), device)
    if re.fullmatch(r"\d+x\d+", str(name).strip().lower()):
        return _validated_mesh(parse_mesh_shape(name), device)
    raise ValueError(f"unknown mesh {name!r} (none|host|production|DxM)")
