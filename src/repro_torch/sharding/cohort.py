"""2-D ``(data, model)`` layout of the resident FL round, one process per
mesh position (``repro_torch.launch.mesh``).

  * **client axis m over ``data``** — the cohort is padded to a multiple
    of the data-shard count D and rank (d, k) holds rows
    [d·m/D, (d+1)·m/D): their runtimes, batches, label permutations and
    pool rows.  Model peers (ranks of one data index) train the same
    clients, as the reference's model-replicated training does.
  * **parameter axis N over ``model``** — N is padded by ``FlatIndex``
    to a multiple of ``pad_unit`` (M × the multilevel quantile's 512
    column tile) with an inert zero tail, and rank (d, k) keeps columns
    [k·N/M, (k+1)·N/M) of the global and, where the aggregation runs 2-D,
    of the cohort pools.

Pad rows are inert: ``n_data = 0`` zeroes their weight in both (M', γ)
sums and keeps them out of the α mean, and the round averages its loss
over the real rows only.  The inert N tail has density 0 and segment id
−1, so it never enters a norm, α or the merged global.

Each rank holds only its own slice and every collective is explicit
(``collectives``): the aggregation sums per-shard partials with one
N/M-sized all-reduce over ``data`` for each of M' and Γ, and the
distributed quantile all-reduces histogram planes over ``model`` — no
all-gather.  The one all-gather of a round brings the global to training.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.masks import WidthMasks

DATA_AXIS = "data"
MODEL_AXIS = "model"
# the multilevel quantile's column tile in the reference; pad_unit keeps it
# so that ``n_padded`` is the same in both packages
TILE = 512


def data_shards(mesh) -> int:
    """Number of shards of the client axis (1 without a mesh)."""
    return 1 if mesh is None else int(mesh.shape[0])


def model_shards(mesh) -> int:
    """Number of shards of the (N,) parameter axis (1 without a mesh)."""
    return 1 if mesh is None else int(mesh.shape[1])


def pad_unit(mesh) -> int:
    """``FlatIndex(pad_to=)`` for this mesh: 1 without model shards, else
    the model-shard count times the 512-column tile, so that each shard's
    slice of N tiles the distributed norms pass evenly."""
    ms = model_shards(mesh)
    return 1 if ms <= 1 else ms * TILE


def shardable(mesh, m: int) -> bool:
    """Can a client axis of length m be split over this mesh's ``data``
    axis?  (A mesh is present and D divides m; padded cohorts always
    qualify.)"""
    return mesh is not None and m % data_shards(mesh) == 0


def pad_rows(m: int, mesh) -> int:
    """Pad rows needed to make the cohort divisible by the data shards."""
    return (-m) % data_shards(mesh)


def model_cols(mesh, n: int) -> slice:
    """This rank's columns of an (n,)-wide axis split over ``model``
    (``P("model")``): the whole axis without model shards or where M does
    not divide n, as the reference's ``accumulate`` falls back."""
    ms = model_shards(mesh)
    if ms <= 1 or n % ms:
        return slice(0, n)
    k = mesh.coord[1]
    return slice(k * (n // ms), (k + 1) * (n // ms))


def data_rows(mesh, m: int) -> slice:
    """This rank's rows of an m-row cohort split over ``data``
    (``P("data")``); m must be a multiple of the data shards."""
    ds = data_shards(mesh)
    if mesh is not None and not shardable(mesh, m):
        raise ValueError(f"{m} rows do not split over {ds} data shards: "
                         f"pad the cohort first (pad_rows)")
    d = 0 if mesh is None else mesh.coord[0]
    return slice(d * (m // ds), (d + 1) * (m // ds))


def pad_leading(tree: Any, pad: int) -> Any:
    """Append ``pad`` copies of row 0 along every leaf's leading axis of a
    cohort-stacked tree (tensors, dicts of tensors, ``WidthMasks``)."""
    if tree is None or pad <= 0:
        return tree
    if isinstance(tree, WidthMasks):
        return tree._map(lambda t: pad_leading(t, pad))
    if isinstance(tree, dict):
        return {k: pad_leading(v, pad) for k, v in tree.items()}
    return torch.cat([tree, tree[:1].expand((pad,) + tuple(tree.shape[1:]))])


def rows_of(tree: Any, rows: slice) -> Any:
    """The ``rows`` of every leaf of a cohort-stacked tree (tensors,
    dicts of tensors, ``WidthMasks``)."""
    if tree is None:
        return None
    if isinstance(tree, WidthMasks):
        return tree._map(lambda t: t[rows])
    if isinstance(tree, dict):
        return {k: rows_of(v, rows) for k, v in tree.items()}
    return tree[rows]


def pad_cohort(runtimes: Tuple, batches: Any, pad: int) -> Tuple[Tuple, Any]:
    """Pad the ``server.stack_runtimes`` tuple and the stacked batches with
    inert rows: masks, gates, graft maps, class masks and batches repeat
    row 0, ``n_data`` is 0 (zero weight in both (M', γ) sums) and
    ``malicious`` is 0."""
    if pad <= 0:
        return runtimes, batches
    masks, gates, gmaps, nd, cms, mal = runtimes
    padded = (pad_leading(masks, pad), pad_leading(gates, pad),
              pad_leading(gmaps, pad),
              torch.cat([nd, torch.zeros(pad, dtype=nd.dtype,
                                         device=nd.device)]),
              pad_leading(cms, pad),
              torch.cat([mal, torch.zeros(pad, dtype=mal.dtype,
                                          device=mal.device)]))
    return padded, pad_leading(batches, pad)

