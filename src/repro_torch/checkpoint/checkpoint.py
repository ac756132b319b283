"""Self-contained tree checkpointing in the JAX package's format: an
uncompressed ``np.savez`` payload ``PATH.npz`` with one array ``a{i}`` per
leaf, in ``jax.tree_util`` flatten order, and ``PATH.json`` holding
``{"names": [keystr path per leaf], "meta": {...}}``.  Either package
restores what the other wrote."""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.tree import from_paths, leaves_with_path


def _pathstr(path) -> str:
    """A leaf path as ``jax.tree_util.keystr`` renders it: ``['k']`` for a
    dict key, ``[i]`` for a sequence index."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # numpy has no bfloat16: np.save writes ml_dtypes.bfloat16 arrays
        # as raw 2-byte records ('<V2'), which is what this writes
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """An array read from the payload (a fresh, writable array) on the
    device and in the dtype of ``like``; 2-byte records are bf16."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=like.device, dtype=like.dtype)


def save(path: str, tree: Any, meta: Dict[str, Any] | None = None) -> None:
    flat = list(leaves_with_path(tree))
    names = [_pathstr(p) for p, _ in flat]
    arrays = {f"a{i}": _to_numpy(l) for i, (_, l) in enumerate(flat)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump({"names": names, "meta": meta or {}}, f)


def save_from_buffer(path: str, index, buf: torch.Tensor,
                     meta: Dict[str, Any] | None = None) -> None:
    """Checkpoint a resident (N,) f32 buffer (``repro_torch.core.round``),
    unflattened to the original leaf dtypes with ``index`` (the buffer's
    ``flat.FlatIndex``); ``flat_n`` joins the meta.  The files equal those
    of ``save`` on the equivalent tree."""
    from repro_torch.core import flat
    save(path, flat.unflatten(index, buf),
         meta=dict(meta or {}, flat_n=int(index.n)))


def restore_to_buffer(path: str, like: Any
                      ) -> Tuple[Any, torch.Tensor, Dict[str, Any]]:
    """Restore a checkpoint straight into the resident flat representation:
    (FlatIndex, (N,) f32 buffer on ``like``'s device, meta), ready for
    ``run_rounds``."""
    from repro_torch.core import flat
    tree, meta = restore(path, like)
    index = flat.FlatIndex(tree)
    return index, flat.flatten(index, tree), meta


def restore(path: str, like: Any) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``like``: each leaf takes the device
    and dtype of ``like``'s leaf; structure and shapes are checked."""
    with open(path + ".json") as f:
        spec = json.load(f)
    flat = list(leaves_with_path(like))
    names = [_pathstr(p) for p, _ in flat]
    # errors, not asserts: a mismatched restore under ``python -O`` must
    # not load the wrong parameters
    if names != spec["names"]:
        bad = next((f"{a!r} != {b!r}" for a, b in zip(names, spec["names"])
                    if a != b),
                   f"{len(names)} leaves in tree vs "
                   f"{len(spec['names'])} in checkpoint")
        raise ValueError(f"checkpoint/tree structure mismatch at {bad} "
                         f"(restoring {path!r})")
    leaves = []
    with np.load(path + ".npz") as data:
        for i, (_, l) in enumerate(flat):
            a = data[f"a{i}"]
            if tuple(a.shape) != tuple(l.shape):
                raise ValueError(
                    f"checkpoint shape mismatch at {names[i]}: checkpoint "
                    f"has {tuple(a.shape)}, tree expects {tuple(l.shape)} "
                    f"(restoring {path!r})")
            leaves.append(_from_numpy(a, l))
    return from_paths([p for p, _ in flat], leaves), spec["meta"]
