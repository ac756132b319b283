"""Residual blocks by name.  A layer kind of a configuration's
``layer_pattern`` runs the module ``bench/reference/blocks/<name>.py``,
``<name>`` the configuration's ``blocks[kind]`` where its ``model`` object
gives one, else the kind itself (``ModelConfig.block_name``).  A module
holds one kind of block and defines

* ``flex(cfg, w)``: {dimension: (full size, active size at width
  multiplier w)} of the block's flexible dimensions (``d_model`` is the
  model's, and no block's);
* ``shapes(cfg, r)``: {leaf: shape} of its leaves for r repeats;
* ``init_rule(leaf, shape)``: how a leaf is drawn, as
  ``model.init_rule`` says;
* ``axes(cfg, m)``: {leaf: the masks along its trailing axes} for width
  masks m (``masks.width_masks``);
* ``forward(p, x, cfg, m, gate)``: x after the block's residual adds,
  each times the depth gate, and a scalar that the loss adds (0.0 where
  the block has no auxiliary loss);
* ``flops(cfg, sizes, B, S)``: the forward FLOPs of one block at the
  active sizes ``sizes`` (``masks.width_sizes``) for a batch of B x S.

A leaf is its path below the block, such as ("attn", "wq").  A module
under another directory of this package's ``__path__`` is found the same
way."""
from __future__ import annotations

import importlib


def module(name: str):
    """The block module ``name``."""
    full = f"{__name__}.{name}"
    try:
        return importlib.import_module(full)
    except ModuleNotFoundError as e:
        if e.name != full:
            raise
        raise ValueError(f"no block {name!r}: add "
                         f"bench/reference/blocks/{name}.py") from None


def of(cfg, kind: str):
    """The block module that runs layer kind ``kind`` of ``cfg``."""
    return module(cfg.block_name(kind))


def used(cfg):
    """The block modules of ``cfg``'s layer pattern, each once, in the
    pattern's order."""
    names = dict.fromkeys(cfg.block_name(k) for k in cfg.layer_pattern)
    return [module(n) for n in names]
