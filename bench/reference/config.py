"""A model configuration as the plain reference reads it: the ``model``
object of a ``bench/configs/<name>.json`` file, with the derived sizes
(padded vocabulary, head width, stages, FedFA sections) worked out here
from the published ones.  The fields are those every block shares; a
block's own sub-configuration (Mamba-2's ``ssm``) stays in ``extra``,
where the block reads it."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    family: str                     # a label, and the tests' small sizes' key
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0
    layer_pattern: Tuple[str, ...] = ("attn",)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    n_sections: int = 4
    pad_vocab: bool = True
    optimizer: str = "sgd"
    momentum: float = 0.9
    weight_decay: float = 1e-4
    extra: dict = field(default_factory=dict, compare=False)

    @classmethod
    def from_json(cls, model: dict) -> "ModelConfig":
        known = {f for f in cls.__dataclass_fields__ if f != "extra"}
        kw = {k: v for k, v in model.items() if k in known}
        if "layer_pattern" in kw:
            kw["layer_pattern"] = tuple(kw["layer_pattern"])
        return cls(**kw, extra={k: v for k, v in model.items()
                                if k not in known})

    def block_name(self, kind: str) -> str:
        """The block module (``bench/reference/blocks/<name>.py``) that
        runs layer kind ``kind``: ``blocks[kind]`` of the ``model`` object
        where it names one, else the kind."""
        return self.extra.get("blocks", {}).get(kind, kind)

    @property
    def padded_vocab(self) -> int:
        if not self.pad_vocab:
            return self.vocab_size
        return (self.vocab_size + 127) // 128 * 128

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(self.n_heads, 1))

    def stages(self):
        unit = self.layer_pattern
        full, rem = divmod(self.n_layers, len(unit))
        out = []
        if full:
            out.append((unit, full))
        if rem:
            out.append((unit[:rem], 1))
        return tuple(out)

    def section_bounds(self):
        reps = self.stages()[0][1]
        n_sec = min(self.n_sections, reps)
        base, extra = divmod(reps, n_sec)
        bounds, start = [], 0
        for s in range(n_sec):
            size = base + (1 if s < extra else 0)
            bounds.append((start, start + size))
            start += size
        return tuple(bounds)

    def max_section_depths(self):
        return tuple(hi - lo for lo, hi in self.section_bounds())
