"""Typed records of the collectives a run of the port issued.

The counterpart of the reference's ``analysis/hlo.py`` collective records.
The reference parses them out of a compiled program's HLO text; the port
has no compiled program, so each of its own collectives
(``sharding/collectives.py``) appends one ``CollectiveOp`` to
``mesh.ops`` as it is issued, with the ``repro_torch`` file and line that
issued it.  ``count``, ``sizes``, ``max_elems``, ``byte_totals`` and
``summarize`` read such a list as the reference's read HLO.

Kinds carry the reference's HLO names: ``all_reduce`` (and its ``max``
form) is ``all-reduce``, ``all_gather`` is ``all-gather`` and
``reduce_scatter`` is ``reduce-scatter``.  The port issues no
``all-to-all`` or ``collective-permute``, so those count 0.  A payload is
counted as the reference counts it, by its result: an all-gather's
gathered size, a reduce-scatter's scattered block.

Two things of the reference's HLO have no counterpart here.  There is no
donation header: the port keeps its resident buffers in place by writing
into them (``passes.check_in_place`` checks that instead).  And there are
no async ``-start``/``-done`` pairs: each collective is one call of
``torch.distributed``, recorded once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

# the port's collective names (``mesh.counts`` keys) -> the reference's
KIND_OF = {"all_reduce": "all-reduce", "all_reduce_max": "all-reduce",
           "all_gather": "all-gather", "reduce_scatter": "reduce-scatter"}


@dataclass(frozen=True)
class CollectiveOp:
    """One collective a rank issued.

    kind         the reference's name (``all-reduce``, ...)
    axis         the mesh axis it ran over (``data`` or ``model``)
    elems        payload elements of its result
    nbytes       bytes of its result
    source_file  the ``repro_torch`` file that issued it (None if none)
    source_line  the line there
    """
    kind: str
    axis: str
    elems: int
    nbytes: int
    source_file: Optional[str] = None
    source_line: Optional[int] = None


def count(ops: Sequence[CollectiveOp], kind: str) -> int:
    """Number of ``kind`` collectives."""
    return sum(1 for op in ops if op.kind == kind)


def sizes(ops: Sequence[CollectiveOp], kind: str,
          min_elems: int = 0) -> List[int]:
    """Payload sizes of every ``kind`` op with >= min_elems elements."""
    return [op.elems for op in ops
            if op.kind == kind and op.elems >= min_elems]


def max_elems(ops: Sequence[CollectiveOp], kind: str) -> int:
    """Largest payload of any ``kind`` op (0 if none)."""
    return max((op.elems for op in ops if op.kind == kind), default=0)


def byte_totals(ops: Sequence[CollectiveOp]) -> Dict[str, int]:
    """{kind: summed result bytes} over every collective, plus ``total``."""
    out: Dict[str, int] = {}
    for op in ops:
        out[op.kind] = out.get(op.kind, 0) + op.nbytes
    out["total"] = sum(out.values())
    return out


def summarize(ops: Sequence[CollectiveOp]) -> Dict[str, int]:
    """{kind: count} over every collective kind present."""
    out: Dict[str, int] = {}
    for op in ops:
        out[op.kind] = out.get(op.kind, 0) + 1
    return out
