"""Attribute collectives to the ``repro_torch`` source line that issued
them.

Each ``comms.CollectiveOp`` carries the file and line of the first frame
outside ``sharding/collectives.py`` that called the collective
(``sharding.collectives._count``).  This module groups those records into
the table a contract violation prints, so that a violation names the line
to fix: "async/admit has 1 all-gather" becomes "all-gather x1 <- at
async_round.py:232".
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.comms import CollectiveOp


def source_ref(op: CollectiveOp) -> Optional[str]:
    """``file.py:line`` (basename) of an op, None without provenance."""
    if not op.source_file:
        return None
    ref = os.path.basename(op.source_file)
    if op.source_line is not None:
        ref += f":{op.source_line}"
    return ref


def describe(op: CollectiveOp) -> str:
    """One-line attribution: ``all-gather[9708544] over model
    (round.py:119)`` or ``... (no provenance)``."""
    return (f"{op.kind}[{op.elems}] over {op.axis} "
            f"({source_ref(op) or 'no provenance'})")


@dataclass(frozen=True)
class BlameEntry:
    """Collectives grouped by (kind, source line): one row of the table."""
    kind: str
    source: Optional[str]   # "file.py:line" or None (no provenance)
    axis: str               # the axis of a representative op
    count: int
    max_elems: int
    total_elems: int


def blame_table(ops: Sequence[CollectiveOp]) -> List[BlameEntry]:
    """Collectives of a run grouped by provenance, largest first."""
    groups: Dict[Tuple[str, Optional[str]], List[CollectiveOp]] = {}
    for op in ops:
        groups.setdefault((op.kind, source_ref(op)), []).append(op)
    out = [BlameEntry(kind=kind, source=ref, axis=group[0].axis,
                      count=len(group),
                      max_elems=max(o.elems for o in group),
                      total_elems=sum(o.elems for o in group))
           for (kind, ref), group in groups.items()]
    out.sort(key=lambda e: (-e.total_elems, e.kind, e.source or ""))
    return out


def format_blame(ops: Sequence[CollectiveOp],
                 kinds: Optional[Sequence[str]] = None,
                 limit: int = 8) -> List[str]:
    """Attribution lines for a violation message, optionally filtered to the
    offending collective kinds, biggest contributors first."""
    rows = [e for e in blame_table(ops) if kinds is None or e.kind in kinds]
    lines = [f"{e.kind} x{e.count} (max {e.max_elems} elems) over {e.axis} "
             f"<- at {e.source or '(no provenance)'}" for e in rows[:limit]]
    if len(rows) > limit:
        lines.append(f"... and {len(rows) - limit} more blame rows")
    return lines
