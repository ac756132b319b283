"""Declarative program contracts checked against recorded runs.

A ``Contract`` states the *structural* invariants a round program must
keep — zero all-gathers on the aggregation path, (M', γ) partial sums
whose all-reduces stay within N/n_model, resident buffers kept in place,
the fused quantile reading each cohort row exactly once — as data, not
as ad-hoc asserts.  Programs declare their contract next to their code
(``core/round.py::round_contract``,
``core/async_round.py::admit_contract``/``merge_contract``,
``kernels/fedfa_agg/ops.py::accumulate_contract``,
``kernels/fedfa_quantile/ops.py::fused_quantile_contract``, ...), with the
reference's names, fields and bounds, and ``python -m repro_torch.analysis
check`` and ``chip_smoke.py`` evaluate the same objects.

Count-valued fields take a ``Bound``: an exact int, a ``(lo, hi)`` tuple
(either end None for open), or None for unchecked.  The reference
measures its contracts on compiled HLO and traced jaxprs; the port has
neither, so every field is measured on a run of the program
(``dispatch.Run``): the collectives each rank issued
(``comms.CollectiveOp``, recorded by ``sharding.collectives``), the aten
ops it executed (``dispatch.Recorder``), its peak memory (``memory``) and
which of its arguments held the result in place
(``passes.in_place_positions``).  ``donated`` names those in-place
argument positions of the port's program function.

This module imports only the sibling ``comms`` and ``blame`` modules, so
the program modules can import it where they declare their contracts.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.analysis import blame as blame_mod
from repro_torch.analysis import comms

Bound = Union[int, Tuple[Optional[int], Optional[int]], None]

_COLLECTIVE_FIELDS = ("all_gathers", "reduce_scatters", "all_to_alls",
                      "collective_permutes", "allreduce_max_elems",
                      "scale_allreduces", "full_cohort_gathers",
                      "max_all_gather_elems")


def check_bound(name: str, value: int, bound: Bound) -> Optional[str]:
    """Violation message (or None) for ``value`` against ``bound``."""
    if bound is None:
        return None
    if isinstance(bound, int):
        if value != bound:
            return f"{name} == {value}, expected exactly {bound}"
        return None
    lo, hi = bound
    if lo is not None and value < lo:
        return f"{name} == {value}, expected >= {lo}"
    if hi is not None and value > hi:
        return f"{name} == {value}, expected <= {hi}"
    return None


def _fmt_bound(bound: Bound) -> str:
    if isinstance(bound, int):
        return f"=={bound}"
    lo, hi = bound
    if lo is None:
        return f"<={hi}"
    if hi is None:
        return f">={lo}"
    return f"in[{lo},{hi}]"


@dataclass(frozen=True)
class Contract:
    """Structural contract of one program, measured on a run of it.

    Collective structure (over ``Run.ops``, the collectives this rank
    issued; a run without a mesh issues none):
      all_gathers / reduce_scatters / all_to_alls / collective_permutes
                       Bound on the op count.
      allreduce_max_elems
                       No all-reduce payload may exceed this many elements
                       (the per-device-volume cap: N/n_model with model
                       shards, N on a data-only mesh).
      scale_allreduces / scale_elems
                       Bound on the number of all-reduces of EXACTLY
                       ``scale_elems`` elements — the (M', γ) partial-sum
                       reductions.
      full_cohort_gathers / cohort_elems
                       Bound on all-gathers whose payload >= cohort_elems
                       (materializing the full (m, N) cohort is the
                       failure the sharded round exists to prevent).
      max_all_gather_elems
                       Largest tolerated all-gather payload (e.g. the <= N
                       global-model gather into local training).
      peak_live_bytes_per_device
                       Bound on the run's peak live bytes on this rank
                       (``Run.memory``: the allocator's count on the card,
                       the storage sweep on the CPU).  Proves the
                       resident buffers are not double-buffered and the
                       cohort scratch stays ~(m, N)/(D*M) bytes a rank.

    In place (over ``Run.in_place``):
      donated          Positions of the program function's arguments that
                       must hold its result in their own storage — the
                       resident buffers the reference donates.

    Executed-op structure (over ``Run.counts`` and ``Run.row_elems``):
      row_reads        Bound on the read sites of the row block.
      sorts            Bound on sort/topk ops.
    """
    name: str
    description: str = ""
    all_gathers: Bound = None
    reduce_scatters: Bound = None
    all_to_alls: Bound = None
    collective_permutes: Bound = None
    allreduce_max_elems: Optional[int] = None
    scale_allreduces: Bound = None
    scale_elems: Optional[int] = None
    full_cohort_gathers: Bound = None
    cohort_elems: Optional[int] = None
    max_all_gather_elems: Optional[int] = None
    peak_live_bytes_per_device: Bound = None
    donated: Optional[frozenset] = None
    row_reads: Bound = None
    sorts: Bound = None

    def __post_init__(self):
        if self.full_cohort_gathers is not None and self.cohort_elems is None:
            raise ValueError(
                f"contract {self.name!r}: full_cohort_gathers needs "
                f"cohort_elems (the full-cohort payload size)")
        if self.scale_allreduces is not None and self.scale_elems is None:
            raise ValueError(
                f"contract {self.name!r}: scale_allreduces needs "
                f"scale_elems (the payload size it counts)")

    _SPEC_SKIP = ("name", "description", "cohort_elems", "scale_elems")

    # -- evaluation --------------------------------------------------------

    def _needs(self, names) -> bool:
        return any(getattr(self, n) is not None for n in names)

    def check(self, run=None) -> "Report":
        """Evaluate the contract on a recorded run (``dispatch.Run``);
        returns a ``Report`` (ok + measured + violations).  A field whose
        measurement the run lacks is a violation."""
        measured: Dict[str, object] = {}
        violations: List[str] = []
        ops = None if run is None else run.ops
        if ops is not None:
            self._check_ops(ops, measured, violations)
        elif self._needs(_COLLECTIVE_FIELDS):
            violations.append("contract has collective fields but no "
                              "collective record was provided")
        if self.peak_live_bytes_per_device is not None:
            mem = None if run is None else run.memory
            if mem is None:
                violations.append("contract has peak_live_bytes_per_device "
                                  "but no memory measurement was provided")
            else:
                measured["peak_live_bytes_per_device"] = mem.peak_bytes
                v = check_bound("peak_live_bytes_per_device", mem.peak_bytes,
                                self.peak_live_bytes_per_device)
                if v:
                    top = ", ".join(f"{n}={b}B" for n, b in mem.top[:3])
                    violations.append(
                        f"{v} (peak at op {mem.peak_index}; largest live "
                        f"buffers: {top or 'not named by the allocator'})")
        if self.donated is not None:
            held = None if run is None else run.in_place
            if held is None:
                violations.append("contract has donated but no in-place "
                                  "record was provided")
            else:
                measured["donated"] = sorted(held)
                missing = set(self.donated) - set(held)
                if missing:
                    violations.append(
                        f"in-place results missing for argument(s) "
                        f"{sorted(missing)} (held in place: {sorted(held)})")
        if self.row_reads is not None or self.sorts is not None:
            self._check_counts(run, measured, violations)
        blame_rows = None if ops is None else blame_mod.blame_table(ops)
        return Report(contract=self, measured=measured,
                      violations=violations, blame=blame_rows)

    @staticmethod
    def _with_blame(msg: str, ops, kinds) -> str:
        """Append source attributions for the offending collective kinds —
        every collective-structure failure names the line to fix."""
        lines = blame_mod.format_blame(ops, kinds=list(kinds), limit=4)
        if lines:
            msg += "".join("\n      blame: " + ln for ln in lines)
        return msg

    def _check_ops(self, ops, measured, violations) -> None:
        counters = (("all_gathers", "all-gather"),
                    ("reduce_scatters", "reduce-scatter"),
                    ("all_to_alls", "all-to-all"),
                    ("collective_permutes", "collective-permute"))
        for field, kind in counters:
            n = comms.count(ops, kind)
            measured[field] = n
            v = check_bound(field, n, getattr(self, field))
            if v:
                violations.append(self._with_blame(v, ops, (kind,)))
        ar_sizes = comms.sizes(ops, "all-reduce")
        measured["all_reduces"] = len(ar_sizes)
        if self.allreduce_max_elems is not None:
            big = [e for e in ar_sizes if e > self.allreduce_max_elems]
            measured["allreduce_max_elems"] = max(ar_sizes, default=0)
            if big:
                violations.append(self._with_blame(
                    f"all-reduce payload(s) {big} exceed "
                    f"{self.allreduce_max_elems} elems",
                    ops, ("all-reduce",)))
        if self.scale_allreduces is not None:
            n_scale = sum(1 for e in ar_sizes if e == self.scale_elems)
            measured["scale_allreduces"] = n_scale
            v = check_bound("scale_allreduces", n_scale,
                            self.scale_allreduces)
            if v:
                violations.append(self._with_blame(v, ops, ("all-reduce",)))
        ag_max = comms.max_elems(ops, "all-gather")
        measured["max_all_gather_elems"] = ag_max
        if self.max_all_gather_elems is not None \
                and ag_max > self.max_all_gather_elems:
            violations.append(self._with_blame(
                f"all-gather of {ag_max} elems exceeds "
                f"{self.max_all_gather_elems}", ops, ("all-gather",)))
        if self.full_cohort_gathers is not None:
            n_full = len(comms.sizes(ops, "all-gather",
                                     min_elems=self.cohort_elems))
            measured["full_cohort_gathers"] = n_full
            v = check_bound("full_cohort_gathers", n_full,
                            self.full_cohort_gathers)
            if v:
                violations.append(self._with_blame(v, ops, ("all-gather",)))

    def _check_counts(self, run, measured, violations) -> None:
        counts = None if run is None else run.counts
        if counts is None:
            violations.append("contract has row_reads/sorts but no "
                              "recorded run was provided")
            return
        if self.row_reads is not None and run.row_elems is None:
            violations.append("contract has row_reads but no row_elems "
                              "was provided")
            return
        measured["row_reads"] = counts.reads
        measured["row_reads_executed"] = counts.reads_executed
        measured["sorts"] = counts.sorts
        for field, val in (("row_reads", counts.reads),
                           ("sorts", counts.sorts)):
            v = check_bound(field, val, getattr(self, field))
            if v:
                violations.append(v)

    def spec(self) -> str:
        """Compact one-line rendering of the declared bounds."""
        parts = []
        for f in fields(self):
            if f.name in self._SPEC_SKIP:
                continue
            val = getattr(self, f.name)
            if val is None:
                continue
            if f.name == "donated":
                parts.append(f"donated={sorted(val)}")
            elif f.name in ("allreduce_max_elems", "max_all_gather_elems"):
                parts.append(f"{f.name}<={val}")
            else:
                parts.append(f"{f.name}{_fmt_bound(val)}")
        return " ".join(parts)


@dataclass
class Report:
    """One contract evaluation: measured values + violations + (where the
    run recorded its collectives) the per-provenance collective blame
    table."""
    contract: Contract
    measured: Dict[str, object]
    violations: List[str]
    blame: Optional[List] = None  # List[blame.BlameEntry]

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_json(self) -> Dict[str, object]:
        """JSON-serializable dict (for ``check --json``): the declared
        spec, every measured value, violations and the per-provenance
        blame table."""
        from dataclasses import asdict
        return {
            "program": self.contract.name,
            "description": self.contract.description,
            "spec": self.contract.spec(),
            "measured": dict(self.measured),
            "violations": list(self.violations),
            "ok": self.ok,
            "blame": [asdict(b) for b in self.blame or []],
        }


def format_table(reports: Sequence[Report]) -> str:
    """The one-table rendering ``python -m repro_torch.analysis check``
    prints: program | declared contract | measured | PASS/FAIL (+
    violations)."""
    rows = [("program", "contract", "measured", "status")]
    for r in reports:
        meas = " ".join(f"{k}={v}" for k, v in sorted(r.measured.items()))
        rows.append((r.contract.name, r.contract.spec(), meas,
                     "PASS" if r.ok else "FAIL"))
    widths = [max(len(row[i]) for row in rows) for i in range(4)]
    lines = []
    for i, row in enumerate(rows):
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    for r in reports:
        for v in r.violations:
            lines.append(f"FAIL {r.contract.name}: {v}")
    return "\n".join(lines)
