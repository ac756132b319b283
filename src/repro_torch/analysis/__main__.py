"""CLI: ``python -m repro_torch.analysis {check,lint}``.

check   Run the canonical program set (``analysis.programs``): the
        resident round, the quantized round, the aggregation, the async
        admission and merge on two meshes of 4 ``torch.distributed``
        ranks over gloo (4 x 1 and 2 x 2, spawned processes; on the card
        every rank runs on ``cuda:0``), and the quantile paths in this
        process; print every declared contract in one table, then the
        pool passes and ``contracts: k/15 passed``.  Exit 1 on any FAIL.
        ``--device`` is ``cuda`` or ``cpu``; without it the check runs on
        the card and raises where there is none.  ``--json PATH`` also
        writes the machine-readable report (measured values, violations,
        blame tables) to PATH.

lint    Run the port's source lints (``analysis.lint``) over the given
        paths (default: the ``repro_torch`` package).  Exit 1 on any
        finding.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

_PACKAGE = str(Path(__file__).resolve().parents[1])


def _cmd_check(args) -> int:
    from repro_torch import resolve_device
    from repro_torch.analysis import format_table, programs

    device = resolve_device(args.device).type
    progress = (lambda s: print(s, flush=True)) if not args.quiet \
        else (lambda s: None)
    reports = programs.canonical_reports(progress, device=device)
    print()
    print(format_table(reports))
    ok = all(r.ok for r in reports)

    print()
    passes = []
    for name, violations in programs.cache_checks(device):
        status = "PASS" if not violations else "FAIL"
        passes.append({"name": name, "ok": not violations,
                       "violations": list(violations)})
        print(f"{status}  {name}")
        for v in violations:
            print(f"      {v}")
            ok = False
    print()
    n_fail = sum(1 for r in reports if not r.ok)
    print(f"contracts: {len(reports) - n_fail}/{len(reports)} passed"
          + ("" if ok else "  [FAIL]"))
    if args.json:
        payload = {"ok": ok, "device": device,
                   "programs": [r.to_json() for r in reports],
                   "passes": passes}
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"wrote {args.json}")
    return 0 if ok else 1


def _cmd_lint(args) -> int:
    from repro_torch.analysis import lint

    paths = args.paths or [_PACKAGE]
    findings = lint.lint_paths(paths)
    for f in findings:
        print(f)
    print(f"{len(findings)} finding(s) over {len(paths)} path(s)")
    return 1 if findings else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__,
                                 formatter_class=argparse
                                 .RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    ck = sub.add_parser("check", help="run the canonical program set and "
                                      "report every contract")
    ck.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="where the programs run (default: cuda, raising "
                         "where there is none)")
    ck.add_argument("--quiet", action="store_true",
                    help="suppress per-program progress lines")
    ck.add_argument("--json", metavar="PATH", default=None,
                    help="also write the full machine-readable report to "
                         "PATH")
    ck.set_defaults(fn=_cmd_check)
    ln = sub.add_parser("lint", help="run the port's source lints")
    ln.add_argument("paths", nargs="*", default=None,
                    help="files/directories to lint (default: the "
                         "repro_torch package)")
    ln.set_defaults(fn=_cmd_lint)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
