"""``python -m repro_torch.analysis`` — run the static invariant suite.

Exit status 0 when no error-severity finding survives suppression,
1 otherwise, 2 on usage errors. ``--report`` always writes the JSON
report, on a clean run too.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

from repro_torch.analysis import ANALYZERS, run_analyzers
from repro_torch.analysis.report import apply_suppressions


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static invariant suite of the port (host-sync / "
                    "concurrency / wire).")
    ap.add_argument("--all", action="store_true",
                    help="run every analyzer (default when --only absent)")
    ap.add_argument("--only", action="append", default=[],
                    metavar="NAME", help="run one analyzer (repeatable); "
                    f"names: {', '.join(sorted(ANALYZERS))}")
    ap.add_argument("--report", metavar="PATH",
                    help="write the JSON report here")
    ap.add_argument("--suppress", action="append", default=[],
                    metavar="CODE",
                    help="drop findings with this code (repeatable)")
    ap.add_argument("--list", action="store_true",
                    help="list analyzers and exit")
    args = ap.parse_args(argv)

    if args.list:
        for name, mod in sorted(ANALYZERS.items()):
            print(f"{name:14s} {mod}")
        return 0
    names = args.only or None
    if args.all and args.only:
        ap.error("--all and --only are mutually exclusive")
    try:
        report = run_analyzers(names)
    except KeyError as e:
        print(e.args[0], file=sys.stderr)
        return 2
    if args.suppress:
        report.findings = apply_suppressions(report.findings,
                                             args.suppress)
    if args.report:
        pathlib.Path(args.report).write_text(report.to_json() + "\n")
    for f in report.findings:
        print(f)
    n = len(report.errors)
    print(f"{', '.join(report.analyzers_run)}: "
          f"{n} error(s), {len(report.findings) - n} warning(s)")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
