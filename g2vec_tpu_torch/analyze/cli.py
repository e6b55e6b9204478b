"""``python -m g2vec_tpu_torch analyze`` — the port's static-check front end.

Exit-code contract (the same as ``python -m g2vec_tpu analyze``):

- ``0`` — clean: no active findings, no stale baseline entries;
- ``1`` — findings (or a stale baseline: shrink-only means a fixed
  finding must also drop its suppression);
- ``2`` — usage error (unknown flag or ``--checker`` id).

The suite is pure AST, so this subcommand never imports torch and runs
in well under a second on the port — cheap enough for a pre-push hook
and for a machine with no CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from g2vec_tpu_torch.analyze.core import (BASELINE_FILE, all_checkers,
                                          run_analysis, save_baseline)


def _default_root() -> str:
    """The repo root: the directory holding the g2vec_tpu_torch package."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m g2vec_tpu_torch analyze",
        description="Run the port's static-analysis suite "
                    "(lock discipline, torch purity, fault seams, "
                    "metrics schemas, config/doc drift, epoch stamps).")
    p.add_argument("--root", default=None,
                   help="repo root to scan (default: the checkout "
                        "containing this package)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report on stdout")
    p.add_argument("--baseline", default=None,
                   help=f"suppression file (default: "
                        f"<root>/{BASELINE_FILE})")
    p.add_argument("--checker", action="append", default=None,
                   metavar="ID",
                   help="run only this checker (repeatable); "
                        "see --list-checkers")
    p.add_argument("--list-checkers", action="store_true",
                   help="print checker ids and exit")
    p.add_argument("--write-baseline", action="store_true",
                   help="write the current active findings as the new "
                        "baseline (deliberate growth — CI refuses it)")
    return p


def analyze_main(argv: Optional[List[str]] = None) -> int:
    try:
        args = build_parser().parse_args(argv)
    except SystemExit as e:
        # argparse exits 2 on usage errors and 0 on --help; preserve.
        return int(e.code or 0)
    if args.list_checkers:
        for c in all_checkers():
            print(f"{c.id:18s} {c.description}")
        return 0
    root = os.path.abspath(args.root or _default_root())
    baseline = args.baseline or os.path.join(root, BASELINE_FILE)
    t0 = time.perf_counter()
    try:
        report = run_analysis(root, checker_ids=args.checker,
                              baseline_path=baseline)
    except KeyError as e:
        print(f"g2vec analyze: {e.args[0]}", file=sys.stderr)
        return 2
    dt = time.perf_counter() - t0
    if args.write_baseline:
        save_baseline(baseline, report.findings)
        print(f"[analyze] wrote {len(report.findings)} suppression(s) "
              f"to {baseline}")
        return 0
    if args.json:
        out = report.to_dict()
        out["elapsed_s"] = round(dt, 3)
        json.dump(out, sys.stdout)
        print()
    else:
        for f in report.findings:
            print(f"{f.location()}: [{f.checker}] {f.severity}: "
                  f"{f.message}   ({f.context})")
        for fp in sorted(report.stale_baseline):
            print(f"{baseline}: stale suppression {fp} — the finding "
                  f"is gone, remove the entry (shrink-only)")
        counts = (f"{len(report.findings)} finding(s), "
                  f"{len(report.waived)} waived, "
                  f"{len(report.baselined)} baselined, "
                  f"{len(report.stale_baseline)} stale")
        status = "clean" if report.clean else "FAIL"
        print(f"[analyze] {status}: {counts} "
              f"({', '.join(report.checkers_run)}; {dt:.2f}s)")
    return 0 if report.clean else 1


if __name__ == "__main__":
    sys.exit(analyze_main())
