"""raftlint command line: `python -m raftsql_tpu_torch.analysis [paths...]`.

The port's copy of raftsql_tpu/analysis/cli.py: the same rule ids, the
same annotation grammar, the port's registry (analysis/config.py).

Exit status is the contract (CI gates on it): 0 clean, 1 findings,
2 usage error.  `--list` prints the registered rules with their
one-line invariants; `--rules a,b` restricts a run to named rules
(fixture tests and focused pre-commit runs).
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from raftsql_tpu_torch.analysis import config as config_mod
from raftsql_tpu_torch.analysis.core import all_checkers, run_suite


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="raftlint",
        description="project-invariant static analysis for "
                    "raftsql_tpu_torch")
    ap.add_argument("paths", nargs="*",
                    default=config_mod.DEFAULT_PATHS,
                    help="files/dirs to check (default: project tree)")
    ap.add_argument("--list", action="store_true", dest="list_rules",
                    help="list registered rules and exit")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default all)")
    args = ap.parse_args(argv)

    if args.list_rules:
        seen = set()
        for cls in all_checkers():
            if cls.name in seen:
                continue
            seen.add(cls.name)
            print(f"{cls.name:18s} {cls.doc}")
        return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        known = {c.name for c in all_checkers()}
        bad = [r for r in rules if r not in known]
        if bad:
            print(f"raftlint: unknown rule(s): {', '.join(bad)}",
                  file=sys.stderr)
            return 2

    findings = run_suite(args.paths, rules=rules)
    for f in findings:
        print(f.render())
    if findings:
        print(f"raftlint: {len(findings)} finding(s)")
        return 1
    print("raftlint: ok")
    return 0


