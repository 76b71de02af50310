"""Check one result line against BENCHMARK.json for a cell and a role.

    python -m portbench.check_line --workload etcd-put.g1 --trace 1 < out.txt

reads the last line of standard input that parses as a JSON object and
exits 1, naming each problem, when it lacks a key the driver reads, a
metric declared for the cell and role (or its number or unit), or, in a
traced run, `busy_s` above 0 and at most `window_s`.  The harness calls
`problems()` on its own line before printing it.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("correct", "attempted", "failed", "metrics", "device")


def load_bench(path: str = os.path.join(ROOT, "BENCHMARK.json")) -> dict:
    with open(path) as f:
        return json.load(f)


def declared(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of `workload` reports in this role."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def _number(x) -> bool:
    return (isinstance(x, (int, float)) and not isinstance(x, bool)
            and math.isfinite(x))


def problems(line: dict, bench: dict, workload: str, trace: bool) -> list:
    out = []
    if not isinstance(line, dict):
        return ["the line is not a JSON object"]
    for k in KEYS:
        if k not in line:
            out.append(f"key {k} missing")
    if "correct" in line and not isinstance(line["correct"], bool):
        out.append("correct is not true or false")
    for k in ("attempted", "failed"):
        if k in line and not (isinstance(line[k], int)
                              and not isinstance(line[k], bool)
                              and line[k] >= 0):
            out.append(f"{k} is not a count")
    metrics = line.get("metrics")
    if not isinstance(metrics, dict):
        out.append("metrics is not an object")
        metrics = {}
    for m in declared(bench, workload, trace):
        got = metrics.get(m["name"])
        if not isinstance(got, dict) or not _number(got.get("value")):
            out.append(f"metric {m['name']} missing or not a number")
        elif got.get("unit") != m["unit"]:
            out.append(f"metric {m['name']}: unit {got.get('unit')!r}, "
                       f"declared {m['unit']!r}")
    dev = line.get("device")
    if not isinstance(dev, dict):
        out.append("device is not an object")
        dev = {}
    for k in ("platform", "kind", "count", "memory_peak_bytes"):
        if k not in dev:
            out.append(f"device.{k} missing")
    if trace:
        busy, window = dev.get("busy_s"), dev.get("window_s")
        if not (_number(busy) and _number(window)):
            out.append("device.busy_s or device.window_s missing")
        elif not 0 < busy <= window:
            out.append(f"device.busy_s {busy} not in (0, window_s "
                       f"{window}]")
    br = line.get("breakdown")
    if br is not None:
        for k in ("device_ops", "idle_gaps"):
            if len(br.get(k, [])) > 10:
                out.append(f"breakdown.{k} has more than 10 entries")
    return out


def last_json(text: str):
    for raw in reversed(text.splitlines()):
        raw = raw.strip()
        if raw.startswith("{"):
            try:
                return json.loads(raw)
            except ValueError:
                continue
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    ap.add_argument("--bench", default=os.path.join(ROOT, "BENCHMARK.json"))
    args = ap.parse_args(argv)
    line = last_json(sys.stdin.read())
    if line is None:
        print("no JSON line", file=sys.stderr)
        return 1
    bad = problems(line, load_bench(args.bench), args.workload,
                   bool(args.trace))
    for p in bad:
        print(p, file=sys.stderr)
    if not bad:
        print(f"{args.workload} trace={args.trace}: line complete "
              f"(correct={line['correct']})")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
