"""Run a small traced fused cluster and emit a Chrome trace-event JSON
that Perfetto (ui.perfetto.dev) or chrome://tracing loads directly:

    python -m raftsql_tpu_torch.obs.trace_demo --out trace.json
    python -m raftsql_tpu_torch.obs.trace_demo --out trace.json --device cpu

Port of raftsql_tpu/obs/trace_demo.py (the JAX package's `make trace`).
Drives a 3-peer x G-group FusedClusterNode on `--device` (the card by
default; a missing card is an error) with tracing enabled for a few
hundred ticks of seeded PUT load, then exports both planes — the
per-proposal lifecycle spans (propose → append → replicate → commit)
and the device event ring's counter tracks (commit / inbox depth /
votes per peer x group) — schema-validates the document
(obs/export.py validate_chrome_trace), and writes it out.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile


def run_demo(out_path: str, groups: int = 4, ticks: int = 200,
             props_per_tick: int = 2, device="cuda") -> dict:
    from raftsql_tpu_torch.config import RaftConfig
    from raftsql_tpu_torch.obs.export import (chrome_trace,
                                              validate_chrome_trace)
    from raftsql_tpu_torch.runtime.fused import FusedClusterNode

    cfg = RaftConfig(num_groups=groups, num_peers=3, log_window=32,
                     max_entries_per_msg=4, election_ticks=10,
                     heartbeat_ticks=1, tick_interval_s=0.0)
    with tempfile.TemporaryDirectory(prefix="raftsql-trace-") as d:
        node = FusedClusterNode(cfg, d, device=device)
        node.enable_tracing()
        try:
            seq = 0
            for t in range(ticks):
                if t > 20:           # let the first elections settle
                    for g in range(groups):
                        node.propose_many(
                            g, [f"SET k{g} v{seq + i}".encode()
                                for i in range(props_per_tick)])
                    seq += props_per_tick
                node.tick()
            node.publish_flush()
            node.ring.drain()
            doc = chrome_trace(node.tracer.snapshot(), node.ring.rows())
        finally:
            node.stop()
    validate_chrome_trace(doc)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="trace.json")
    ap.add_argument("--groups", type=int, default=4)
    ap.add_argument("--ticks", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="torch device the cluster steps on (default "
                         "cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    doc = run_demo(args.out, groups=args.groups, ticks=args.ticks,
                   device=args.device)
    n = len(doc["traceEvents"])
    print(f"trace ok: {args.out} ({n} events; load it at "
          f"https://ui.perfetto.dev or chrome://tracing)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
