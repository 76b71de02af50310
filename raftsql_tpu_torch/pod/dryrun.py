"""Dry-run pod driver: N local processes on one box.

Port of raftsql_tpu/pod/dryrun.py: the same modes and the same JSON
documents, each process stepping on `--device` (the card by default)
over RAFTSQL_SHARD_SLOTS shard slots.  The first two rungs of the pod
ladder:

  rung 1 — dry-run multi-process: N processes of THIS module form a
  pod over localhost sockets and run a seeded workload;

  rung 2 — bit-for-bit equivalence: each process dumps its hard
  states, publish cursors, leader hints and applied KV stream, and
  tests/test_torch_pod.py compares every host's dump against a
  single-controller MeshClusterNode driven through the SAME global
  workload (and against each other).

Launch (one line per process, any order; proc 0 is the coordinator):

    RAFTSQL_SHARD_SLOTS=8 \\
      python -m raftsql_tpu_torch.pod.dryrun --procs 2 --proc-id 0 \\
        --coord 127.0.0.1:19317 --data-dir pod/h0 --ticks 80 \\
        --out pod/h0.json
    ... --proc-id 1 --data-dir pod/h1 --out pod/h1.json

With RAFTSQL_POD_JAX_DISTRIBUTED=1 (the JAX package's variable) every
process first joins the pod's torch.distributed process group
(pod/config.py init_distributed, `--dist-backend`) and steps only the
group shards it owns: the dumps must not change.

`--mode bench` times the same loop and reports commits/s plus the
per-phase profiler shares with the pod gather wait broken out, so the
cross-host hop cost is attributed, not guessed (chip_smoke.py's pod
phase drives it on the card).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import queue
import sys
from typing import List, Tuple


def seeded_workload(seed: int, ticks: int, num_groups: int,
                    rate: float = 0.4) -> List[List[Tuple[int, int, bytes]]]:
    """The pod dry-run workload: per tick, a seeded subset of groups
    each gets one `SET k<g> v<seq>` — the same shape tests/test_mesh.py
    drives the fused<->mesh equivalence with.  Returns per-tick lists
    of (global_index, group, payload); in a pod of N processes, item i
    is OFFERED by process i % N, and the gather's seq-order merge
    reassembles exactly this global order on every host."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out: List[List[Tuple[int, int, bytes]]] = []
    idx = seq = 0
    for _ in range(ticks):
        tick_items: List[Tuple[int, int, bytes]] = []
        for g in range(num_groups):
            if rng.random() < rate:
                tick_items.append(
                    (idx, g, f"SET k{g} v{seq}".encode()))
                idx += 1
                seq += 1
        out.append(tick_items)
    return out


def drain_commits(node, peer: int = 0) -> List[tuple]:
    """Drain peer 0's commit stream into (group, index, payload) rows
    (the applied-KV stream the equivalence contract compares)."""
    from raftsql_tpu_torch.runtime.db import _expand_commit_item
    out: List[tuple] = []
    q = node.commit_q(peer)
    while True:
        try:
            item = q.get_nowait()
        except queue.Empty:
            break
        if item is None or not isinstance(item, tuple):
            continue
        out.extend(_expand_commit_item(item))
    return out


def state_doc(node, applied_rows: List[tuple]) -> dict:
    """The equivalence dump: full hard states / cursors / hints plus
    the applied stream, and a digest of the lot for quick cross-host
    comparison."""
    import base64

    import numpy as np
    # Canonical order (group, index): per-group streams are FIFO on
    # every runtime, but the INTERLEAVING across group shards depends
    # on the publish mode (inline serial vs per-shard workers), which
    # the host's core count selects — sorting removes exactly that
    # execution detail and nothing semantic.
    rows = sorted([int(g), int(i),
                   d.decode("utf-8", "replace")
                   if isinstance(d, (bytes, bytearray)) else str(d)]
                  for (g, i, d) in applied_rows)
    doc = {
        "hard": base64.b64encode(
            np.ascontiguousarray(node._hard).tobytes()).decode(),
        "applied": base64.b64encode(
            np.ascontiguousarray(node._applied).tobytes()).decode(),
        "hints": [int(x) for x in node._hints],
        "kv_stream": rows,
    }
    blob = json.dumps(doc, sort_keys=True,
                      separators=(",", ":")).encode()
    doc["digest"] = hashlib.sha256(blob).hexdigest()[:16]
    return doc


def build_pod_node(args, transport=None):
    from raftsql_tpu_torch.config import RaftConfig
    from raftsql_tpu_torch.pod.config import POD_DISTRIBUTED_ENV, PodConfig
    from raftsql_tpu_torch.pod.node import PodClusterNode
    from raftsql_tpu_torch.runtime.mesh import MeshConfig
    device = getattr(args, "device", "cuda")
    pod = PodConfig(procs=args.procs, proc_id=args.proc_id,
                    coordinator=args.coord or "")
    dist = os.environ.get(POD_DISTRIBUTED_ENV) == "1"
    cfg = RaftConfig(num_groups=args.groups, num_peers=args.peers,
                     log_window=32, max_entries_per_msg=4,
                     election_ticks=10, heartbeat_ticks=1,
                     tick_interval_s=0.0, seed=7,
                     commit_rule=getattr(args, "commit_rule", "point"))
    gg = args.group_shards
    if gg <= 0:
        gg = MeshConfig.for_groups(cfg, device=device).group_shards
    if dist:
        pod.init_distributed(device=device,
                             backend=getattr(args, "dist_backend", "")
                             or None)
    try:
        mesh = MeshConfig(peer_shards=1, group_shards=gg).build(
            device=device, owned=pod.owned_shards(gg) if dist else None)
        node = PodClusterNode(pod, cfg, args.data_dir, mesh,
                              transport=transport, seed=3,
                              connect_timeout_s=args.connect_timeout,
                              distributed=dist)
    except BaseException:
        if dist:
            pod.destroy_distributed()
        raise
    return node, cfg


def run_equiv(args) -> dict:
    node, cfg = build_pod_node(args)
    applied: List[tuple] = []
    try:
        wl = seeded_workload(args.seed, args.ticks, cfg.num_groups)
        for t in range(args.ticks):
            for i, g, payload in wl[t]:
                if i % args.procs == args.proc_id:
                    node.pod_propose(g, [payload])
            node.tick()
            applied.extend(drain_commits(node))
        doc = state_doc(node, applied)
        doc["proc_id"] = args.proc_id
        return doc
    finally:
        node.stop()


def run_bench(args) -> dict:
    import time
    node, cfg = build_pod_node(args)
    try:
        wl = seeded_workload(args.seed, args.ticks, cfg.num_groups)
        # Warmup: elections + compile fall out of the timed window.
        for _ in range(10):
            node.tick()
        drain_commits(node)
        t0 = time.perf_counter()
        commits = 0
        for t in range(args.ticks):
            for i, g, payload in wl[t]:
                if i % args.procs == args.proc_id:
                    node.pod_propose(g, [payload])
            node.tick()
            commits += len(drain_commits(node))
        dt = time.perf_counter() - t0
        snap = node.metrics.snapshot()
        doc = {"proc_id": args.proc_id, "ticks": args.ticks,
               "commits": commits,
               "commits_per_s": round(commits / max(dt, 1e-9), 1),
               "wall_s": round(dt, 3),
               "phase_ms_per_tick": snap["phase_ms_per_tick"],
               "pod": snap["pod"],
               "pod_wait_ms_per_tick": round(
                   snap["pod"]["gather_wait_ms"]
                   / max(snap["pod"]["gathers"], 1), 4)}
        if node.prof is not None:
            doc["phase_shares"] = node.prof.shares()
        return doc
    finally:
        node.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="raftsql pod dry-run driver (one pod process, "
                    "PyTorch port)")
    ap.add_argument("--procs", type=int, default=1)
    ap.add_argument("--proc-id", type=int, default=0)
    ap.add_argument("--coord", default="",
                    help="coordinator host:port (procs > 1)")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--peers", type=int, default=3)
    ap.add_argument("--group-shards", type=int, default=0,
                    help="0 = widest fit for the visible devices")
    ap.add_argument("--ticks", type=int, default=80)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mode", choices=("equiv", "bench"),
                    default="equiv")
    ap.add_argument("--connect-timeout", type=float, default=30.0)
    ap.add_argument("--commit-rule", default="point",
                    choices=("point", "windowed", "pallas"),
                    help="Phase-7 commit rule ('pallas' runs the CUDA "
                         "quorum kernels once per shard per tick)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the consensus state steps on "
                         "(default cuda; 'cpu' runs the plain versions)")
    ap.add_argument("--dist-backend", default="",
                    choices=("", "nccl", "gloo"),
                    help="with RAFTSQL_POD_JAX_DISTRIBUTED=1: the process "
                         "group's backend (default nccl on a card, gloo "
                         "on the CPU; gloo on a card runs several "
                         "processes on one card)")
    ap.add_argument("--out", default="",
                    help="write the result doc here (default stdout)")
    args = ap.parse_args(argv)
    doc = run_equiv(args) if args.mode == "equiv" else run_bench(args)
    blob = json.dumps(doc, sort_keys=True)
    if args.out:
        tmp = args.out + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(blob)
        os.replace(tmp, args.out)
    else:
        print(blob)
    return 0


if __name__ == "__main__":
    sys.exit(main())
