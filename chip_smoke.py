"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Drives raftsql_tpu_torch on the card, phase by phase, and fails (non-zero
exit, no result line) at the first phase that fails:

  1. environment: the card's name and power limit, torch and CUDA;
  2. build: the CUDA quorum kernels from raftsql_tpu_torch/csrc/, with
     ptxas's report of every kernel; the main path's instantiations
     (P = 3) must have no stack frame and no spills;
  3. kernels: K1 and K2 against their plain PyTorch versions on the
     card (exact equality) at 1 to 385 peers (the generic kernel on
     both sides of the peer count past which it reads its rows from
     device memory), with no, all and random leader rows, ragged and
     misaligned inputs; at the main path's P = 3, kernel and plain
     times by CUDA events and the kernel's device time by
     torch.profiler;
  4. the fused tick (the main path's device program) at G = 100,000,
     P = 3, W = 256, E = 32 with commit_rule="pallas": the launch
     counts are zeroed just before and read just after; one tick of
     each kernel has its inputs copied, and K1 and K2 are then timed on
     those tensors; then a card run and a CPU run of the same 64 ticks
     at G = 8192, each booted from the same seed, must be bit-identical;
     then the bench's device helpers at its saturated headline shape
     (bench.py bench_throughput, the same G, W, E and rule, T = 32):
     one cluster_run of T ticks whose stacked [T, P, G] infos (~0.8 GB)
     running_commit and commit_latency_ticks reduce on the card to the
     commit delta and the p50 and p99 latency in ticks (only scalars
     cross to the host), ms per tick, K1 launched exactly T times (count
     zeroed just before, read just after), one tick's K1 inputs copied
     (R = 300,000); a card run and a CPU run of cluster_run + K8 at G =
     8192 from one seed must be bit-identical; then the device event
     ring's cost at G = 100,000 ([64, 3, 100000, 9] int32): the fused
     tick without and with a ring record per tick, the host history's
     rows and bytes and the process RSS after each of three 64-slot
     drains (bytes within the ring's 256 MiB budget, RSS growth within
     the budget plus one drain's block), and the durable node's tick (native WALs, G = 10,000: its elections
     take 52 s at G = 100,000, 14.6 s at 25,000) without and with
     enable_tracing;
  5. the membership and transfer planes at G = 10,000 on 4 slots
     (voters {0,1,2}, a spare slot 3, durable FusedClusterNode,
     commit_rule="pallas"): after the elections slot 0 is replaced by
     slot 3 (add_learner, promote, remove through joint consensus) on 64
     groups while leadership moves on 64 others; every touched group
     must end on its expected config or leader and every other group on
     {0,1,2}; K2 must launch on every tick after enable_membership, and
     on the first tick with joint masks live whose K2 call advances
     some row's commit its inputs are copied (the dispatch run again
     eagerly on copies: spy_fused_kernel), held against its plain
     version and timed (R = 40,000, P = 4);
     G is cut from the bench headline's 100,000 to keep the whole run
     under its time limit (the phase's host plane costs about 1.5 s a
     tick and 73 s of set-up at G = 100,000; 37 s in all at 25,000);
  6. the fused durable SQL server (build_fused_node + the aio HTTP
     plane) on native WALs: the reference curl recipe, concurrent acked
     PUTs, a close and a resume=True reopen that replays the WALs;
  7. the same server with tracing on (the CLI's --trace): the PUT load
     again, GET /trace must pass validate_chrome_trace, and GET /events
     must show tracing on, device rows, and one full propose-to-ack
     span per acked PUT;
  8. the server with placement (the CLI's --placement): POST /transfer
     answers 200 and moves the leader, 400 for a transfer in flight, a
     target that already leads and (a second start with --witness 2) a
     witness target; skewed PUT load with placement off and on, in
     turns: placement must complete a transfer, every acked PUT is read
     back, p50/p99 of each;
  9. chaos: the default family at SEED=0 (240 ticks,
     commit_rule="pallas"), the five fused families, and the reads,
     quorum and transfers families (commit_rule="pallas"), once each
     (RUNS), through raftsql_tpu_torch.chaos.run (the five in a
     process of their own beside the rest); every
     schedule and result digest must equal the JAX package's
     (CHAOS_DIGESTS), K1 must launch in the default's and the
     nemesis families' runs, and the signature tripwire armed over the
     default's runs prints its `signature-tripwire:` line and must see
     one call signature of cluster_step_host; meanwhile, in a process
     of its own, the falsification pairs of the three gauntlets (the
     broken lease bound, the unsafe transfer kernel, quorum arms A and
     B) must be caught and their controls pass;
 10. the distributed runtime at the bench's node shape: 3 RaftNodes on
     the card over LoopbackHub(codec=False), G = 10,000, P = 3, W = 64,
     E = 8, tick_interval_s = 0, commit_rule="pallas", in lockstep
     through the elections, then 12 ticks draining E proposals per
     group per tick queued ahead: node 1's commits/s and per-phase ms
     per tick, every WAL native; K1 must launch once per node tick, and
     one tick's K1 inputs (R = 10,000, one peer's rows) are copied, held
     to the plain version and timed; then the same shape for 4 ticks on
     the Python WAL backend (RAFTSQL_TPU_NATIVE=0), for node 1's ms per
     tick by phase beside the native run's; then a card run and a CPU
     run of one lockstep script at G = 512 must be bit-identical (packed
     info, commit stream, WAL bytes);
 11. the Procfile cluster: three `python -m raftsql_tpu_torch.server.main
     --id I --cluster <3 urls> --port I2380 --groups 8 --resume`
     processes on the card (the Procfile's ports, default tick and
     commit rule): the curl recipe, node 2 SIGKILLed, a write while it
     is down and its catch-up, PUT p50/p99 from 16 client threads over
     the 8 groups with every acked PUT read back at every node, no
     election during that load (node steps slower than the 10 ms tick
     must not depose a leader), each node's GET /metrics
     phase_ms_per_tick, and every start of every child on native WALs
     (its "WAL backend: native" log line);
 12. the node-plane chaos families: corrupt, snapshot and membership
     once each (RUNS) with commit_rule="pallas" (digests equal to the JAX
     package's, CHAOS_DIGESTS; K1 launches in corrupt and snapshot, K2
     in membership, where the inputs of its first call on joint masks,
     R = 2 rows of one peer at P = 4, are copied, held to the plain
     version and timed; a device time the profiler does not catch in
     three captures fails the phase, as on every main path; snapshot in
     a process of its own, its launches counted there); meanwhile, in
     another, tcp and tcp_rebind once each (invariants hold, faults
     fired);
 13. the overload gauntlet (chaos.run overload_gauntlet, what --overload
     runs) at the plan's own size, G = 4, P = 3, 160 ticks, 32 offered
     writes a tick plus bursts, commit_rule="pallas", twice: plan and
     result digests equal to the JAX package's (CHAOS_DIGESTS), every
     pressure family fired, the backlog peak at or under its cap of 48,
     the goodput and starvation floors met, the falsification pair
     caught and its control passed, and K1 launched once per device
     step (launches and dispatches zeroed just before, read just after);
     the inputs of K1's first call that advances some row's commit (R
     = 12, P = 3) are copied, held to the plain version and timed;
 14. the process plane, every server child a CUDA process: the --procs
     gauntlet at seed 0, 80 ticks, once (RUNS; every fault family fires,
     no unexpected exit, the verdict digest the reference's all-pass
     digest, PROC_VERDICTS), the read and transfer arms once each on
     generate_procs(0, ticks=60), one after another (at once, the
     transfer arm issued no transfer: it needs the PUT rate a gauntlet
     gets alone), and a SIGSTOP probe (a stalled
     CUDA leader's survivors: device ms per node tick and ticks per
     second before and during the stall);
 15. the durable storage plane at the bench's accelerator durable shape
     (bench.py bench_durable_fused): FusedClusterNode, G = 10,000, P =
     3, W = 64, E = 8, tick_interval_s = 0, commit_rule="pallas", WAL
     group commit, publish_peers = {0}; arm (a) the native payload log
     (RAFTSQL_FUSED_NATIVE_PLOG=1) with NativeKV applying peer 0's
     stream, arm (b) the Python payload log with one KVStateMachine a
     group draining it, in turns (a, then b), each booted from seed 0,
     elected, then 12 ticks with E SET proposals a group a tick queued
     ahead: every WAL native, the same commit indexes, KV state and WAL
     records in both arms, K1 launched once per device step; commits/s
     and ms per tick by phase of each arm;
 16. the mesh tick (BASELINE config 5, bench.py bench_multichip): G =
     32,768 (8,192 a group shard), P = 4, W = 64, E = 8 on a 2 x 4 mesh
     whose eight shards share the card, commit_rule="pallas": the sharded
     host step and the fused cluster_step_host in lockstep from boot
     (at least 48 ticks, until every group has a leader; packed info and
     busy bit equal every tick), then blocks of 16
     ticks in turns (fused, mesh, mesh, fused) for ms per tick, the final
     states equal; K1 launched pp x gg = 8 times a mesh step (counts
     zeroed before the first mesh block, read after); one shard's K1
     inputs copied (R = 16,384, P = 4); then voter masks (K2, 8 a step,
     one shard's inputs copied); then a card mesh and a CPU mesh run one
     48-tick lockstep script with skew at G = 512, bit-identical;
 17. the durable mesh node (bench.py's runtime="mesh" rung): G = 10,000,
     P = 3, W = 64, E = 8 over 8 group shards on the card, native WALs
     per shard dir, the rung's queue-drain KV apply, booted from seed 0,
     elected, 12 ticks with E SETs a group queued ahead: commits/s and ms
     per tick by phase beside phase 15's arm (b), the same commit indexes
     and KV state per group, K1 launched 8 times a device step;
 18. the mesh server: `python -m raftsql_tpu_torch.server.main --mesh
     --groups 8 --group-shards 4 --resume` on the card with 4 shard
     slots: the curl recipe, 16 client threads of acked PUTs read back
     (p50/p99), a clean stop and a --resume reopen from the per-shard
     WALs with every row intact, native WALs at both starts;
 19. mesh chaos: mesh_skew at seed 0, RUNS times, commit_rule="pallas",
     8 shard slots: digests equal to the fused skew family's
     (CHAOS_DIGESTS["mesh_skew"]), K1 launched once per shard per step;
 20. the pod: two pods of two `--pod --pod-procs 2` server processes
     on the card (8 groups, --group-shards 2), the replicated default
     and the one program over hosts (RAFTSQL_POD_JAX_DISTRIBUTED=1 over
     a gloo process group), booted at once: for each, writes through a
     client at host 0 that follows the 421 to the owner, every acked PUT
     read back from its owner, PUT p50/p99; then `pod.dryrun --mode
     equiv` with 2 processes, replicated and distributed pairs at once
     (G = 1024 over 8 shards, commit_rule="pallas"), equal to the
     single-controller run in this process (the pod path's K1 count, 8 a
     device step, and one shard's K1 inputs, R = 384, P = 3), the pod
     gauntlet (below) running beside it; then the
     distributed step at the bench's multichip group count (G = 32,768,
     P = 3, W = 64, E = 8, 8 shards): two ranks on the card over gloo,
     each for 64 ticks bit-identical to the single-process sharded step,
     K1 launched owned shards x steps a rank, one owned shard's K1
     inputs (R = 12,288) held to the plain version, ms per tick against
     the replicated step and the all-gather's ms; one rank alone over
     NCCL, 16 ticks equal; the pod gauntlet at seed 0, RUNS times
     (every fault fires, no unexpected exit, PROC_VERDICTS["pod"]) and
     its falsification pair;
 21. the workers plane (--workers): the engine in this process on the
     card (build_fused_node, 8 groups, parity mode, commit_rule="pallas",
     native WALs) with a RingServer and 2 worker processes spawned as
     server/main.py _serve_workers spawns them (spawn_worker, no card:
     CUDA_VISIBLE_DEVICES=""): the curl recipe through the workers, 16
     client threads of acked PUTs read back, local and session GETs with
     the workers' shm fast-path hits above 0 (a shm plane that disabled
     itself fails), the engine the only compute process on the card
     (nvidia-smi lists one compute app; workers see no card), K1
     launches equal to the engine's device steps (zeroed
     before the engine boots, read after it closed), the inputs of K1's
     first call that advances some row's commit copied (R = 24, P = 3);
     then the load
     ladder: native/http_load.cc (built with g++; a failed build raises)
     at 192 connections, 3 s a rung, against phase 6's in-process aio
     server and 1 and 2 workers, each a fresh engine (req/s, p50/p99,
     0 errors; a 4-worker rung gave no more than 2 and was cut to keep
     the script near its time budget); then `python -m raftsql_tpu_torch.server.main --fused
     --workers 2 --groups 8` as a process: the recipe, a worker SIGKILLed
     and respawned while 8 threads PUT, every acked PUT read back,
     SIGTERM exit 0 and no worker left;
 22. the read-replica tier: `--fused --groups 2 --replica-listen` on the
     card (parity mode, the case the JAX package's engine dies on) and
     two `python -m raftsql_tpu_torch.replica` processes without the
     card: 40 acked PUTs, session reads at their watermarks served by
     both replicas, the engine the only compute process, SIGTERM exit 0,
     then linear reads refused (421); then the replica gauntlet at seed
     0 (RUNS times, with its falsification pair, all at once): the plan
     and all-pass verdict digests (PROC_VERDICTS["replica"]), the
     gate-less replica caught and its control passed, each run's wall
     time;
 23. the elastic keyspace (--reshard): (a) the engine in this process
     (build_fused_node, 8 groups x 3 peers, commit_rule="pallas", native
     WALs, ReshardPlane with 64 slots and the PlacementController
     attached, the aio HTTP plane): scripts/bench_reshard.py's zipfian
     load (256 keys, s = 1.2, 800 PUTs, from 16 threads) and the
     controller's split_hottest, the hot group's share of the load
     before and after; then 16 client threads of /kv PUT and GET while a
     split, a merge and a migrate run through POST /reshard, every
     acked write read back after each verb; a stale epoch answered 409
     with the current keymap, a frozen slot 503 + Retry-After, the
     reshard counters in /metrics, scripts/check_prom.py --url clean
     (run as a process of its own) with the raftsql_reshard_* families,
     a fresh ReshardPlane.recover_from_db() rebuilding the same keymap,
     K1 launches equal to the engine's device steps (zeroed before the
     engine boots, read after it closed) and the inputs of K1's first
     call that advances some row's commit copied (R = 24, P = 3);
     (b) `python -m
     raftsql_tpu_torch.server.main --fused --groups 8 --workers 2
     --reshard --trace` as a process: 64 keyed PUTs through the workers
     (ring op 7), a split through POST /reshard at a worker (op 6),
     every key read back, 409 at a stale epoch, each worker's shm reads
     failing closed across the epoch and serving again once it adopted
     it, the engine the only compute process on the card, GET /trace
     valid with the workers' ring spans, SIGTERM exit 0; (c) the
     reshard gauntlet at seed 0 (RUNS times, commit_rule="pallas") with
     its repaired falsification pair, beside it in a process of its own
     the JAX package's unrepaired pair: the nemesis digests and the
     unrepaired pair's result digests
     equal the JAX package's (RESHARD_DIGESTS), the broken flip caught
     and its control passed, K1 launches equal to device steps; (d) the
     trace demo (obs/trace_demo.py: a traced 4-group fused cluster on
     the card, its Chrome trace valid) and the native WAL's stress
     harness under asan, ubsan and tsan (native/sanitize.py, built with
     g++ where the script runs, the three at once and while (c) runs; a
     failed build or a report fails the phase);
 24. the fused step's CUDA graph (runtime/fused.py): the graph against
     the eager cluster_step_host chain on the card at the benchmark
     cell's shape (G = 1, P = 3, E = 8, commit_rule="pallas") and at G =
     10,000, 200 ticks each with seeded proposals and a skewed timer
     window, packed info and busy bit equal every tick and every state
     and inbox leaf every 20 ticks, one capture and a replay every tick
     after the first, K1 once a tick on each side, and each side's
     enqueue in ms a tick; then the fused server on one group under 16
     client threads of acked PUTs, GET /metrics read every 0.2 s:
     graph_captures 1 in every reading, graph_replays / ticks at least
     0.99;
 25. the kernels line (JSON: K1 as phase 4 measured it, K2 on phase 5's
     joint masks, launches summed over the paths; K1's launches and time
     on phase 4's cluster_run path, R = 300,000; each kernel's
     node-path launches and time: K1 at R = 10,000 from phase 10, K2 at
     R = 2 from phase 12; K1's launches and time on the overload path of
     phase 13, R = 12; K1's launches in phase 15; K1 and K2 on the mesh
     path of phases 16, 17 and 19 and K1 on the pod paths of phase 20
     (replicated and distributed), with their per-shard times; K1's launches on the workers path of
     phase 21 and its time at R = 24; K1's launches on the reshard path
     of phase 23 and its time at R = 24) and the result line.

The mesh and pod phases share one card among their shards: they measure
whether the sharded program is right on the card and what it costs
there, not scaling across cards.

`--only 13,15` runs the build and the named phases (3-24) alone: a
development run, with no result line.  It needs one card and writes
under build/ of its checkout (and the chaos runs' data dirs under
$TMPDIR, removed after each run).
"""
from __future__ import annotations

import contextlib
import dataclasses
import http.client
import json
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from raftsql_tpu_torch import convert
from raftsql_tpu_torch.config import RaftConfig
from raftsql_tpu_torch.core import cluster
from raftsql_tpu_torch.ops import pallas_quorum as pq
from raftsql_tpu_torch.ops import quorum as tq

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "build", "chip_smoke_data")
HBM_BYTES_S = 3.35e12     # H100 SXM device memory (data sheet)
INT_OPS_S = 67e12         # H100 SXM non-tensor 32-bit rate (data sheet)
# (schedule digest, result digest) of each fused chaos family at seed 0,
# as its runner reports them (a nemesis plan's runner reports the digest
# of the schedule it projects the plan into): the JAX package's runners
# on the CPU under JAX 0.9.0, whose threefry is partitionable
# (tests/test_torch_chaos.py and test_torch_chaos_nemesis.py hold the
# port to a live JAX run and to these constants).
CHAOS_DIGESTS = {
    "default": ("622b22c59545816b", "3bcaa6784fc0a2d8"),
    "asym": ("1450fc31d17ad885", "a8ebb9ca13ed9532"),
    "skew": ("4b1508ca5ccc18d0", "74bb6ca5cda40817"),
    "enospc": ("92bed49e35e5bdc5", "bb5164888fc9f234"),
    "fsync_stall": ("a74066e3175df9f0", "e6e3ea9dd9aa0b2e"),
    "compact": ("53ad340caa28b97e", "93a3ecaa989d1b05"),
    "reads": ("1e788605c763474d", "078b010d4d28b49f"),
    "quorum": ("238cad39f96aea26", "ea8cfbc0d6779d40"),
    "transfers": ("c82c989e600de20b", "cfd7db527bd7f45e"),
    # The lockstep node-plane families (the distributed runtime): the
    # runner reports (plan digest, result digest).
    "corrupt": ("4f4ed0f264577c9d", "f5ee78bdc4375e9c"),
    "snapshot": ("edd1a37f25bc171d", "d4b51966c0c2ee25"),
    "membership": ("2a76495647d33d68", "f6f1b63bf483aaba"),
    # The overload family (OverloadChaosRunner): (plan digest, result
    # digest) of a live JAX run.  bench_logs/chaos_digests.json pins the
    # result as ac2d01c5e3007d01, the non-partitionable threefry run.
    "overload": ("993c8f68e0b1ac1a", "fadf1a8688e66fa1"),
    # The skew schedule on the mesh runtime (MeshChaosRunner): sharding
    # is an execution detail, so its digests are the fused skew
    # family's; a live JAX MeshChaosRunner run on 8 forced host devices
    # gave the same pair.
    "mesh_skew": ("4b1508ca5ccc18d0", "74bb6ca5cda40817"),
}
# The reshard family at seed 0 (ReshardChaosRunner): the nemesis's
# (plan, schedule, result) digests of a live JAX run on the CPU under
# JAX 0.9.0; the JAX package's unrepaired falsification pair's result
# digests (its broken coordinator is not caught under these draws:
# ROADMAP Queue 3); the repaired control's result digest (the port's
# falsification_reshard_plan default).
RESHARD_DIGESTS = {
    "nemesis": ("4d9d3209a892d3da", "6f04ea9b244bcc28", "8e946aabb9151b3b"),
    "unrepaired": {"broken": "5ce32a5e772fc48d",
                   "control": "02c46e48d3d3b479"},
    "control": "a4dc880d871812ad",
}
# Runs of each seed-0 chaos family and of the --procs gauntlet (phases 9,
# 12, 14).  One: every run's digests must equal the reference's constants
# (CHAOS_DIGESTS, PROC_VERDICTS), which a second run only repeats; the
# whole script must stay near half its 1,200 s limit.
RUNS = 1
REPLACES = {
    "pallas_quorum_commit_index":
        "raftsql_tpu/ops/pallas_quorum.py:72",
    "pallas_masked_quorum_commit_index":
        "raftsql_tpu/ops/pallas_quorum.py:164",
}


def log(*a):
    print(*a, flush=True)


def _mem_available_gib() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def expect(got, want, what: str) -> None:
    """A check that holds under `python -O` too."""
    if got != want:
        raise AssertionError(f"{what}: got {got!r}, want {want!r}")


# ---- phase 1 ---------------------------------------------------------------

def environment() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False "
                         "— this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"card: {smi}")
    return smi


# ---- phase 3 ---------------------------------------------------------------

PTXAS_PROPS = re.compile(r"Function properties for (\S+)\s*\n\s*(\d+) bytes "
                         r"stack frame, (\d+) bytes spill stores, (\d+) "
                         r"bytes spill loads")


def check_ptxas(text: str) -> None:
    """Log ptxas's report for every kernel of the build, and fail unless
    the main path's instantiations (P = 3 of K1 and K2) keep their rows
    in registers: a 0-byte stack frame and no spills."""
    for line in text.splitlines():
        if "ptxas" in line or "bytes stack frame" in line:
            log(f"ptxas: {line.strip()}")
    props = {m.group(1): tuple(map(int, m.group(2, 3, 4)))
             for m in PTXAS_PROPS.finditer(text)}
    for masked, name in ((0, "K1"), (1, "K2")):
        key = f"quorum_commitILb{masked}ELi3EE"
        found = [v for k, v in props.items() if key in k]
        if not found or any(found[0]):
            raise AssertionError(f"{name} at P=3: stack/spill stores/spill "
                                 f"loads {found or 'not in the ptxas log'}, "
                                 f"want 0/0/0")
        log(f"ptxas: {name} at P=3: {found[0][0]} bytes stack frame, "
            f"{found[0][1]}/{found[0][2]} bytes spill stores/loads")


def kernel_case(seed, G, P, W, mask_kind=None, dev="cuda", lead="rand",
                offset=0):
    """Seeded inputs with the edge rows up front: cand 0, a non-leader,
    commit >= cand, a stale-term ring, cand above log_len.  `lead`:
    "rand" (75 % of rows lead), "none" or "all".  `offset` > 0 makes
    every tensor a view that starts that many elements into its storage,
    off a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    log_len = rng.integers(0, 3 * W, G).astype(np.int32)
    match = (rng.random((G, P)) * (log_len[:, None] + 1)).astype(np.int32)
    commit = (rng.random(G) * (log_len + 1)).astype(np.int32)
    term = rng.integers(1, 4, G).astype(np.int32)
    log_term = rng.integers(0, 4, (G, W)).astype(np.int32)
    is_leader = rng.random(G) < 0.75
    if G >= 5:
        match[0] = 0
        is_leader[1] = False
        commit[2] = log_len[2]
        log_term[3] = term[3] - 1
        match[4] = log_len[4] + 7
        is_leader[:5] = [True, False, True, True, True]
    if lead != "rand":
        is_leader[:] = lead == "all"

    def put(x):
        t = torch.from_numpy(x)
        if not offset:
            return t.to(dev)
        flat = torch.zeros(t.numel() + offset, dtype=t.dtype, device=dev)
        return flat[offset:].view(t.shape).copy_(t)

    args = [put(x) for x in (match, log_term, log_len, commit, term,
                             is_leader)]
    if mask_kind is None:
        return args, None
    full = np.ones((G, P), bool)
    v = rng.random((G, P)) < 0.7
    j = rng.random((G, P)) < 0.7
    v[:, 0] = True
    vj = {"full": (full, full), "reduced": (v, v), "joint": (v, j),
          "empty": (np.where(np.arange(G)[:, None] % 3 == 0, False, v),
                    np.where(np.arange(G)[:, None] % 2 == 0, False, j))}
    tv, tj = vj[mask_kind]
    return args, (put(tv), put(tj))


def time_ms(fn, reps=30):
    """Median per-call device time by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_device_us(fn, reps=20, name="quorum_commit"):
    """Device time per call of the kernels `fn` launches whose name holds
    `name` (every kernel when None), from torch.profiler: the kernels'
    own time (the CUDA-event time around one call also holds the
    wrapper's host work, during which the card idles); None where the
    trace has none.  Each kernel's time is the mean over the launches
    the trace recorded, times its launches per call: a capture on this
    card records no launch, or only some, now and then, and the total
    over `reps` calls would then read low."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # A capture that records no kernel is taken again with ten times the
    # launches, twice, before the time is reported as not measured
    # (main_path_kernels then fails).
    for i, n in enumerate((reps, 10 * reps, 10 * reps)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if (name is None or name in e.key) and _self_device_us(e) > 0]
        if ev:
            got = sum(e.count for e in ev)
            if i or got < n:
                log(f"profiler: {name} on capture {i + 1}: {got} kernel "
                    f"launches recorded of {n} calls")
            return sum(_self_device_us(e) / e.count
                       * max(1, round(e.count / n)) for e in ev)
    return None


def host_us(fn, calls=300) -> float:
    """Host time per call over back-to-back calls (each call's device
    work is shorter than its host work, so the host sets the pace)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def k1_host_parts(args, quorum) -> str:
    """Where K1's wrapper spends its host time: the input checks, the
    output allocation, and the ctypes call that launches the kernel; and
    for scale, one eager torch op of the kind the tick is made of (a
    `where` over the same [R] columns)."""
    R, P = args[0].shape
    W = args[1].shape[1]
    lib = pq._loaded()
    out = torch.empty_like(args[3])
    ptrs = [a.data_ptr() for a in args] + [out.data_ptr()]
    stream = torch.cuda.current_stream().cuda_stream
    parts = {
        "checks": lambda: pq._checked(args, W),
        "allocation": lambda: torch.empty_like(args[3]),
        "ctypes call + launch": lambda: lib.raftsql_quorum_commit(
            *ptrs, R, P, W, quorum, stream),
        "one eager torch.where": lambda: torch.where(args[5], args[3],
                                                     args[2]),
    }
    return ", ".join(f"{k} {host_us(f):.1f} us" for k, f in parts.items())


def _us(x) -> str:
    return "not measured" if x is None else f"{x:.2f} us"


def bound(args, masks, cand):
    """The least time for the function on these inputs, counting what
    they need: every row reads is_leader and commit and writes out; a
    leader row also reads its match row, log_len and term (K2: both mask
    rows); the ring word only where the row leads, its candidate is in
    [1, log_len] and above commit.  The P^2 compares of each leader row
    against the card's 32-bit rate.  Returns (ms, "bytes"|"operations",
    ms of the all-rows count: every row read as if it led, the ring
    wherever the candidate is in range)."""
    match, log_term, log_len, commit, term, is_leader = args
    R, P = match.shape
    per_leader = 4 * P + 8 + (2 * P if masks is not None else 0)
    per_compare = 2 if masks is None else 4
    in_range = (cand >= 1) & (cand <= log_len)
    leaders = int(is_leader.sum())
    ring = int((is_leader & in_range & (cand > commit)).sum())
    t_bytes = (9 * R + per_leader * leaders + 4 * ring) / HBM_BYTES_S
    t_ops = leaders * P * P * per_compare / INT_OPS_S
    all_rows = max(((9 + per_leader) * R + 4 * int(in_range.sum()))
                   / HBM_BYTES_S, R * P * P * per_compare / INT_OPS_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", all_rows * 1e3)


def _calls(args, masks, P, size, mod=pq):
    """(kernel, plain, cand) for one input set; `mod` is the wrapper
    module to call (this package's, or a comparison build's)."""
    W = args[1].shape[1]
    if masks is None:
        q = P // 2 + 1 if size is None else size
        kern = lambda: mod.pallas_quorum_commit_index(  # noqa: E731
            *args, quorum=q, window=W)
        plain = lambda: pq.quorum_commit_index_plain(  # noqa: E731
            *args, quorum=q, window=W)
        return kern, plain, tq.quorum_match_index(args[0], q)
    kw = dict(voters=masks[0], voters_joint=masks[1], window=W, size=size)
    kern = lambda: mod.pallas_masked_quorum_commit_index(  # noqa: E731
        *args, **kw)
    plain = lambda: pq.masked_quorum_commit_index_plain(  # noqa: E731
        *args, **kw)
    cand = torch.minimum(
        tq.masked_quorum_match_index(args[0], masks[0], size),
        tq.masked_quorum_match_index(args[0], masks[1], size))
    return kern, plain, cand


def _equal(kern, plain, what) -> int:
    got, want = kern(), plain()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = (got != want).nonzero()[:5].flatten().tolist()
        raise AssertionError(f"{what}: kernel != plain at rows {bad}")
    return int((got.long() - want.long()).abs().max()) if len(got) else 0


def check_kernels(card: str, dev="cuda", G=100_000) -> None:
    """K1 and K2 against their plain versions: seeded cases at G rows
    (timed at P = 3), the peer counts of both the unrolled and the
    generic kernels, and the edge cases (untimed)."""
    W = 256
    cases = [(G, P, None, None, "rand", 0) for P in (3, 5, 15)]
    cases += [(G, P, kind, size, "rand", 0)
              for P in (3, 5, 15)
              for kind in ("full", "reduced", "joint", "empty")
              for size in (None, P - 1 if P > 3 else 2)]
    cases += [(G, P, kind, None, "rand", 0)
              for P in (1, 2, 4, 7, 9, 32, 33, 64)
              for kind in (None, "joint")]
    # The fused tick's row count (P x G) with this generator's 75 %
    # leaders: phase 4 times the kernels on the tick's own tensors.
    cases += [(3 * G, 3, None, None, "rand", 0),
              (3 * G, 3, "full", None, "rand", 0)]
    edges = [(R, P, kind, size, lead, off)
             for P in (3, 33) for R in (1, 31, 4099)
             for lead in ("none", "all", "rand")
             for kind, size in ((None, None), ("joint", None),
                                ("full", P - 1))
             for off in ((0, 1) if R == 4099 else (0,))]
    # The generic kernel stages a warp's rows in the default 48 KB of
    # shared memory up to P = 383 (K1) and 255 (K2) and reads them from
    # device memory past that: both sides of both limits.
    edges += [(4099, P, kind, size, lead, 0)
              for P in (255, 256, 257, 383, 384, 385)
              for lead in ("all", "rand")
              for kind, size in ((None, None), ("joint", None),
                                 ("full", P - 1))]
    for i, (rows, P, kind, size, lead, off) in enumerate(cases + edges):
        args, masks = kernel_case(100 + i, rows, P, W, kind, dev, lead, off)
        kern, plain, cand = _calls(args, masks, P, size)
        what = (f"{'K1' if masks is None else 'K2'} R={rows} P={P} W={W} "
                f"masks={kind} size={size} leaders={lead} offset={off}")
        _equal(kern, plain, what)
        # Timed: the main path's peer count (P = 3) at G and at the
        # fused tick's rows; the other peer counts are checked only.
        if i >= len(cases) or P != 3:
            continue
        ms, plain_ms = time_ms(kern), time_ms(plain)
        bms, by, _ = bound(args, masks, cand)
        log(f"kernel {what}: equal; {ms * 1e3:.1f} us per call (device "
            f"{_us(kernel_device_us(kern))}; plain {plain_ms * 1e3:.1f} "
            f"us, bound {bms * 1e3:.2f} us by {by}) on {card}")
    log(f"kernels: {len(edges)} edge cases equal (R in 1, 31, 4099; no, "
        f"all and random leaders; misaligned views; P up to 385) on "
        f"{card}")


def main_path_kernels(card: str, captured: dict, detail=True) -> dict:
    """K1 and K2 on the tensors a main path handed them (captured in
    phase 4's fused tick, phase 5's membership node and phase 10's node
    cluster): equality, per-call (CUDA events), host and device time
    (a device time the profiler cannot catch fails the phase), the plain
    version, the bound, and (with `detail`) what bounds the kernel from
    below."""
    results = {}
    for name, (args, kw) in captured.items():
        masks = (kw["voters"], kw["voters_joint"]) if "voters" in kw \
            else None
        P = args[0].shape[1]
        size = kw.get("size") if masks is not None else kw["quorum"]
        kern, plain, cand = _calls(args, masks, P, size)
        err = _equal(kern, plain, f"{name} on the main path's tensors")
        ms, plain_ms = time_ms(kern, reps=100), time_ms(plain)
        dev_us, h_us = kernel_device_us(kern), host_us(kern)
        if dev_us is None:
            raise AssertionError(f"{name}: the profiler caught no launch "
                                 f"of the kernel in three captures")
        bms, by, all_rows_ms = bound(args, masks, cand)
        leaders = int(args[5].sum())
        log(f"main path {name}: R={args[0].shape[0]} P={P} "
            f"W={args[1].shape[1]}, {leaders} leader rows; equal; "
            f"{ms * 1e3:.1f} us per call (host {h_us:.1f} us), "
            f"device {_us(dev_us)}; plain {plain_ms * 1e3:.1f} us; bound "
            f"{bms * 1e3:.2f} us by {by} (all-rows count "
            f"{all_rows_ms * 1e3:.2f} us) on {card}")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bms, bound_by=by,
                             rows=args[0].shape[0], device_us=dev_us,
                             host_us=h_us)
        if not detail:
            continue
        # What holds it back: the same launch with no leader (every row
        # reads is_leader and commit and writes out), one warp, and the
        # wrapper's host work by part.
        follow = list(args)
        follow[5] = torch.zeros_like(args[5])
        k_none = _calls(follow, masks, P, size)[0]
        one = [a[:32] for a in args]
        k_one = _calls(one, None if masks is None else
                       tuple(m[:32] for m in masks), P, size)[0]
        log(f"main path {name}: device {_us(kernel_device_us(k_none))} "
            f"with no leader row, {_us(kernel_device_us(k_one))} for "
            f"32 rows (one warp) on {card}")
        if masks is None:
            log(f"main path {name} host parts: "
                f"{k1_host_parts(args, size)} on {card}")
    return results


# ---- phase 4 ---------------------------------------------------------------

def _np(tup):
    return convert.to_numpy(tup)


def run_ticks(cfg, st, ib, ticks, seed, record=False, ring=None):
    """`ticks` fused steps with seeded proposals; returns the state, the
    inbox, the committed-entry count and (record) every packed info.
    With `ring` (a DeviceEventRing) every tick is recorded into it, as
    the host plane's tick does with tracing on (the apply cursor a zero
    [P, G] array: this loop has no host plane)."""
    rng = np.random.default_rng(seed)
    dev = st.term.device
    # Every tick's proposals made in bulk and moved once: the loop times
    # the tick, not the host's random draws.
    props = torch.from_numpy(rng.integers(
        0, cfg.max_entries_per_msg + 1,
        (ticks, cfg.num_peers, cfg.num_groups)).astype(np.int32)).to(dev)
    infos, commit0 = [], int(st.commit[0].sum())
    applied = np.zeros((cfg.num_peers, cfg.num_groups), np.int64)
    for t, prop in enumerate(props):
        st, ib, pinfo, _busy = cluster.cluster_step_host(cfg, st, ib, prop)
        if ring is not None:
            ring.record(t, pinfo, st.votes, ib.v_type, ib.a_type, applied)
        if record:
            infos.append(pinfo.cpu().numpy())
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return st, ib, int(st.commit[0].sum()) - commit0, infos


def rss_mb() -> float:
    """This process's resident set, from /proc/self/status."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024
    raise AssertionError("no VmRSS in /proc/self/status")


def _self_device_us(e) -> float:
    return float(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)))


def profile_ticks(cfg, st, ib, card, ticks=4):
    """torch.profiler over a few ticks: the device's busy time per tick
    (the sum of its kernels' self time) against the wall time, and the
    ops that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if st.term.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    t0 = time.monotonic()
    with profile(activities=acts) as prof:
        st, ib, _, _ = run_ticks(cfg, st, ib, ticks, seed=5)
    wall = (time.monotonic() - t0) / ticks * 1e3
    # Kernel rows carry the device time once; the aten rows that
    # launched them repeat it, so busy time sums the kernel rows only.
    from torch.autograd import DeviceType
    ka = prof.key_averages()
    kern = [e for e in ka if e.device_type == DeviceType.CUDA]
    ops = [e for e in ka
           if e.device_type == DeviceType.CPU and _self_device_us(e) > 0]
    if not kern:
        log("tick profile: no device time in the trace (not measured)")
        return st, ib
    busy = sum(_self_device_us(e) for e in kern) / ticks / 1e3
    log(f"tick profile ({ticks} ticks, profiler on): wall {wall:.2f} "
        f"ms/tick, device busy {busy:.2f} ms/tick "
        f"(idle {max(0.0, 1 - busy / wall) * 100:.1f}% under the "
        f"profiler), {sum(e.count for e in kern) // ticks} kernels/tick "
        f"on {card}")
    for e in sorted(ops, key=_self_device_us, reverse=True)[:8]:
        log(f"  {_self_device_us(e) / ticks / 1e3:8.3f} ms/tick  "
            f"{e.count // ticks:4d}x  {e.key}")
    return st, ib


@contextlib.contextmanager
def spy_fused_kernel(name: str, captured: dict, want=None):
    """While open, each fused dispatch made while `want(node)` holds
    (default: always) and captured[name] is unset is run a second time,
    eagerly (`_run`), on copies of its inputs taken before it, with the
    wrapper `name` spied on: the fused runtime replays its step as a
    CUDA graph, which calls no wrapper, and phase 24 holds the graph to
    the eager chain bit for bit.  The wrapper's arguments are kept once
    some row's plain answer lies above its `commit` argument, so that a
    kernel that left commit as it was fails the check on them.  The
    second step's launches are taken back out of pq.launches."""
    from raftsql_tpu_torch.runtime.fused import FusedClusterNode
    real, wrapper = FusedClusterNode._device_step, getattr(pq, name)
    plain = pq.quorum_commit_index_plain \
        if name == "pallas_quorum_commit_index" \
        else pq.masked_quorum_commit_index_plain
    dispatches = [0]

    def step(self, prop_n, timer_inc=None):
        dispatches[0] += 1
        if name in captured or not (want is None or want(self)):
            return real(self, prop_n, timer_inc)
        st = type(self.states)(*[x.clone() for x in self.states])
        ib = type(self.inboxes)(*[x.clone() for x in self.inboxes])
        pn = torch.as_tensor(np.array(prop_n, copy=True),
                             device=self.device)
        ti = torch.ones((self.cfg.num_peers,), dtype=torch.int32,
                        device=self.device) if timer_inc is None \
            else torch.as_tensor(np.asarray(timer_inc, np.int32),
                                 device=self.device)
        out = real(self, prop_n, timer_inc)
        calls = []

        def spy(*args, **kw):
            calls.append(([a.clone() for a in args],
                          {k: v.clone() if torch.is_tensor(v) else v
                           for k, v in kw.items()}))
            return wrapper(*args, **kw)

        before = dict(pq.launches)
        setattr(pq, name, spy)
        try:
            self._run(st, ib, pn, ti)
        finally:
            setattr(pq, name, wrapper)
            pq.launches.update(before)
        for args, kw in calls:
            up = int((plain(*args, **kw) > args[3]).sum())
            if up:
                captured[name] = (args, kw)
                log(f"{name}: inputs kept from fused dispatch "
                    f"{dispatches[0]}, {up} of {args[0].shape[0]} rows "
                    f"advance commit")
                break
        return out

    FusedClusterNode._device_step = step
    try:
        yield
    finally:
        FusedClusterNode._device_step = real


def capture_tick(cfg, st, ib, name, captured):
    """One tick with the step's call of the wrapper `name` spied on: a
    copy of the tensors it was handed goes into captured[name]."""
    real = getattr(pq, name)

    def spy(*args, **kw):
        captured[name] = ([a.clone() for a in args],
                          {k: v.clone() if torch.is_tensor(v) else v
                           for k, v in kw.items()})
        return real(*args, **kw)

    setattr(pq, name, spy)
    try:
        st, ib, _, _ = run_ticks(cfg, st, ib, 1, seed=6)
    finally:
        setattr(pq, name, real)
    if name not in captured:
        raise AssertionError(f"the tick never called {name}")
    return st, ib


def fused_tick(card: str, dev="cuda", G=100_000, g=8192) -> dict:
    P, W, E = 3, 256, 32
    cfg = RaftConfig(num_groups=G, num_peers=P, log_window=W,
                     max_entries_per_msg=E, commit_rule="pallas")
    st = cluster.init_cluster_state(cfg, device=dev)
    ib = cluster.empty_cluster_inbox(cfg, device=dev)
    pq.reset_launches()                        # the main path starts here
    st, ib, _, _ = run_ticks(cfg, st, ib, 32, seed=1)   # elect leaders
    t0 = time.monotonic()
    ticks = 128
    st, ib, commits, _ = run_ticks(cfg, st, ib, ticks, seed=2)
    dt = time.monotonic() - t0
    leaders = int((st.role == 2).sum())
    log(f"fused tick G={G} P={P} W={W} E={E} pallas: "
        f"{dt / ticks * 1e3:.2f} ms/tick over {ticks} ticks, "
        f"{commits} entries committed ({commits / dt:.0f}/s), "
        f"{leaders} leaders, K1 launches "
        f"{pq.launches['pallas_quorum_commit_index']} on {card}")
    if commits <= 0 or leaders < G:
        raise AssertionError("fused tick made no progress")
    st, ib = profile_ticks(cfg, st, ib, card)
    captured = {}
    k1 = "pallas_quorum_commit_index"
    st, ib = capture_tick(cfg, st, ib, k1, captured)
    # The same tick with voter masks: Phase 7 runs K2.
    dcfg = RaftConfig(num_groups=G, num_peers=P, log_window=W,
                      max_entries_per_msg=E, commit_rule="pallas",
                      dynamic_membership=True)
    k2 = "pallas_masked_quorum_commit_index"
    st, ib = capture_tick(dcfg, st, ib, k2, captured)
    t0 = time.monotonic()
    st, ib, dcommits, _ = run_ticks(dcfg, st, ib, 64, seed=3)
    ddt = time.monotonic() - t0
    launches = dict(pq.launches)               # ... and ends here
    log(f"fused tick dynamic_membership: {ddt / 64 * 1e3:.2f} ms/tick, "
        f"{dcommits} committed, launches {launches}")
    if dcommits <= 0 or min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    del st, ib

    # Card vs CPU: the same 64 ticks, bit for bit, each side booted
    # from the same seed (the boot draws are made on the host).
    scfg = RaftConfig(num_groups=g, num_peers=P, log_window=W,
                      max_entries_per_msg=E, commit_rule="pallas")
    cst = cluster.init_cluster_state(scfg, device="cpu")
    cib = cluster.empty_cluster_inbox(scfg, device="cpu")
    gst = cluster.init_cluster_state(scfg, device=dev)
    gib = cluster.empty_cluster_inbox(scfg, device=dev)
    gst, gib, gcom, ginfo = run_ticks(scfg, gst, gib, 64, 4, record=True)
    cst, cib, ccom, cinfo = run_ticks(scfg, cst, cib, 64, 4, record=True)
    for t, (a, b) in enumerate(zip(ginfo, cinfo)):
        if not np.array_equal(a, b):
            raise AssertionError(f"card and CPU packed info differ at "
                                 f"tick {t}")
    for part, (a, b) in (("state", (_np(gst), _np(cst))),
                         ("inbox", (_np(gib), _np(cib)))):
        for k in a:
            if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]):
                raise AssertionError(f"card and CPU differ: {part}.{k}")
    log(f"card vs CPU at G={g}: 64 ticks bit-identical "
        f"({gcom} entries committed)")
    return {"ms_per_tick": dt / ticks * 1e3, "commits": commits,
            "launches": launches, "captured": captured}


def run_reduce(cfg, st, ib, T, prop):
    """`cluster_run` over T ticks, then the bench's reduction of its
    stacked infos on the device (bench.py make_bench_run): the commit
    delta, and the latency of the tick-0 proposals, the first tick at
    which each group's running commit reaches its tick-0 log length.
    Returns the state, the inbox, the infos, the first-hit ticks and the
    scalars (the only values that cross to the host)."""
    from raftsql_tpu_torch.ops.commit_scan import (commit_latency_ticks,
                                                   running_commit)
    commit0 = st.commit.amax(0)                                  # [G]
    st, ib, infos = cluster.cluster_run(cfg, st, ib, T, prop)
    ctraj = infos.commit.amax(1)                                 # [T, G]
    first = commit_latency_ticks(running_commit(ctraj),
                                 infos.new_log_len[0].amax(0))
    ok = first < T
    n_ok = int(ok.sum())
    lats = torch.sort(torch.where(ok, (first + 1).float(),
                                  torch.inf)).values
    q = [float(lats[min(max(int(p * (n_ok - 1)), 0), len(lats) - 1)])
         if n_ok else float("inf") for p in (0.5, 0.99)]
    return st, ib, infos, first, {
        "committed": int((ctraj[-1] - commit0).sum()), "n_ok": n_ok,
        "p50_ticks": q[0], "p99_ticks": q[1]}


def run_path(card: str, dev="cuda", G=100_000, T=32, g=8192) -> dict:
    """The bench's device helpers at its saturated headline shape
    (bench.py bench_throughput: G = 100,000, P = 3, W = 256, E = 32,
    commit_rule="pallas", T = 32 ticks a cluster_run): the warm-up runs
    at zero load (4 election intervals), then one cluster_run at E
    proposals a group a tick with K1's count zeroed just before and read
    just after (it must launch exactly T times), its stacked [T, P, G]
    infos reduced on the card by running_commit and
    commit_latency_ticks; one more run with the first K1 call's inputs
    copied (R = 300,000).  Then a card run and a CPU run of the same
    warm-up and loaded cluster_run + reduction at G = g, each booted
    from one seed, must be bit-identical: every info leaf of every tick,
    the final states and inboxes, the first-hit ticks and the scalars."""
    P, W, E = 3, 256, 32
    cfg = RaftConfig(num_groups=G, num_peers=P, log_window=W,
                     max_entries_per_msg=E, commit_rule="pallas")
    k1 = "pallas_quorum_commit_index"
    t_in = time.monotonic()

    def warm(c, st, ib, d):
        zero = torch.zeros((T, P, c.num_groups), dtype=torch.int32,
                           device=d)
        for _ in range(max(1, -(-4 * c.election_ticks // T))):
            st, ib, _ = cluster.cluster_run(c, st, ib, T, zero)
        return st, ib

    st = cluster.init_cluster_state(cfg, device=dev)
    ib = cluster.empty_cluster_inbox(cfg, device=dev)
    st, ib = warm(cfg, st, ib, dev)
    full = torch.full((T, P, G), E, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    pq.reset_launches()                        # the run path starts here
    t0 = time.monotonic()
    st, ib, infos, _, got = run_reduce(cfg, st, ib, T, full)
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = pq.launches[k1]                 # ... and ends here
    mib = sum(x.numel() * x.element_size() for x in infos) / 2**20
    log(f"cluster_run G={G} P={P} W={W} E={E} pallas T={T}: "
        f"{dt / T * 1e3:.2f} ms/tick with the on-card reduction, "
        f"{got['committed']} entries committed ({got['committed'] / dt:.0f}"
        f"/s), tick-0 latency p50 {got['p50_ticks']:.0f} p99 "
        f"{got['p99_ticks']:.0f} ticks over {got['n_ok']} of {G} groups; "
        f"stacked infos {mib:.0f} MiB; K1 launches {launches} on {card}")
    expect(launches, T, "K1 launches in one cluster_run of T ticks")
    if got["committed"] <= 0 or got["n_ok"] < G:
        raise AssertionError(f"cluster_run made no progress: {got}")
    del infos
    captured = {}
    real = getattr(pq, k1)

    def spy(*args, **kw):
        if k1 not in captured:
            captured[k1] = ([a.clone() for a in args], dict(kw))
        return real(*args, **kw)

    setattr(pq, k1, spy)
    try:
        st, ib, _, _, _ = run_reduce(cfg, st, ib, 1, full[:1])
    finally:
        setattr(pq, k1, real)
    if k1 not in captured:
        raise AssertionError("cluster_run never called K1")
    del st, ib, full

    # Card vs CPU at G = g: warm-up and one loaded run from one seed.
    scfg = dataclasses.replace(cfg, num_groups=g)
    out = {}
    for d in (dev, "cpu"):
        s0 = cluster.init_cluster_state(scfg, seed=7, device=d)
        i0 = cluster.empty_cluster_inbox(scfg, device=d)
        s0, i0 = warm(scfg, s0, i0, d)
        prop = torch.from_numpy(np.random.default_rng(8).integers(
            0, E + 1, (T, P, g)).astype(np.int32)).to(d)
        s0, i0, inf, first, sc = run_reduce(scfg, s0, i0, T, prop)
        out[d] = (_np(s0), _np(i0), _np(inf), first.cpu().numpy(), sc)
    for part, i in (("state", 0), ("inbox", 1), ("infos", 2)):
        a, b = out[dev][i], out["cpu"][i]
        for k in a:
            if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]):
                raise AssertionError(f"cluster_run card and CPU differ: "
                                     f"{part}.{k}")
    if not np.array_equal(out[dev][3], out["cpu"][3]) \
            or out[dev][4] != out["cpu"][4]:
        raise AssertionError(f"K8 card and CPU differ: {out[dev][4]} "
                             f"!= {out['cpu'][4]}")
    log(f"cluster_run + K8 card vs CPU at G={g}: bit-identical "
        f"({out['cpu'][4]}); the run path took "
        f"{time.monotonic() - t_in:.1f} s")
    return {"ms_per_tick": dt / T * 1e3, "launches": launches,
            "captured": captured, **got}


def traced_tick(card: str, dev="cuda", G=100_000, ticks=64,
                node_ticks=4, node_G=10_000) -> dict:
    """The event ring's cost at G = 100,000.  First on phase 4's fused
    tick: blocks of `ticks` ticks without and with a DeviceEventRing
    record per tick (one full drain per traced block), in turns.  Then
    on the durable node (FusedClusterNode: the fused tick plus the host
    plane, idle after the elections, on native WALs) without and with
    enable_tracing, in turns, `node_ticks` a block.  And the ring's slot
    write alone (CUDA events) and one drain of the full ring.  After
    each of the three 64-slot drains the host history's rows and bytes
    and this process's RSS are logged: the bytes must stay within the
    ring's byte budget (DEFAULT_BUDGET_BYTES: 24 rows of 10.8 MB here)
    and the RSS growth within the budget plus one drain's block.  The
    durable node runs at node_G = 10,000, as phase 5 does: at G =
    100,000 its elections took 52.1 s on native WALs too (the staging
    and payload-log work per row stay in Python), 14.6 s at 25,000; the
    whole script must stay under its time limit with the mesh and pod
    phases."""
    from raftsql_tpu_torch.obs.device_ring import (DEFAULT_BUDGET_BYTES,
                                                   DeviceEventRing,
                                                   _record_slot)
    from raftsql_tpu_torch.runtime.fused import FusedClusterNode
    cfg = RaftConfig(num_groups=G, num_peers=3, log_window=256,
                     max_entries_per_msg=32, commit_rule="pallas")
    P = cfg.num_peers
    st = cluster.init_cluster_state(cfg, device=dev)
    ib = cluster.empty_cluster_inbox(cfg, device=dev)
    st, ib, _, _ = run_ticks(cfg, st, ib, 32, seed=1)     # elect leaders
    ring = DeviceEventRing(P, G, device=dev)
    loop = {"off": [], "on": []}
    # The host history's bytes and this process's RSS after each drain
    # (a traced block of `ticks` = depth ticks ends in one).
    rss0, drains = rss_mb(), []

    def after_drain():
        drains.append((len(ring), ring.history_bytes(), rss_mb()))
        n, b, r = drains[-1]
        log(f"ring at G={G}: drain {ring.drains}: history {n} rows, "
            f"{b / 2**20:.1f} MiB (budget {DEFAULT_BUDGET_BYTES / 2**20:.0f}"
            f" MiB, {ring.capacity} rows), RSS {r:.0f} MiB "
            f"(+{r - rss0:.0f} MiB) on {card}")

    for i, mode in enumerate(("off", "on", "off", "on")):
        t0 = time.monotonic()
        st, ib, _, _ = run_ticks(cfg, st, ib, ticks, seed=10 + i,
                                 ring=ring if mode == "on" else None)
        loop[mode].append((time.monotonic() - t0) / ticks * 1e3)
        if mode == "on":
            after_drain()
    if len(ring) != min(2 * ticks, ring.capacity) or ring.drains != 2:
        raise AssertionError(f"ring: {len(ring)} rows, {ring.drains} "
                             f"drains after {2 * ticks} traced ticks")
    app = torch.zeros((P, G), dtype=torch.int32, device=dev)
    pinfo = cluster.cluster_step_host(
        cfg, st, ib, torch.zeros((P, G), dtype=torch.int32,
                                 device=dev))[2]
    rec_ms = time_ms(lambda: _record_slot(
        ring._ring, 0, 0, pinfo, st.votes, ib.v_type, ib.a_type, app))
    rec_dev = kernel_device_us(lambda: _record_slot(
        ring._ring, 0, 0, pinfo, st.votes, ib.v_type, ib.a_type, app),
        name=None)
    ring._slot = ring.depth
    t0 = time.monotonic()
    ring.drain()
    drain_ms = (time.monotonic() - t0) * 1e3
    after_drain()
    block = ring.depth * ring.row_bytes / 2**20
    for n, b, r in drains:
        if b > DEFAULT_BUDGET_BYTES or r - rss0 > \
                DEFAULT_BUDGET_BYTES / 2**20 + block:
            raise AssertionError(
                f"ring history {b} B (budget {DEFAULT_BUDGET_BYTES}), RSS "
                f"growth {r - rss0:.0f} MiB (limit: the budget plus one "
                f"{block:.0f} MiB drain block)")
    mb = ring._ring.numel() * 4 / 1e6
    fmt = lambda xs: ", ".join(f"{x:.2f}" for x in xs)  # noqa: E731
    log(f"ring at G={G}: fused tick {statistics.mean(loop['off']):.2f} "
        f"ms/tick without the ring ({fmt(loop['off'])}), "
        f"{statistics.mean(loop['on']):.2f} with a record per tick "
        f"({fmt(loop['on'])}), {ticks} ticks a block in turns; ring "
        f"{list(ring._ring.shape)} int32 ({mb:.1f} MB): slot write "
        f"{rec_ms * 1e3:.1f} us per call, {_us(rec_dev)} of device time, "
        f"one full drain {drain_ms:.1f} ms on {card}")
    del st, ib, ring, pinfo

    d = os.path.join(ROOT, "build", "chip_smoke_ring")
    shutil.rmtree(d, ignore_errors=True)
    G = node_G
    node = FusedClusterNode(dataclasses.replace(cfg, num_groups=G), d,
                            device=dev)
    try:
        wals = node.wals
        expect([w.is_native for w in wals], [True] * len(wals),
               "the traced node's WALs are native")
        t0, n = time.monotonic(), 0
        while (node._hints < 0).any() and n < 300:
            node.tick()
            n += 1
        node.publish_flush()
        if (node._hints < 0).any():
            raise AssertionError(f"{G} groups not elected in {n} ticks")
        log(f"traced node: {G} groups elected in {n} ticks "
            f"({time.monotonic() - t0:.1f} s) on native WALs")

        def block():
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for _ in range(node_ticks):
                node.tick()
            node.publish_flush()
            torch.cuda.synchronize()
            return (time.monotonic() - t0) / node_ticks * 1e3

        m = node.metrics
        m0 = (m.ticks, m.t_device_ms, m.t_wal_ms, m.t_publish_ms)
        off = [block()]
        node.enable_tracing()
        saved = node.tracer, node.ring
        on = [block()]
        # In turns: the same node with the hooks detached, then again.
        node.tracer = node.ring = None
        off.append(block())
        node.tracer, node.ring = saved
        on.append(block())
        node.ring.drain()
        if len(node.ring) != 2 * node_ticks:
            raise AssertionError(f"node ring holds {len(node.ring)} rows "
                                 f"after {2 * node_ticks} traced ticks")
        n = max(m.ticks - m0[0], 1)
        log(f"traced node G={G}: {statistics.mean(off):.2f} ms/tick "
            f"without enable_tracing ({fmt(off)}), "
            f"{statistics.mean(on):.2f} with ({fmt(on)}), {node_ticks} "
            f"ticks a block in turns; per tick over all blocks: device "
            f"(dispatch + readback) {(m.t_device_ms - m0[1]) / n:.2f} ms, "
            f"WAL + fsync {(m.t_wal_ms - m0[2]) / n:.2f} ms, publish "
            f"{(m.t_publish_ms - m0[3]) / n:.2f} ms on {card}")
        return {"loop": loop, "node_off": off, "node_on": on,
                "record_ms": rec_ms, "drain_ms": drain_ms,
                "drains": drains, "rss0": rss0}
    finally:
        node.stop()
        shutil.rmtree(d, ignore_errors=True)


# ---- phase 5 ---------------------------------------------------------------

def membership_node(card: str, dev="cuda", G=10_000, n=64) -> dict:
    """The membership and transfer planes: a durable FusedClusterNode of
    G groups on 4 slots, voters {0,1,2}
    and a live spare slot 3 (the JAX package's node-replacement layout),
    commit_rule="pallas".  After the elections, slot 0 is replaced by
    slot 3 (add_learner 3, promote 3, remove 0, each change through
    joint consensus where it moves a vote) on `n` groups spread over the
    range, while leadership moves on `n` other groups.  K2 must launch
    on every tick after enable_membership (and K1 on none); its inputs
    are copied on the first tick with joint masks live whose K2 call
    advances some row's commit, for the kernel-vs-plain check and
    timing on them."""
    from raftsql_tpu_torch.chaos.scenarios import _drain_fused_q
    from raftsql_tpu_torch.membership import MembershipError
    from raftsql_tpu_torch.runtime.fused import FusedClusterNode
    cfg = RaftConfig(num_groups=G, num_peers=4, log_window=256,
                     max_entries_per_msg=32, commit_rule="pallas",
                     initial_voters=(0, 1, 2))
    k1, k2 = "pallas_quorum_commit_index", \
        "pallas_masked_quorum_commit_index"
    d = os.path.join(ROOT, "build", "chip_smoke_members")
    shutil.rmtree(d, ignore_errors=True)
    node = FusedClusterNode(cfg, d, device=dev)
    node.publish_peers = {0}
    captured = {}
    spying = contextlib.ExitStack()
    ticks = [0]

    def tick():
        node.tick()
        node.publish_flush()
        _drain_fused_q(node.commit_q(0))
        ticks[0] += 1

    try:
        pq.reset_launches()                  # this path starts here
        t0 = time.monotonic()
        node.enable_membership()
        t_enable = time.monotonic() - t0
        spying.enter_context(spy_fused_kernel(
            k2, captured, lambda n: bool(n.membership.joint_groups)))
        t0 = time.monotonic()
        while (node._hints < 0).any() and ticks[0] < 300:
            tick()
        if (node._hints < 0).any():
            raise AssertionError(f"{G} groups not elected in {ticks[0]} "
                                 f"ticks")
        t_elect, n_elect = time.monotonic() - t0, ticks[0]
        mm = node.membership
        step = G // n
        repl = [i * step for i in range(n)]
        xfer = {}
        for i in range(n):
            g = i * step + step // 2
            lead = node.leader_of(g)
            xfer[g] = next(p for p in (0, 1, 2) if p != lead)
            node.transfer_leadership(g, xfer[g])
        # add_learner 3 -> promote 3 -> remove 0, one change in flight
        # per group: each is issued once the previous one has applied.
        ops = (("add_learner", 3), ("promote", 3), ("remove", 0))
        ready = (lambda c: True, lambda c: c.learners == 0b1000,
                 lambda c: c.voters == 0b1111)
        stage = dict.fromkeys(repl, 0)
        t0, m0 = time.monotonic(), ticks[0]
        while ticks[0] - m0 < 400:
            for g in repl:
                c = mm.config(g)
                k = stage[g]
                if k < 3 and not c.is_joint and ready[k](c):
                    try:
                        node.member_change(g, *ops[k])
                        stage[g] += 1
                    except MembershipError:
                        pass                 # still in flight: next tick
            done = (all(k == 3 and mm.config(g).voters == 0b1110
                        and not mm.config(g).is_joint
                        for g, k in stage.items())
                    and all(node.leader_of(g) == t for g, t in xfer.items())
                    and not node.transferring_groups())
            if done:
                break
            tick()
        t_ops, n_ops = time.monotonic() - t0, ticks[0] - m0
        spying.close()
        launches = dict(pq.launches)         # ... and ends here
        if not done:
            raise AssertionError(
                f"membership ops unfinished after {n_ops} ticks: stages "
                f"{sorted(set(stage.values()))}, transfers in flight "
                f"{len(node.transferring_groups())}")
        doc = node.members_doc()["groups"]
        for g in range(G):
            want = [1, 2, 3] if g in stage else [0, 1, 2]
            if doc[str(g)]["voters"] != want or doc[str(g)]["joint"]:
                raise AssertionError(f"g{g}: config {doc[str(g)]}, want "
                                     f"voters {want}")
        for g, t in xfer.items():
            expect(doc[str(g)]["leader"], t + 1, f"g{g} leader")
        outcomes = [e["outcome"] for e in node.transfers_doc()["recent"]]
        expect(outcomes.count("completed"), n, "completed transfers")
        expect(launches, {k1: 0, k2: ticks[0]},
               "K2 on every tick after enable_membership, K1 on none")
        if k2 not in captured:
            raise AssertionError("no tick ran K2 with joint masks live")
        v, j = captured[k2][1]["voters"], captured[k2][1]["voters_joint"]
        joint_rows = int((v != j).any(1).sum())
        if not joint_rows:
            raise AssertionError("captured K2 masks are not joint")
        log(f"membership node G={G} P=4 W=256 E=32 pallas: "
            f"enable_membership {t_enable:.1f} s; elected in {n_elect} "
            f"ticks ({t_elect / n_elect * 1e3:.2f} ms/tick); {n} "
            f"replacements (slot 0 -> 3) and {n} transfers finished in "
            f"{n_ops} ticks ({t_ops / max(n_ops, 1) * 1e3:.2f} ms/tick, "
            f"{t_ops:.1f} s); {node.metrics.conf_changes_applied} conf "
            f"changes applied; K2 launches {launches[k2]} on "
            f"{ticks[0]} ticks, K1 {launches[k1]}; K2 inputs copied on a "
            f"tick with {joint_rows} joint rows on {card}")
        return {"launches": launches, "captured": captured,
                "ms_per_tick": t_ops / max(n_ops, 1) * 1e3}
    finally:
        spying.close()
        node.stop()
        shutil.rmtree(d, ignore_errors=True)


# ---- phase 6 ---------------------------------------------------------------

def _req(port, method, body=b"", group=0, path="/"):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request(method, path, body=body,
                  headers={"X-Raft-Group": str(group)})
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def recipe(port, groups, what) -> None:
    """The reference curl recipe at `port`, in every group."""
    for g in range(groups):
        expect(_req(port, "PUT", b"CREATE TABLE main.t (name text)", g),
               (204, b""), f"{what}: CREATE g{g}")
        expect(_req(port, "PUT",
                    b'INSERT INTO main.t (name) VALUES ("abc")', g),
               (204, b""), f"{what}: INSERT g{g}")
        expect(_req(port, "GET", b"SELECT * FROM main.t", g),
               (200, b"|abc|\n"), f"{what}: SELECT g{g}")
    expect(_req(port, "POST", b"SELECT 1")[0], 405, f"{what}: POST")
    expect(_req(port, "PUT", b"NOT SQL")[0], 400, f"{what}: bad SQL")


def _serve(groups, dev, trace=False, witnesses=()):
    from raftsql_tpu_torch.api.aio import AioSQLServer
    from raftsql_tpu_torch.server.main import build_fused_node
    rdb = build_fused_node(groups=groups, peers=3, resume=True,
                           data_prefix=os.path.join(DATA, "raftsql"),
                           commit_rule="pallas", trace=trace,
                           witnesses=witnesses, device=dev)
    srv = AioSQLServer(_free_port(), rdb, host="127.0.0.1")
    srv.start()
    return rdb, srv


def put_load(rdb, port, groups, card, what, threads=16, per=25,
             on=None) -> tuple:
    """`threads` clients PUT `per` unique rows each across the groups `on`
    (default all; concurrently), then the row counts of every group are
    read back; logs the per-tick split and the propose->ack p50/p99.
    Returns (the acked (group, query) pairs, p50 ms, p99 ms)."""
    on = list(range(groups)) if on is None else list(on)
    def rows():
        n = 0
        for g in range(groups):
            st, body = _req(port, "GET", b"SELECT count(*) FROM main.t", g)
            expect(st, 200, f"count g{g}")
            n += int(body.strip().strip(b"|"))
        return n

    rows0 = rows()
    lat, errs, acked = [], [], []
    mu = threading.Lock()

    def client(i):
        for k in range(per):
            g = on[(i + k) % len(on)]
            q = f'INSERT INTO main.t (name) VALUES ("{what}-c{i}-{k}")'
            t0 = time.monotonic()
            s, b = _req(port, "PUT", q.encode(), g)
            with mu:
                lat.append(time.monotonic() - t0)
                if s != 204:
                    errs.append((s, b))
                else:
                    acked.append((g, q))

    m = rdb.pipe.node.metrics
    m0 = (m.ticks, m.t_device_ms, m.t_wal_ms, m.t_publish_ms,
          time.monotonic())
    ths = [threading.Thread(target=client, args=(i,))
           for i in range(threads)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    n = max(m.ticks - m0[0], 1)
    log(f"{what} ticks during the PUTs: {n}, per tick: wall "
        f"{(time.monotonic() - m0[4]) * 1e3 / n:.2f} ms, device "
        f"(dispatch + readback) {(m.t_device_ms - m0[1]) / n:.2f} ms, "
        f"WAL + fsync {(m.t_wal_ms - m0[2]) / n:.2f} ms, publish "
        f"{(m.t_publish_ms - m0[3]) / n:.2f} ms")
    expect(errs, [], f"{what}: concurrent PUTs")
    expect(rows(), rows0 + threads * per, f"{what}: rows")
    lat.sort()
    p50 = lat[len(lat) // 2] * 1e3
    p99 = lat[int(len(lat) * 0.99)] * 1e3
    log(f"{what}: {len(lat)} PUTs from {threads} threads acked and read "
        f"back; propose->ack p50 {p50:.2f} ms p99 {p99:.2f} ms on {card}")
    return acked, p50, p99


def server(card: str, dev="cuda") -> int:
    groups = 8
    shutil.rmtree(DATA, ignore_errors=True)
    os.makedirs(DATA)
    k1 = "pallas_quorum_commit_index"
    base = pq.launches[k1]
    rdb, srv = _serve(groups, dev)
    try:
        port = srv.port
        wals = rdb.pipe.node.wals
        expect([w.is_native for w in wals], [True] * len(wals),
               "the server's WALs are native")
        recipe(port, groups, "server")
        put_load(rdb, port, groups, card, "server")
    finally:
        srv.stop()
        err = rdb.close()
    expect(err, None, "close")
    rdb, srv = _serve(groups, dev)             # resume: replay the WALs
    try:
        rows = 0
        for g in range(groups):
            st, body = _req(srv.port, "GET", b"SELECT count(*) FROM main.t",
                            g)
            rows += int(body.strip().strip(b"|"))
        expect(rows, groups + 16 * 25, "rows after reopen")
        expect(_req(srv.port, "PUT", b'INSERT INTO main.t (name) VALUES '
                    b'("again")')[0], 204, "PUT after reopen")
    finally:
        srv.stop()
        err = rdb.close()
    expect(err, None, "close after reopen")
    grew = pq.launches[k1] - base
    if grew <= 0:
        raise AssertionError("the server never launched K1")
    log(f"server: {len(wals)} native WALs; reopen replayed them, rows "
        f"intact; K1 launches {grew} during the phase")
    shutil.rmtree(DATA, ignore_errors=True)
    return grew


# ---- phase 7 ---------------------------------------------------------------

def traced_server(card: str, dev="cuda") -> None:
    """Phase 5's server with tracing on: the PUT load again, then GET
    /trace (Perfetto schema) and GET /events (device rows and one full
    propose-to-ack span per acked PUT)."""
    from collections import Counter

    from raftsql_tpu_torch.obs.export import validate_chrome_trace
    groups = 8
    shutil.rmtree(DATA, ignore_errors=True)
    os.makedirs(DATA)
    rdb, srv = _serve(groups, dev, trace=True)
    try:
        port = srv.port
        create = "CREATE TABLE main.t (name text)"
        for g in range(groups):
            expect(_req(port, "PUT", create.encode(), g), (204, b""),
                   f"traced CREATE g{g}")
        acked, _, _ = put_load(rdb, port, groups, card, "traced server")
        acked += [(g, create) for g in range(groups)]
        st, body = _req(port, "GET", path="/trace")
        expect(st, 200, "GET /trace")
        doc = json.loads(body)
        validate_chrome_trace(doc)
        n_ev = len(doc["traceEvents"])
        st, body = _req(port, "GET", path="/events")
        expect(st, 200, "GET /events")
        ev = json.loads(body)
        expect(ev["tracing"], True, "/events tracing")
        if not ev["device"]:
            raise AssertionError("/events: no device rows")
        phases = {"propose", "append", "replicate", "commit", "apply",
                  "ack"}
        full = Counter((s["group"], s["key"]) for s in ev["host"]["spans"]
                       if phases <= set(s["phases"]))
        expect(full, Counter(acked), "one full span per acked PUT")
        log(f"traced server: GET /trace valid ({n_ev} events), GET "
            f"/events {len(ev['device'])} device rows, {len(acked)} full "
            f"propose->ack spans for {len(acked)} acked PUTs")
    finally:
        srv.stop()
        err = rdb.close()
    expect(err, None, "traced close")
    shutil.rmtree(DATA, ignore_errors=True)


# ---- phase 8 ---------------------------------------------------------------

def _transfer(port, group, target):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request("POST", "/transfer", body=json.dumps(
            {"group": group, "target": target}).encode())
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def _until(pred, what, timeout_s=60.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError(f"{what}: not within {timeout_s} s")
        time.sleep(0.01)


def placement_server(card: str, dev="cuda", groups=8) -> dict:
    """The --fused --placement server (8 groups x 3 peers, aio): POST
    /transfer moves a leader (200) and refuses a transfer in flight, a
    target that already leads and, on a second short start with --witness
    2, a witness target (400).  Then skewed PUT load (every write on the
    groups one peer leads) with placement off and on, in turns on the same
    server: placement must complete a transfer, and every acked PUT is
    read back."""
    from raftsql_tpu_torch.server.main import attach_placement
    shutil.rmtree(DATA, ignore_errors=True)
    os.makedirs(DATA)
    k1 = "pallas_quorum_commit_index"
    base = pq.launches[k1]                    # this path starts here
    rdb, srv = _serve(groups, dev)
    node, pc, lat = rdb.pipe.node, None, {}
    try:
        port = srv.port
        for g in range(groups):
            expect(_req(port, "PUT", b"CREATE TABLE main.t (name text)",
                        g), (204, b""), f"CREATE g{g}")
        lead = node.leader_of(0)
        target = (lead + 1) % 3
        st, body = _transfer(port, 0, target)
        expect(st, 200, f"POST /transfer: {body!r}")
        st, body = _transfer(port, 0, (lead + 2) % 3)
        expect((st, b"in flight" in body), (400, True), "transfer in flight")
        _until(lambda: node.leader_of(0) == target
               and not node.transferring_groups(), "transfer to a follower")
        st, body = _transfer(port, 0, target)
        expect((st, b"already leads" in body), (400, True),
               "transfer to the leader")
        log(f"placement server: POST /transfer moved group 0 from peer "
            f"{lead + 1} to {target + 1} (200); in-flight and "
            f"already-leads requests refused (400)")
        acked = []
        for i, mode in enumerate(("off", "on", "on", "off")):
            if mode == "on" and pc is None:
                pc = attach_placement(rdb, interval_s=0.2)
            elif mode == "off" and pc is not None:
                pc.stop()
                pc = rdb.placement = None
            leads = [node.leader_of(g) for g in range(groups)]
            hot = max(range(3), key=leads.count)
            on = [g for g in range(groups) if leads[g] == hot]
            done0 = node.metrics.transfers_completed
            a, p50, p99 = put_load(rdb, port, groups, card,
                                   f"placement {mode} (run {i + 1})",
                                   on=on)
            acked += a
            lat.setdefault(mode, []).append((p50, p99))
            if mode == "on":
                _until(lambda: node.metrics.transfers_completed > done0,
                       "placement never completed a transfer")
                log(f"placement on: {pc.issued} transfers issued, "
                    f"{node.metrics.transfers_completed - done0} completed "
                    f"during the load on peer {hot + 1}'s {len(on)} "
                    f"groups; metrics {rdb.metrics()['placement']}")
        for g in range(groups):
            st, body = _req(port, "GET", b"SELECT name FROM main.t", g)
            expect(st, 200, f"read back g{g}")
            got = set(body.decode().split("\n"))
            for q in (q for (ag, q) in acked if ag == g):
                name = q.rsplit('"', 2)[1]
                if f"|{name}|" not in got:
                    raise AssertionError(f"acked PUT {q!r} on g{g} lost")
        log(f"placement server: {len(acked)} acked PUTs read back; "
            f"p50/p99 ms with placement off "
            f"{[(round(a, 2), round(b, 2)) for a, b in lat['off']]}, on "
            f"{[(round(a, 2), round(b, 2)) for a, b in lat['on']]} on "
            f"{card}")
    finally:
        if pc is not None:
            pc.stop()
        srv.stop()
        err = rdb.close()
    expect(err, None, "placement close")
    lat["launches"] = pq.launches[k1] - base  # ... and ends here
    if lat["launches"] <= 0:
        raise AssertionError("the placement server never launched K1")
    shutil.rmtree(DATA, ignore_errors=True)
    os.makedirs(DATA)
    rdb, srv = _serve(2, dev, witnesses=(2,))
    try:
        node = rdb.pipe.node
        _until(lambda: (node._hints >= 0).all(), "witness cluster elected")
        st, body = _transfer(srv.port, 0, 2)
        expect((st, b"witness" in body), (400, True), "witness target")
        log("placement server --witness 2: transfer to the witness slot "
            "refused (400)")
    finally:
        srv.stop()
        err = rdb.close()
    expect(err, None, "witness close")
    shutil.rmtree(DATA, ignore_errors=True)
    return lat


# ---- phase 9 ---------------------------------------------------------------

def side_job(name: str, out: str, dev="cuda") -> int:
    """A part of a phase run as a process of its own beside the rest of
    the phase (`chip_smoke.py --side NAME --side-out PATH`), its result
    JSON at `out`: "families", the five fused families, and
    "falsify", the falsification pairs of the reads, quorum and
    transfers gauntlets (phase 9); "snapshot", the snapshot node family
    with its K1 and K2 launches, and "tcp", the tcp and tcp_rebind node
    families (phase 12); "unrepaired", the JAX package's unrepaired
    reshard falsification pair (phase 23).  Each runs a seeded plan in
    lockstep, so a process of its own changes no digest; a job's
    launches are counted in its process and reported."""
    from raftsql_tpu_torch.chaos import run as crun
    pq.build()
    res = {}
    if name == "families":
        for fam, (gen, fired) in crun.family_specs().items():
            if fam in ("reads", "quorum", "transfers"):
                continue
            t0 = time.monotonic()
            r = crun.run_fused(gen(0), device=dev)
            res[fam] = {"digests": [r["schedule_digest"],
                                    r["result_digest"]],
                        "fired": bool(fired(r)),
                        "wall": time.monotonic() - t0}
    elif name == "snapshot":
        fired = crun.node_family_specs()["snapshot"][3]
        pq.reset_launches()
        runs = []
        for _ in range(RUNS):
            t0 = time.monotonic()
            r = crun.run_node("snapshot", 0, device=dev,
                              commit_rule="pallas")
            runs.append({"report": r, "fired": bool(fired(r)),
                         "wall": time.monotonic() - t0})
        res = {"runs": runs, "launches": dict(pq.launches)}
    elif name == "unrepaired":
        from raftsql_tpu_torch.chaos import schedule as S
        t0 = time.monotonic()
        for broken in (True, False):
            plan = S.falsification_reshard_plan(0, broken, repaired=False)
            r = crun.run_fused(plan, device=dev, commit_rule="pallas")
            res["broken" if broken else "control"] = r["result_digest"]
        res["wall"] = time.monotonic() - t0
    elif name == "falsify":
        for fam in ("reads", "quorum", "transfers"):
            t0 = time.monotonic()
            ok = crun.run_falsification(fam, 0, device=dev,
                                        commit_rule="pallas")
            res[fam] = {"ok": bool(ok), "wall": time.monotonic() - t0}
    elif name == "tcp":
        specs = crun.node_family_specs()
        for fam in ("tcp", "tcp_rebind"):
            t0 = time.monotonic()
            r = crun.run_node(fam, 0, device=dev, commit_rule="pallas")
            res[fam] = {"report": r, "fired": bool(specs[fam][3](r)),
                        "wall": time.monotonic() - t0}
    else:
        raise SystemExit(f"unknown side job {name!r}")
    with open(out + ".tmp", "w") as f:
        json.dump(res, f, default=str)
    os.replace(out + ".tmp", out)
    return 0


def _side_start(name: str):
    """Start side job `name`; returns its handle for _side_finish."""
    work = os.path.join(ROOT, "build", "chip_smoke_side")
    os.makedirs(work, exist_ok=True)
    out = os.path.join(work, f"{name}.json")
    logp = os.path.join(work, f"{name}.log")
    for f in (out, logp):
        if os.path.exists(f):
            os.remove(f)
    with open(logp, "ab") as logf:
        p = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--side", name,
             "--side-out", out], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=ROOT), stdout=logf,
            stderr=subprocess.STDOUT)
    return name, p, out, logp


def _side_kill(job) -> None:
    """Stop a side job that is still running (a phase that failed)."""
    p = job[1]
    if p.poll() is None:
        p.kill()
        p.wait()


def _side_finish(job, timeout=600) -> dict:
    """Wait for a side job; its log joins this one, then its result."""
    name, p, out, logp = job
    try:
        rc = p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        rc = p.wait()
    with open(logp, errors="replace") as f:
        text = f.read().strip()
    if text:
        log(text)
    if rc != 0:
        raise AssertionError(f"side job {name} exited {rc}")
    with open(out) as f:
        return json.load(f)


def chaos(card: str, dev="cuda") -> dict:
    """The seed-0 chaos digests on the card: the default family with
    commit_rule="pallas", then each fused family, then the read, quorum
    and transfer nemesis families with commit_rule="pallas" (K1's
    launch count zeroed just before those runs and read just after,
    twice: the default's and the nemesis families'), each `RUNS` times,
    and meanwhile, each in a process of its own (side_job "families"
    and "falsify"), the five fused families and the falsification pairs
    of those three gauntlets, which must be caught.
    Returns the wall time of each run in seconds and the K1 launches of
    each path."""
    sides = [_side_start("families"), _side_start("falsify")]
    try:
        return _chaos_runs(card, dev, sides)
    finally:
        for side in sides:
            _side_kill(side)


def _chaos_runs(card, dev, sides) -> dict:
    from raftsql_tpu_torch.analysis.tripwire import SignatureTripwire
    from raftsql_tpu_torch.chaos import run as crun
    from raftsql_tpu_torch.chaos.schedule import generate
    k1 = "pallas_quorum_commit_index"
    walls, launches = {}, {}
    pq.reset_launches()                       # the chaos path starts here
    tripwire = SignatureTripwire()
    for i in range(RUNS):
        t0 = time.monotonic()
        r = crun.run_fused(generate(0, ticks=240), device=dev,
                           commit_rule="pallas")
        walls[f"default#{i + 1}"] = time.monotonic() - t0
        got = (r["schedule_digest"], r["result_digest"])
        log(f"chaos default run {i + 1}: schedule={got[0]} "
            f"result={got[1]} ({r['committed_entries']} committed, "
            f"{r['crashes']} crashes, {r['torn_writes']} torn, "
            f"{r['fsync_faults']} fsync faults) "
            f"{walls[f'default#{i + 1}']:.2f} s on {card}")
        expect(got, CHAOS_DIGESTS["default"], "chaos default digests")
    launches["default"] = pq.launches[k1]     # ... and ends here
    tripwire.disarm()
    sigs = {k: v for k, v in tripwire.compiles().items() if v > 0}
    log(f"signature-tripwire: {json.dumps(sigs, sort_keys=True)}")
    tripwire.check()
    expect(sigs, {"cluster_step_host": 1}, "the default run's signatures")
    if launches["default"] <= 0:
        raise AssertionError("the chaos runs never launched K1")
    log(f"chaos default: K1 launches {launches['default']} over {RUNS} "
        f"run(s)")
    nemesis = ("reads", "quorum", "transfers")
    specs = crun.family_specs()
    pq.reset_launches()                       # the nemesis path starts here
    for name in nemesis:
        gen, fired = specs[name]
        for i in range(RUNS):
            t0 = time.monotonic()
            r = crun.run_fused(gen(0), device=dev, commit_rule="pallas")
            walls[f"{name}#{i + 1}"] = time.monotonic() - t0
            got = (r["schedule_digest"], r["result_digest"])
            log(f"chaos {name} run {i + 1}: schedule={got[0]} "
                f"result={got[1]} {walls[f'{name}#{i + 1}']:.2f} s on "
                f"{card}")
            expect(got, CHAOS_DIGESTS[name], f"chaos {name} digests")
            if not fired(r):
                raise AssertionError(f"chaos {name}: its faults never "
                                     f"fired ({r})")
    launches["nemesis"] = pq.launches[k1]     # ... and ends here
    if launches["nemesis"] <= 0:
        raise AssertionError("the nemesis families never launched K1")
    log(f"chaos nemesis families: K1 launches {launches['nemesis']} over "
        f"{3 * RUNS} runs")
    fams = _side_finish(sides[0])
    for name, f in fams.items():
        walls[name] = f["wall"]
        got = tuple(f["digests"])
        log(f"chaos {name}: schedule={got[0]} result={got[1]} "
            f"{walls[name]:.2f} s (a process of its own) on {card}")
        expect(got, CHAOS_DIGESTS[name], f"chaos {name} digests")
        if not f["fired"]:
            raise AssertionError(f"chaos {name}: its faults never fired")
    fals = _side_finish(sides[1])
    for name in nemesis:
        walls[f"{name} falsification"] = fals[name]["wall"]
        if not fals[name]["ok"]:
            raise AssertionError(f"chaos {name}: a falsification arm was "
                                 f"not caught or its control failed")
        log(f"chaos {name} falsification: every broken arm caught, every "
            f"control passed, {walls[f'{name} falsification']:.2f} s (a "
            f"process of its own, beside the runs above) on "
            f"{card}")
    return {"walls": walls, "launches": launches}


# ---- phase 10 --------------------------------------------------------------

def _node_drain(n, plain=False) -> list:
    """Node n's commit stream so far, expanded to (g, idx, sql); `plain`
    only counts (the bench's drain without apply)."""
    from raftsql_tpu_torch.runtime.db import _expand_commit_item
    out = []
    while not n.commit_q.empty():
        item = n.commit_q.get_nowait()
        if item is None:
            continue
        got = _expand_commit_item(item, n)
        out.extend([None] * len(got) if plain else got)
    return out


def _boot_nodes(cfg, d, dev, codec=True):
    from raftsql_tpu_torch.runtime.node import RaftNode
    from raftsql_tpu_torch.transport.loopback import (LoopbackHub,
                                                      LoopbackTransport)
    shutil.rmtree(d, ignore_errors=True)
    hub = LoopbackHub(codec=codec)
    P = cfg.num_peers
    nodes = [RaftNode(i + 1, P, cfg, LoopbackTransport(hub),
                      os.path.join(d, f"n{i + 1}"), device=dev)
             for i in range(P)]
    for n in nodes:
        n.start(threaded=False)
    return nodes


def _elect(nodes, cfg) -> int:
    """Lockstep ticks until node 1 knows a leader for every group."""
    for t in range(40 * cfg.election_ticks):
        for n in nodes:
            n.tick()
        for n in nodes:
            _node_drain(n, plain=True)
        if t > cfg.election_ticks and (nodes[0]._last_hint >= 0).all():
            return t + 1
    raise AssertionError("node cluster: not every group elected a leader")


def node_lockstep(dev, G, ticks, d) -> tuple:
    """The bench's node shape at G groups on `dev`, with envelope ids
    from a counter: every tick's packed info of every node, node 1's
    commit stream and every WAL file's bytes."""
    from raftsql_tpu_torch.runtime import envelope
    from raftsql_tpu_torch.core.step import INFO_FIELDS
    cfg = RaftConfig(num_groups=G, num_peers=3, log_window=64,
                     max_entries_per_msg=8, tick_interval_s=0.0,
                     commit_rule="pallas")
    real_id = envelope.new_id
    envelope.new_id = iter(range(1, 1 << 62)).__next__
    infos, commits = [], []
    try:
        nodes = _boot_nodes(cfg, d, dev)
        for n in nodes:
            wal_phase = n._wal_phase

            def spy(info, wal_phase=wal_phase):
                infos.append(np.stack([np.asarray(getattr(info, f))
                                       for f in INFO_FIELDS], 1))
                return wal_phase(info)

            n._wal_phase = spy
        rng = np.random.default_rng(9)
        for t in range(ticks):
            for g in np.nonzero(rng.random(G) < 0.3)[0].tolist():
                nodes[int(rng.integers(0, 3))].propose(
                    g, f"SET k{g} v{t}".encode())
            for n in nodes:
                n.tick()
            commits.extend(_node_drain(nodes[0]))
        for n in nodes:
            n.stop()
    finally:
        envelope.new_id = real_id
    wal = {}
    for root, _, files in os.walk(d):
        for f in files:
            with open(os.path.join(root, f), "rb") as fh:
                wal[os.path.relpath(os.path.join(root, f), d)] = fh.read()
    shutil.rmtree(d, ignore_errors=True)
    return infos, commits, wal


def _load_nodes(nodes, G, n_cmds) -> None:
    """Queue n_cmds proposals at each group's leader (as node 1 knows
    it) and zero every node's phase clocks."""
    hints = nodes[0]._last_hint.copy()
    cmds = [f"SET k{i} v".encode() for i in range(n_cmds)]
    for g in range(G):
        nodes[int(hints[g])].propose_many(g, cmds)
    for n in nodes:
        _node_drain(n, plain=True)
        m = n.metrics
        m.ticks = 0
        m.t_stage_ms = m.t_device_ms = m.t_wal_ms = 0.0
        m.t_send_ms = m.t_publish_ms = 0.0


def node_cluster(card: str, dev="cuda", G=10_000, ticks=12,
                 g_cmp=512) -> dict:
    """The distributed runtime at the bench's node shape (bench.py
    bench_durable, BENCH_DURABLE_MODE=node): 3 RaftNodes on the card over
    LoopbackHub(codec=False), G groups, P = 3, W = 64, E = 8,
    tick_interval_s = 0, commit_rule="pallas", ticked in lockstep.  After
    the elections, `ticks` x E proposals per group are queued at each
    group's leader and `ticks` lockstep ticks drain them: commits/s from
    node 1's commit stream (counted, not applied) and node 1's per-phase
    ms per tick.  K1 must launch once per node tick (R = G rows of one
    peer); one tick's K1 inputs are copied.  Then a card run and a CPU
    run of a lockstep script at G = g_cmp must be bit-identical."""
    E = 8
    cfg = RaftConfig(num_groups=G, num_peers=3, log_window=64,
                     max_entries_per_msg=E, tick_interval_s=0.0,
                     commit_rule="pallas")
    d = os.path.join(ROOT, "build", "chip_smoke_node")
    k1 = "pallas_quorum_commit_index"
    t0 = time.monotonic()
    nodes = _boot_nodes(cfg, d, dev, codec=False)
    try:
        expect([n.wal.is_native for n in nodes], [True] * 3,
               "the node cluster's WALs are native")
        n_elect = _elect(nodes, cfg)
        t_elect = time.monotonic() - t0
        _load_nodes(nodes, G, ticks * E)
        captured = {}
        real = getattr(pq, k1)

        def spy(*args, **kw):
            captured.setdefault(k1, ([a.clone() for a in args], dict(kw)))
            return real(*args, **kw)

        pq.reset_launches()                    # the node path starts here
        t1 = time.monotonic()
        committed = 0
        for t in range(ticks):
            if t == ticks // 2:
                setattr(pq, k1, spy)
            for n in nodes:
                n.tick()
            setattr(pq, k1, real)
            committed += len(_node_drain(nodes[0], plain=True))
        if dev != "cpu":
            torch.cuda.synchronize()
        dt = time.monotonic() - t1
        launches = dict(pq.launches)           # ... and ends here
        phase = nodes[0].metrics.snapshot()["phase_ms_per_tick"]
        roles = np.stack([n._last_role for n in nodes])
    finally:
        setattr(pq, k1, real)
        for n in nodes:
            n.stop()
        shutil.rmtree(d, ignore_errors=True)
    expect(launches, {k1: 3 * ticks,
                      "pallas_masked_quorum_commit_index": 0},
           "K1 once per node tick")
    if committed <= 0 or (roles == 2).sum(0).max() != 1:
        raise AssertionError(f"node cluster: {committed} committed, "
                             f"leaders per group off")
    log(f"node cluster G={G} P=3 W=64 E={E} pallas: elected in {n_elect} "
        f"lockstep ticks ({t_elect:.1f} s with boot); {ticks} ticks "
        f"drained {committed} commits at node 1 in {dt:.2f} s: "
        f"{committed / dt:.0f} commits/s, {dt / ticks * 1e3:.1f} ms per "
        f"cluster tick; node 1 ms per tick {phase}; K1 launches "
        f"{launches[k1]}; native WALs on {card}")
    t2 = time.monotonic()
    got = node_lockstep(dev, g_cmp, 60, d)
    want = node_lockstep("cpu", g_cmp, 60, d)
    for part, a, b in zip(("packed info", "commit stream", "WAL bytes"),
                          got, want):
        if part == "packed info":
            same = len(a) == len(b) and all(
                np.array_equal(x, y) for x, y in zip(a, b))
        else:
            same = a == b
        if not same:
            raise AssertionError(f"node cluster card vs CPU at G={g_cmp}: "
                                 f"{part} differs")
    log(f"node cluster card vs CPU at G={g_cmp}: 60 lockstep ticks "
        f"bit-identical (packed info of {len(got[0])} node ticks, "
        f"{len(got[1])} commits at node 1, {len(got[2])} WAL files) in "
        f"{time.monotonic() - t2:.1f} s")
    return {"launches": launches, "captured": captured,
            "commits_per_s": committed / dt, "phase_ms": phase}


def node_wal_python(card: str, dev="cuda", G=10_000, ticks=4) -> dict:
    """Phase 10's shape again on the Python WAL backend
    (RAFTSQL_TPU_NATIVE=0), `ticks` ticks after the elections: node 1's
    ms per tick by phase, beside the native run's in the same call."""
    E = 8
    cfg = RaftConfig(num_groups=G, num_peers=3, log_window=64,
                     max_entries_per_msg=E, tick_interval_s=0.0,
                     commit_rule="pallas")
    d = os.path.join(ROOT, "build", "chip_smoke_node_python")
    old = os.environ.get("RAFTSQL_TPU_NATIVE")
    os.environ["RAFTSQL_TPU_NATIVE"] = "0"
    nodes = []
    try:
        nodes = _boot_nodes(cfg, d, dev, codec=False)
        expect([n.wal.is_native for n in nodes], [False] * 3,
               "RAFTSQL_TPU_NATIVE=0 selects the Python WAL")
        _elect(nodes, cfg)
        _load_nodes(nodes, G, ticks * E)
        for _ in range(ticks):
            for n in nodes:
                n.tick()
            _node_drain(nodes[0], plain=True)
        phase = nodes[0].metrics.snapshot()["phase_ms_per_tick"]
    finally:
        for n in nodes:
            n.stop()
        if old is None:
            del os.environ["RAFTSQL_TPU_NATIVE"]
        else:
            os.environ["RAFTSQL_TPU_NATIVE"] = old
        shutil.rmtree(d, ignore_errors=True)
    log(f"node cluster G={G} on the Python WAL backend, {ticks} ticks: "
        f"node 1 ms per tick {phase} on {card}")
    return phase


# ---- phase 11 --------------------------------------------------------------

def procfile_cluster(card: str, dev="cuda", groups=8, threads=16,
                     per=25) -> dict:
    """The reference's Procfile cluster on the card: three
    `python -m raftsql_tpu_torch.server.main --id I --cluster <3 urls>
    --port I2380 --groups 8 --resume` processes (the Procfile's ports
    and default tick and commit rule), driven by the port's
    RaftSQLClient: the curl recipe, a SIGKILL of node 2 with a write
    while it is down and its catch-up after the restart, then PUT
    latency from `threads` clients over the groups, every acked PUT
    read back, no election during the load, and each node's GET
    /metrics phase split."""
    from raftsql_tpu_torch.api.client import RaftSQLClient, SQLError
    from raftsql_tpu_torch.chaos.proc import ProcCluster
    work = os.path.join(ROOT, "build", "chip_smoke_procs")
    shutil.rmtree(work, ignore_errors=True)
    c = ProcCluster(work, peers=3, groups=groups, tick=0.01,
                    device=dev, resume=True,
                    peer_ports=[12379, 22379, 32379],
                    http_ports=[12380, 22380, 32380])
    t0 = time.monotonic()
    for i in range(3):
        c.spawn(i)
    cli = RaftSQLClient([f"127.0.0.1:{p}" for p in c.http_ports],
                        timeout_s=10.0)
    dl = 120.0
    try:
        cli.put("CREATE TABLE main.t (name text)", node=0, deadline_s=dl)
        t_up = time.monotonic() - t0
        cli.put('INSERT INTO main.t (name) VALUES ("abc")', node=1,
                deadline_s=dl)
        cli.get_until("SELECT * FROM main.t", "|abc|\n", node=2,
                      deadline_s=dl)
        expect(cli.raw(0, "POST", "/", "SELECT 1")[0], 405, "POST")
        try:
            cli.put("NOT SQL", node=0, deadline_s=dl)
        except SQLError:
            pass
        else:
            raise AssertionError("bad SQL was not refused with 400")
        c.sigkill(1)
        cli.put('INSERT INTO main.t (name) VALUES ("while-down")', node=0,
                deadline_s=dl)
        c.spawn(1)
        cli.get_until("SELECT count(*) FROM main.t", "|2|\n", node=1,
                      deadline_s=dl)
        log(f"procfile cluster: first PUT acked {t_up:.1f} s after spawn; "
            f"curl recipe ok (204, rows, 405, 400); node 2 SIGKILLed, a "
            f"write while down, restarted with --resume and caught up")
        for g in range(1, groups):
            cli.put("CREATE TABLE main.t (name text)", group=g,
                    deadline_s=dl)

        def metrics():
            out = []
            for i in range(3):
                st, _, body = cli.raw(i, "GET", "/metrics")
                expect(st, 200, f"node {i + 1} /metrics")
                out.append(json.loads(body))
            return out

        won0 = [m["elections_won"] for m in metrics()]
        lat, errs, acked = [], [], []
        mu = threading.Lock()

        def client(i):
            my = RaftSQLClient([f"127.0.0.1:{p}" for p in c.http_ports],
                               timeout_s=10.0)
            try:
                for k in range(per):
                    g = (i + k) % groups
                    q = f'INSERT INTO main.t (name) VALUES ("c{i}-{k}")'
                    t1 = time.monotonic()
                    try:
                        my.put(q, group=g, deadline_s=dl)
                    except Exception as e:               # noqa: BLE001
                        with mu:
                            errs.append(repr(e))
                        continue
                    with mu:
                        lat.append(time.monotonic() - t1)
                        acked.append((g, f"c{i}-{k}"))
            finally:
                my.close()

        ths = [threading.Thread(target=client, args=(i,))
               for i in range(threads)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        expect(errs, [], "procfile cluster PUTs")
        for g in range(groups):
            # Plain reads are stale by design: poll each node until it
            # has applied every acked PUT of the group.
            want = [v for (gg, v) in acked if gg == g]
            want += ["abc", "while-down"] if g == 0 else []
            want = sorted(f"|{v}|" for v in want)
            for node in range(3):
                until = time.monotonic() + 30.0
                while True:
                    st, _, body = cli.raw(
                        node, "GET", "/", "SELECT name FROM main.t",
                        headers={"X-Raft-Group": str(g)})
                    got = sorted(x for x in body.strip().split("\n") if x)
                    if st == 200 and got == want:
                        break
                    if time.monotonic() > until:
                        expect((st, got), (200, want), f"acked PUTs of "
                               f"g{g} read back at node {node + 1}")
                    time.sleep(0.1)
        lat.sort()
        p50 = lat[len(lat) // 2] * 1e3
        p99 = lat[int(len(lat) * 0.99)] * 1e3
        after = metrics()
        phases = [m["phase_ms_per_tick"] for m in after]
        # The node steps run slower than the 10 ms tick on the card; the
        # event loop's margin cap must still keep every leader in place:
        # no election while the load ran.
        won = [m["elections_won"] - w for m, w in zip(after, won0)]
        expect(won, [0, 0, 0], "elections during the PUT load")
        log(f"procfile cluster: {len(lat)} PUTs from {threads} threads "
            f"on {groups} groups acked and read back; PUT p50 "
            f"{p50:.2f} ms p99 {p99:.2f} ms, no election during the "
            f"load (device ms per node tick "
            f"{[round(ph['device'], 1) for ph in phases]} against a "
            f"10 ms tick) on {card}")
        for i, ph in enumerate(phases):
            log(f"procfile cluster node {i + 1} GET /metrics "
                f"phase_ms_per_tick {ph}")
        # Every start of every child logged a native WAL backend (node 2
        # started twice).
        for i, starts in enumerate((1, 2, 1)):
            with open(os.path.join(work, f"node{i + 1}.log")) as f:
                text = f.read()
            expect((text.count("WAL backend: native"),
                    "WAL backend: python" in text), (starts, False),
                   f"node {i + 1}'s WAL backend at each start")
        log("procfile cluster: every child started on native WALs")
    except BaseException:
        for i in range(3):
            log(f"--- node {i + 1} log tail ---\n{c.log_tail(i, 3000)}")
        raise
    finally:
        cli.close()
        codes = c.stop_all()
    expect(codes, [0, 0, 0], "procfile cluster clean stop exit codes")
    shutil.rmtree(work, ignore_errors=True)
    return {"p50": p50, "p99": p99, "phases": phases}


# ---- phase 12 --------------------------------------------------------------

def node_chaos(card: str, dev="cuda") -> dict:
    """The node-plane chaos families on the card: corrupt, snapshot and
    membership `RUNS` times each with commit_rule="pallas" (their plan and
    result digests must equal the JAX package's, CHAOS_DIGESTS; K1 must
    launch in each family's runs and K2 in membership's, whose conf
    entries switch every node to the masked rule; snapshot in a process
    of its own, side_job "snapshot", its launches counted there), and
    meanwhile, in another (side_job "tcp"), tcp and tcp_rebind once
    each (real sockets: their invariants must hold and their faults
    fire).  In the first membership run, the inputs of the
    first K2 call with joint masks live are copied.  Returns the wall
    time of each run, the launches of each family and the copy."""
    sides = [_side_start("snapshot"), _side_start("tcp")]
    try:
        return _node_chaos_runs(card, dev, sides)
    finally:
        for side in sides:
            _side_kill(side)


def _node_chaos_runs(card, dev, sides) -> dict:
    from raftsql_tpu_torch.chaos import run as crun
    walls, launches, captured = {}, {}, {}
    specs = crun.node_family_specs()
    k2 = "pallas_masked_quorum_commit_index"
    real = getattr(pq, k2)

    def spy(*args, **kw):
        if k2 not in captured and bool(
                (kw["voters"] != kw["voters_joint"]).any()):
            captured[k2] = ([a.clone() for a in args],
                            {k: v.clone() if torch.is_tensor(v) else v
                             for k, v in kw.items()})
        return real(*args, **kw)

    for name in ("corrupt", "membership"):
        fired = specs[name][3]
        pq.reset_launches()                    # this family starts here
        for i in range(RUNS):
            t0 = time.monotonic()
            if name == "membership" and i == 0:
                setattr(pq, k2, spy)
            try:
                r = crun.run_node(name, 0, device=dev,
                                  commit_rule="pallas")
            finally:
                setattr(pq, k2, real)
            walls[f"{name}#{i + 1}"] = time.monotonic() - t0
            got = (r["plan_digest"], r["result_digest"])
            log(f"node chaos {name} run {i + 1}: plan={got[0]} "
                f"result={got[1]} ({r['commits']} commits, "
                f"{r['crashes']} crashes) {walls[f'{name}#{i + 1}']:.2f} s "
                f"on {card}")
            expect(got, CHAOS_DIGESTS[name], f"node chaos {name} digests")
            if not fired(r):
                raise AssertionError(f"node chaos {name}: its faults "
                                     f"never fired ({r})")
        launches[name] = dict(pq.launches)     # ... and ends here
        if launches[name]["pallas_quorum_commit_index"] <= 0 and \
                name != "membership":
            raise AssertionError(f"node chaos {name} never launched K1")
    if launches["membership"][k2] <= 0 or k2 not in captured:
        raise AssertionError("node chaos membership never launched K2 "
                             "(on joint masks)")
    snap = _side_finish(sides[0])
    for i, run in enumerate(snap["runs"]):
        r = run["report"]
        walls[f"snapshot#{i + 1}"] = run["wall"]
        got = (r["plan_digest"], r["result_digest"])
        log(f"node chaos snapshot run {i + 1}: plan={got[0]} "
            f"result={got[1]} ({r['commits']} commits, {r['crashes']} "
            f"crashes) {run['wall']:.2f} s (a process of its own) on "
            f"{card}")
        expect(got, CHAOS_DIGESTS["snapshot"], "node chaos snapshot digests")
        if not run["fired"]:
            raise AssertionError(f"node chaos snapshot: its faults never "
                                 f"fired ({r})")
    launches["snapshot"] = snap["launches"]
    if launches["snapshot"]["pallas_quorum_commit_index"] <= 0:
        raise AssertionError("node chaos snapshot never launched K1")
    tcp = _side_finish(sides[1])
    for name in ("tcp", "tcp_rebind"):
        r = tcp[name]["report"]
        walls[name] = tcp[name]["wall"]
        if not tcp[name]["fired"]:
            raise AssertionError(f"node chaos {name}: faults never fired "
                                 f"or too few commits ({r})")
        log(f"node chaos {name}: invariants held, {r} "
            f"{walls[name]:.2f} s (a process of its own, beside the "
            f"families above) on {card}")
    log(f"node chaos launches by family: {launches}")
    return {"walls": walls, "launches": launches, "captured": captured}


# ---- phase 13 --------------------------------------------------------------

def overload(card: str, dev="cuda") -> int:
    """The overload gauntlet on the card (chaos.run overload_gauntlet,
    what `--overload` runs): the overload family at seed 0 twice with
    commit_rule="pallas" at the plan's own size (G = 4, P = 3, 160
    ticks, 32 offered writes a tick plus two bursts, a crash mid-
    overload), then the falsification pair (no admission controller:
    caught as OVERLOAD-MEMORY; bounded: passes and refuses).  Plan and
    result digests must equal CHAOS_DIGESTS["overload"] in both runs,
    every pressure family must fire, the backlog peak must stay at or
    under the cap and the goodput and starvation floors hold (the
    gauntlet's own checks), and K1 must launch once per device step:
    the launch count and the dispatch count are zeroed just before the
    gauntlet and read just after.  The inputs of K1's first call that
    advances some row's commit are copied (R = 12 rows, P = 3).
    Returns K1's launches and the copy."""
    from raftsql_tpu_torch.chaos import run as crun
    from raftsql_tpu_torch.runtime.hostplane import ClusterHostPlane
    k1 = "pallas_quorum_commit_index"
    steps = [0]
    real = ClusterHostPlane._readback       # one call per device dispatch
    captured = {}

    def counted(*a, **kw):
        steps[0] += 1
        return real(*a, **kw)

    pq.reset_launches()                       # the overload path starts here
    ClusterHostPlane._readback = staticmethod(counted)
    try:
        t0 = time.monotonic()
        with spy_fused_kernel(k1, captured):
            ok, reports = crun.overload_gauntlet(0, runs=2, device=dev,
                                                 commit_rule="pallas")
        wall = time.monotonic() - t0
    finally:
        ClusterHostPlane._readback = staticmethod(real)
    launches = pq.launches[k1]                # ... and ends here
    if not ok:
        raise AssertionError("the overload gauntlet failed (see CHAOS FAIL "
                             "above)")
    for r in reports:
        got = (r["plan_digest"], r["result_digest"])
        log(f"overload run {r['run'] + 1}: plan={got[0]} result={got[1]} "
            f"offered {r['offered']}, rejected {r['overload_rejected']}, "
            f"shed_stage {r['overload_shed_stage']}, depth peak "
            f"{r['overload_depth_peak']}/48, committed "
            f"{r['committed_entries']}, per group {r['group_commits']}, "
            f"{r['crashes']} crashes, {r['fsync_stalls']} fsync stalls; "
            f"{r['wall_s']:.2f} s on {card}")
        expect(got, CHAOS_DIGESTS["overload"], "overload digests")
    expect(launches, steps[0], "K1 launches against device steps on the "
                               "overload path")
    if launches <= 0 or k1 not in captured:
        raise AssertionError("the overload path never launched K1")
    log(f"overload: K1 launches {launches} = device steps {steps[0]} over "
        f"both runs and the falsification pair; falsification caught, "
        f"control passed; gauntlet {wall:.2f} s on {card}")
    return launches, captured


# ---- phase 14 --------------------------------------------------------------

# The reference's all-pass verdict digests at seed 0 (chaos/proc.py
# _verdict_digest of the JAX package: the schedule digest, every
# invariant "pass" and every family boolean true, hashed as its
# docstring says): the --procs family at 80 ticks, and the read and
# transfer arms on generate_procs(0, ticks=60).
PROC_VERDICTS = {
    # The pod gauntlet's nemesis (chaos/pod.py PodChaosRunner over
    # generate_pod(0)): (plan digest, all-pass verdict digest), equal to
    # a live run of the JAX package's runner.
    "pod": ("a3effdcab6da10bd", "0acaa0bc4bc11569"),
    "procs": ("fb868899b7dbd88a", "3b7df695ba0107b3"),
    # The read-replica gauntlet's nemesis (chaos/replica.py over
    # generate_replica(0)): (plan digest, all-pass verdict digest), equal
    # to a live run of the JAX package's runner with its _snapshot_of
    # repaired (its parity-mode engine dies at boot otherwise).
    "replica": ("24da40d585dbd4f0", "b56ccbc55a1eac20"),
    "reads": ("14e0b1d3918591ef", "95fa6c73158c79e6"),
    "transfers": ("14e0b1d3918591ef", "05aec3f72b210740"),
}


def _device_ms(doc: dict):
    """(ticks, device ms summed over them) from one GET /metrics doc."""
    t = doc["ticks"]
    return t, doc["phase_ms_per_tick"]["device"] * max(t, 1)


def stall_probe(card: str, dev="cuda", writes=60) -> None:
    """SIGSTOP of a CUDA child: three server processes on the card, 60
    acked PUTs at the group-0 leader with all three up, then that leader
    SIGSTOPped (its CUDA context held, frozen) and 60 more PUTs at the
    survivor that leads next.  Each survivor's device ms per node tick
    and ticks per second in the two windows, from GET /metrics (a node
    steps only when it has work or a timer due, so ticks per second
    follow the PUT rate).  The woken leader must rejoin and every write
    must be read back at every node."""
    from raftsql_tpu_torch.api.client import RaftSQLClient
    from raftsql_tpu_torch.chaos.proc import ProcCluster
    work = os.path.join(ROOT, "build", "chip_smoke_stall")
    shutil.rmtree(work, ignore_errors=True)
    c = ProcCluster(work, peers=3, device=dev)
    for i in range(3):
        c.spawn(i)
    cli = RaftSQLClient([f"127.0.0.1:{p}" for p in c.http_ports],
                        timeout_s=5.0)

    def leader(nodes):
        until = time.monotonic() + 60.0
        while time.monotonic() < until:
            for i in nodes:
                doc = cli.health(i)
                if doc and doc["groups"]["0"]["role"] == "leader":
                    return i
            time.sleep(0.2)
        raise AssertionError(f"no leader among nodes {nodes}")

    def window(nodes, tag, at):
        m0 = {i: _device_ms(json.loads(cli.raw(i, "GET", "/metrics")[2]))
              for i in nodes}
        t0 = time.monotonic()
        for k in range(writes):
            cli.put(f"INSERT INTO t (v) VALUES ('{tag}{k}')", node=at,
                    deadline_s=60.0)
        dt = time.monotonic() - t0
        out = {}
        for i in nodes:
            t1, d1 = _device_ms(json.loads(cli.raw(i, "GET",
                                                   "/metrics")[2]))
            ticks = t1 - m0[i][0]
            out[i] = ((d1 - m0[i][1]) / max(ticks, 1), ticks / dt)
        return out, dt

    try:
        cli.put("CREATE TABLE t (v text)", deadline_s=120.0)
        lead = leader(range(3))
        survivors = [i for i in range(3) if i != lead]
        before, dt0 = window(range(3), "b", lead)
        c.sigstop(lead)
        during, dt1 = window(survivors, "s", leader(survivors))
        c.sigcont(lead)
        want = "".join(f"|{v}|\n" for v in sorted(
            [f"b{k}" for k in range(writes)]
            + [f"s{k}" for k in range(writes)]))
        for i in range(3):
            cli.get_until("SELECT v FROM t ORDER BY v", want, node=i,
                          deadline_s=60.0)
    except BaseException:
        for i in range(3):
            log(f"--- stall probe node {i + 1} log tail ---\n"
                f"{c.log_tail(i, 3000)}")
        raise
    finally:
        cli.close()
        codes = c.stop_all()
    expect(codes, [0, 0, 0], "stall probe clean stop exit codes")
    shutil.rmtree(work, ignore_errors=True)
    for i in survivors:
        log(f"stall probe: survivor node {i + 1} device "
            f"{before[i][0]:.3f} ms per node tick at "
            f"{before[i][1]:.1f} ticks/s with all three up, "
            f"{during[i][0]:.3f} ms at {during[i][1]:.1f} ticks/s with "
            f"leader node {lead + 1} SIGSTOPped on {card}")
    log(f"stall probe: {writes} PUTs in {dt0:.2f} s before, {writes} in "
        f"{dt1:.2f} s during the stall; the woken node rejoined and every "
        f"write was read back at every node on {card}")


def proc_chaos(card: str, dev="cuda") -> None:
    """The process plane on the card, every server child a CUDA process
    (`--device cuda`, the CLI's default point rule): run_procs's
    gauntlet at seed 0, 80 ticks, RUNS times (every family fires, no
    unexpected exit, schedule digest fb868899b7dbd88a, every verdict
    digest the reference's all-pass digest), the read arm and the
    transfer arm once each on generate_procs(0, ticks=60) (linear,
    session and follower reads above 0 with no stale session read; a
    transfer completed), then the SIGSTOP probe."""
    from raftsql_tpu_torch.chaos import run as crun
    runs = []
    for family, ticks, n in (("procs", 80, RUNS), ("reads", 60, 1),
                             ("transfers", 60, 1)):
        ok, reports = crun.procs_gauntlet(family, 0, ticks, runs=n,
                                          device=dev)
        if not ok:
            raise AssertionError(f"the process {family} gauntlet failed "
                                 f"(see CHAOS FAIL above)")
        runs += [(family, r) for r in reports]
    for family, r in runs:
        got = (r["schedule_digest"], r["result_digest"])
        extra = ""
        if family == "reads":
            expect(r["stale_session"], 0, "stale session reads")
            extra = (f", reads linear {r['linear_reads']} session "
                     f"{r['session_reads']} follower "
                     f"{r['follower_reads']}")
        elif family == "transfers":
            extra = (f", transfers requested "
                     f"{r['transfers_requested']} completed "
                     f"{r['transfers_completed']} lost "
                     f"{r['transfers_lost']}")
        log(f"proc chaos {family}: schedule={got[0]} verdict={got[1]} "
            f"acked {r['acked']}, respawns {r['respawns']}, kills "
            f"{r['kills']}, stalls {r['stalls']}, storm restarts "
            f"{r['storm_restarts']}, fsio exits {r['fsio_exits']}, fatal "
            f"exits {r['fatal_exits']}, unexpected {r['unexpected_exits']}"
            f"{extra}; first child healthy {r['boot_s']:.1f} s after "
            f"spawn; {r['wall_s']:.1f} s on {card}")
        expect(got, PROC_VERDICTS[family], f"proc chaos {family} digests")
    stall_probe(card, dev)


# ---- phase 15 --------------------------------------------------------------

def record_streams(blob: bytes) -> dict:
    """The framed records of one WAL file (u32 crc | u32 len | body) as
    {group id: [record, ...]} in file order (epoch markers, which carry
    no group, under None); the whole file must parse."""
    out, off = {}, 0
    while off < len(blob):
        n = int.from_bytes(blob[off + 4: off + 8], "little")
        rec = blob[off: off + 8 + n]
        key = None if rec[8] == 6 else int.from_bytes(rec[9:13], "little")
        out.setdefault(key, []).append(rec)
        off += 8 + n
    if off != len(blob):
        raise AssertionError("a WAL file ends in a torn record")
    return out


def _dir_files(d: str) -> dict:
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            with open(os.path.join(root, f), "rb") as fh:
                out[os.path.relpath(os.path.join(root, f), d)] = fh.read()
    return out


def durable_arm(card, dev, native_plog, G, ticks, E=8, seed=0,
                mesh=None) -> dict:
    """One arm of phase 15: the bench's fused durable shape
    (bench.py bench_durable_fused: FusedClusterNode, P = 3, W = 64, E,
    tick_interval_s = 0, WAL group commit, publish_peers = {0}) with
    commit_rule="pallas", booted from `seed`, elected, then `ticks`
    ticks draining E `SET k<i> v<t>` proposals a group a tick queued
    ahead.  native_plog: RAFTSQL_FUSED_NATIVE_PLOG=1 and NativeKV
    applying peer 0's stream inside the publish (the bench's default);
    else the Python payload log and one KVStateMachine a group draining
    peer 0's commit queue (BENCH_DURABLE_APPLY=python).  K1's launches
    and the device steps (ClusterHostPlane._readback, one a dispatch)
    are zeroed just before the boot and read just after the run.
    `mesh` (a parallel/sharded.py Mesh) runs the bench's runtime="mesh"
    rung instead: MeshClusterNode over the mesh (per-shard WAL dirs, one
    publish worker per group shard, no group commit), K1 launched once
    per shard per device step."""
    from raftsql_tpu_torch.models.kv_native import NativeKV
    from raftsql_tpu_torch.models.kv_sm import KVStateMachine
    from raftsql_tpu_torch.runtime.db import (iter_plain_batches,
                                              iter_plain_entries)
    from raftsql_tpu_torch.runtime.fused import FusedClusterNode
    from raftsql_tpu_torch.runtime.hostplane import ClusterHostPlane
    cfg = RaftConfig(num_groups=G, num_peers=3, log_window=max(64, 4 * E),
                     max_entries_per_msg=E, tick_interval_s=0.0,
                     commit_rule="pallas")
    name = ("mesh" if mesh is not None
            else "native" if native_plog else "python")
    d = os.path.join(ROOT, "build", f"chip_smoke_durable_{name}")
    shutil.rmtree(d, ignore_errors=True)
    steps = [0]
    real = ClusterHostPlane._readback

    def counted(*a, **kw):
        steps[0] += 1
        return real(*a, **kw)

    sms = [KVStateMachine() for _ in range(G)] if not native_plog else None

    def drain():
        q = node.commit_q(0)
        per_g = {}
        while not q.empty():
            item = q.get_nowait()
            if not isinstance(item, tuple):
                continue
            for g, base, datas in iter_plain_batches(item):
                per_g.setdefault(g, []).extend(
                    (cmd, idx) for idx, cmd in iter_plain_entries(base,
                                                                 datas))
        if sms is not None:
            for g, items in per_g.items():
                for err in sms[g].apply_batch(items):
                    if err is not None:
                        raise AssertionError(f"apply g{g}: {err}")

    old_env = os.environ.get("RAFTSQL_FUSED_NATIVE_PLOG")
    os.environ["RAFTSQL_FUSED_NATIVE_PLOG"] = "1" if native_plog else "0"
    pq.reset_launches()                       # this arm's path starts here
    ClusterHostPlane._readback = staticmethod(counted)
    kv = node = None
    try:
        t0 = time.monotonic()
        if mesh is not None:
            from raftsql_tpu_torch.runtime.mesh import MeshClusterNode
            node = MeshClusterNode(cfg, d, mesh, seed=seed)
        else:
            node = FusedClusterNode(cfg, d, group_commit=True, seed=seed,
                                    device=dev)
        node.publish_peers = {0}
        if native_plog:
            kv = NativeKV(G, node._plog_lib)
            node.native_kv = kv
        expect([w.is_native for w in node.wals], [True] * 3,
               f"arm {name}: native WALs")
        expect(all(hasattr(pl, "handle") for pl in node.plogs), native_plog,
               f"arm {name}: native payload logs")
        n_elect = 0
        while (node._hints < 0).any() and n_elect < 40 * cfg.election_ticks:
            node.tick()
            drain()
            n_elect += 1
        if (node._hints < 0).any():
            raise AssertionError(f"arm {name}: not every group elected")
        node.publish_flush()
        drain()
        t_elect = time.monotonic() - t0
        for g in range(G):
            node.propose_many(g, [f"SET k{i} v{t}".encode()
                                  for t in range(ticks) for i in range(E)])
        m = node.metrics
        m.ticks = 0
        m.t_device_ms = m.t_wal_ms = m.t_publish_ms = 0.0
        applied0 = int(node._applied[0].sum())
        fsync = [0.0]

        def barrier():
            # The fsync barrier of the durable phase that just ran (the
            # host plane's _fsync_span), read once: the WAL phase's
            # share that waits on the disk.
            fs, node._fsync_span = node._fsync_span, None
            fsync[0] += fs[1] if fs is not None else 0.0

        torch.cuda.synchronize()
        t1 = time.monotonic()
        for _ in range(ticks):
            node.tick()
            barrier()
            drain()
        node.publish_flush()
        barrier()
        drain()
        torch.cuda.synchronize()
        dt = time.monotonic() - t1
        committed = int(node._applied[0].sum()) - applied0
        phase = {"device": m.t_device_ms / ticks, "wal": m.t_wal_ms / ticks,
                 "fsync": fsync[0] * 1e3 / ticks,
                 "publish": m.t_publish_ms / ticks}
        launches = pq.launches["pallas_quorum_commit_index"]
        commit = node._applied[0].copy()
        if native_plog:
            state = [(kv.applied_index(g), kv.count(g),
                      [kv.get(g, f"k{i}") for i in range(E)])
                     for g in range(G)]
        else:
            state = [(sm.applied_index(), len(sm.snapshot()),
                      [sm.query(f"GET k{i}") or None for i in range(E)])
                     for sm in sms]
    finally:
        if node is not None:
            node.stop()
        ClusterHostPlane._readback = staticmethod(real)
        if old_env is None:
            del os.environ["RAFTSQL_FUSED_NATIVE_PLOG"]
        else:
            os.environ["RAFTSQL_FUSED_NATIVE_PLOG"] = old_env
        if kv is not None:
            kv.close()
    files = _dir_files(d)
    shutil.rmtree(d, ignore_errors=True)
    per_step = 1 if mesh is None else mesh.size
    expect(launches, steps[0] * per_step,
           f"arm {name}: K1 launches against device steps x shards")
    if committed <= 0:
        raise AssertionError(f"arm {name}: nothing committed")
    log(f"durable plane arm {name} G={G} P=3 W={cfg.log_window} E={E} "
        f"pallas, "
        f"{'group commit' if mesh is None else f'{mesh.size} group shards'}"
        f": elected in {n_elect} ticks "
        f"({t_elect:.1f} s with boot); {ticks} ticks drained {committed} "
        f"commits in {dt:.2f} s: {committed / dt:.0f} commits/s, "
        f"{dt / ticks * 1e3:.1f} ms per tick; ms per tick: device "
        f"{phase['device']:.2f}, wal {phase['wal']:.2f} (of it the fsync "
        f"barrier {phase['fsync']:.2f}), publish "
        f"{phase['publish']:.2f}; K1 launches {launches} = device steps "
        f"{steps[0]} x {per_step}; every WAL native on {card}")
    return {"commits_per_s": committed / dt, "ms_per_tick": dt / ticks * 1e3,
            "phase": phase, "launches": launches, "commit": commit,
            "state": state, "files": files}


def durable_plane(card: str, dev="cuda", G=10_000, ticks=12) -> dict:
    """The durable storage plane at the bench's accelerator durable shape
    (bench.py bench_durable_fused, G = 10,000): arm (a) the native
    payload log with NativeKV applying peer 0's stream, arm (b) the
    Python payload log with KVStateMachine draining it, run in turns
    (a, then b).  Every WAL in both arms must be native; both arms must
    commit the same indexes and hold the same KV state group by group
    (applied index, key count, the value of every key), and write the
    same WAL records: under group commit the shared log's records of
    each group in the same order and the files the same size (the
    parallel per-peer mirror of arm (a) interleaves different groups'
    records as its threads run, as in the JAX package).  Returns the
    arms' numbers and the K1 launches over both runs."""
    a = durable_arm(card, dev, True, G, ticks)
    b = durable_arm(card, dev, False, G, ticks)
    if not np.array_equal(a["commit"], b["commit"]):
        raise AssertionError("durable arms committed different indexes")
    if a["state"] != b["state"]:
        bad = next(g for g, (x, y) in enumerate(zip(a["state"], b["state"]))
                   if x != y)
        raise AssertionError(f"durable arms' KV state differs at g{bad}: "
                             f"{a['state'][bad]} != {b['state'][bad]}")
    expect(sorted(a["files"]), sorted(b["files"]), "WAL file names")
    same_bytes = a["files"] == b["files"]
    for f, blob in a["files"].items():
        expect(len(blob), len(b["files"][f]), f"{f} size")
        if record_streams(blob) != record_streams(b["files"][f]):
            raise AssertionError(f"{f}: a group's WAL records differ "
                                 f"between the durable arms")
    log(f"durable plane G={G}: native plog + NativeKV "
        f"{a['commits_per_s']:.0f} commits/s, Python plog + "
        f"KVStateMachine {b['commits_per_s']:.0f} commits/s "
        f"({a['commits_per_s'] / b['commits_per_s']:.2f}x); the same "
        f"commit indexes, KV state and WAL records per group "
        f"({len(a['files'])} WAL files, "
        f"{'byte-identical' if same_bytes else 'groups interleaved differently in the shared log'}"
        f") on {card}")
    return {"commits_per_s": {"native": a["commits_per_s"],
                              "python": b["commits_per_s"]},
            "phase": {"native": a["phase"], "python": b["phase"]},
            "launches": a["launches"] + b["launches"], "arm_b": b}


# ---- phases 16-20: the mesh and pod runtimes ---------------------------------

@contextlib.contextmanager
def slots_env(n: int):
    """RAFTSQL_SHARD_SLOTS=n inside the block: the card counts as n shard
    slots (the JAX package's forced host devices); restored after."""
    old = os.environ.get("RAFTSQL_SHARD_SLOTS")
    os.environ["RAFTSQL_SHARD_SLOTS"] = str(n)
    try:
        yield
    finally:
        if old is None:
            del os.environ["RAFTSQL_SHARD_SLOTS"]
        else:
            os.environ["RAFTSQL_SHARD_SLOTS"] = old


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _device_busy_ms(fn, ticks: int):
    """(wall ms, device busy ms) per tick of `ticks` calls of fn() under
    torch.profiler: busy is the sum of the kernels' self time; None
    where the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            fn()
        torch.cuda.synchronize()
    wall = (time.monotonic() - t0) / ticks * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(_self_device_us(e) for e in kern) / ticks / 1e3
    return wall, (busy if kern else None), \
        sum(e.count for e in kern) // ticks


def mesh_tick(card: str, dev="cuda", G=32_768, g=512, T=16) -> dict:
    """BASELINE config 5 at its own shape (bench.py bench_multichip): G =
    32,768 groups (8,192 a group shard), P = 4, W = 64, E = 8 over a 2 x
    4 mesh whose eight shards share the card, commit_rule="pallas".
    From boot until every group has a leader (at least 48 ticks) the
    sharded host step and the fused cluster_step_host run in lockstep,
    packed info and busy bit equal every tick; then blocks of T ticks in turns (fused, sharded,
    sharded, fused) on the same proposals, the final states equal, for
    ms per tick; K1 must launch pp x gg times a sharded step (counts
    zeroed just before the first sharded block, read just after); one
    shard's K1 inputs are copied; then the same with voter masks (K2
    per shard).  Then one lockstep script at G = `g` on a card mesh and
    a CPU mesh must be bit-identical."""
    from raftsql_tpu_torch.parallel import (make_mesh,
                                            make_sharded_cluster_step_host,
                                            shard_cluster_arrays)
    P, W, E, pp, gg = 4, 64, 8, 2, 4
    cfg = RaftConfig(num_groups=G, num_peers=P, log_window=W,
                     max_entries_per_msg=E, commit_rule="pallas")
    mesh = make_mesh(pp, gg, devices=[torch.device(dev)] * (pp * gg))
    step = make_sharded_cluster_step_host(cfg, mesh)
    fs = cluster.init_cluster_state(cfg, device=dev)
    fi = cluster.empty_cluster_inbox(cfg, device=dev)
    ss, si = shard_cluster_arrays(
        mesh, cluster.init_cluster_state(cfg, device=dev),
        cluster.empty_cluster_inbox(cfg, device=dev))
    ones = torch.ones((P,), dtype=torch.int32, device=dev)
    rng = np.random.default_rng(16)

    def props(n):
        return torch.from_numpy(rng.integers(
            0, E + 1, (n, P, G)).astype(np.int32)).to(dev)

    # Lockstep from boot until every group has a leader (split votes
    # among 4 peers can take a few election rounds), at least 48 ticks.
    lock = leaders = 0
    while lock < 48 or (leaders < G and lock < 240):
        for pn in props(16):
            fs, fi, finfo, fbusy = cluster.cluster_step_host(cfg, fs, fi,
                                                             pn, ones)
            ss, si, sinfo, sbusy = step(ss, si, pn, ones)
            if not torch.equal(finfo, sinfo) \
                    or bool(fbusy) != bool(sbusy):
                raise AssertionError(f"mesh tick != fused tick at tick "
                                     f"{lock}")
            lock += 1
        leaders = int(((fs.role == 2).sum(0) > 0).sum())
    if leaders < G:
        raise AssertionError(f"only {leaders} of {G} groups elected")

    def fused_block(pb):
        nonlocal fs, fi
        for pn in pb:
            fs, fi, _, _ = cluster.cluster_step_host(cfg, fs, fi, pn, ones)
        _sync(dev)

    def mesh_block(pb):
        nonlocal ss, si
        for pn in pb:
            ss, si, _, _ = step(ss, si, pn, ones)
        _sync(dev)

    b1, b2 = props(T), props(T)
    k1 = "pallas_quorum_commit_index"
    times = {"fused": [], "mesh": []}
    t0 = time.monotonic()
    fused_block(b1)
    times["fused"].append(time.monotonic() - t0)
    pq.reset_launches()                        # the mesh path starts here
    t0 = time.monotonic()
    mesh_block(b1)
    times["mesh"].append(time.monotonic() - t0)
    launches = pq.launches[k1]                 # ... and ends here
    t0 = time.monotonic()
    mesh_block(b2)
    times["mesh"].append(time.monotonic() - t0)
    t0 = time.monotonic()
    fused_block(b2)
    times["fused"].append(time.monotonic() - t0)
    for k, v in convert.to_numpy(fs).items():
        if not np.array_equal(v, convert.to_numpy(ss.gather())[k]):
            raise AssertionError(f"mesh and fused states differ: {k}")
    expect(launches, pp * gg * T, "K1 launches in a block of mesh steps")
    ms = {k: min(v) / T * 1e3 for k, v in times.items()}
    mwall, mbusy, mkern = _device_busy_ms(
        lambda: mesh_block(props(1)), 3)
    fwall, fbusy, fkern = _device_busy_ms(
        lambda: fused_block(props(1)), 3)
    log(f"mesh tick G={G} P={P} W={W} E={E} pallas, {pp}x{gg} mesh, "
        f"{pp * gg} shards on one card: bit-identical to the fused tick "
        f"for {lock} ticks from boot ({leaders} leaders) and after "
        f"{2 * T} more; ms/tick mesh {ms['mesh']:.2f}, fused "
        f"{ms['fused']:.2f} (best of 2 blocks of {T}, in turns); K1 "
        f"launches {launches} in {T} mesh steps ({launches // T} a step) "
        f"on {card}")
    log(f"mesh tick profile (3 ticks, profiler on): mesh wall "
        f"{mwall:.2f} ms/tick, device busy {_ms(mbusy)}, {mkern} "
        f"kernels/tick; fused wall {fwall:.2f} ms/tick, device busy "
        f"{_ms(fbusy)}, {fkern} kernels/tick on {card}")
    captured = {}
    real = pq.pallas_quorum_commit_index

    def spy(*args, **kw):                      # keeps the last shard's
        captured[k1] = ([a.clone() for a in args], dict(kw))
        return real(*args, **kw)

    pq.pallas_quorum_commit_index = spy
    try:
        mesh_block(props(1))
    finally:
        pq.pallas_quorum_commit_index = real
    # Voter masks: every shard's Phase 7 runs K2.
    k2 = "pallas_masked_quorum_commit_index"
    dcfg = dataclasses.replace(cfg, dynamic_membership=True)
    dstep = make_sharded_cluster_step_host(dcfg, mesh)
    real2 = pq.pallas_masked_quorum_commit_index

    def spy2(*args, **kw):
        captured[k2] = ([a.clone() for a in args],
                        {k: v.clone() if torch.is_tensor(v) else v
                         for k, v in kw.items()})
        return real2(*args, **kw)

    pq.reset_launches()                        # the mesh K2 path
    t0 = time.monotonic()
    for pn in props(T):
        ss, si, _, _ = dstep(ss, si, pn, ones)
    _sync(dev)
    dms = (time.monotonic() - t0) / T * 1e3
    k2_launches = pq.launches[k2]
    expect(k2_launches, pp * gg * T, "K2 launches in mesh steps")
    pq.pallas_masked_quorum_commit_index = spy2
    try:
        ss, si, _, _ = dstep(ss, si, props(1)[0], ones)
    finally:
        pq.pallas_masked_quorum_commit_index = real2
    log(f"mesh tick dynamic_membership: {dms:.2f} ms/tick, K2 launches "
        f"{k2_launches} in {T} steps on {card}")
    del fs, fi, ss, si

    # Card vs CPU: one lockstep script (proposals and per-peer skew) on a
    # 2 x 4 mesh of the card and a 2 x 4 mesh of the CPU.
    scfg = dataclasses.replace(cfg, num_groups=g)
    out = []
    for d in (dev, "cpu"):
        m = make_mesh(pp, gg, devices=[torch.device(d)] * (pp * gg))
        st_, ib_ = shard_cluster_arrays(
            m, cluster.init_cluster_state(scfg, device=d),
            cluster.empty_cluster_inbox(scfg, device=d))
        sstep = make_sharded_cluster_step_host(scfg, m)
        r = np.random.default_rng(5)
        infos = []
        for _ in range(48):
            pn = r.integers(0, E + 1, (P, g)).astype(np.int32)
            ti = r.integers(0, 3, (P,)).astype(np.int32)
            st_, ib_, pinfo, busy = sstep(st_, ib_, pn, ti)
            infos.append((pinfo.cpu().numpy(), bool(busy)))
        out.append((infos, convert.to_numpy(st_.gather())))
    for t, ((a, ba), (b, bb)) in enumerate(zip(out[0][0], out[1][0])):
        if not np.array_equal(a, b) or ba != bb:
            raise AssertionError(f"card and CPU mesh differ at tick {t}")
    for k in out[0][1]:
        if not np.array_equal(out[0][1][k], out[1][1][k]):
            raise AssertionError(f"card and CPU mesh states differ: {k}")
    log(f"mesh tick card vs CPU at G={g}: 48 ticks with skew "
        f"bit-identical")
    return {"ms_per_tick": ms, "launches": {k1: launches, k2: k2_launches},
            "captured": captured, "busy_ms": (mbusy, fbusy)}


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.2f} ms"


# ---- phase 17 ---------------------------------------------------------------

def durable_mesh(card: str, dev="cuda", G=10_000, ticks=12,
                 arm_b=None) -> dict:
    """The bench's runtime="mesh" durable rung (bench.py
    bench_durable_fused, runtime="mesh"): G = 10,000, P = 3, W = 64,
    E = 8 over 8 group shards sharing the card, native WALs per shard
    dir, the rung's queue-drain KV apply (Python payload log,
    KVStateMachine per group), booted from seed 0, elected, then 24
    ticks with E SETs a group queued ahead.  The KV state and commit
    indexes per group must equal phase 15's arm (b) (the fused runtime,
    Python payload log, KVStateMachine), run again here when phase 15
    did not run."""
    from raftsql_tpu_torch.parallel import make_mesh
    mesh = make_mesh(1, 8, devices=[torch.device(dev)] * 8)
    if arm_b is None:
        arm_b = durable_arm(card, dev, False, G, ticks)
    m = durable_arm(card, dev, False, G, ticks, mesh=mesh)
    if not np.array_equal(m["commit"], arm_b["commit"]):
        raise AssertionError("mesh and fused arms committed different "
                             "indexes")
    if m["state"] != arm_b["state"]:
        bad = next(i for i, (x, y) in enumerate(zip(m["state"],
                                                    arm_b["state"]))
                   if x != y)
        raise AssertionError(f"mesh KV state differs from arm (b) at "
                             f"g{bad}")
    log(f"durable mesh G={G}: {m['commits_per_s']:.0f} commits/s, "
        f"{m['ms_per_tick']:.1f} ms/tick (device "
        f"{m['phase']['device']:.2f}, wal {m['phase']['wal']:.2f}, fsync "
        f"barrier {m['phase']['fsync']:.2f}, publish "
        f"{m['phase']['publish']:.2f}) against arm (b) "
        f"{arm_b['commits_per_s']:.0f} commits/s, "
        f"{arm_b['ms_per_tick']:.1f} ms/tick (device "
        f"{arm_b['phase']['device']:.2f}, wal {arm_b['phase']['wal']:.2f},"
        f" fsync barrier {arm_b['phase']['fsync']:.2f}, publish "
        f"{arm_b['phase']['publish']:.2f}); the same commit "
        f"indexes and KV state per group on {card}")
    return {"commits_per_s": m["commits_per_s"],
            "ms_per_tick": m["ms_per_tick"], "phase": m["phase"],
            "launches": m["launches"],
            "fused_commits_per_s": arm_b["commits_per_s"]}


# ---- phases 18 and 20: server processes -------------------------------------

def _spawn(args, work, name, env_extra) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=ROOT, **env_extra)
    logf = open(os.path.join(work, f"{name}.log"), "ab")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "raftsql_tpu_torch.server.main", *args],
            cwd=work, env=env, stdout=logf, stderr=subprocess.STDOUT)
    finally:
        logf.close()


def _tail(work, name, n=3000) -> str:
    try:
        with open(os.path.join(work, f"{name}.log"), "rb") as f:
            return f.read()[-n:].decode("utf-8", "replace")
    except OSError:
        return ""


def _stop(p, timeout=60) -> int:
    if p.poll() is None:
        p.terminate()
    try:
        return p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        return p.wait(timeout=15)


def _client_load(addrs, groups, threads, per, tag, dl=120.0):
    """`threads` RaftSQLClients over `addrs` PUT `per` unique rows each
    across the groups (following 421s to the serving host); returns the
    acked (group, value) pairs and the PUT latencies in seconds."""
    from raftsql_tpu_torch.api.client import RaftSQLClient
    lat, errs, acked = [], [], []
    mu = threading.Lock()

    def client(i):
        my = RaftSQLClient(addrs, timeout_s=15.0)
        try:
            my.refresh_hints(timeout_s=5.0)
            for k in range(per):
                g = (i + k) % groups
                v = f"{tag}-c{i}-{k}"
                t1 = time.monotonic()
                try:
                    my.put(f'INSERT INTO main.t (name) VALUES ("{v}")',
                           group=g, deadline_s=dl)
                except Exception as e:               # noqa: BLE001
                    with mu:
                        errs.append(repr(e))
                    continue
                with mu:
                    lat.append(time.monotonic() - t1)
                    acked.append((g, v))
        finally:
            my.close()

    ths = [threading.Thread(target=client, args=(i,))
           for i in range(threads)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    expect(errs, [], f"{tag}: PUTs")
    lat.sort()
    return acked, lat


def _read_back(cli, node_of, groups, want_extra, acked, what):
    """Every acked value of every group read back at `node_of(g)`."""
    for g in range(groups):
        want = sorted(f"|{v}|" for v in
                      [v for (gg, v) in acked if gg == g] + want_extra(g))
        until = time.monotonic() + 60.0
        while True:
            st, _, body = cli.raw(node_of(g), "GET", "/",
                                  "SELECT name FROM main.t",
                                  headers={"X-Raft-Group": str(g)})
            got = sorted(x for x in body.strip().split("\n") if x)
            if st == 200 and got == want:
                break
            if time.monotonic() > until:
                expect((st, len(got)), (200, len(want)),
                       f"{what}: acked PUTs of g{g} read back")
            time.sleep(0.1)


def mesh_server(card: str, dev="cuda", groups=8, threads=16,
                per=25) -> dict:
    """`python -m raftsql_tpu_torch.server.main --mesh --groups 8
    --group-shards 4 --resume` on the card with 4 shard slots: the
    reference curl recipe, concurrent acked PUTs from `threads` clients
    read back, a clean stop, then a --resume reopen from the per-shard
    WALs with every row intact; every start on native WALs."""
    from raftsql_tpu_torch.api.client import RaftSQLClient
    work = os.path.join(ROOT, "build", "chip_smoke_mesh")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    port = _free_port()
    args = ["--mesh", "--groups", str(groups), "--group-shards", "4",
            "--port", str(port), "--resume", "--device", dev]
    env = {"RAFTSQL_SHARD_SLOTS": "4"}
    t0 = time.monotonic()
    p = _spawn(args, work, "mesh", env)
    cli = RaftSQLClient([f"127.0.0.1:{port}"], timeout_s=15.0)
    try:
        cli.wait_healthy(0, deadline_s=120.0)
        t_up = time.monotonic() - t0
        recipe(port, groups, "mesh server")
        acked, lat = _client_load([f"127.0.0.1:{port}"], groups, threads,
                                  per, "mesh")
        _read_back(cli, lambda g: 0, groups, lambda g: ["abc"], acked,
                   "mesh server")
        doc = json.loads(cli.raw(0, "GET", "/metrics")[2])
    except BaseException:
        log(f"--- mesh server log tail ---\n{_tail(work, 'mesh')}")
        raise
    finally:
        cli.close()
        code = _stop(p)
    if code != 0:
        log(f"--- mesh server log tail ---\n{_tail(work, 'mesh')}")
    expect(code, 0, "mesh server clean stop")
    p = _spawn(args, work, "mesh", env)         # reopen: replay the WALs
    cli = RaftSQLClient([f"127.0.0.1:{port}"], timeout_s=15.0)
    try:
        cli.wait_healthy(0, deadline_s=120.0)
        _read_back(cli, lambda g: 0, groups, lambda g: ["abc"], acked,
                   "mesh server after --resume")
        expect(_req(port, "PUT", b'INSERT INTO main.t (name) VALUES '
                    b'("again")')[0], 204, "PUT after reopen")
    except BaseException:
        log(f"--- mesh server log tail ---\n{_tail(work, 'mesh')}")
        raise
    finally:
        cli.close()
        code = _stop(p)
    if code != 0:
        log(f"--- mesh server log tail ---\n{_tail(work, 'mesh')}")
    expect(code, 0, "mesh server clean stop after reopen")
    text = _tail(work, "mesh", 1 << 20)
    expect((text.count("WAL backend: native"), "WAL backend: python"
            in text), (2, False), "mesh server WAL backend at each start")
    expect(text.count("mesh deployment: 1x4 shard slots"), 2,
           "mesh server shard slots")
    p50, p99 = lat[len(lat) // 2] * 1e3, lat[int(len(lat) * 0.99)] * 1e3
    log(f"mesh server: up {t_up:.1f} s after spawn; curl recipe ok; "
        f"{len(lat)} PUTs from {threads} threads over {groups} groups "
        f"(4 group shards on the card) acked and read back, PUT p50 "
        f"{p50:.2f} ms p99 {p99:.2f} ms; phase_ms_per_tick "
        f"{doc['phase_ms_per_tick']}; a --resume reopen replayed the "
        f"per-shard WALs, rows intact; native WALs at both starts on "
        f"{card}")
    shutil.rmtree(work, ignore_errors=True)
    return {"p50": p50, "p99": p99, "phase": doc["phase_ms_per_tick"]}


# ---- phase 19 ---------------------------------------------------------------

def mesh_chaos(card: str, dev="cuda") -> dict:
    """The mesh_skew family (chaos.run run_mesh: MeshChaosRunner over the
    skew schedule) at seed 0, RUNS times, commit_rule="pallas", on 8
    shard slots of the card (4 groups: 4 group shards): schedule and
    result digests equal the fused skew family's (CHAOS_DIGESTS), K1
    launched once per shard per device step."""
    from raftsql_tpu_torch.chaos import run as crun
    from raftsql_tpu_torch.chaos.schedule import generate_skew
    from raftsql_tpu_torch.runtime.hostplane import ClusterHostPlane
    steps = [0]
    real = ClusterHostPlane._readback

    def counted(*a, **kw):
        steps[0] += 1
        return real(*a, **kw)

    k1 = "pallas_quorum_commit_index"
    pq.reset_launches()                        # the mesh chaos path
    ClusterHostPlane._readback = staticmethod(counted)
    try:
        with slots_env(8):
            reps = []
            for _ in range(RUNS):
                t0 = time.monotonic()
                r = crun.run_mesh(generate_skew(0), device=dev,
                                  commit_rule="pallas")
                r["wall_s"] = time.monotonic() - t0
                reps.append(r)
    finally:
        ClusterHostPlane._readback = staticmethod(real)
    launches = pq.launches[k1]
    for r in reps:
        expect((r["schedule_digest"], r["result_digest"]),
               CHAOS_DIGESTS["mesh_skew"], "mesh_skew digests")
        if not (r["skew_ticks"] > 0 and r["crashes"] >= 1):
            raise AssertionError(f"mesh_skew: faults never fired ({r})")
    expect(launches, 4 * steps[0], "mesh chaos K1 launches against device "
                                   "steps x 4 group shards")
    log(f"mesh chaos mesh_skew seed 0 x{RUNS}: digests "
        f"{CHAOS_DIGESTS['mesh_skew']} (= skew), skew ticks "
        f"{reps[0]['skew_ticks']}, crashes {reps[0]['crashes']}, K1 "
        f"launches {launches} = {steps[0]} device steps x 4 shards, "
        f"{reps[0]['wall_s']:.1f} s on {card}")
    return {"launches": launches}


# ---- phase 20 ---------------------------------------------------------------

POD_DIST_ENV = "RAFTSQL_POD_JAX_DISTRIBUTED"


def _coord_pair() -> str:
    """A localhost pod coordinator `host:port` whose port and the port
    above it are free: the distributed pod's process group meets at
    port + 1 (pod/config.py PodConfig.distributed_address)."""
    for _ in range(64):
        a, b = socket.socket(), socket.socket()
        try:
            a.bind(("127.0.0.1", 0))
            port = a.getsockname()[1]
            b.bind(("127.0.0.1", port + 1))
        except OSError:
            continue
        finally:
            a.close()
            b.close()
        return f"127.0.0.1:{port}"
    raise AssertionError("no free pair of localhost ports")


def pod_servers(card: str, dev="cuda", groups=8, threads=16,
                per=25) -> dict:
    """Two pods of two `python -m raftsql_tpu_torch.server.main --pod
    --pod-procs 2` processes each on the card (8 groups, --group-shards
    2, 2 shard slots each), booted at once: the replicated default and
    the one program over hosts (RAFTSQL_POD_JAX_DISTRIBUTED=1,
    --pod-dist-backend gloo: NCCL refuses two ranks on one card).  For
    each pod in turn: writes go through a client pointed at host 0,
    which follows the 421 to the owner; every acked PUT is read back
    from its owner (host 0 owns groups 0-3, host 1 groups 4-7); a
    misdirected write answers 421 naming the owner; host 0, stopped
    first, exits 0, and host 1 exits 0 or the pod-wide fail-stop
    code."""
    from raftsql_tpu_torch.api.client import RaftSQLClient
    from raftsql_tpu_torch.server.main import EXIT_CODE_FATAL
    work = os.path.join(ROOT, "build", "chip_smoke_pod")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.monotonic()
    pods = {}
    for tag, env, extra in (
            ("replicated", {}, []),
            ("distributed", {POD_DIST_ENV: "1"},
             ["--pod-dist-backend", "gloo"])):
        ports = [_free_port(), _free_port()]
        coord = _coord_pair()
        hosts = ",".join(f"127.0.0.1:{p}" for p in ports)
        os.makedirs(os.path.join(work, tag))     # each pod its data dirs
        pods[tag] = (ports, [
            _spawn(["--pod", "--pod-procs", "2", "--pod-id", str(i),
                    "--pod-coord", coord, "--pod-hosts", hosts,
                    "--port", str(p), "--groups", str(groups),
                    "--group-shards", "2", "--device", dev, *extra],
                   os.path.join(work, tag), f"host{i}",
                   dict(env, RAFTSQL_SHARD_SLOTS="2"))
            for i, p in enumerate(ports)])
    owner = lambda g: 0 if g < groups // 2 else 1  # noqa: E731
    out = {}
    try:
        for tag, (ports, procs) in pods.items():
            cli = RaftSQLClient([f"127.0.0.1:{ports[0]}"], timeout_s=15.0)
            try:
                cli.wait_healthy(0, deadline_s=180.0)
                t_up = time.monotonic() - t0
                # Host 1 boots beside host 0 and may answer /healthz
                # later: its groups' hints come once it does.
                _until(lambda: cli.refresh_hints(timeout_s=5.0) == groups,
                       f"{tag} pod hints for every group", timeout_s=120.0)
                expect(len(cli.nodes), 2, f"{tag} pod: host 1 adopted "
                                          "from /healthz")
                for g in range(groups):
                    cli.put("CREATE TABLE main.t (name text)", group=g,
                            deadline_s=120.0)
                st, hdrs, _ = cli.raw(
                    0, "PUT", "/", 'INSERT INTO main.t (name) VALUES ("x")',
                    headers={"X-Raft-Group": str(groups - 1)})
                expect((st, hdrs.get("X-Raft-Leader")), (421, "2"),
                       f"misdirected {tag} pod write")
                acked, lat = _client_load([f"127.0.0.1:{ports[0]}"],
                                          groups, threads, per, tag)
                _read_back(cli, owner, groups, lambda g: [], acked,
                           f"{tag} pod servers")
                docs = [json.loads(cli.raw(i, "GET", "/metrics")[2])
                        for i in range(2)]
                health = [cli.health(i)["pod"] for i in range(2)]
            finally:
                cli.close()
            expect([h.get("distributed", False) for h in health],
                   [tag == "distributed"] * 2, f"{tag} pod: /healthz pod")
            codes = [_stop(p) for p in procs]
            # Host 0 (the coordinator) is stopped first, with host 1
            # still up, so it must stop clean; host 1 then loses the
            # coordinator and may fail-stop before its own SIGTERM lands.
            if codes[0] != 0 or codes[1] not in (0, EXIT_CODE_FATAL):
                raise AssertionError(f"{tag} pod server exit codes {codes}")
            p50 = lat[len(lat) // 2] * 1e3
            p99 = lat[int(len(lat) * 0.99)] * 1e3
            dist_s = ""
            if tag == "distributed":
                dist_s = (f"; process group {health[0]['dist_backend']}, "
                          f"all-gathers {[h['dist_gathers'] for h in health]}"
                          f", ms each {[h['dist_gather_ms_per_tick'] for h in health]}")
            log(f"pod servers ({tag}): up {t_up:.1f} s after spawn; "
                f"{len(lat)} PUTs from {threads} threads through host 0 "
                f"(421s followed to the owner) acked and read back from "
                f"their owners, PUT p50 {p50:.2f} ms p99 {p99:.2f} ms; pod "
                f"gathers {[d['pod']['gathers'] for d in docs]}, proposals "
                f"routed {[d['pod']['proposals_routed'] for d in docs]}, "
                f"phase_ms_per_tick host 0 {docs[0]['phase_ms_per_tick']}"
                f"{dist_s}; exit codes {codes} on {card}")
            out[tag] = {"p50": p50, "p99": p99}
    except BaseException:
        for tag in pods:
            for i in range(2):
                log(f"--- {tag} pod host {i} log tail ---\n"
                    f"{_tail(os.path.join(work, tag), f'host{i}')}")
        raise
    finally:
        for _ports, procs in pods.values():
            for p in procs:
                if p.poll() is None:
                    _stop(p)
    shutil.rmtree(work, ignore_errors=True)
    return dict(out["replicated"], distributed=out["distributed"])


def pod_dryrun(card: str, dev="cuda", groups=1024, ticks=60) -> dict:
    """`pod.dryrun --mode equiv` with 2 processes on the card (G = 1024
    over 8 group shards, 8 shard slots each, commit_rule="pallas"), a
    second pair at once with the one program over hosts
    (RAFTSQL_POD_JAX_DISTRIBUTED=1, --dist-backend gloo: each steps its
    4 shards), and the single-controller run of the same workload in
    this process (a procs == 1 pod): every dump's digest must be equal.
    The in-process run is the pod path's K1 count: one launch per shard
    per device step; one shard's K1 inputs are copied."""
    from raftsql_tpu_torch.pod.dryrun import (build_pod_node, drain_commits,
                                              seeded_workload, state_doc)
    from raftsql_tpu_torch.runtime.hostplane import ClusterHostPlane
    work = os.path.join(ROOT, "build", "chip_smoke_pod_dryrun")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.monotonic()
    procs = []
    names = ["h0", "h1", "d0", "d1"]
    for tag, extra, more in (("h", {}, []),
                             ("d", {POD_DIST_ENV: "1"},
                              ["--dist-backend", "gloo"])):
        coord = _coord_pair()
        env = dict(os.environ, PYTHONPATH=ROOT, RAFTSQL_SHARD_SLOTS="8",
                   **extra)
        for i in range(2):
            with open(os.path.join(work, f"{tag}{i}.log"), "ab") as logf:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "raftsql_tpu_torch.pod.dryrun",
                     "--procs", "2", "--proc-id", str(i), "--coord", coord,
                     "--data-dir", os.path.join(work, f"{tag}{i}"),
                     "--groups", str(groups), "--group-shards", "8",
                     "--ticks", str(ticks), "--seed", "0",
                     "--commit-rule", "pallas", "--device", dev, *more,
                     "--out", os.path.join(work, f"{tag}{i}.json")],
                    cwd=work, env=env, stdout=logf,
                    stderr=subprocess.STDOUT))

    class _A:
        procs = 1
        proc_id = 0
        coord = ""
        data_dir = os.path.join(work, "ref")
        peers = 3
        group_shards = 8
        connect_timeout = 30.0
        commit_rule = "pallas"
        device = dev
    _A.groups = groups

    steps = [0]
    real = ClusterHostPlane._readback

    def counted(*a, **kw):
        steps[0] += 1
        return real(*a, **kw)

    k1 = "pallas_quorum_commit_index"
    captured = {}
    real_k1 = pq.pallas_quorum_commit_index

    def spy(*args, **kw):
        captured[k1] = ([a.clone() for a in args], dict(kw))
        return real_k1(*args, **kw)

    with slots_env(8):
        node, cfg = build_pod_node(_A)
    applied = []
    wl = seeded_workload(0, ticks, groups)
    pq.reset_launches()                        # the pod path starts here
    ClusterHostPlane._readback = staticmethod(counted)
    try:
        t1 = time.monotonic()
        for t in range(ticks):
            for _i, g, payload in wl[t]:
                node.pod_propose(g, [payload])
            if t == ticks - 1:                 # copy the last shard's
                pq.pallas_quorum_commit_index = spy
            node.tick()
            applied.extend(drain_commits(node))
        dt = time.monotonic() - t1
        launches = pq.launches[k1]             # ... and ends here
        ref = state_doc(node, applied)
    finally:
        pq.pallas_quorum_commit_index = real_k1
        ClusterHostPlane._readback = staticmethod(real)
        node.stop()
    codes = [p.wait(timeout=300) for p in procs]
    if codes != [0] * 4:
        for n in names:
            log(f"--- pod dryrun {n} log tail ---\n{_tail(work, n)}")
        raise AssertionError(f"pod dryrun exit codes {codes}")
    docs = []
    for n in names:
        with open(os.path.join(work, f"{n}.json")) as f:
            docs.append(json.load(f))
    expect([d["digest"] for d in docs], [ref["digest"]] * 4,
           "pod dryrun dumps (replicated and distributed) against the "
           "single-controller run")
    expect(launches, 8 * steps[0], "pod path K1 launches against device "
                                   "steps x 8 shards")
    expect([sorted(os.listdir(os.path.join(work, n, "p1")))
            for n in ("d0", "d1")],
           [[f"s{j}" for j in (0, 2, 4, 6)], [f"s{j}" for j in (1, 3, 5, 7)]],
           "distributed pod dryrun: each host's owned shard dirs")
    log(f"pod dryrun equiv G={groups} over 8 shards, 2 processes on the "
        f"card, replicated and (at once) distributed over a gloo process "
        f"group: all four dumps digest {docs[0]['digest']}, "
        f"{len(docs[0]['kv_stream'])} applied rows, equal to the "
        f"single-controller run's; single controller "
        f"{dt / ticks * 1e3:.1f} ms/tick, K1 launches {launches} "
        f"({time.monotonic() - t0:.1f} s with the children) on {card}")
    shutil.rmtree(work, ignore_errors=True)
    return {"launches": launches, "captured": captured, "steps": steps[0]}


DIST_G, DIST_SHARDS = 32_768, 8     # bench.py bench_multichip's G


def dist_rank(rank: int, procs: int, coord: str, backend: str, out: str,
              ticks: int, timed: int, dev="cuda", G=DIST_G,
              after: str = "") -> int:
    """One rank of the distributed pod step (`chip_smoke.py --pod-rank
    R`, a child of phase 20): G = 32,768, P = 3, W = 64, E = 8 over 8
    group shards on the card, commit_rule="pallas", this rank holding
    its owned shards (PodConfig.shard_owner) in a process group of
    `procs` over `backend`.  For `ticks` ticks of seeded proposals and
    a skewed timer advance (every rank draws the same), the distributed
    step and the single-process sharded step of the whole state run in
    lockstep: packed info and busy equal every tick; K1's launches in
    the distributed step alone are counted, and rank 0 copies the
    inputs of its first owned shard's K1 call in the last tick.  Then
    `timed` ticks of each (the distributed step on every rank at once,
    then the replicated step on every rank at once, as replicated hosts
    sharing the card), ms per tick and the collective's ms per tick,
    once the file `after` exists (another process's result: the timed
    ticks then have the card to themselves).  Writes dist<rank>.json
    (and dist_k1.pt) under `out`."""
    import torch.distributed as dist

    from raftsql_tpu_torch.parallel import (make_distributed_cluster_step_host,
                                            make_mesh,
                                            make_sharded_cluster_step_host,
                                            shard, shard_cluster_arrays)
    from raftsql_tpu_torch.parallel.sharded import inbox_specs, state_specs
    from raftsql_tpu_torch.pod import PodConfig
    P, W, E, gg = 3, 64, 8, DIST_SHARDS
    k1 = "pallas_quorum_commit_index"
    pod = PodConfig(procs=procs, proc_id=rank, coordinator=coord)
    pq.build()
    got = pod.init_distributed(device=dev, backend=backend, timeout_s=300)
    try:
        ranks = pod.rank_group(gg)
        cfg = RaftConfig(num_groups=G, num_peers=P, log_window=W,
                         max_entries_per_msg=E, commit_rule="pallas")
        mesh = make_mesh(1, gg, devices=[torch.device(dev)] * gg)
        dstep = make_distributed_cluster_step_host(cfg, mesh, ranks)
        rstep = make_sharded_cluster_step_host(cfg, mesh)
        st0 = cluster.init_cluster_state(cfg, device=dev)
        ib0 = cluster.empty_cluster_inbox(cfg, device=dev)
        ds = shard(mesh, st0, state_specs(), ranks.owned)
        di = shard(mesh, ib0, inbox_specs(), ranks.owned)
        rs, ri = shard_cluster_arrays(mesh, st0, ib0)
        del st0, ib0
        rng = np.random.default_rng(20)

        def inputs(n):
            pn = rng.integers(0, E + 1, (n, P, G)).astype(np.int32)
            ti = rng.integers(0, 3, (n, P)).astype(np.int32)
            return (torch.from_numpy(pn).to(dev),
                    torch.from_numpy(ti).to(dev))

        real = pq.pallas_quorum_commit_index
        captured = {}

        def spy(*args, **kw):
            if k1 not in captured:
                captured[k1] = ([a.clone() for a in args], dict(kw))
            return real(*args, **kw)

        launches = 0
        pns, tis = inputs(ticks)
        for t in range(ticks):
            if t == ticks - 1 and rank == 0:
                pq.pallas_quorum_commit_index = spy
            n0 = pq.launches[k1]
            try:
                ds, di, dinfo, dbusy, _ = dstep(ds, di, pns[t], tis[t])
            finally:
                pq.pallas_quorum_commit_index = real
            launches += pq.launches[k1] - n0
            rs, ri, rinfo, rbusy = rstep(rs, ri, pns[t], tis[t])
            if not torch.equal(dinfo.to(dev), rinfo) \
                    or bool(dbusy) != bool(rbusy):
                raise AssertionError(f"rank {rank}: the distributed step "
                                     f"!= the sharded step at tick {t}")
        leaders = int(sum(int(((rs.blocks[0][j].role == 2).sum(0) > 0)
                              .sum()) for j in range(gg)))
        doc = {"rank": rank, "procs": procs, "backend": got,
               "owned": ranks.owned, "steps": ticks, "launches": launches,
               "leaders": leaders}
        if timed:
            pns, tis = inputs(timed)
            until = time.monotonic() + 300.0
            while after and not os.path.exists(after):
                if time.monotonic() > until:
                    raise AssertionError(f"{after} never appeared")
                time.sleep(0.1)
            dist.barrier()
            _sync(dev)
            g0, s0 = ranks.gathers, ranks.gather_s
            t0 = time.perf_counter()
            for t in range(timed):
                ds, di, dinfo, dbusy, _ = dstep(ds, di, pns[t], tis[t])
                bool(dbusy)                 # the host plane's readback
            doc["dist_ms"] = (time.perf_counter() - t0) / timed * 1e3
            doc["coll_ms"] = ((ranks.gather_s - s0)
                              / max(ranks.gathers - g0, 1) * 1e3)
            dist.barrier()
            _sync(dev)
            t0 = time.perf_counter()
            for t in range(timed):
                rs, ri, rinfo, rbusy = rstep(rs, ri, pns[t], tis[t])
                bool(rbusy)
            doc["repl_ms"] = (time.perf_counter() - t0) / timed * 1e3
            dist.barrier()
        if captured:
            torch.save(captured, os.path.join(out, "dist_k1.pt"))
        tmp = os.path.join(out, f"dist{rank}.json.tmp")
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, os.path.join(out, f"dist{rank}.json"))
    finally:
        PodConfig.destroy_distributed()
    return 0


def _start_ranks(work, procs, backend, ticks, timed, after=""):
    """Start `procs` rank processes of dist_rank (results under
    `work`)."""
    os.makedirs(work, exist_ok=True)
    coord = _coord_pair()
    env = dict(os.environ, PYTHONPATH=ROOT)
    ps = []
    for r in range(procs):
        with open(os.path.join(work, f"rank{r}.log"), "ab") as logf:
            ps.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--pod-rank",
                 str(r), "--pod-procs", str(procs), "--pod-coord", coord,
                 "--pod-backend", backend, "--pod-out", work,
                 "--pod-ticks", str(ticks), "--pod-timed", str(timed),
                 "--pod-after", after],
                cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT))
    return ps


def _finish_ranks(work, ps, backend, timeout=600):
    """Wait for the ranks; their result docs, each K1 count checked."""
    try:
        codes = [p.wait(timeout=timeout) for p in ps]
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.wait()
    if codes != [0] * len(ps):
        for r in range(len(ps)):
            log(f"--- distributed rank {r} of {len(ps)} ({backend}) log "
                f"tail ---\n{_tail(work, f'rank{r}')}")
        raise AssertionError(f"distributed pod ranks ({backend}) exit "
                             f"codes {codes}")
    docs = []
    for r in range(len(ps)):
        with open(os.path.join(work, f"dist{r}.json")) as f:
            docs.append(json.load(f))
    for d in docs:
        expect(d["launches"], len(d["owned"]) * d["steps"],
               f"rank {d['rank']} of {len(ps)} ({backend}): K1 launches "
               "against owned shards x steps")
    return docs


def pod_distributed(card: str, dev="cuda", ticks=64, timed=32) -> dict:
    """The one program over hosts at the bench's multichip group count
    (see dist_rank): two ranks on the card over a gloo process group
    (NCCL refuses two ranks on one device), each bit-identical to the
    single-process sharded step for `ticks` ticks and K1 launched once
    per owned shard per step; then one rank alone over NCCL, the
    backend a CUDA host gets by default, for 16 ticks.  Both ranks share
    one card and gloo stages the collective through host memory, so
    the times show what the sharded program costs here, not scaling."""
    work = os.path.join(ROOT, "build", "chip_smoke_pod_dist")
    shutil.rmtree(work, ignore_errors=True)
    gw, nw = os.path.join(work, "gloo"), os.path.join(work, "nccl")
    t0 = time.monotonic()
    # The NCCL rank runs beside the pair's lockstep ticks; the pair
    # times its ticks only once the NCCL rank is done.
    nccl_ps = _start_ranks(nw, 1, "nccl", 16, 0)
    gloo_ps = _start_ranks(gw, 2, "gloo", ticks, timed,
                           after=os.path.join(nw, "dist0.json"))
    nccl = _finish_ranks(nw, nccl_ps, "nccl")[0]
    docs = _finish_ranks(gw, gloo_ps, "gloo")
    wall = time.monotonic() - t0
    captured = torch.load(os.path.join(gw, "dist_k1.pt"), map_location=dev)
    for d in docs:
        log(f"pod distributed G={DIST_G} P=3 W=64 E=8 pallas over "
            f"{DIST_SHARDS} shards, rank {d['rank']} of 2 (gloo, one "
            f"card): owns shards {d['owned']}, {d['steps']} ticks "
            f"bit-identical to the single-process sharded step "
            f"({d['leaders']} groups with a leader), K1 launches "
            f"{d['launches']} = {len(d['owned'])} owned shards x "
            f"{d['steps']} steps; ms/tick distributed "
            f"{d['dist_ms']:.2f} (of it the all-gather "
            f"{d['coll_ms']:.2f}) against replicated {d['repl_ms']:.2f}, "
            f"both ranks at once on one card: the sharded program's cost "
            f"here, not scaling, on {card}")
    expect(nccl["backend"], "nccl", "one-rank group backend")
    log(f"pod distributed over NCCL, one rank (world size 1) owning all "
        f"{len(nccl['owned'])} shards: {nccl['steps']} ticks bit-identical "
        f"to the replicated step, K1 launches {nccl['launches']}; the "
        f"three ranks {wall:.1f} s on {card}")
    shutil.rmtree(work, ignore_errors=True)
    return {"launches": sum(d["launches"] for d in docs)
            + nccl["launches"], "captured": captured, "ranks": docs,
            "nccl": nccl}


def pod_chaos(card: str, dev="cuda") -> None:
    """The pod gauntlet (chaos.run pod_gauntlet, what --pod runs) at seed
    0, RUNS times, every child a CUDA process over 8 shard slots: every
    scripted fault fires, no child dies of anything unscripted, writes
    are acked, and (plan, verdict) equals the JAX package's all-pass
    digests (PROC_VERDICTS["pod"]); then the falsification pair: the
    premature ack is caught and the honest control passes."""
    from raftsql_tpu_torch.chaos import run as crun
    t0 = time.monotonic()
    # Its RUNS nemesis runs and the falsification pair run at once.
    ok, reports = crun.pod_gauntlet(0, runs=RUNS, device=dev,
                                    workers=RUNS + 2)
    if not ok:
        raise AssertionError("the pod gauntlet failed (see CHAOS FAIL "
                             "above)")
    for r in reports:
        expect((r["plan_digest"], r["result_digest"]), PROC_VERDICTS["pod"],
               "pod gauntlet digests")
        log(f"pod chaos: plan={r['plan_digest']} verdict="
            f"{r['result_digest']} acked {r['acked']}, kills "
            f"{r['kills']} (coordinator {r['coord_kills']}), pod-lost "
            f"exits {r['pod_lost_exits']}, cut deferred "
            f"{r['cut_deferred']}, re-offered {r['reoffered']}, "
            f"unexpected {r['unexpected_exits']}; {r['wall_s']:.1f} s "
            f"on {card}")
    log(f"pod chaos: the falsification pair caught the premature ack "
        f"and its control passed; gauntlet {time.monotonic() - t0:.1f} s "
        f"on {card}")


# ---- phases 21 and 22: the workers plane and the replica tier ---------------

LADDER_CONNS = 192          # bench.py's http_workers ladder's clients
LADDER_S = 3.0


def _proc_stat(pid: int):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()
    except OSError:
        return None


def _alive(pid: int) -> bool:
    st = _proc_stat(pid)
    return st is not None and st[0] != "Z"


def _children(pid: int) -> list:
    """Live child pids of `pid`."""
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            st = _proc_stat(int(d))
            if st is not None and st[0] != "Z" and int(st[1]) == pid:
                out.append(int(d))
    return sorted(out)


def _maps_driver(pid: int) -> bool:
    """True when the process has the CUDA driver library (libcuda.so)
    mapped."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            return "libcuda.so" in f.read()
    except OSError:
        return False


def _no_card_env(pid: int) -> bool:
    """True when the process runs with CUDA_VISIBLE_DEVICES empty."""
    try:
        with open(f"/proc/{pid}/environ", "rb") as f:
            env = f.read().split(b"\0")
    except OSError:
        return False
    return b"CUDA_VISIBLE_DEVICES=" in env


def only_engine_on_card(engine: int, others: list, what: str,
                        apps_want: int = 1) -> None:
    """The engine is the only compute process on the card while `others`
    (workers, replicas) serve: nvidia-smi lists `apps_want` compute apps
    (1; 2 when the engine is a child and this script's process holds
    its own context), none of them one of the others' pids, and every
    other process runs with no visible card (CUDA_VISIBLE_DEVICES
    empty)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    apps = [int(line.split(",")[0]) for line in out.splitlines() if line]
    expect([p for p in others if p in apps], [],
           f"{what}: other processes in nvidia-smi's compute apps")
    expect([p for p in others if not _no_card_env(p)], [],
           f"{what}: other processes that can see the card")
    # nvidia-smi may list the card's processes by pids of another pid
    # namespace, so the count is what is held.
    expect(len(apps), apps_want,
           f"{what}: compute apps on the card ({out!r})")
    log(f"{what}: compute apps on the card {out!r} (engine pid {engine}, "
        f"libcuda.so mapped {_maps_driver(engine)}); {len(others)} "
        f"processes beside it with no visible card (libcuda.so mapped "
        f"in {sum(_maps_driver(p) for p in others)})")


def _wait_healthy(port, deadline_s=120.0) -> None:
    from raftsql_tpu_torch.api.client import RaftSQLClient
    cli = RaftSQLClient([f"127.0.0.1:{port}"], timeout_s=15.0)
    try:
        cli.wait_healthy(0, deadline_s=deadline_s)
    finally:
        cli.close()


def _req_h(port, method, body=b"", headers=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request(method, "/", body=body, headers=headers or {})
        r = c.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        c.close()


class RingEngine:
    """The --workers deployment with its engine in this process:
    build_fused_node on the card (parity mode, commit_rule="pallas"), a
    RingServer over `n` ring pairs, and `n` worker processes spawned by
    server/main.py spawn_worker, as _serve_workers spawns them.  A shm
    plane that disabled itself fails."""

    def __init__(self, work, name, n, groups, dev):
        from raftsql_tpu_torch.runtime.ring import RingServer
        from raftsql_tpu_torch.server.main import (build_fused_node,
                                                   spawn_worker)
        self.rdb = build_fused_node(
            groups=groups, peers=3, data_prefix=os.path.join(work, name),
            commit_rule="pallas", device=dev)
        self.ring = RingServer(self.rdb, os.path.join(work, f"{name}-rings"),
                               n)
        self.procs, self._log = [], None
        try:
            if self.ring.shm is None:
                raise AssertionError(f"{name}: the shm read plane disabled "
                                     "itself at boot")
            self.ring.start()
            self.port = _free_port()
            self._log = open(os.path.join(work, f"{name}-workers.log"),
                             "ab")
            self.procs = [spawn_worker(self.ring.dirname, i, self.port,
                                       log_file=self._log)
                          for i in range(n)]
            _wait_healthy(self.port)
        except BaseException:
            log(f"--- {name} workers log tail ---\n"
                f"{_tail(work, f'{name}-workers')}")
            self.close()
            raise

    def close(self):
        from raftsql_tpu_torch.server.main import stop_workers
        stop_workers(self.procs)
        self.ring.stop()
        if self._log is not None:
            self._log.close()
        expect(self.rdb.close(), None, "ring engine close")


def _tables_for_load(port, groups) -> None:
    for g in range(groups):
        expect(_req(port, "PUT", b"CREATE TABLE t (v text)", g),
               (204, b""), f"load table g{g}")


def http_load(exe, port, groups, what, card, node, secs=LADDER_S,
              conns=LADDER_CONNS) -> dict:
    """One rung: the native loadgen against `port`; 0 errors.  Also the
    engine's ticks during the rung, split by phase, and the entries
    committed a tick."""
    m = node.metrics
    m0 = (m.ticks, m.t_device_ms, m.t_wal_ms, m.t_publish_ms,
          time.monotonic())
    out = subprocess.run([exe, str(secs), str(conns), str(groups),
                          str(port)], capture_output=True, text=True,
                         timeout=secs + 120)
    ticks = max(m.ticks - m0[0], 1)
    split = {"ticks": ticks,
             "wall_ms": (time.monotonic() - m0[4]) * 1e3 / ticks,
             "device_ms": (m.t_device_ms - m0[1]) / ticks,
             "wal_ms": (m.t_wal_ms - m0[2]) / ticks,
             "publish_ms": (m.t_publish_ms - m0[3]) / ticks}
    if out.returncode != 0:
        raise AssertionError(f"{what}: http_load rc={out.returncode}: "
                             f"{out.stderr[-800:]}")
    j = json.loads(out.stdout.strip().splitlines()[-1])
    expect(j["errors"], 0, f"{what}: loadgen errors")
    if j["n"] <= 0:
        raise AssertionError(f"{what}: no request completed ({j})")
    j["req_s"] = j["n"] / j["secs"]
    j["tick"] = split
    log(f"{what}: {j['n']} PUTs in {j['secs']:.2f} s from {conns} "
        f"connections: {j['req_s']:.1f} req/s, p50 {j['p50_ms']:.2f} ms "
        f"p99 {j['p99_ms']:.2f} ms, 0 errors; {ticks} ticks, "
        f"{j['n'] / ticks:.1f} PUTs a tick, per tick: wall "
        f"{split['wall_ms']:.2f} ms, device (dispatch + readback) "
        f"{split['device_ms']:.2f}, WAL + fsync {split['wal_ms']:.2f}, "
        f"publish {split['publish_ms']:.2f} on {card}")
    return j


def _shm_reads(port, groups, what) -> int:
    """Local and session GETs through the workers, then the largest
    reads.shm_hits over 16 GET /metrics (each on a new connection, so
    they reach both workers)."""
    for g in range(groups):
        st, h, _ = _req_h(port, "PUT", b'INSERT INTO main.t (name) VALUES '
                          b'("shm")', {"X-Raft-Group": str(g)})
        expect(st, 204, f"{what}: session PUT g{g}")
        wm = h["X-Raft-Session"]
        st, _, body = _req_h(port, "GET", b"SELECT count(*) FROM main.t",
                             {"X-Raft-Group": str(g)})
        expect(st, 200, f"{what}: local GET g{g}")
        want = body
        for _ in range(8):
            for mode, extra in (("local", {}),
                                ("session", {"X-Raft-Session": wm})):
                st, _, body = _req_h(
                    port, "GET", b"SELECT count(*) FROM main.t",
                    {"X-Raft-Group": str(g), "X-Consistency": mode,
                     **extra})
                expect((st, body), (200, want), f"{what}: {mode} GET g{g}")
    hits = []
    for _ in range(16):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            c.request("GET", "/metrics")
            doc = json.loads(c.getresponse().read())
        finally:
            c.close()
        hits.append(int(doc["reads"]["shm_hits"]))
    if max(hits) <= 0:
        raise AssertionError(f"{what}: the shm fast path served no read "
                             f"(shm_hits {hits})")
    return max(hits)


def workers_plane(card: str, dev="cuda", groups=8) -> dict:
    """Phase 21 (see the module docstring)."""
    from raftsql_tpu_torch.native.build import build_http_load
    from raftsql_tpu_torch.server.main import build_fused_node
    from raftsql_tpu_torch.api.aio import AioSQLServer
    k1 = "pallas_quorum_commit_index"
    work = os.path.join(ROOT, "build", "chip_smoke_workers")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.monotonic()
    exe = build_http_load()                 # raises when g++ fails
    log(f"workers: http_load built in {time.monotonic() - t0:.1f} s")
    res = {"launches": 0, "steps": 0, "ladder": {}}

    def counted(eng_node):
        """K1 launches over an engine's life equal its device steps."""
        steps = eng_node._device_steps
        got = pq.launches[k1]
        expect(got, steps, "K1 launches = device steps, workers path")
        if steps <= 0:
            raise AssertionError("the workers engine took no device step")
        res["launches"] += got
        res["steps"] += steps

    # (a) the checks, 2 workers.  The inputs of K1's first call that
    # advances some row's commit are copied (R = 24 rows, P = 3).
    captured = {}
    pq.reset_launches()                     # the workers path starts here
    with spy_fused_kernel(k1, captured):
        eng = RingEngine(work, "checks", 2, groups, dev)
        node = eng.rdb.pipe.node
        try:
            recipe(eng.port, groups, "workers")
            only_engine_on_card(os.getpid(), [p.pid for p in eng.procs],
                                "workers")
            _, p50, p99 = put_load(eng.rdb, eng.port, groups, card,
                                   "workers")
            res["put_p50"], res["put_p99"] = p50, p99
            res["shm_hits"] = _shm_reads(eng.port, groups, "workers")
        finally:
            eng.close()
    counted(node)                            # ... and ends here
    if k1 not in captured:
        raise AssertionError("the workers engine never launched K1 on a "
                             "leader row")
    res["captured"] = captured
    log(f"workers: recipe, {16 * 25} PUTs read back, shm fast path "
        f"{res['shm_hits']} hits at one worker; K1 {res['launches']} "
        f"launches = {res['steps']} device steps on {card}")

    # (b) the load ladder: the in-process aio server, then 1 and 2
    # workers, each a fresh engine.
    pq.reset_launches()
    rdb = build_fused_node(groups=groups, peers=3,
                           data_prefix=os.path.join(work, "aio"),
                           commit_rule="pallas", device=dev)
    srv = AioSQLServer(_free_port(), rdb, host="127.0.0.1")
    srv.start()
    try:
        _tables_for_load(srv.port, groups)
        res["ladder"]["aio"] = http_load(exe, srv.port, groups,
                                         "ladder in-process aio server",
                                         card, rdb.pipe.node)
    finally:
        srv.stop()
        expect(rdb.close(), None, "aio rung close")
    for n in (1, 2):
        pq.reset_launches()                  # this rung's path starts here
        eng = RingEngine(work, f"rung{n}", n, groups, dev)
        node = eng.rdb.pipe.node
        try:
            _tables_for_load(eng.port, groups)
            res["ladder"][n] = http_load(exe, eng.port, groups,
                                         f"ladder {n} workers", card,
                                         node)
        finally:
            eng.close()
        counted(node)                        # ... and ends here

    # (c) the CLI deployment: respawn under load, SIGTERM.
    res["cli"] = workers_cli(card, dev, groups, work)
    shutil.rmtree(work, ignore_errors=True)
    return res


def workers_cli(card, dev, groups, work, threads=8, secs=4.0) -> dict:
    """`python -m raftsql_tpu_torch.server.main --fused --workers 2
    --groups 8` on the card: the recipe, a worker SIGKILLed (and
    respawned) while PUTs continue with every acked PUT read back, then
    SIGTERM: exit 0 and no worker left."""
    cli = os.path.join(work, "cli")
    os.makedirs(cli)
    port = _free_port()
    t0 = time.monotonic()
    p = _spawn(["--fused", "--workers", "2", "--groups", str(groups),
                "--port", str(port), "--device", dev], cli, "server", {})
    workers = []
    try:
        _wait_healthy(port, 180.0)
        t_up = time.monotonic() - t0
        recipe(port, groups, "workers CLI")
        workers = _children(p.pid)
        expect(len(workers), 2, "workers CLI: worker processes")
        only_engine_on_card(p.pid, workers, "workers CLI", apps_want=2)
        acked, failed = [], [0]
        mu = threading.Lock()
        stop_at = time.monotonic() + secs

        def client(i):
            k = 0
            while time.monotonic() < stop_at:
                g, v = (i + k) % groups, f"cli-c{i}-{k}"
                k += 1
                try:
                    st, _ = _req(port, "PUT", f'INSERT INTO main.t (name) '
                                 f'VALUES ("{v}")'.encode(), g)
                except OSError:
                    st = None
                with mu:
                    if st == 204:
                        acked.append((g, v))
                    else:
                        failed[0] += 1

        ths = [threading.Thread(target=client, args=(i,))
               for i in range(threads)]
        for t in ths:
            t.start()
        time.sleep(secs / 3)
        victim = workers[0]
        os.kill(victim, signal.SIGKILL)
        until = time.monotonic() + 60.0
        while True:
            now = _children(p.pid)
            if len(now) == 2 and victim not in now:
                break
            if time.monotonic() > until:
                raise AssertionError(f"workers CLI: no respawn ({now})")
            time.sleep(0.1)
        t_respawn = 60.0 - (until - time.monotonic())
        for t in ths:
            t.join()
        workers = now
        for g in range(groups):
            want = sorted(["|abc|"] + [f"|{v}|" for gg, v in acked
                                       if gg == g])
            st, body = _req(port, "GET", b"SELECT name FROM main.t", g)
            got = sorted(x for x in body.decode().strip().split("\n") if x)
            missing = sorted(set(want) - set(got))
            expect(missing, [], f"workers CLI: acked PUTs of g{g} read back")
    except BaseException:
        log(f"--- workers CLI log tail ---\n{_tail(cli, 'server')}")
        raise
    finally:
        code = _stop(p)
        until = time.monotonic() + 30.0
        while any(_alive(w) for w in workers) and time.monotonic() < until:
            time.sleep(0.1)
        left = [w for w in workers if _alive(w)]
        for w in left:
            os.kill(w, signal.SIGKILL)
    expect(code, 0, "workers CLI: exit code after SIGTERM")
    expect(left, [], "workers CLI: workers left after the engine's exit")
    log(f"workers CLI: up {t_up:.1f} s after spawn; recipe; {len(acked)} "
        f"PUTs acked from {threads} threads ({failed[0]} failed) while "
        f"worker {victim} was SIGKILLed and respawned in {t_respawn:.1f} "
        f"s, every acked PUT read back; SIGTERM exit 0, no worker left, "
        f"on {card}")
    return {"acked": len(acked), "failed": failed[0],
            "respawn_s": t_respawn, "up_s": t_up}


def replica_tier(card: str, dev="cuda", groups=2, writes=40) -> dict:
    """Phase 22 (see the module docstring)."""
    from raftsql_tpu_torch.chaos import run as crun
    work = os.path.join(ROOT, "build", "chip_smoke_replica")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    api, stream = _free_port(), _free_port()
    rports = [_free_port(), _free_port()]
    t0 = time.monotonic()
    eng = _spawn(["--fused", "--groups", str(groups), "--port", str(api),
                  "--tick", "0.005", "--lease-ticks", "40",
                  "--replica-listen", str(stream), "--device", dev],
                 work, "engine", {})
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    reps = []
    for i, rp in enumerate(rports):
        with open(os.path.join(work, f"replica{i}.log"), "ab") as logf:
            reps.append(subprocess.Popen(
                [sys.executable, "-m", "raftsql_tpu_torch.replica",
                 "--upstream", f"127.0.0.1:{stream}", "--port", str(rp)],
                cwd=work, env=env, stdout=logf, stderr=subprocess.STDOUT))
    res = {}
    try:
        until = time.monotonic() + 180.0
        for g in range(groups):
            while True:
                if eng.poll() is not None or time.monotonic() > until:
                    raise AssertionError("replica engine never served")
                try:
                    if _req(api, "PUT", b"CREATE TABLE t (k int)",
                            g)[0] == 204:
                        break
                except OSError:
                    pass
                time.sleep(0.3)
        res["up_s"] = time.monotonic() - t0
        wm, acked = [0] * groups, [0] * groups
        for k in range(writes):
            g = k % groups
            st, h, _ = _req_h(api, "PUT",
                              f"INSERT INTO t VALUES ({k})".encode(),
                              {"X-Raft-Group": str(g)})
            expect(st, 204, "replica tier: engine PUT")
            wm[g] = max(wm[g], int(h["X-Raft-Session"]))
            acked[g] += 1
        t1 = time.monotonic()
        for i, rp in enumerate(rports):
            for g in range(groups):
                want = f"|{acked[g]}|".encode()
                until = time.monotonic() + 60.0
                while True:
                    try:
                        st, _, body = _req_h(
                            rp, "GET", b"SELECT count(*) FROM t",
                            {"X-Raft-Group": str(g),
                             "X-Consistency": "session",
                             "X-Raft-Session": str(wm[g])})
                    except OSError:
                        st, body = None, b""
                    if st == 200:
                        expect(body.strip(), want,
                               f"replica {i} g{g}: session read")
                        break
                    if time.monotonic() > until:
                        raise AssertionError(f"replica {i} never served a "
                                             f"session read ({st})")
                    time.sleep(0.1)
        res["session_s"] = time.monotonic() - t1
        only_engine_on_card(eng.pid, [r.pid for r in reps], "replica tier",
                            apps_want=2)
        expect(_stop(eng), 0, "replica engine: exit code after SIGTERM")
        for i, rp in enumerate(rports):
            until = time.monotonic() + 30.0
            while True:
                try:
                    st = _req_h(rp, "GET", b"SELECT count(*) FROM t",
                                {"X-Consistency": "linear"})[0]
                except OSError:
                    st = None
                if st == 421:
                    break
                if time.monotonic() > until:
                    raise AssertionError(f"replica {i}: linear read after "
                                         f"the upstream stopped: {st}")
                time.sleep(0.1)
    except BaseException:
        for name in ("engine", "replica0", "replica1"):
            log(f"--- {name} log tail ---\n{_tail(work, name)}")
        raise
    finally:
        for p in (*reps, eng):
            _stop(p)
    log(f"replica tier: parity-mode --replica-listen engine up in "
        f"{res['up_s']:.1f} s; {writes} acked PUTs served by both "
        f"replicas at their session watermarks within "
        f"{res['session_s']:.2f} s; linear reads refused (421) once the "
        f"upstream stopped, on {card}")
    t0 = time.monotonic()
    # Its RUNS nemesis runs and the falsification pair run at once.
    ok, reports, walls = crun.replica_gauntlet(0, runs=RUNS, device=dev,
                                               workers=RUNS + 2)
    if not ok:
        raise AssertionError("the replica gauntlet failed (see CHAOS FAIL "
                             "above)")
    for r in reports:
        expect((r["plan_digest"], r["result_digest"]),
               PROC_VERDICTS["replica"], "replica gauntlet digests")
        log(f"replica chaos: plan={r['plan_digest']} verdict="
            f"{r['result_digest']} acked {r['acked']}, served session "
            f"{r['served_session']} linear {r['served_linear']}, refusals "
            f"{r['refusals']} on {card}")
    res["walls"] = walls
    log(f"replica chaos: run wall times {[round(w, 1) for w in walls]} s "
        f"(nemesis x{RUNS}, broken, control; at once); the gate-less "
        f"replica was caught and its control passed; gauntlet "
        f"{time.monotonic() - t0:.1f} s on {card}")
    shutil.rmtree(work, ignore_errors=True)
    return res


# ---- phase 23 --------------------------------------------------------------

# The Prometheus families of the elastic keyspace (scripts/check_prom.py
# requires them of a --placement --reshard server).
RESHARD_FAMILIES = (
    "raftsql_reshard_splits", "raftsql_reshard_merges",
    "raftsql_reshard_migrations", "raftsql_reshard_aborted",
    "raftsql_reshard_resumed", "raftsql_reshard_epoch",
    "raftsql_reshard_active", "raftsql_reshard_duration_split_count",
    "raftsql_reshard_duration_merge_count",
    "raftsql_reshard_duration_migrate_count",
    "raftsql_placement_reshard_issued",
    "raftsql_placement_reshard_refused")
# scripts/bench_reshard.py's zipfian shape, and its artefact's hot-group
# shares (bench_logs/reshard_zipfian_s0.json: the JAX package at G = 4,
# 32 slots, on a CPU).
ZIPF_KEYS, ZIPF_S, ZIPF_PUTS = 256, 1.2, 800
ZIPF_JAX_SHARES = (0.4738, 0.3387)


def _kv_raw(port, method, key, body=b"", headers=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request(method, f"/kv/{key}", body=body, headers=headers or {})
        r = c.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        c.close()


def _metrics(port, prom=False):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request("GET", "/metrics?format=prom" if prom else "/metrics")
        body = c.getresponse().read().decode()
    finally:
        c.close()
    return body if prom else json.loads(body)


def _check_prom(port, what) -> int:
    """scripts/check_prom.py --url against a live server (a process of
    its own; the script's round trip reads the JSON-to-exposition
    mapping from the repo), then the reshard families in the
    exposition.  Returns the script's exit code (0, or this raises)."""
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "check_prom.py"),
         "--url", f"http://127.0.0.1:{port}"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    if r.returncode != 0:
        raise AssertionError(f"{what}: check_prom.py exit {r.returncode}:"
                             f"\n{r.stdout}{r.stderr}")
    text = _metrics(port, prom=True)
    missing = [f for f in RESHARD_FAMILIES
               if f"\n{f} " not in text and f"\n{f}{{" not in text]
    expect(missing, [], f"{what}: reshard families in /metrics?format=prom")
    return r.returncode


def _await_verb(plane, what, n_done, timeout=120.0):
    """Wait until the plane's coordinator finished `n_done` verbs in all
    (done or aborted) and is idle."""
    until = time.monotonic() + timeout
    while True:
        c = plane.coord.counters
        if not plane.coord.busy and (c["splits"] + c["merges"]
                                     + c["migrations"] + c["aborted"]
                                     >= n_done):
            return
        if time.monotonic() > until:
            raise AssertionError(f"{what}: verb stuck: {plane.doc()}")
        time.sleep(0.02)


def _hot_share(keymap, hits) -> tuple:
    loads = {}
    for k, n in hits.items():
        g = keymap.group_of(k)
        loads[g] = loads.get(g, 0) + n
    total = sum(loads.values()) or 1
    return round(max(loads.values()) / total, 4), loads


def _zipf_split_hottest(port, plane, pc, threads, card) -> dict:
    """scripts/bench_reshard.py's zipfian load (256 keys, s = 1.2, 800
    PUTs, random.Random(0)) from `threads` clients, each key written by
    one client in order, then the placement controller's split_hottest;
    the hot group's share of the load before and after, and every key's
    last acked value read back under the new mapping."""
    import random
    from raftsql_tpu_torch.api.client import RaftSQLClient
    rng = random.Random(0)
    keys = [f"user{r}" for r in range(ZIPF_KEYS)]
    draws = rng.choices(keys, weights=[1.0 / (r + 1) ** ZIPF_S
                                       for r in range(ZIPF_KEYS)],
                        k=ZIPF_PUTS)
    hits = {}
    for k in draws:
        hits[k] = hits.get(k, 0) + 1
    per = [[] for _ in range(threads)]
    for i, k in enumerate(draws):
        per[int(k[4:]) % threads].append((k, f"z{i}"))
    last, errors = {}, []
    mu = threading.Lock()

    def client(i):
        cli = RaftSQLClient([port], timeout_s=10.0, backoff_s=0.01)
        try:
            for k, v in per[i]:
                try:
                    cli.put_kv(k, v, deadline_s=60.0)
                except Exception as e:                  # noqa: BLE001
                    with mu:
                        errors.append(repr(e))
                    continue
                with mu:
                    last[k] = v
        finally:
            cli.close()

    t0 = time.monotonic()
    ths = [threading.Thread(target=client, args=(i,))
           for i in range(threads)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    load_s = time.monotonic() - t0
    expect(errors, [], "zipfian PUTs")
    before, loads0 = _hot_share(plane.keymap, hits)
    c0 = dict(plane.coord.counters)
    t0 = time.monotonic()
    doc = pc.split_hottest()
    if doc is None:
        raise AssertionError("split_hottest issued no verb after the "
                             "zipfian load")
    _await_verb(plane, "split_hottest",
                c0["splits"] + c0["merges"] + c0["migrations"]
                + c0["aborted"] + 1)
    verb_s = time.monotonic() - t0
    expect(plane.coord.counters["splits"], c0["splits"] + 1,
           "split_hottest: the split done")
    after, loads1 = _hot_share(plane.keymap, hits)
    cli = RaftSQLClient([port], timeout_s=10.0, backoff_s=0.01)
    try:
        for k, v in last.items():
            expect(cli.get_kv(k, deadline_s=60.0), v,
                   f"zipfian key {k} read back after split_hottest")
    finally:
        cli.close()
    log(f"reshard zipfian: {ZIPF_PUTS} PUTs over {len(hits)} keys from "
        f"{threads} threads in {load_s:.2f} s; split_hottest "
        f"{doc['src']} -> {doc['dst']} "
        f"({len(plane.keymap.slots_of(doc['dst']))} slots at dst after) "
        f"in {verb_s:.2f} s; hot-group share "
        f"{before} -> {after} (JAX artefact at G = 4, 32 slots: "
        f"{ZIPF_JAX_SHARES[0]} -> {ZIPF_JAX_SHARES[1]}); loads before "
        f"{dict(sorted(loads0.items()))} after {dict(sorted(loads1.items()))}"
        f"; {len(last)} keys read back on {card}")
    return {"before": before, "after": after, "load_s": load_s,
            "verb_s": verb_s, "src": doc["src"], "dst": doc["dst"]}


def _verbs_under_load(port, plane, rdb, threads, card) -> dict:
    """`threads` clients PUT (and GET) their own keys through /kv while a
    split, a merge and a migrate run through POST /reshard, one verb a
    burst; after each verb the load stops and every key's last acked
    value is read back."""
    from raftsql_tpu_torch.api.client import RaftSQLClient
    own = [dict() for _ in range(threads)]
    errors, stop = [], threading.Event()
    mu = threading.Lock()

    def client(i):
        cli = RaftSQLClient([port], timeout_s=10.0, backoff_s=0.01)
        j = len(own[i])
        try:
            while not stop.is_set():
                k, v = f"t{i}-k{j % 12}", f"t{i}-v{j}"
                j += 1
                try:
                    cli.put_kv(k, v, deadline_s=60.0)
                    own[i][k] = v
                    if j % 3 == 0:
                        got = cli.get_kv(k, deadline_s=60.0)
                        if got != v:
                            raise AssertionError(f"{k}: read {got!r} "
                                                 f"after acking {v!r}")
                except Exception as e:                  # noqa: BLE001
                    with mu:
                        errors.append(repr(e))
        finally:
            cli.close()

    admin = RaftSQLClient([port], timeout_s=10.0, backoff_s=0.01)
    node = rdb.pipe.node
    out = {}

    def burst(name, verb, src, dst, slots=None):
        stop.clear()
        ths = [threading.Thread(target=client, args=(i,))
               for i in range(threads)]
        for t in ths:
            t.start()
        time.sleep(0.5)
        n = sum(plane.coord.counters[c] for c in
                ("splits", "merges", "migrations", "aborted"))
        t0 = time.monotonic()
        admin.reshard(verb, src, dst, slots, deadline_s=60.0)
        _await_verb(plane, name, n + 1)
        verb_s = time.monotonic() - t0
        time.sleep(0.3)
        stop.set()
        for t in ths:
            t.join()
        expect(errors, [], f"{name}: client errors under the verb")
        acked = sum(len(o) for o in own)
        for o in own:
            for k, v in o.items():
                expect(admin.get_kv(k, deadline_s=60.0), v,
                       f"{name}: key {k} read back")
        out[name] = {"verb_s": verb_s, "epoch": plane.keymap.epoch,
                     "keys": acked}
        log(f"reshard {name}: {verb} {src} -> {dst} under {threads} "
            f"threads of /kv PUT+GET done in {verb_s:.2f} s, epoch "
            f"{plane.keymap.epoch}; {acked} keys' last acked values read "
            f"back on {card}")

    try:
        km = plane.keymap
        live = km.live_groups()
        src = max(live, key=lambda g: (len(km.slots_of(g)), -g))
        dst = min((g for g in live if g != src),
                  key=lambda g: (len(km.slots_of(g)), g))
        owned = km.slots_of(src)
        burst("split", "split", src, dst, owned[:len(owned) // 2])
        live = km.live_groups()
        src = min(live, key=lambda g: (len(km.slots_of(g)), g))
        dst = min((g for g in live if g != src),
                  key=lambda g: (len(km.slots_of(g)), g))
        burst("merge", "merge", src, dst)
        expect(src in km.retired, True, "merge: source retired")
        g = km.live_groups()[0]
        target = (node.leader_of(g) + 1) % 3
        burst("migrate", "migrate", g, target)
        expect(node.leader_of(g), target, "migrate: the leader cut over")
    finally:
        admin.close()
    return out


def reshard_engine(card: str, dev="cuda", groups=8,
                   threads=16) -> dict:
    """Phase 23 (a) (see the module docstring)."""
    from raftsql_tpu_torch.api.aio import AioSQLServer
    from raftsql_tpu_torch.reshard.plane import ReshardPlane
    from raftsql_tpu_torch.server.main import (attach_placement,
                                               attach_reshard,
                                               build_fused_node)
    k1 = "pallas_quorum_commit_index"
    work = os.path.join(ROOT, "build", "chip_smoke_reshard")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    captured = {}
    spying = contextlib.ExitStack()
    pq.reset_launches()                     # the reshard path starts here
    spying.enter_context(spy_fused_kernel(k1, captured))
    try:
        rdb = build_fused_node(groups=groups, peers=3,
                               data_prefix=os.path.join(work, "engine"),
                               commit_rule="pallas", device=dev)
    except BaseException:
        spying.close()
        raise
    node = rdb.pipe.node
    res = {}
    pc = plane = srv = None
    try:
        expect(all(w.is_native for w in node.wals), True,
               "reshard engine: native WALs")
        pc = attach_placement(rdb, interval_s=3600.0)
        plane = attach_reshard(rdb, nslots=64,
                               ship_dir=os.path.join(work, "ship"))
        srv = AioSQLServer(_free_port(), rdb, host="127.0.0.1")
        srv.start()
        port = srv.port
        until = time.monotonic() + 120.0
        while any(node.leader_of(g) < 0 for g in range(groups)):
            if time.monotonic() > until:
                raise AssertionError("reshard engine: no leaders")
            time.sleep(0.05)
        res["zipf"] = _zipf_split_hottest(port, plane, pc, threads, card)
        res["verbs"] = _verbs_under_load(port, plane, rdb, threads, card)
        # Fail-closed surfaces.
        st, h, body = _kv_raw(port, "GET", "t0-k0",
                              headers={"X-Raft-Keymap-Epoch": "0"})
        expect(st, 409, "stale-epoch /kv GET")
        expect(json.loads(body)["keymap"], plane.keymap.to_doc(),
               "the 409's keymap document")
        expect(int(h["X-Raft-Keymap-Epoch"]), plane.keymap.epoch,
               "the 409's epoch header")
        s0 = plane.keymap.slot_of("t0-k0")
        plane.keymap.freeze([s0])
        try:
            st, h, _ = _kv_raw(port, "PUT", "t0-k0", b"frozen")
        finally:
            plane.keymap.unfreeze([s0])
        expect((st, bool(h.get("Retry-After"))), (503, True),
               "frozen-slot /kv PUT")
        m = _metrics(port)["reshard"]
        expect((m["splits"], m["merges"], m["migrations"], m["aborted"],
                m["epoch"]), (2, 1, 1, 0, plane.keymap.epoch),
               "reshard counters in /metrics")
        res["check_prom"] = _check_prom(port, "reshard engine")
        want = plane.keymap.to_doc()
        rebuilt = ReshardPlane(rdb, nslots=64, ship_dir=plane.ship_dir)
        rebuilt.recover_from_db()
        rdb.reshard = plane
        expect(rebuilt.keymap.to_doc(), want,
               "the keymap re-folded from the journal")
        expect(rebuilt.coord.busy, False, "no verb left in flight")
        res["epoch"] = plane.keymap.epoch
        res["metrics"] = m
    finally:
        if srv is not None:
            srv.stop()
        if plane is not None:
            plane.stop()
        if pc is not None:
            pc.stop()
        expect(rdb.close(), None, "reshard engine close")
        spying.close()
    res["launches"] = pq.launches[k1]       # ... and ends here
    res["steps"] = node._device_steps
    expect(res["launches"], res["steps"], "K1 launches = device steps, "
                                          "reshard path")
    if res["steps"] <= 0 or k1 not in captured:
        raise AssertionError("the reshard engine never launched K1 on a "
                             "leader row")
    res["captured"] = captured
    log(f"reshard engine: 409 with the current keymap, 503 + Retry-After "
        f"on a frozen slot, counters {m['splits']} splits / {m['merges']} "
        f"merges / {m['migrations']} migrations at epoch {res['epoch']}, "
        f"check_prom.py exit {res['check_prom']}, the keymap re-folded "
        f"from the journal; K1 {res['launches']} launches = "
        f"{res['steps']} device steps on {card}")
    shutil.rmtree(work, ignore_errors=True)
    return res


def reshard_cli(card: str, dev="cuda", groups=8, keys=64) -> dict:
    """Phase 23 (b) (see the module docstring)."""
    from raftsql_tpu_torch.api.client import RaftSQLClient
    from raftsql_tpu_torch.obs.export import validate_chrome_trace
    work = os.path.join(ROOT, "build", "chip_smoke_reshard_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    port = _free_port()
    t0 = time.monotonic()
    p = _spawn(["--fused", "--workers", "2", "--reshard", "--trace",
                "--groups", str(groups), "--port", str(port),
                "--device", dev], work, "server", {})
    workers, res = [], {}
    cli = RaftSQLClient([port], timeout_s=10.0, backoff_s=0.01)

    def shm(n=32):
        best = {}
        for i in range(n):
            cli.get("SELECT count(*) FROM t", group=i % groups,
                    deadline_s=60.0)
            r = _metrics(port)["reads"]
            for k in ("shm_hits", "shm_fallbacks", "shm_keymap_adoptions"):
                best[k] = max(best.get(k, 0), r[k])
        return best

    try:
        _wait_healthy(port, 180.0)
        res["up_s"] = time.monotonic() - t0
        workers = _children(p.pid)
        expect(len(workers), 2, "reshard CLI: worker processes")
        only_engine_on_card(p.pid, workers, "reshard CLI", apps_want=2)
        for g in range(groups):
            cli.put("CREATE TABLE t (v text)", group=g, deadline_s=60.0)
            cli.put("INSERT INTO t (v) VALUES ('x')", group=g,
                    deadline_s=60.0)
        kv = {f"k{i}": f"v{i}" for i in range(keys)}
        for k, v in kv.items():
            cli.put_kv(k, v, deadline_s=60.0)
        before = shm()
        if before["shm_hits"] <= 0 or before["shm_keymap_adoptions"]:
            raise AssertionError(f"reshard CLI: shm before the split "
                                 f"{before}")
        doc = cli.reshard("split", 0, 1, [0, 8], deadline_s=60.0)
        expect(doc["verb"], "split", "POST /reshard at a worker")
        until = time.monotonic() + 120.0
        while _metrics(port)["reshard"]["splits"] < 1:
            if time.monotonic() > until:
                raise AssertionError("reshard CLI: the split never "
                                     "finished")
            time.sleep(0.05)
        after = shm(48)
        if after["shm_keymap_adoptions"] < 1 \
                or after["shm_fallbacks"] <= before["shm_fallbacks"] \
                or after["shm_hits"] <= before["shm_hits"]:
            raise AssertionError(f"reshard CLI: shm across the epoch: "
                                 f"before {before} after {after}")
        for k, v in kv.items():
            expect(cli.get_kv(k, deadline_s=60.0), v,
                   f"reshard CLI: key {k} read back")
        expect(cli.keymap_epoch(), 1, "reshard CLI: the client's epoch")
        st, _, body = _kv_raw(port, "GET", "k0",
                              headers={"X-Raft-Keymap-Epoch": "0"})
        expect((st, json.loads(body)["keymap"]["epoch"]), (409, 1),
               "reshard CLI: stale-epoch /kv GET at a worker")
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            c.request("GET", "/trace")
            trace = json.loads(c.getresponse().read())
        finally:
            c.close()
        validate_chrome_trace(trace)
        names = {str(e.get("name")) for e in trace["traceEvents"]}
        expect({"ring.kv", "ring.reshard"} <= names, True,
               "worker trace segments (ring.kv, ring.reshard) in GET "
               "/trace")
        res.update(before=before, after=after,
                   trace_events=len(trace["traceEvents"]))
    except BaseException:
        log(f"--- reshard CLI log tail ---\n{_tail(work, 'server')}")
        raise
    finally:
        cli.close()
        code = _stop(p)
        until = time.monotonic() + 30.0
        while any(_alive(w) for w in workers) and time.monotonic() < until:
            time.sleep(0.1)
        left = [w for w in workers if _alive(w)]
        for w in left:
            os.kill(w, signal.SIGKILL)
    expect(code, 0, "reshard CLI: exit code after SIGTERM")
    expect(left, [], "reshard CLI: workers left after the engine's exit")
    log(f"reshard CLI: --workers 2 --reshard --trace up in "
        f"{res['up_s']:.1f} s; {keys} keyed PUTs through the workers, a "
        f"split by POST /reshard at a worker, every key read back, 409 "
        f"at a stale epoch; shm before {before}, after {after} (failed "
        f"closed across the epoch, served again once adopted); GET /trace "
        f"{res['trace_events']} events with the workers' ring spans; "
        f"SIGTERM exit 0 on {card}")
    shutil.rmtree(work, ignore_errors=True)
    return res


def reshard_chaos(card: str, dev="cuda") -> dict:
    """Phase 23 (c) (see the module docstring)."""
    from raftsql_tpu_torch.chaos import run as crun
    from raftsql_tpu_torch.runtime.hostplane import ClusterHostPlane
    k1 = "pallas_quorum_commit_index"
    steps = [0]
    real = ClusterHostPlane._readback       # one call per device dispatch

    def counted(*a, **kw):
        steps[0] += 1
        return real(*a, **kw)

    # The JAX package's unrepaired pair runs in a process of its own.
    side = _side_start("unrepaired")
    pq.reset_launches()                     # the reshard chaos path
    ClusterHostPlane._readback = staticmethod(counted)
    try:
        t0 = time.monotonic()
        ok, reports = crun.reshard_gauntlet(0, runs=RUNS, device=dev,
                                            commit_rule="pallas")
        wall = time.monotonic() - t0
    except BaseException:
        _side_kill(side)
        raise
    finally:
        ClusterHostPlane._readback = staticmethod(real)
    launches = pq.launches[k1]              # ... and ends here
    unrepaired = _side_finish(side)
    wall_u = unrepaired.pop("wall")
    if not ok:
        raise AssertionError("the reshard gauntlet failed (see CHAOS FAIL "
                             "above)")
    for r in reports:
        got = (r["plan_digest"], r["schedule_digest"], r["result_digest"])
        expect(got, RESHARD_DIGESTS["nemesis"], "reshard nemesis digests")
        log(f"reshard chaos run {r['run'] + 1}: plan={got[0]} "
            f"schedule={got[1]} result={got[2]}; splits "
            f"{r['reshard_splits']}, merges {r['reshard_merges']}, "
            f"migrations {r['reshard_migrations']}, aborted "
            f"{r['reshard_aborted']}, resumed {r['reshard_resumed']}, "
            f"coordinator kills {r['coordinator_kills']}, fork faults "
            f"{r['fork_faults']}, epoch {r['keymap_epoch']}, committed "
            f"{r['committed_entries']}; {r['wall_s']:.2f} s on {card}")
    expect(unrepaired, RESHARD_DIGESTS["unrepaired"],
           "the JAX package's unrepaired falsification pair")
    expect(launches, steps[0], "K1 launches against device steps on the "
                               "reshard chaos path")
    if launches <= 0:
        raise AssertionError("the reshard chaos path never launched K1")
    log(f"reshard chaos: gauntlet (nemesis x{RUNS} and the repaired "
        f"falsification pair: broken flip caught, control passed) "
        f"{wall:.2f} s; the JAX package's unrepaired pair "
        f"{wall_u:.2f} s (a process of its own, beside the gauntlet), "
        f"both passed (its broken flip NOT caught, as on "
        f"the CPU); K1 {launches} launches = {steps[0]} device steps on "
        f"{card}")
    return {"launches": launches, "steps": steps[0], "wall": wall,
            "walls": [r["wall_s"] for r in reports]}


def sanitizers() -> dict:
    """The native WAL's stress harness under asan, ubsan and tsan, the
    three builds at once: {name: (build + run s, run s)}; a failed build
    or a report raises."""
    from concurrent.futures import ThreadPoolExecutor

    from raftsql_tpu_torch.native.sanitize import run_one

    def one(san):
        t0 = time.monotonic()
        run = run_one(san)
        return san, (time.monotonic() - t0, run)

    with ThreadPoolExecutor(max_workers=3) as ex:
        return dict(ex.map(one, ("asan", "ubsan", "tsan")))


def tooling(card: str, dev="cuda", sans=None) -> dict:
    """Phase 23 (d) (see the module docstring); `sans` is sanitizers()'s
    result when it already ran."""
    from raftsql_tpu_torch.obs.export import validate_chrome_trace
    from raftsql_tpu_torch.obs.trace_demo import run_demo
    work = os.path.join(ROOT, "build", "chip_smoke_tooling")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.monotonic()
    doc = run_demo(os.path.join(work, "trace.json"), device=dev)
    demo_s = time.monotonic() - t0
    with open(os.path.join(work, "trace.json")) as f:
        validate_chrome_trace(json.load(f))
    phases = {e.get("ph") for e in doc["traceEvents"]}
    expect("C" in phases and bool(phases & {"X", "B", "E"}), True,
           "trace demo: counter tracks and spans")
    res = {"trace_demo_s": demo_s, "trace_events": len(doc["traceEvents"])}
    res.update(sanitizers() if sans is None else sans)
    log(f"tooling: trace demo (4 groups x 3 peers, 200 ticks, traced) "
        f"{res['trace_events']} events, valid, in {demo_s:.1f} s; WAL "
        f"stress under sanitizers, built and run at once (build + run, "
        f"run): "
        + ", ".join(f"{k} {res[k][0]:.1f} s / {res[k][1]:.2f} s"
                    for k in ("asan", "ubsan", "tsan"))
        + f", no report, on {card}")
    shutil.rmtree(work, ignore_errors=True)
    return res


def reshard_plane(card: str, dev="cuda") -> dict:
    """Phase 23: (a), (b), (c) and (d); (d)'s sanitizer builds and runs
    (host processes, no card) go on while (c) runs."""
    from concurrent.futures import ThreadPoolExecutor
    eng = reshard_engine(card, dev)
    cli = reshard_cli(card, dev)
    with ThreadPoolExecutor(max_workers=1) as ex:
        sans = ex.submit(sanitizers)
        ch = reshard_chaos(card, dev)
        tools = tooling(card, dev, sans.result())
    return {"engine": eng, "cli": cli, "chaos": ch, "tooling": tools,
            "launches": eng["launches"] + ch["launches"],
            "steps": eng["steps"] + ch["steps"],
            "captured": eng.pop("captured")}


# ---- phase 24 --------------------------------------------------------------

def _graph_against_eager(card, G, ticks, d) -> dict:
    """A FusedClusterNode's device step (an eager warm-up tick, then one
    capture and replays) beside the eager cluster_step_host chain on the
    card from the same boot, with seeded proposals and a skewed timer
    window: packed info and busy bit equal every tick, every state and
    inbox leaf every 20 ticks and at the end.  Each side's enqueue (the
    host clock around the call, no synchronize) and whole step (to its
    readback) in ms, medians over the ticks after the capture."""
    from raftsql_tpu_torch.runtime.fused import FusedClusterNode
    cfg = RaftConfig(num_groups=G, num_peers=3, log_window=64,
                     max_entries_per_msg=8, tick_interval_s=0.0,
                     commit_rule="pallas")
    node = FusedClusterNode(cfg, d, seed=0, device="cuda")
    st = type(node.states)(*[x.clone() for x in node.states])
    ib = type(node.inboxes)(*[x.clone() for x in node.inboxes])
    ones = torch.ones((3,), dtype=torch.int32, device="cuda")
    rng = np.random.default_rng(G)
    times = {"graph": ([], []), "eager": ([], [])}
    k1 = "pallas_quorum_commit_index"
    base = pq.launches[k1]
    try:
        for t in range(ticks):
            pn = rng.integers(0, 9, (3, G)).astype(np.int32)
            skew = np.array([1, 2, 0], np.int32) if 40 <= t < 70 else None
            t0 = time.perf_counter()
            pd, bd = node._device_step(pn, skew)
            t1 = time.perf_counter()
            got, busy = node._readback(pd, bd)
            t2 = time.perf_counter()
            ti = ones if skew is None else torch.from_numpy(skew).cuda()
            pnd = torch.from_numpy(pn).cuda()
            t3 = time.perf_counter()
            st, ib, want, wbusy = cluster.cluster_step_host(cfg, st, ib,
                                                            pnd, ti)
            t4 = time.perf_counter()
            want = want.cpu().numpy()
            wbusy = bool(wbusy)
            t5 = time.perf_counter()
            if t >= 2:
                times["graph"][0].append(t1 - t0)
                times["graph"][1].append(t2 - t0)
                times["eager"][0].append(t4 - t3)
                times["eager"][1].append(t5 - t3)
            expect(np.array_equal(got, want) and busy == wbusy, True,
                   f"graph step G={G} tick {t}: packed info and busy bit")
            if t % 20 == 19 or t == ticks - 1:
                for name, a, b in zip(st._fields + ib._fields,
                                      node.states + node.inboxes, st + ib):
                    expect(torch.equal(a, b), True,
                           f"graph step G={G} tick {t}: {name}")
        m = node.metrics
        expect((m.graph_captures, m.graph_replays, m.eager_steps),
               (1, ticks - 1, 1), f"graph step G={G}: captures, replays, "
               "eager steps")
        expect(pq.launches[k1] - base, 2 * ticks,
               f"graph step G={G}: K1 once a tick on each side")
    finally:
        node.stop()
    out = {k: {"enqueue_ms": statistics.median(v[0]) * 1e3,
               "step_ms": statistics.median(v[1]) * 1e3}
           for k, v in times.items()}
    log(f"graph step G = {G}, P = 3, E = 8, pallas: {ticks} ticks equal "
        f"to the eager chain; enqueue ms a tick graph "
        f"{out['graph']['enqueue_ms']:.3f}, eager "
        f"{out['eager']['enqueue_ms']:.3f}; to the readback graph "
        f"{out['graph']['step_ms']:.3f}, eager "
        f"{out['eager']['step_ms']:.3f} on {card}")
    return out


def graph_step(card: str, dev="cuda") -> dict:
    """Phase 24: the fused runtime's CUDA graph of its step
    (runtime/fused.py).  (a) The graph against the eager chain at the
    benchmark cell's shape (G = 1) and at the durable bench's (G =
    10,000), 200 ticks each, with the enqueue's ms a tick both ways;
    (b) the fused server on one group (the cell's deployment) under 16
    client threads of acked PUTs, GET /metrics read every 0.2 s:
    `graph_captures` 1 in every reading, and graph_replays / ticks at
    least 0.99 at the end."""
    d = os.path.join(DATA, "graph")
    shutil.rmtree(DATA, ignore_errors=True)
    out = {}
    for G in (1, 10_000):
        os.makedirs(f"{d}-{G}")
        out[G] = _graph_against_eager(card, G, 200, f"{d}-{G}")
    shutil.rmtree(DATA, ignore_errors=True)
    os.makedirs(DATA)
    rdb, srv = _serve(1, dev)
    seen, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            st, body = _req(srv.port, "GET", path="/metrics")
            if st == 200:
                seen.append(json.loads(body)["device_step"])
            stop.wait(0.2)

    th = threading.Thread(target=sample, daemon=True)
    try:
        recipe(srv.port, 1, "graph server")
        th.start()
        put_load(rdb, srv.port, 1, card, "graph server")
        stop.set()
        th.join()
        m = rdb.pipe.node.metrics
        caps = sorted({s["graph_captures"] for s in seen})
        share = m.graph_replays / max(m.ticks, 1)
    finally:
        stop.set()
        srv.stop()
        err = rdb.close()
    expect(err, None, "graph server close")
    expect(caps, [1], "graph server: graph_captures in every reading")
    if len(seen) < 5 or share < 0.99:
        raise AssertionError(f"graph server: {len(seen)} readings, "
                             f"graph_replays / ticks {share:.4f}")
    log(f"graph server: {m.ticks} ticks, {m.graph_replays} replays "
        f"(share {share:.4f}), {m.graph_restages} restages, "
        f"{m.eager_steps} eager steps, graph_captures 1 in all "
        f"{len(seen)} readings of GET /metrics on {card}")
    shutil.rmtree(DATA, ignore_errors=True)
    out["served_share"] = share
    return out


# ---- main ------------------------------------------------------------------

def main(argv=None) -> int:
    """Every phase in turn, then the kernels line and the result line.
    `--only 10,12` (a development run) runs the build and the named
    phases and prints no result line."""
    import argparse
    ap = argparse.ArgumentParser(description="smoke run on one CUDA card")
    ap.add_argument("--only", default="",
                    help="comma separated phases (3-24) to run after the "
                         "build; no result line is printed")
    # One rank of phase 20's distributed pod step (a child process).
    ap.add_argument("--pod-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    # A side job of phase 9 or 12 (a child process).
    ap.add_argument("--side", default="", help=argparse.SUPPRESS)
    ap.add_argument("--side-out", default="", help=argparse.SUPPRESS)
    for flag in ("--pod-procs", "--pod-ticks", "--pod-timed"):
        ap.add_argument(flag, type=int, default=0, help=argparse.SUPPRESS)
    for flag in ("--pod-coord", "--pod-backend", "--pod-out",
                 "--pod-after"):
        ap.add_argument(flag, default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.side:
        return side_job(args.side, args.side_out)
    if args.pod_rank is not None:
        return dist_rank(args.pod_rank, args.pod_procs, args.pod_coord,
                         args.pod_backend, args.pod_out, args.pod_ticks,
                         args.pod_timed, after=args.pod_after)
    only = {int(x) for x in args.only.split(",") if x}
    t_start = time.monotonic()

    def done(phase):
        log(f"phase {phase} done at {time.monotonic() - t_start:.1f} s "
            f"(host memory available {_mem_available_gib():.1f} GiB)")

    def want(phase):
        return not only or phase in only

    card = environment()
    kern = {}               # K1 and K2 on the fused paths (phases 4, 5)
    node_kern = {}          # K1 and K2 on the node path (phases 10, 12)
    build_s = pq.build()
    log(f"build: csrc/quorum.cu in {build_s:.1f} s")
    check_ptxas(pq.build_log())
    done("build")
    if want(3):
        check_kernels(card)
        done("kernels")
    if want(4):
        tick = fused_tick(card)
        kern.update(main_path_kernels(card, tick.pop("captured")))
        runp = run_path(card)
        # K1 on cluster_run's tensors: R = 300,000, P = 3.
        run_kern = main_path_kernels(card, runp.pop("captured"),
                                     detail=False)
        traced_tick(card)
        done("fused tick")
    if want(5):
        mem = membership_node(card)
        # K2's row is its joint-consensus path: R = 40,000, P = 4 (the
        # generic kernel), C_old,new masks live.
        kern.update(main_path_kernels(card, mem.pop("captured")))
        done("membership node")
    if want(6):
        k1_server = server(card)
        done("server")
    if want(7):
        traced_server(card)
        done("traced server")
    if want(8):
        place = placement_server(card)
        done("placement server")
    if want(9):
        ch = chaos(card)
        done("chaos")
    if want(10):
        node = node_cluster(card)
        # K1 on one peer's rows: R = 10,000, P = 3, one leader row in 3.
        node_kern.update(main_path_kernels(card, node.pop("captured")))
        node["python_phase_ms"] = node_wal_python(card)
        done("node cluster")
    if want(11):
        procs = procfile_cluster(card)
        done("procfile cluster")
    if want(12):
        nch = node_chaos(card)
        # K2 on one peer's rows after conf entries applied: R = G = 2,
        # P = 4, C_old,new masks live (the membership family).
        node_kern.update(main_path_kernels(card, nch.pop("captured")))
        done("node chaos")
    if want(13):
        k1_overload, cap = overload(card)
        # K1 on the overload family's fused steps: R = 12 rows, P = 3.
        over_kern = main_path_kernels(card, cap)
        done("overload")
    if want(14):
        proc_chaos(card)
        done("proc chaos")
    if want(15):
        durable = durable_plane(card)
        done("durable plane")
    if want(16):
        mtick = mesh_tick(card)
        # K1 and K2 on one shard's rows: R = 2 x 8,192 = 16,384, P = 4.
        mesh_kern = main_path_kernels(card, mtick.pop("captured"))
        done("mesh tick")
    if want(17):
        dmesh = durable_mesh(card, arm_b=durable["arm_b"] if want(15)
                             else None)
        done("durable mesh")
    if want(18):
        msrv = mesh_server(card)
        done("mesh server")
    if want(19):
        mch = mesh_chaos(card)
        done("mesh chaos")
    if want(20):
        from concurrent.futures import ThreadPoolExecutor
        psrv = pod_servers(card)
        # The pod gauntlet's processes run beside the dry run's (their
        # verdicts and digests do not follow the load; the single
        # controller's ms/tick does), never beside a timed kernel.
        with ThreadPoolExecutor(max_workers=1) as ex:
            pch = ex.submit(pod_chaos, card)
            pdry = pod_dryrun(card)
            pch.result()
        # K1 on one shard's rows of the pod's replicated step: R = 3 x
        # 128 = 384, P = 3.
        pod_kern = main_path_kernels(card, pdry.pop("captured"))
        pdist = pod_distributed(card)
        # K1 on rank 0's first owned shard of the distributed step: R =
        # 3 x 4,096 = 12,288, P = 3.
        pod_dist_kern = main_path_kernels(card, pdist.pop("captured"),
                                          detail=False)
        done("pod")
    if want(21):
        wk = workers_plane(card)
        # K1 on the workers engine's fused steps: R = 24 rows, P = 3.
        workers_kern = main_path_kernels(card, wk.pop("captured"))
        done("workers plane")
    if want(22):
        rtier = replica_tier(card)
        done("replica tier")
    if want(23):
        rsh = reshard_plane(card)
        # K1 on the reshard engine's fused steps: R = 24 rows, P = 3.
        reshard_kern = main_path_kernels(card, rsh.pop("captured"))
        done("reshard plane")
    if want(24):
        graph = graph_step(card)
        done("graph step")
    if only:
        log(f"development run of phases {sorted(only)}: no result line")
        return 0
    k1, k2 = "pallas_quorum_commit_index", \
        "pallas_masked_quorum_commit_index"
    node_launches = {
        k: node["launches"][k] + sum(f[k] for f in nch["launches"].values())
        for k in (k1, k2)}
    mesh_launches = {
        k1: (mtick["launches"][k1] + dmesh["launches"] + mch["launches"]),
        k2: mtick["launches"][k2]}
    pod_launches = {k1: pdry["launches"], k2: 0}
    pod_dist_launches = {k1: pdist["launches"], k2: 0}
    workers_launches = {k1: wk["launches"], k2: 0}
    reshard_launches = {k1: rsh["launches"], k2: 0}
    run_launches = {k1: runp["launches"], k2: 0}
    launches = {
        k1: (tick["launches"][k1] + run_launches[k1] + k1_server
             + place["launches"]
             + ch["launches"]["default"] + ch["launches"]["nemesis"]
             + node_launches[k1] + k1_overload + durable["launches"]
             + mesh_launches[k1] + pod_launches[k1]
             + pod_dist_launches[k1]
             + workers_launches[k1] + reshard_launches[k1]),
        k2: (tick["launches"][k2] + mem["launches"][k2] + node_launches[k2]
             + mesh_launches[k2])}
    log(f"launches by path: fused tick {tick['launches']}, cluster_run "
        f"K1 {runp['launches']}, membership "
        f"node {mem['launches']}, server K1 {k1_server}, placement "
        f"server K1 {place['launches']}, chaos K1 {ch['launches']}, node "
        f"cluster {node['launches']}, node chaos {nch['launches']}, "
        f"overload K1 {k1_overload}, durable plane K1 "
        f"{durable['launches']}, mesh tick {mtick['launches']}, durable "
        f"mesh K1 {dmesh['launches']}, mesh chaos K1 {mch['launches']}, "
        f"pod K1 {pdry['launches']}, distributed pod K1 "
        f"{pdist['launches']} (ranks "
        f"{[d['launches'] for d in pdist['ranks']]}, NCCL rank "
        f"{pdist['nccl']['launches']}), workers K1 {wk['launches']} "
        f"({wk['steps']} device steps), reshard K1 {rsh['launches']} "
        f"({rsh['steps']} device steps: engine {rsh['engine']['launches']}"
        f", chaos {rsh['chaos']['launches']})")
    log(f"mesh tick ms/tick mesh {mtick['ms_per_tick']['mesh']:.2f} fused "
        f"{mtick['ms_per_tick']['fused']:.2f}; durable mesh "
        f"{dmesh['commits_per_s']:.0f} commits/s against fused arm (b) "
        f"{dmesh['fused_commits_per_s']:.0f}; mesh server PUT p50 "
        f"{msrv['p50']:.2f} ms p99 {msrv['p99']:.2f} ms; pod servers PUT "
        f"p50 {psrv['p50']:.2f} ms p99 {psrv['p99']:.2f} ms, distributed "
        f"{psrv['distributed']['p50']:.2f} / "
        f"{psrv['distributed']['p99']:.2f} ms; distributed pod step "
        f"ms/tick {[round(d['dist_ms'], 2) for d in pdist['ranks']]} "
        f"(all-gather {[round(d['coll_ms'], 2) for d in pdist['ranks']]})"
        f" against replicated "
        f"{[round(d['repl_ms'], 2) for d in pdist['ranks']]} on {card}")
    log(f"procfile cluster PUT p50 {procs['p50']:.2f} ms p99 "
        f"{procs['p99']:.2f} ms; node cluster "
        f"{node['commits_per_s']:.0f} commits/s (node 1 WAL "
        f"{node['phase_ms']['wal']:.1f} ms per node tick, "
        f"{node['python_phase_ms']['wal']:.1f} on the Python backend); "
        f"durable plane "
        f"commits/s native plog + NativeKV "
        f"{durable['commits_per_s']['native']:.0f}, Python plog + "
        f"KVStateMachine {durable['commits_per_s']['python']:.0f} on {card}")
    log("graph step enqueue ms a tick, graph / eager: "
        + "; ".join(f"G = {G} {graph[G]['graph']['enqueue_ms']:.3f} / "
                    f"{graph[G]['eager']['enqueue_ms']:.3f}"
                    for G in (1, 10_000))
        + f"; served replay share {graph['served_share']:.4f} on {card}")
    lad = wk["ladder"]
    log(f"workers ladder (192 connections; req/s, p50/p99 ms): "
        + "; ".join(f"{k} {v['req_s']:.1f}, {v['p50_ms']:.2f}/"
                    f"{v['p99_ms']:.2f}" for k, v in lad.items())
        + f"; workers server PUT p50 {wk['put_p50']:.2f} ms p99 "
        f"{wk['put_p99']:.2f} ms; replica chaos runs "
        f"{[round(w, 1) for w in rtier['walls']]} s on {card}")
    z, rv = rsh["engine"]["zipf"], rsh["engine"]["verbs"]
    log(f"reshard: zipfian hot-group share {z['before']} -> {z['after']} "
        f"(JAX artefact {ZIPF_JAX_SHARES[0]} -> {ZIPF_JAX_SHARES[1]}); "
        f"verbs under 16 threads of /kv (s): split_hottest "
        f"{z['verb_s']:.2f}, split {rv['split']['verb_s']:.2f}, merge "
        f"{rv['merge']['verb_s']:.2f}, migrate {rv['migrate']['verb_s']:.2f};"
        f" CLI up {rsh['cli']['up_s']:.1f} s; chaos runs "
        f"{[round(w, 2) for w in rsh['chaos']['walls']]} s, gauntlet "
        f"{rsh['chaos']['wall']:.2f} s; trace demo "
        f"{rsh['tooling']['trace_demo_s']:.1f} s, sanitizers clean on "
        f"{card}")
    rows = []
    for name, r in kern.items():
        row = {"name": name, "route": "cuda",
               "source": "raftsql_tpu_torch/csrc/quorum.cu",
               "replaces": REPLACES[name],
               "launches": launches[name],
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": None,
               "run_path_launches": run_launches[name],
               "node_path_launches": node_launches[name],
               "overload_path_launches":
                   k1_overload if name == k1 else 0,
               "durable_plane_launches":
                   durable["launches"] if name == k1 else 0,
               "mesh_path_launches": mesh_launches[name],
               "pod_path_launches": pod_launches[name],
               "pod_dist_path_launches": pod_dist_launches[name],
               "workers_path_launches": workers_launches[name],
               "reshard_path_launches": reshard_launches[name]}
        for path, got in (("run_path", run_kern),
                          ("node_path", node_kern),
                          ("overload_path", over_kern),
                          ("mesh_path", mesh_kern),
                          ("pod_path", pod_kern),
                          ("pod_dist_path", pod_dist_kern),
                          ("workers_path", workers_kern),
                          ("reshard_path", reshard_kern)):
            if name in got:
                n = got[name]
                row[path] = {k: n[k] for k in (
                    "rows", "ms", "plain_ms", "bound_ms", "bound_by",
                    "max_abs_err", "device_us", "host_us")}
        rows.append(row)
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
