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
     misaligned inputs; kernel and plain times by CUDA events, the
     kernel's device time by torch.profiler;
  4. the fused tick (the main path's device program) at G = 100,000,
     P = 3, W = 256, E = 32 with commit_rule="pallas": the launch
     counts are zeroed just before and read just after; one tick of
     each kernel has its inputs copied, and K1 and K2 are then timed on
     those tensors; then a card run and a CPU run of the same ticks at
     G = 8192, each booted from the same seed, must be bit-identical;
     then the device event ring's cost at G = 100,000 ([64, 3, 100000,
     9] int32): the fused tick without and with a ring record per tick,
     and the durable node's tick (native WALs, G = 25,000: its elections
     take 52 s at G = 100,000) without and with enable_tracing;
  5. the membership and transfer planes at G = 25,000 on 4 slots
     (voters {0,1,2}, a spare slot 3, durable FusedClusterNode,
     commit_rule="pallas"): after the elections slot 0 is replaced by
     slot 3 (add_learner, promote, remove through joint consensus) on 64
     groups while leadership moves on 64 others; every touched group
     must end on its expected config or leader and every other group on
     {0,1,2}; K2 must launch on every tick after enable_membership, and
     on one tick with joint masks live its inputs are copied: K2 is held
     against its plain version and timed on them (R = 100,000, P = 4);
     G is cut from the bench headline's 100,000 to keep the whole run
     near half its time limit (the phase's host plane costs about
     1.5 s a tick and 73 s of set-up at G = 100,000);
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
     (RUNS), through raftsql_tpu_torch.chaos.run; every
     schedule and result digest must equal the JAX package's
     (CHAOS_DIGESTS), and K1 must launch in the default's and the
     nemesis families' runs; then the falsification pairs of the three
     gauntlets (the broken lease bound, the unsafe transfer kernel,
     quorum arms A and B) must be caught and their controls pass;
 10. the distributed runtime at the bench's node shape: 3 RaftNodes on
     the card over LoopbackHub(codec=False), G = 10,000, P = 3, W = 64,
     E = 8, tick_interval_s = 0, commit_rule="pallas", in lockstep
     through the elections, then 24 ticks draining E proposals per
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
     version and timed), tcp and tcp_rebind once each (invariants hold,
     faults fired);
 13. the overload gauntlet (chaos.run overload_gauntlet, what --overload
     runs) at the plan's own size, G = 4, P = 3, 160 ticks, 32 offered
     writes a tick plus bursts, commit_rule="pallas", twice: plan and
     result digests equal to the JAX package's (CHAOS_DIGESTS), every
     pressure family fired, the backlog peak at or under its cap of 48,
     the goodput and starvation floors met, the falsification pair
     caught and its control passed, and K1 launched once per device
     step (launches and dispatches zeroed just before, read just after);
     the inputs of K1's first call with a leader row (R = 12, P = 3) are
     copied, held to the plain version and timed;
 14. the process plane, every server child a CUDA process: the --procs
     gauntlet at seed 0, 80 ticks, once (RUNS; every fault family fires,
     no unexpected exit, the verdict digest the reference's all-pass
     digest, PROC_VERDICTS), the read and transfer arms once each on
     generate_procs(0, ticks=60), and a SIGSTOP probe (a stalled CUDA
     leader's survivors: device ms per node tick and ticks per second
     before and during the stall);
 15. the durable storage plane at the bench's accelerator durable shape
     (bench.py bench_durable_fused): FusedClusterNode, G = 10,000, P =
     3, W = 64, E = 8, tick_interval_s = 0, commit_rule="pallas", WAL
     group commit, publish_peers = {0}; arm (a) the native payload log
     (RAFTSQL_FUSED_NATIVE_PLOG=1) with NativeKV applying peer 0's
     stream, arm (b) the Python payload log with one KVStateMachine a
     group draining it, in turns (a, then b), each booted from seed 0,
     elected, then 24 ticks with E SET proposals a group a tick queued
     ahead: every WAL native, the same commit indexes, KV state and WAL
     records in both arms, K1 launched once per device step; commits/s
     and ms per tick by phase of each arm;
 16. the kernels line (JSON: K1 as phase 4 measured it, K2 on phase 5's
     joint masks, launches summed over the paths, and each kernel's
     node-path launches and time: K1 at R = 10,000 from phase 10, K2 at
     R = 2 from phase 12; K1's launches and time on the overload path of
     phase 13, R = 12; K1's launches in phase 15) and the result line.

`--only 13,15` runs the build and the named phases (3-15) alone: a
development run, with no result line.  It needs one card and writes
under build/ of its checkout (and the chaos runs' data dirs under
$TMPDIR, removed after each run).
"""
from __future__ import annotations

import dataclasses
import http.client
import json
import os
import re
import shutil
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
    trace has none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # A profiling session now and then records no kernel on this card
    # (seen once in a few sessions): the trace is taken again, up to
    # three times, before the time is reported as not measured.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if (name is None or name in e.key) and _self_device_us(e) > 0]
        if ev:
            return sum(_self_device_us(e) for e in ev) / reps
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
    (timed), the peer counts of both the unrolled and the generic
    kernels, and the edge cases (untimed)."""
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
        if i >= len(cases):
            continue
        ms, plain_ms = time_ms(kern), time_ms(plain)
        bms, by, _ = bound(args, masks, cand)
        log(f"kernel {what}: equal; {ms * 1e3:.1f} us per call (device "
            f"{_us(kernel_device_us(kern))}; plain {plain_ms * 1e3:.1f} "
            f"us, bound {bms * 1e3:.2f} us by {by}) on {card}")
    log(f"kernels: {len(edges)} edge cases equal (R in 1, 31, 4099; no, "
        f"all and random leaders; misaligned views; P up to 385) on "
        f"{card}")


def main_path_kernels(card: str, captured: dict) -> dict:
    """K1 and K2 on the tensors a main path handed them (captured in
    phase 4's fused tick, phase 5's membership node and phase 10's node
    cluster): equality, per-call (CUDA events), host and device time,
    the plain version, the bound, and what bounds the kernel from
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
        bms, by, all_rows_ms = bound(args, masks, cand)
        leaders = int(args[5].sum())
        log(f"main path {name}: R={args[0].shape[0]} P={P} "
            f"W={args[1].shape[1]}, {leaders} leader rows; equal; "
            f"{ms * 1e3:.1f} us per call (host {h_us:.1f} us), "
            f"device {_us(dev_us)}; plain {plain_ms * 1e3:.1f} us; bound "
            f"{bms * 1e3:.2f} us by {by} (all-rows count "
            f"{all_rows_ms * 1e3:.2f} us) on {card}")
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
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bms, bound_by=by,
                             rows=args[0].shape[0], device_us=dev_us,
                             host_us=h_us)
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


def _self_device_us(e) -> float:
    return float(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)))


def profile_ticks(cfg, st, ib, card, ticks=8):
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
    ticks = 256
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

    # Card vs CPU: the same 128 ticks, bit for bit, each side booted
    # from the same seed (the boot draws are made on the host).
    scfg = RaftConfig(num_groups=g, num_peers=P, log_window=W,
                      max_entries_per_msg=E, commit_rule="pallas")
    cst = cluster.init_cluster_state(scfg, device="cpu")
    cib = cluster.empty_cluster_inbox(scfg, device="cpu")
    gst = cluster.init_cluster_state(scfg, device=dev)
    gib = cluster.empty_cluster_inbox(scfg, device=dev)
    gst, gib, gcom, ginfo = run_ticks(scfg, gst, gib, 128, 4, record=True)
    cst, cib, ccom, cinfo = run_ticks(scfg, cst, cib, 128, 4, record=True)
    for t, (a, b) in enumerate(zip(ginfo, cinfo)):
        if not np.array_equal(a, b):
            raise AssertionError(f"card and CPU packed info differ at "
                                 f"tick {t}")
    for part, (a, b) in (("state", (_np(gst), _np(cst))),
                         ("inbox", (_np(gib), _np(cib)))):
        for k in a:
            if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]):
                raise AssertionError(f"card and CPU differ: {part}.{k}")
    log(f"card vs CPU at G={g}: 128 ticks bit-identical "
        f"({gcom} entries committed)")
    return {"ms_per_tick": dt / ticks * 1e3, "commits": commits,
            "launches": launches, "captured": captured}


def traced_tick(card: str, dev="cuda", G=100_000, ticks=64,
                node_ticks=8, node_G=25_000) -> dict:
    """The event ring's cost at G = 100,000.  First on phase 4's fused
    tick: blocks of `ticks` ticks without and with a DeviceEventRing
    record per tick (one full drain per traced block), in turns.  Then
    on the durable node (FusedClusterNode: the fused tick plus the host
    plane, idle after the elections, on native WALs) without and with
    enable_tracing, in turns, `node_ticks` a block.  And the ring's slot
    write alone (CUDA events) and one drain of the full ring.  The
    durable node runs at node_G = 25,000, as phase 5 does: at G =
    100,000 its elections took 52.1 s on native WALs too (the staging
    and payload-log work per row stay in Python), against the 15 s that
    would have kept it there."""
    from raftsql_tpu_torch.obs.device_ring import (DeviceEventRing,
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
    for i, mode in enumerate(("off", "on", "off", "on")):
        t0 = time.monotonic()
        st, ib, _, _ = run_ticks(cfg, st, ib, ticks, seed=10 + i,
                                 ring=ring if mode == "on" else None)
        loop[mode].append((time.monotonic() - t0) / ticks * 1e3)
    if len(ring) != 2 * ticks or ring.drains != 2:
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
                "record_ms": rec_ms, "drain_ms": drain_ms}
    finally:
        node.stop()
        shutil.rmtree(d, ignore_errors=True)


# ---- phase 5 ---------------------------------------------------------------

def membership_node(card: str, dev="cuda", G=25_000, n=64) -> dict:
    """The membership and transfer planes: a durable FusedClusterNode of
    G groups on 4 slots, voters {0,1,2}
    and a live spare slot 3 (the JAX package's node-replacement layout),
    commit_rule="pallas".  After the elections, slot 0 is replaced by
    slot 3 (add_learner 3, promote 3, remove 0, each change through
    joint consensus where it moves a vote) on `n` groups spread over the
    range, while leadership moves on `n` other groups.  K2 must launch
    on every tick after enable_membership (and K1 on none); on one tick
    with joint masks live its inputs are copied, for the kernel-vs-plain
    check and timing on them."""
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
    captured, real = {}, pq.pallas_masked_quorum_commit_index

    def spy(*args, **kw):
        mm = node.membership
        if k2 not in captured and mm is not None and mm.joint_groups:
            captured[k2] = ([a.clone() for a in args],
                            {k: v.clone() if torch.is_tensor(v) else v
                             for k, v in kw.items()})
        return real(*args, **kw)

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
        pq.pallas_masked_quorum_commit_index = spy
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
        pq.pallas_masked_quorum_commit_index = real
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
        pq.pallas_masked_quorum_commit_index = real
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
        for g in range(groups):
            expect(_req(port, "PUT", b"CREATE TABLE main.t (name text)",
                        g), (204, b""), f"CREATE g{g}")
            expect(_req(port, "PUT",
                        b'INSERT INTO main.t (name) VALUES ("abc")', g),
                   (204, b""), f"INSERT g{g}")
            expect(_req(port, "GET", b"SELECT * FROM main.t", g),
                   (200, b"|abc|\n"), f"SELECT g{g}")
        expect(_req(port, "POST", b"SELECT 1")[0], 405, "POST")
        expect(_req(port, "PUT", b"NOT SQL")[0], 400, "bad SQL")
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

def chaos(card: str, dev="cuda") -> dict:
    """The seed-0 chaos digests on the card: the default family with
    commit_rule="pallas", then each fused family, then the read, quorum
    and transfer nemesis families with commit_rule="pallas" (K1's
    launch count zeroed just before those runs and read just after,
    twice: the default's and the nemesis families'), each `RUNS` times,
    then the falsification pairs of those three gauntlets, which must be
    caught.  Returns the wall time of each run in seconds and the K1
    launches of each path."""
    from raftsql_tpu_torch.chaos import run as crun
    from raftsql_tpu_torch.chaos.schedule import generate
    k1 = "pallas_quorum_commit_index"
    walls, launches = {}, {}
    pq.reset_launches()                       # the chaos path starts here
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
    if launches["default"] <= 0:
        raise AssertionError("the chaos runs never launched K1")
    log(f"chaos default: K1 launches {launches['default']} over {RUNS} "
        f"run(s)")
    nemesis = ("reads", "quorum", "transfers")
    specs = crun.family_specs()
    for name, (gen, fired) in specs.items():
        if name in nemesis:
            continue
        t0 = time.monotonic()
        r = crun.run_fused(gen(0), device=dev)
        walls[name] = time.monotonic() - t0
        got = (r["schedule_digest"], r["result_digest"])
        log(f"chaos {name}: schedule={got[0]} result={got[1]} "
            f"{walls[name]:.2f} s on {card}")
        expect(got, CHAOS_DIGESTS[name], f"chaos {name} digests")
        if not fired(r):
            raise AssertionError(f"chaos {name}: its faults never fired")
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
    for name in nemesis:
        t0 = time.monotonic()
        ok = crun.run_falsification(name, 0, device=dev,
                                    commit_rule="pallas")
        walls[f"{name} falsification"] = time.monotonic() - t0
        if not ok:
            raise AssertionError(f"chaos {name}: a falsification arm was "
                                 f"not caught or its control failed")
        log(f"chaos {name} falsification: every broken arm caught, every "
            f"control passed, {walls[f'{name} falsification']:.2f} s on "
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


def node_cluster(card: str, dev="cuda", G=10_000, ticks=24,
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
    entries switch every node to the masked rule), then tcp and
    tcp_rebind once each (real sockets: their invariants must hold and
    their faults fire).  In the first membership run, the inputs of the
    first K2 call with joint masks live are copied.  Returns the wall
    time of each run, the launches of each family and the copy."""
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

    for name in ("corrupt", "snapshot", "membership"):
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
    for name in ("tcp", "tcp_rebind"):
        t0 = time.monotonic()
        r = crun.run_node(name, 0, device=dev, commit_rule="pallas")
        walls[name] = time.monotonic() - t0
        if not specs[name][3](r):
            raise AssertionError(f"node chaos {name}: faults never fired "
                                 f"or too few commits ({r})")
        log(f"node chaos {name}: invariants held, {r} "
            f"{walls[name]:.2f} s on {card}")
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
    gauntlet and read just after.  The inputs of K1's first call with a
    leader row (R = 12 rows, P = 3) are copied.  Returns K1's launches
    and the copy."""
    from raftsql_tpu_torch.chaos import run as crun
    from raftsql_tpu_torch.runtime.hostplane import ClusterHostPlane
    k1 = "pallas_quorum_commit_index"
    steps = [0]
    real = ClusterHostPlane._readback       # one call per device dispatch
    real_k1, captured = getattr(pq, k1), {}

    def counted(*a, **kw):
        steps[0] += 1
        return real(*a, **kw)

    def spy(*args, **kw):
        if k1 not in captured and bool(args[5].any()):
            captured[k1] = ([a.clone() for a in args], dict(kw))
        return real_k1(*args, **kw)

    pq.reset_launches()                       # the overload path starts here
    ClusterHostPlane._readback = staticmethod(counted)
    setattr(pq, k1, spy)
    try:
        t0 = time.monotonic()
        ok, reports = crun.overload_gauntlet(0, runs=2, device=dev,
                                             commit_rule="pallas")
        wall = time.monotonic() - t0
    finally:
        ClusterHostPlane._readback = staticmethod(real)
        setattr(pq, k1, real_k1)
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
    "procs": ("fb868899b7dbd88a", "3b7df695ba0107b3"),
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


def durable_arm(card, dev, native_plog, G, ticks, E=8, seed=0) -> dict:
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
    are zeroed just before the boot and read just after the run."""
    from raftsql_tpu_torch.models.kv_native import NativeKV
    from raftsql_tpu_torch.models.kv_sm import KVStateMachine
    from raftsql_tpu_torch.runtime.db import (iter_plain_batches,
                                              iter_plain_entries)
    from raftsql_tpu_torch.runtime.fused import FusedClusterNode
    from raftsql_tpu_torch.runtime.hostplane import ClusterHostPlane
    cfg = RaftConfig(num_groups=G, num_peers=3, log_window=max(64, 4 * E),
                     max_entries_per_msg=E, tick_interval_s=0.0,
                     commit_rule="pallas")
    name = "native" if native_plog else "python"
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
        torch.cuda.synchronize()
        t1 = time.monotonic()
        for _ in range(ticks):
            node.tick()
            drain()
        node.publish_flush()
        drain()
        torch.cuda.synchronize()
        dt = time.monotonic() - t1
        committed = int(node._applied[0].sum()) - applied0
        phase = {"device": m.t_device_ms / ticks, "wal": m.t_wal_ms / ticks,
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
    expect(launches, steps[0], f"arm {name}: K1 launches against device "
                               f"steps")
    if committed <= 0:
        raise AssertionError(f"arm {name}: nothing committed")
    log(f"durable plane arm {name} G={G} P=3 W={cfg.log_window} E={E} "
        f"pallas, group commit: elected in {n_elect} ticks "
        f"({t_elect:.1f} s with boot); {ticks} ticks drained {committed} "
        f"commits in {dt:.2f} s: {committed / dt:.0f} commits/s, "
        f"{dt / ticks * 1e3:.1f} ms per tick; ms per tick: device "
        f"{phase['device']:.2f}, wal {phase['wal']:.2f}, publish "
        f"{phase['publish']:.2f}; K1 launches {launches} = device steps "
        f"{steps[0]}; every WAL native on {card}")
    return {"commits_per_s": committed / dt, "ms_per_tick": dt / ticks * 1e3,
            "phase": phase, "launches": launches, "commit": commit,
            "state": state, "files": files}


def durable_plane(card: str, dev="cuda", G=10_000, ticks=24) -> dict:
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
            "launches": a["launches"] + b["launches"]}


# ---- main ------------------------------------------------------------------

def main(argv=None) -> int:
    """Every phase in turn, then the kernels line and the result line.
    `--only 10,12` (a development run) runs the build and the named
    phases and prints no result line."""
    import argparse
    ap = argparse.ArgumentParser(description="smoke run on one CUDA card")
    ap.add_argument("--only", default="",
                    help="comma separated phases (3-15) to run after the "
                         "build; no result line is printed")
    only = {int(x) for x in ap.parse_args(argv).only.split(",") if x}
    t_start = time.monotonic()

    def done(phase):
        log(f"phase {phase} done at {time.monotonic() - t_start:.1f} s")

    def want(phase):
        return not only or phase in only

    card = environment()
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
        kern = main_path_kernels(card, tick.pop("captured"))
        traced_tick(card)
        done("fused tick")
    if want(5):
        mem = membership_node(card)
        # K2's row is its joint-consensus path: R = 100,000, P = 4 (the
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
    if only:
        log(f"development run of phases {sorted(only)}: no result line")
        return 0
    k1, k2 = "pallas_quorum_commit_index", \
        "pallas_masked_quorum_commit_index"
    node_launches = {
        k: node["launches"][k] + sum(f[k] for f in nch["launches"].values())
        for k in (k1, k2)}
    launches = {
        k1: (tick["launches"][k1] + k1_server + place["launches"]
             + ch["launches"]["default"] + ch["launches"]["nemesis"]
             + node_launches[k1] + k1_overload + durable["launches"]),
        k2: tick["launches"][k2] + mem["launches"][k2] + node_launches[k2]}
    log(f"launches by path: fused tick {tick['launches']}, membership "
        f"node {mem['launches']}, server K1 {k1_server}, placement "
        f"server K1 {place['launches']}, chaos K1 {ch['launches']}, node "
        f"cluster {node['launches']}, node chaos {nch['launches']}, "
        f"overload K1 {k1_overload}, durable plane K1 "
        f"{durable['launches']}")
    log(f"procfile cluster PUT p50 {procs['p50']:.2f} ms p99 "
        f"{procs['p99']:.2f} ms; node cluster "
        f"{node['commits_per_s']:.0f} commits/s (node 1 WAL "
        f"{node['phase_ms']['wal']:.1f} ms per node tick, "
        f"{node['python_phase_ms']['wal']:.1f} on the Python backend); "
        f"durable plane "
        f"commits/s native plog + NativeKV "
        f"{durable['commits_per_s']['native']:.0f}, Python plog + "
        f"KVStateMachine {durable['commits_per_s']['python']:.0f} on {card}")
    rows = []
    for name, r in kern.items():
        row = {"name": name, "route": "cuda",
               "source": "raftsql_tpu_torch/csrc/quorum.cu",
               "replaces": REPLACES[name],
               "launches": launches[name],
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": None,
               "node_path_launches": node_launches[name],
               "overload_path_launches":
                   k1_overload if name == k1 else 0,
               "durable_plane_launches":
                   durable["launches"] if name == k1 else 0}
        for path, got in (("node_path", node_kern),
                          ("overload_path", over_kern)):
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
