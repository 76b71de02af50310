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
     and the durable node's tick without and with enable_tracing;
  5. the membership and transfer planes at G = 100,000 on 4 slots
     (voters {0,1,2}, a spare slot 3, durable FusedClusterNode,
     commit_rule="pallas"): after the elections slot 0 is replaced by
     slot 3 (add_learner, promote, remove through joint consensus) on 64
     groups while leadership moves on 64 others; every touched group
     must end on its expected config or leader and every other group on
     {0,1,2}; K2 must launch on every tick after enable_membership, and
     on one tick with joint masks live its inputs are copied: K2 is held
     against its plain version and timed on them (R = 400,000, P = 4);
  6. the fused durable SQL server (build_fused_node + the aio HTTP
     plane): the reference curl recipe, concurrent acked PUTs, a close
     and a resume=True reopen that replays the WALs;
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
     commit_rule="pallas") twice, the five fused families once each, and
     the reads, quorum and transfers families twice each
     (commit_rule="pallas"), through raftsql_tpu_torch.chaos.run; every
     schedule and result digest must equal the JAX package's
     (CHAOS_DIGESTS), and K1 must launch in the default's and the
     nemesis families' runs; then the falsification pairs of the three
     gauntlets (the broken lease bound, the unsafe transfer kernel,
     quorum arms A and B) must be caught and their controls pass;
 10. the kernels line (JSON: K1 as phase 4 measured it, K2 on phase 5's
     joint masks, launches summed over the paths) and the result line.

It needs one card and writes under build/ of its checkout (and the chaos
runs' data dirs under $TMPDIR, removed after each run).
"""
from __future__ import annotations

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
}
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
    """K1 and K2 on the tensors one fused tick at G = 100,000 handed them
    (captured in phase 4): equality, per-call (CUDA events), host and
    device time, the plain version, the bound, and what bounds the
    kernel from below."""
    results = {}
    for name, (args, kw) in captured.items():
        masks = (kw["voters"], kw["voters_joint"]) if "voters" in kw \
            else None
        P = args[0].shape[1]
        size = kw.get("size") if masks is not None else kw["quorum"]
        kern, plain, cand = _calls(args, masks, P, size)
        err = _equal(kern, plain, f"{name} on the main path's tensors")
        ms, plain_ms = time_ms(kern, reps=100), time_ms(plain)
        dev_us = kernel_device_us(kern)
        bms, by, all_rows_ms = bound(args, masks, cand)
        leaders = int(args[5].sum())
        log(f"main path {name}: R={args[0].shape[0]} P={P} "
            f"W={args[1].shape[1]}, {leaders} leader rows; equal; "
            f"{ms * 1e3:.1f} us per call (host {host_us(kern):.1f} us), "
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
                             bound_ms=bms, bound_by=by)
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
                node_ticks=8) -> dict:
    """The event ring's cost at G = 100,000.  First on phase 4's fused
    tick: blocks of `ticks` ticks without and with a DeviceEventRing
    record per tick (one full drain per traced block), in turns.  Then
    on the durable node (FusedClusterNode: the fused tick plus the host
    plane, idle after the elections) without and with enable_tracing,
    in turns, `node_ticks` a block.  And the ring's slot write alone
    (CUDA events) and one drain of the full ring."""
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
    node = FusedClusterNode(cfg, d, device=dev)
    try:
        t0, n = time.monotonic(), 0
        while (node._hints < 0).any() and n < 300:
            node.tick()
            n += 1
        node.publish_flush()
        if (node._hints < 0).any():
            raise AssertionError(f"{G} groups not elected in {n} ticks")
        log(f"traced node: {G} groups elected in {n} ticks "
            f"({time.monotonic() - t0:.1f} s)")

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

def membership_node(card: str, dev="cuda", G=100_000, n=64) -> dict:
    """The membership and transfer planes at the bench headline's width:
    a durable FusedClusterNode of G groups on 4 slots, voters {0,1,2}
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
    log(f"server: reopen replayed the WALs, rows intact; K1 launches "
        f"{grew} during the phase")
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
    """The seed-0 chaos digests on the card: the default family twice
    with commit_rule="pallas", then each fused family once, then the
    read, quorum and transfer nemesis families twice each with
    commit_rule="pallas" (K1's launch count zeroed just before those
    runs and read just after, twice: the default's and the nemesis
    families'), then the falsification pairs of those three gauntlets,
    which must be caught.  Returns the wall time of each run in seconds
    and the K1 launches of each path."""
    from raftsql_tpu_torch.chaos import run as crun
    from raftsql_tpu_torch.chaos.schedule import generate
    k1 = "pallas_quorum_commit_index"
    walls, launches = {}, {}
    pq.reset_launches()                       # the chaos path starts here
    for i in range(2):
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
    log(f"chaos default: K1 launches {launches['default']} over both runs")
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
        for i in range(2):
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
        f"six runs")
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


# ---- main ------------------------------------------------------------------

def main() -> int:
    t_start = time.monotonic()

    def done(phase):
        log(f"phase {phase} done at {time.monotonic() - t_start:.1f} s")

    card = environment()
    build_s = pq.build()
    log(f"build: csrc/quorum.cu in {build_s:.1f} s")
    check_ptxas(pq.build_log())
    done("build")
    check_kernels(card)
    done("kernels")
    tick = fused_tick(card)
    kern = main_path_kernels(card, tick.pop("captured"))
    traced_tick(card)
    done("fused tick")
    mem = membership_node(card)
    # K2's row is its joint-consensus path: R = 400,000, P = 4 (the
    # generic kernel), C_old,new masks live.
    kern.update(main_path_kernels(card, mem.pop("captured")))
    done("membership node")
    k1_server = server(card)
    done("server")
    traced_server(card)
    done("traced server")
    place = placement_server(card)
    done("placement server")
    ch = chaos(card)
    done("chaos")
    k1, k2 = "pallas_quorum_commit_index", \
        "pallas_masked_quorum_commit_index"
    launches = {
        k1: (tick["launches"][k1] + k1_server + place["launches"]
             + ch["launches"]["default"] + ch["launches"]["nemesis"]),
        k2: tick["launches"][k2] + mem["launches"][k2]}
    log(f"launches by path: fused tick {tick['launches']}, membership "
        f"node {mem['launches']}, server K1 {k1_server}, placement "
        f"server K1 {place['launches']}, chaos K1 {ch['launches']}")
    rows = []
    for name, r in kern.items():
        rows.append({"name": name, "route": "cuda",
                     "source": "raftsql_tpu_torch/csrc/quorum.cu",
                     "replaces": REPLACES[name],
                     "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None})
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
