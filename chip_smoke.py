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
     G = 8192 must be bit-identical;
  5. the fused durable SQL server (build_fused_node + the aio HTTP
     plane): the reference curl recipe, concurrent acked PUTs, a close
     and a resume=True reopen that replays the WALs;
  6. the kernels line (JSON) and the result line.

It needs one card and writes only under build/ of its checkout.
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


def kernel_device_us(fn, reps=20):
    """The kernel's own device time per launch, from torch.profiler (the
    CUDA-event time around one call also holds the wrapper's host work,
    during which the card idles); None where the trace has none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if "quorum_commit" in e.key and _self_device_us(e) > 0]
    if not ev:
        return None
    return sum(_self_device_us(e) for e in ev) / reps


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


def run_ticks(cfg, st, ib, ticks, seed, record=False):
    """`ticks` fused steps with seeded proposals; returns the state, the
    inbox, the committed-entry count and (record) every packed info."""
    rng = np.random.default_rng(seed)
    dev = st.term.device
    # Every tick's proposals made in bulk and moved once: the loop times
    # the tick, not the host's random draws.
    props = torch.from_numpy(rng.integers(
        0, cfg.max_entries_per_msg + 1,
        (ticks, cfg.num_peers, cfg.num_groups)).astype(np.int32)).to(dev)
    infos, commit0 = [], int(st.commit[0].sum())
    for prop in props:
        st, ib, pinfo, _busy = cluster.cluster_step_host(cfg, st, ib, prop)
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

    # Card vs CPU: the same 128 ticks from the same state, bit for bit.
    scfg = RaftConfig(num_groups=g, num_peers=P, log_window=W,
                      max_entries_per_msg=E, commit_rule="pallas")
    cst = cluster.init_cluster_state(scfg, device="cpu")
    cib = cluster.empty_cluster_inbox(scfg, device="cpu")
    gst = convert.peer_state_from_numpy(_np(cst), dev)
    gib = convert.inbox_from_numpy(_np(cib), dev)
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


# ---- phase 5 ---------------------------------------------------------------

def _req(port, method, body=b"", group=0):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        c.request(method, "/", body=body,
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


def _serve(groups, dev):
    from raftsql_tpu_torch.api.aio import AioSQLServer
    from raftsql_tpu_torch.server.main import build_fused_node
    rdb = build_fused_node(groups=groups, peers=3, resume=True,
                           data_prefix=os.path.join(DATA, "raftsql"),
                           commit_rule="pallas", device=dev)
    srv = AioSQLServer(_free_port(), rdb, host="127.0.0.1")
    srv.start()
    return rdb, srv


def server(card: str, dev="cuda") -> None:
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
        lat, errs = [], []
        mu = threading.Lock()

        def client(i):
            for k in range(25):
                g = (i + k) % groups
                t0 = time.monotonic()
                s, b = _req(port, "PUT", f'INSERT INTO main.t (name) '
                            f'VALUES ("c{i}-{k}")'.encode(), g)
                with mu:
                    lat.append(time.monotonic() - t0)
                    if s != 204:
                        errs.append((s, b))

        m = rdb.pipe.node.metrics
        m0 = (m.ticks, m.t_device_ms, m.t_wal_ms, m.t_publish_ms,
              time.monotonic())
        ths = [threading.Thread(target=client, args=(i,))
               for i in range(16)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        n = max(m.ticks - m0[0], 1)
        log(f"server ticks during the PUTs: {n}, per tick: wall "
            f"{(time.monotonic() - m0[4]) * 1e3 / n:.2f} ms, device "
            f"(dispatch + readback) {(m.t_device_ms - m0[1]) / n:.2f} ms, "
            f"WAL + fsync {(m.t_wal_ms - m0[2]) / n:.2f} ms, publish "
            f"{(m.t_publish_ms - m0[3]) / n:.2f} ms")
        expect(errs, [], "concurrent PUTs")
        rows = 0
        for g in range(groups):
            st, body = _req(port, "GET", b"SELECT count(*) FROM main.t", g)
            expect(st, 200, f"count g{g}")
            rows += int(body.strip().strip(b"|"))
        expect(rows, groups + 16 * 25, "rows")
        lat.sort()
        p50 = lat[len(lat) // 2] * 1e3
        p99 = lat[int(len(lat) * 0.99)] * 1e3
        log(f"server: {len(lat)} PUTs from 16 threads acked and read "
            f"back; propose->ack p50 {p50:.2f} ms p99 {p99:.2f} ms on "
            f"{card}")
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


# ---- main ------------------------------------------------------------------

def main() -> int:
    card = environment()
    build_s = pq.build()
    log(f"build: csrc/quorum.cu in {build_s:.1f} s")
    check_ptxas(pq.build_log())
    check_kernels(card)
    tick = fused_tick(card)
    kern = main_path_kernels(card, tick.pop("captured"))
    server(card)
    rows = []
    for name, r in kern.items():
        rows.append({"name": name, "route": "cuda",
                     "source": "raftsql_tpu_torch/csrc/quorum.cu",
                     "replaces": REPLACES[name],
                     "launches": tick["launches"][name],
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
