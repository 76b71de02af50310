"""Seeded, deterministic, tick-indexed fault schedules for the fused
chaos runner.

Port of the fused-plane part of raftsql_tpu/chaos/schedule.py (pure
numpy, copied so the port imports nothing of the JAX package): the
window and fault dataclasses, `ChaosSchedule`, `generate(seed)` and the
fused family generators.  Every schedule derives from one integer seed
via `numpy.random.default_rng`, and `digest()` hashes the canonical
JSON form with sha256 — the same bytes as the JAX package's, so a port
schedule hashes to the reference's for the same seed.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Tuple

import numpy as np

# Partition / crash target sentinel: resolved at the window's first tick
# to whichever peer then leads group 0 — the leader-targeted kill.
LEADER_TARGET = -2


@dataclasses.dataclass(frozen=True)
class DropWindow:
    """Drop each message slot independently with probability p while
    start <= tick < end (transport.faults.random_drop)."""
    start: int
    end: int
    p: float


@dataclasses.dataclass(frozen=True)
class DelayWindow:
    """Hold each message slot with probability p for `latency` ticks
    before delivery (transport.faults.hold_messages/release_messages).
    Messages still in flight at a crash are lost — as on a real wire."""
    start: int
    end: int
    p: float
    latency: int


@dataclasses.dataclass(frozen=True)
class PartitionWindow:
    """Isolate one peer (nothing in, nothing out) for the window.
    peer == LEADER_TARGET resolves to group 0's leader at `start`."""
    start: int
    end: int
    peer: int


@dataclasses.dataclass(frozen=True)
class AsymPartitionWindow:
    """ONE-directional partition for the window: `dst` stops hearing
    `src` while `src` still hears `dst` (transport.faults.asym_partition
    on the device plane; FaultPlan.block / TCP SendFaults.block on the
    wire planes).  src == LEADER_TARGET resolves to group 0's leader at
    `start` — "the cluster goes deaf to its leader" is the classic
    half-open failure."""
    start: int
    end: int
    src: int
    dst: int


@dataclasses.dataclass(frozen=True)
class SkewWindow:
    """Per-peer clock skew: while start <= tick < end, peer p's
    election/heartbeat timers advance incs[p] intervals per tick
    (1 = nominal).  Integer rates express relative drift — a peer at 2
    experiences time twice as fast as its cluster; real deployments
    never tick in lockstep, and the batched runtime's lockstep default
    is exactly the assumption this window breaks."""
    start: int
    end: int
    incs: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class EnospcFault:
    """Peer `peer`'s op-th WAL write ATTEMPT fails with ENOSPC before
    any byte lands (storage/fsio.py check_write).  The runner treats it
    as fatal — crash + restart — and the consumed trigger models the
    operator freeing space, so the retry succeeds from a clean tail."""
    peer: int
    op: int


@dataclasses.dataclass(frozen=True)
class FsyncStall:
    """Peer `peer`'s fsyncs op .. op+count-1 stall `stall_s` seconds
    each (slow disk, not failed disk): durability holds, latency
    suffers, every invariant must survive the slowdown."""
    peer: int
    op: int
    count: int = 3
    stall_s: float = 0.02


@dataclasses.dataclass(frozen=True)
class CrashEvent:
    """Hard process crash at `tick` (the whole fused cluster process),
    followed by immediate restart-from-WAL.  power_loss=True models a
    machine crash instead: everything not fsynced is dropped, and
    `tear_peer` (if >= 0) additionally has its last WAL write torn
    mid-record.  Scheduled crashes fire on tick boundaries (post-
    barrier); MID-tick power loss comes from TornWriteFault."""
    tick: int
    power_loss: bool = False
    tear_peer: int = -1


@dataclasses.dataclass(frozen=True)
class FsyncFault:
    """The op-th fsync under peer `peer`'s WAL directory raises (a
    failed disk flush).  The runner treats it as fatal for the process
    — crash + restart — which is the etcd posture (panic on WAL sync
    failure rather than ack unsynced data)."""
    peer: int
    op: int


@dataclasses.dataclass(frozen=True)
class TornWriteFault:
    """Power loss mid-way through peer `peer`'s op-th WAL record write:
    the machine dies with the record partially in the page cache and
    nothing of the current tick fsynced.  The runner tears that record
    (truncates it mid-write), drops every other file's unsynced tail,
    and restarts — WAL._repair_tail and epoch repair must recover."""
    peer: int
    op: int


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """A complete scripted scenario for the fused runtime."""
    seed: int
    ticks: int
    drops: Tuple[DropWindow, ...] = ()
    delays: Tuple[DelayWindow, ...] = ()
    partitions: Tuple[PartitionWindow, ...] = ()
    crashes: Tuple[CrashEvent, ...] = ()
    fsync_faults: Tuple[FsyncFault, ...] = ()
    torn_writes: Tuple[TornWriteFault, ...] = ()
    asym_partitions: Tuple[AsymPartitionWindow, ...] = ()
    skews: Tuple[SkewWindow, ...] = ()
    enospc_faults: Tuple[EnospcFault, ...] = ()
    fsync_stalls: Tuple[FsyncStall, ...] = ()
    # Aggressive-compaction interleaving: every `compact_every` ticks the
    # runner advances every peer's compaction floor to applied -
    # compact_keep (clamped to the device window) — so crashes and
    # restarts land on compacted WALs (COMPACT markers, segment drops,
    # floor-aware replay).  0 = never compact (the pre-matrix default).
    compact_every: int = 0
    compact_keep: int = 0
    prop_rate: float = 0.5       # P(issue a PUT batch) per tick
    read_rate: float = 0.35      # P(issue a linearizable GET) per tick

    def describe(self) -> dict:
        return dataclasses.asdict(self)

    def digest(self) -> str:
        blob = json.dumps(self.describe(), sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


def generate(seed: int, ticks: int = 240, peers: int = 3,
             min_partitions: int = 2, min_crashes: int = 2,
             min_fsync_faults: int = 1,
             min_torn_writes: int = 1,
             with_delays: bool = True) -> ChaosSchedule:
    """Derive a full scenario from one seed.

    Guarantees the floors the acceptance gate needs: >= min_partitions
    partition windows (at least one leader-targeted), >= min_crashes
    crash/restart events, >= min_fsync_faults injected fsync failures,
    and >= min_torn_writes mid-write power losses (each also a
    crash/restart).
    """
    rng = np.random.default_rng(seed)
    warmup = 40                          # let first elections settle

    n_part = int(min_partitions + rng.integers(0, 2))
    parts = []
    for i in range(n_part):
        start = int(rng.integers(warmup, max(warmup + 1,
                                             ticks - 60)))
        length = int(rng.integers(20, 41))
        # First window is always the leader-targeted kill.
        peer = LEADER_TARGET if i == 0 else int(rng.integers(0, peers))
        parts.append(PartitionWindow(start, min(start + length, ticks),
                                     peer))
    parts.sort(key=lambda w: w.start)

    n_crash = int(min_crashes + rng.integers(0, 2))
    lo, hi = int(ticks * 0.35), int(ticks * 0.9)
    crash_ticks = sorted(int(t) for t in rng.choice(
        np.arange(lo, hi), size=n_crash, replace=False))
    # Scheduled crashes land on tick boundaries, where the durable
    # barrier has just completed — they exercise clean process-kill
    # replay.  Power-loss recovery (unsynced/torn tails) is exercised
    # by the torn-write faults below, which fire MID-tick.
    crashes = tuple(CrashEvent(t) for t in crash_ticks)

    # Each active tick fsyncs every peer once, so op counts in the low
    # tens always fire well before the first crash window.
    faults = tuple(FsyncFault(int(rng.integers(0, peers)),
                              int(rng.integers(15, 30)) + 10 * i)
                   for i in range(min_fsync_faults))
    # Every active tick writes at least a hard-state record per peer;
    # write ops accumulate a few per active tick, so these fire mid-run.
    torn = tuple(TornWriteFault(int(rng.integers(0, peers)),
                                int(rng.integers(60, 120)) + 40 * i)
                 for i in range(min_torn_writes))

    drops = (DropWindow(int(rng.integers(warmup, ticks // 2)),
                        int(rng.integers(ticks // 2, ticks)),
                        float(rng.uniform(0.05, 0.2))),)
    delays = ()
    if with_delays:
        d0 = int(rng.integers(warmup, ticks - 40))
        delays = (DelayWindow(d0, d0 + int(rng.integers(20, 40)),
                              float(rng.uniform(0.1, 0.3)),
                              int(rng.integers(2, 5))),)

    return ChaosSchedule(seed=seed, ticks=ticks, drops=drops,
                         delays=delays, partitions=tuple(parts),
                         crashes=crashes, fsync_faults=faults,
                         torn_writes=torn)


# ---------------------------------------------------------------------------
# Scenario FAMILY generators — one per uncovered fault-matrix axis
# (ROADMAP open items).  Each derives a focused schedule from one seed:
# the family's faults plus light background load, sized so a fast
# tier-1 run stays cheap and `make chaos-matrix` can sweep one seed per
# family.  All are deterministic functions of (seed, ticks).

def generate_asym(seed: int, ticks: int = 160,
                  peers: int = 3) -> ChaosSchedule:
    """Asymmetric partitions (fused plane): one leader-targeted deafness
    window (the cluster stops hearing its leader), one random
    one-directional link cut, plus a crash so recovery interleaves."""
    rng = np.random.default_rng(seed ^ 0xA51)
    warmup = 40
    s0 = int(rng.integers(warmup, ticks // 2))
    d0 = int(rng.integers(0, peers))
    asym = [AsymPartitionWindow(s0, s0 + int(rng.integers(25, 40)),
                                LEADER_TARGET, d0)]
    s1 = int(rng.integers(ticks // 2, ticks - 30))
    src = int(rng.integers(0, peers))
    dst = int((src + 1 + rng.integers(0, peers - 1)) % peers)
    asym.append(AsymPartitionWindow(s1, s1 + int(rng.integers(20, 35)),
                                    src, dst))
    crash = CrashEvent(int(rng.integers(int(ticks * 0.55),
                                        int(ticks * 0.85))))
    return ChaosSchedule(seed=seed, ticks=ticks,
                         asym_partitions=tuple(asym), crashes=(crash,))


def generate_skew(seed: int, ticks: int = 160, peers: int = 3,
                  max_inc: int = 3) -> ChaosSchedule:
    """Per-peer clock skew (fused plane): two windows of drifting timer
    rates — one peer fast, later another — with a crash between them.
    The lockstep run of the SAME seed minus the skews is the regression
    baseline: election outcomes must demonstrably differ."""
    rng = np.random.default_rng(seed ^ 0x5E3)
    warmup = 30

    def draw_incs() -> Tuple[int, ...]:
        incs = [1] * peers
        fast = int(rng.integers(0, peers))
        incs[fast] = int(rng.integers(2, max_inc + 1))
        slow = int((fast + 1) % peers)
        if rng.random() < 0.5:
            incs[slow] = 0               # a stalled clock, not just slow
        return tuple(incs)

    s0 = int(rng.integers(warmup, ticks // 3))
    w0 = SkewWindow(s0, s0 + int(rng.integers(30, 50)), draw_incs())
    s1 = int(rng.integers(ticks // 2, int(ticks * 0.8)))
    w1 = SkewWindow(s1, s1 + int(rng.integers(25, 40)), draw_incs())
    crash = CrashEvent(int(rng.integers(ticks // 3, ticks // 2)))
    return ChaosSchedule(seed=seed, ticks=ticks, skews=(w0, w1),
                         crashes=(crash,))


def generate_enospc(seed: int, ticks: int = 140,
                    peers: int = 3) -> ChaosSchedule:
    """Disk-full on WAL append (fused plane): two ENOSPC write failures
    on seeded peers/ops — each is fatal (crash + restart from a clean
    tail), and the consumed trigger lets the retry land."""
    rng = np.random.default_rng(seed ^ 0xE05)
    faults = tuple(EnospcFault(int(rng.integers(0, peers)),
                               int(rng.integers(20, 60)) + 60 * i)
                   for i in range(2))
    return ChaosSchedule(seed=seed, ticks=ticks, enospc_faults=faults,
                         prop_rate=0.6)


def generate_stall(seed: int, ticks: int = 120,
                   peers: int = 3) -> ChaosSchedule:
    """Fsync latency stalls (fused plane): bursts of slow fsyncs on two
    seeded peers, plus a crash mid-run — durability and ordering must
    hold when the barrier is merely LATE."""
    rng = np.random.default_rng(seed ^ 0x57A)
    stalls = tuple(FsyncStall(int(rng.integers(0, peers)),
                              int(rng.integers(10, 40)) + 40 * i,
                              count=3, stall_s=0.02)
                   for i in range(2))
    crash = CrashEvent(int(rng.integers(ticks // 2, int(ticks * 0.8))))
    return ChaosSchedule(seed=seed, ticks=ticks, fsync_stalls=stalls,
                         crashes=(crash,), prop_rate=0.6)


def generate_compact(seed: int, ticks: int = 200,
                     peers: int = 3) -> ChaosSchedule:
    """Aggressive compaction interleaved with crashes (fused plane):
    compact every few ticks with a tiny retained window while crashes
    (one power loss with a torn record) land between floors — restart
    replays COMPACT-marked, segment-dropped WALs.  Pair with a small
    cfg log_window (the runner's compact clamps keep to it)."""
    rng = np.random.default_rng(seed ^ 0xC04)
    lo, hi = int(ticks * 0.3), int(ticks * 0.9)
    t0, t1 = sorted(int(t) for t in rng.choice(
        np.arange(lo, hi), size=2, replace=False))
    crashes = (CrashEvent(t0), CrashEvent(t1))
    # A mid-record power loss (NOT on a tick boundary — boundary
    # crashes have nothing unsynced to tear) so torn-tail repair runs
    # against a compacted, COMPACT-marked WAL.
    torn = (TornWriteFault(int(rng.integers(0, peers)),
                           int(rng.integers(120, 240))),)
    return ChaosSchedule(seed=seed, ticks=ticks, crashes=crashes,
                         torn_writes=torn,
                         compact_every=int(rng.integers(6, 12)),
                         compact_keep=1, prop_rate=0.9, read_rate=0.3)
