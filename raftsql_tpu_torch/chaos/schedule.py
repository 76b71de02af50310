"""Seeded, deterministic, tick-indexed fault schedules for the fused
chaos runner.

Port of the fused-plane part of raftsql_tpu/chaos/schedule.py (pure
numpy, copied so the port imports nothing of the JAX package): the
window and fault dataclasses, `ChaosSchedule`, `generate(seed)`, the
fused family generators, and the read, transfer and quorum nemesis plans
with their falsification plans, and the node-plane plans of the
distributed runtime's families (NodeChaosPlan, TcpChaosPlan,
MembershipChaosPlan, TcpRebindPlan) with their generators.  Every
schedule derives from one integer seed
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
class CorruptWindow:
    """Wire-frame corruption (loopback / TCP planes): while active,
    each encoded frame is bit-flipped with probability p.  The CRC32
    framing (transport/codec.py) must catch and drop every mangled
    frame — corruption may cost progress, never correctness."""
    start: int
    end: int
    p: float


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


@dataclasses.dataclass(frozen=True)
class ReadNemesisPlan:
    """Scripted read-plane attack (fused plane, chaos/scenarios.py
    ReadNemesisRunner): writes race lease / ReadIndex / session /
    follower reads while clock skew, partitions, leader kills and
    crashes land — checked by the real-time read-linearizability and
    session-consistency invariants.

    A SEPARATE plan class on purpose: extending ChaosSchedule would
    change the asdict() digest of every existing family.  The runner
    projects the fault fields into a ChaosSchedule internally so fault
    application shares the proven code paths.

    `lease_ticks`/`max_clock_skew` configure the engine's lease bound;
    `max_skew_rate` caps the per-peer timer rates the skew windows
    draw.  The SAFE sizing contract (config.py lease_ticks) is
    lease_ticks + max_clock_skew <= election_ticks / max_skew_rate;
    `broken_lease=True` deliberately violates it (the falsification
    plan — the invariant must then CATCH a stale lease read)."""
    seed: int
    ticks: int
    peers: int = 3
    groups: int = 4
    election_ticks: int = 16
    lease_ticks: int = 6
    max_clock_skew: int = 1
    max_skew_rate: int = 2
    broken_lease: bool = False
    skews: Tuple[SkewWindow, ...] = ()
    partitions: Tuple[PartitionWindow, ...] = ()
    asym_partitions: Tuple[AsymPartitionWindow, ...] = ()
    crashes: Tuple[CrashEvent, ...] = ()
    prop_rate: float = 0.8
    lease_read_rate: float = 0.8
    read_index_rate: float = 0.5
    session_read_rate: float = 0.5
    follower_read_rate: float = 0.5

    def describe(self) -> dict:
        return dataclasses.asdict(self)

    def digest(self) -> str:
        blob = json.dumps(self.describe(), sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


# TransferEvent.target sentinel: resolved at issue time to the peer the
# plan's FIRST partition window isolated (the "lagging" peer — behind by
# a whole window of appends).  The directed falsification plan uses it
# to aim a transfer at a provably-behind target.
XFER_LAGGER = -3


@dataclasses.dataclass(frozen=True)
class TransferEvent:
    """Graceful leadership transfer requested at `tick` (retried each
    tick until the engine accepts it or the retry budget runs out).
    `group` -1 = any group currently led by someone other than the
    resolved target; `target` -1 = the leader's successor slot
    ((leader + 1) % peers), XFER_LAGGER = the first partition window's
    isolated peer.  `must_complete` marks the directed falsification
    probe: the transfer MUST end `completed` within the plan's
    max_stall_ticks — the §3.10-broken kernel (unsafe_transfer) deposes
    the old leader before the target caught up, the behind target can
    never win the election, and the transfer ABORTS instead."""
    tick: int
    group: int = -1
    target: int = -1
    must_complete: bool = False


@dataclasses.dataclass(frozen=True)
class TransferNemesisPlan:
    """Scripted transfer-under-nemesis attack (fused plane,
    chaos/scenarios.py TransferChaosRunner): graceful leadership
    transfers race the existing nemesis arsenal — drops, partitions
    (leader-targeted kills), one-directional cuts, clock skew, and
    crash+restart — under live acked-PUT load, checked by the
    TransferAvailability invariant (bounded per-transfer proposal
    stall, aborted transfers re-open the group) on top of the standing
    election-safety / durability / linearizability invariants.

    A SEPARATE plan class on purpose (ReadNemesisPlan precedent):
    extending ChaosSchedule would change the asdict() digest of every
    existing family.  The runner projects the fault fields into a
    ChaosSchedule internally so fault application shares the proven
    code paths.

    `unsafe_transfer=True` compiles the deliberately broken transfer
    kernel (config.py unsafe_transfer: no catch-up gate, instant
    abdication) — the falsification plan the harness must CATCH."""
    seed: int
    ticks: int
    peers: int = 3
    groups: int = 4
    transfers: Tuple[TransferEvent, ...] = ()
    drops: Tuple[DropWindow, ...] = ()
    partitions: Tuple[PartitionWindow, ...] = ()
    asym_partitions: Tuple[AsymPartitionWindow, ...] = ()
    skews: Tuple[SkewWindow, ...] = ()
    crashes: Tuple[CrashEvent, ...] = ()
    election_ticks: int = 10
    # Engine-side per-transfer deadline (device steps): past it the host
    # clears the latch and the group resumes under the old leader.
    deadline_ticks: int = 40
    # Directed stall bound for must_complete transfers (falsification).
    max_stall_ticks: int = 60
    # A probe write proposed when a transfer resolves inside a
    # fault-free window must commit within this many ticks (the
    # "group keeps serving" leg of the availability invariant).
    probe_ticks: int = 30
    unsafe_transfer: bool = False
    prop_rate: float = 0.7
    read_rate: float = 0.25

    def describe(self) -> dict:
        return dataclasses.asdict(self)

    def digest(self) -> str:
        blob = json.dumps(self.describe(), sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


def generate_transfers(seed: int, ticks: int = 260,
                       peers: int = 3) -> TransferNemesisPlan:
    """The transfer-under-nemesis family: graceful transfers land
    before, inside, and after each fault window — a leader-targeted
    partition (the fused plane's leader kill), a one-directional cut, a
    drop window, a clock-skew window, and a whole-process crash — while
    the acked-PUT workload keeps running.  At least two transfers fall
    in fault-free air so their serving probes actually assert."""
    rng = np.random.default_rng(seed ^ 0x7AFE)
    warmup = 40
    groups = 4
    # Fault windows in the middle third-ish of the run.
    p0 = int(rng.integers(warmup + 20, ticks // 3))
    part = PartitionWindow(p0, p0 + int(rng.integers(20, 30)),
                           LEADER_TARGET)
    a0 = int(rng.integers(ticks // 3 + 10, ticks // 2))
    asym = AsymPartitionWindow(a0, a0 + int(rng.integers(15, 25)),
                               LEADER_TARGET, int(rng.integers(0, peers)))
    d0 = int(rng.integers(ticks // 2, int(ticks * 0.62)))
    drop = DropWindow(d0, d0 + int(rng.integers(15, 25)),
                      float(rng.uniform(0.08, 0.2)))
    incs = [1] * peers
    incs[int(rng.integers(0, peers))] = 2
    s0 = int(rng.integers(int(ticks * 0.62), int(ticks * 0.72)))
    skew = SkewWindow(s0, s0 + int(rng.integers(12, 20)), tuple(incs))
    crash = CrashEvent(int(rng.integers(int(ticks * 0.72),
                                        int(ticks * 0.8))))
    # Transfers: two in the clean warmup air, one inside each fault
    # window (racing it), two in the post-crash tail.
    evs = [
        TransferEvent(warmup, int(rng.integers(0, groups))),
        TransferEvent(warmup + 8, int(rng.integers(0, groups))),
        TransferEvent(part.start + 5, int(rng.integers(0, groups))),
        TransferEvent(asym.start + 4, int(rng.integers(0, groups))),
        TransferEvent(drop.start + 4, int(rng.integers(0, groups))),
        TransferEvent(skew.start + 3, int(rng.integers(0, groups))),
        TransferEvent(crash.tick + 12, int(rng.integers(0, groups))),
        TransferEvent(crash.tick + 24, int(rng.integers(0, groups))),
    ]
    return TransferNemesisPlan(
        seed=seed, ticks=max(ticks, crash.tick + 70), peers=peers,
        groups=groups, transfers=tuple(evs), drops=(drop,),
        partitions=(part,), asym_partitions=(asym,), skews=(skew,),
        crashes=(crash,))


def falsification_transfer_plan(seed: int = 0,
                                broken: bool = True
                                ) -> TransferNemesisPlan:
    """DIRECTED transfer-falsification scenario: a long leader-targeted
    partition leaves one peer a full window of appends behind; after
    the heal, a must_complete transfer aims a group at exactly that
    lagging peer.  The CORRECT kernel (thesis §3.10) holds the
    TimeoutNow until the target's match_index catches up, then the
    target wins immediately — the transfer COMPLETES well inside
    max_stall_ticks.  broken=True compiles the unsafe kernel (no
    catch-up gate, instant abdication): the behind target calls an
    election it cannot win (log restriction), the group goes leaderless
    until a third peer times out, and the transfer ABORTS — the
    TransferAvailability invariant MUST fire on the same schedule,
    proving the harness detects the §3.10 mistake, not chaos in
    general."""
    # The transfer fires AT the heal tick: the lagger is still a full
    # window of appends behind (replication closes the gap at
    # max_entries_per_msg per tick, so waiting even a handful of ticks
    # would hand the broken kernel an already-caught-up target and
    # nothing to falsify).
    part = PartitionWindow(40, 100, LEADER_TARGET)
    xfer = TransferEvent(100, group=-1, target=XFER_LAGGER,
                         must_complete=True)
    return TransferNemesisPlan(
        seed=seed, ticks=200, peers=3, groups=2,
        transfers=(xfer,), partitions=(part,),
        election_ticks=10, deadline_ticks=80, max_stall_ticks=60,
        probe_ticks=40, unsafe_transfer=broken,
        prop_rate=1.0, read_rate=0.2)


def generate_reads(seed: int, ticks: int = 240,
                   peers: int = 3) -> ReadNemesisPlan:
    """The read-linearizability nemesis family: two skew windows at
    rates within the configured bound, a leader-targeted full
    partition, a one-directional leader cut, and a crash — all while
    every read mode races the write stream.  Lease bound sized SAFELY
    (election 16, rate cap 2, lease 6 + skew 1 < 16/2): under this
    schedule a lease read must NEVER be stale, and the run asserts the
    invariant checked every family."""
    rng = np.random.default_rng(seed ^ 0x4EAD)
    warmup = 40
    rate = 2

    def draw_incs() -> Tuple[int, ...]:
        incs = [1] * peers
        fast = int(rng.integers(0, peers))
        incs[fast] = rate
        if rng.random() < 0.5:
            incs[int((fast + 1) % peers)] = 0    # a stalled clock too
        return tuple(incs)

    s0 = int(rng.integers(warmup, warmup + ticks // 4))
    w0 = SkewWindow(s0, s0 + int(rng.integers(25, 40)), draw_incs())
    s1 = int(rng.integers(ticks // 2, int(ticks * 0.75)))
    w1 = SkewWindow(s1, s1 + int(rng.integers(25, 40)), draw_incs())
    p0 = int(rng.integers(warmup, ticks // 3))
    part = PartitionWindow(p0, p0 + int(rng.integers(25, 40)),
                           LEADER_TARGET)
    a0 = int(rng.integers(ticks // 3, int(ticks * 0.7)))
    asym = AsymPartitionWindow(a0, a0 + int(rng.integers(20, 35)),
                               LEADER_TARGET,
                               int(rng.integers(0, peers)))
    crash = CrashEvent(int(rng.integers(int(ticks * 0.55),
                                        int(ticks * 0.85))))
    return ReadNemesisPlan(seed=seed, ticks=ticks, peers=peers,
                           election_ticks=16, lease_ticks=6,
                           max_clock_skew=1, max_skew_rate=rate,
                           skews=(w0, w1), partitions=(part,),
                           asym_partitions=(asym,), crashes=(crash,))


def falsification_plan(seed: int = 0,
                       broken: bool = True) -> ReadNemesisPlan:
    """DIRECTED lease-falsification scenario: both followers run their
    clocks at 4x through a long leader partition, so a new leader is
    elected (election_ticks/4 of ITS clock) while the old one still
    sits inside a mis-sized lease.  broken=True sizes the lease at
    election_ticks (legal only for rate <= ~1) — the stale window is
    real and the read-linearizability invariant MUST fire.
    broken=False sizes it to the actual rate (16/4 - margin) — the
    same schedule must pass, which proves the harness is sensitive to
    exactly the bound and not just to chaos in general."""
    # All clocks at 4x (the lease is measured in device steps, so the
    # leader's own rate is irrelevant — what matters is how fast the
    # FOLLOWERS' election timers run); the partition resolves to
    # whoever leads group 0 when it opens.
    skew = SkewWindow(40, 160, (4, 4, 4))
    part = PartitionWindow(50, 160, LEADER_TARGET)
    return ReadNemesisPlan(
        seed=seed, ticks=200, peers=3, groups=2,
        election_ticks=16,
        # Broken: the lease outlives the whole election dance the 4x
        # clocks run behind the partition (sized like an operator who
        # tuned for no skew at all); correct: within election/rate.
        lease_ticks=100 if broken else 3,
        max_clock_skew=0, max_skew_rate=4,
        broken_lease=broken,
        skews=(skew,), partitions=(part,),
        prop_rate=1.0, lease_read_rate=1.0,
        read_index_rate=0.4, session_read_rate=0.4,
        follower_read_rate=0.4)


@dataclasses.dataclass(frozen=True)
class QuorumNemesisPlan:
    """Scripted quorum-geometry attack (fused plane, chaos/scenarios.py
    QuorumChaosRunner): flexible write/election quorums and witness
    peers under the read-nemesis workload — acked PUTs race lease and
    ReadIndex reads while partitions, asymmetric cuts, clock skew and
    crash+restart land.

    A SEPARATE plan class on purpose (same rule as ReadNemesisPlan):
    extending an existing plan would change the asdict() digest of
    every committed family.  The runner projects the fault fields into
    a ChaosSchedule internally and forwards the geometry fields into
    RaftConfig (write_quorum / election_quorum / witnesses /
    unsafe_quorum_geometry / unsafe_witness_lease).

    `pin_leader_tick` >= 0 pins group 0's leadership onto
    `pin_leader_peer` (transfer_leadership, retried for a few ticks)
    before the fault windows open — the directed falsification plans
    need to know WHO the partitioned leader is so the windows can be
    written against fixed peer ids instead of LEADER_TARGET."""
    seed: int
    ticks: int
    peers: int = 3
    groups: int = 2
    election_ticks: int = 16
    lease_ticks: int = 6
    max_clock_skew: int = 1
    max_skew_rate: int = 2
    write_quorum: "int | None" = None
    election_quorum: "int | None" = None
    witnesses: Tuple[int, ...] = ()
    unsafe_geometry: bool = False
    broken_witness_lease: bool = False
    pin_leader_tick: int = -1
    pin_leader_peer: int = 0
    skews: Tuple[SkewWindow, ...] = ()
    partitions: Tuple[PartitionWindow, ...] = ()
    asym_partitions: Tuple[AsymPartitionWindow, ...] = ()
    crashes: Tuple[CrashEvent, ...] = ()
    prop_rate: float = 0.8
    lease_read_rate: float = 0.8
    read_index_rate: float = 0.4
    # Session/follower reads resolve at a RANDOM peer in the read
    # nemesis; a witness peer has no apply state to answer from, so the
    # quorum family keeps these modes off by default.
    session_read_rate: float = 0.0
    follower_read_rate: float = 0.0

    def describe(self) -> dict:
        return dataclasses.asdict(self)

    def digest(self) -> str:
        blob = json.dumps(self.describe(), sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


def generate_quorum(seed: int, ticks: int = 240) -> QuorumNemesisPlan:
    """The quorum-geometry nemesis family: a 2-voter + 1-witness
    cluster (the last peer is the witness; W = E = 2 explicit, which
    intersects: W+E > N, 2E > N) sustains acked PUTs plus lease and
    ReadIndex reads through two skew windows within the configured
    bound, a leader-targeted full partition, a one-directional leader
    cut, and a whole-cluster crash+restart — the restart replays the
    witness's vote/term/log purely from its WAL (it has no shard).
    Geometry is CORRECT, so every standing invariant must hold and
    digests must reproduce across runs; the witness must accumulate
    replicated appends (witness_appends) while its publish stream
    stays empty (one fewer apply stream than WAL streams)."""
    rng = np.random.default_rng(seed ^ 0x9E0)
    warmup = 40
    rate = 2
    wit = 2                       # witness slot: the last of 3 peers

    def draw_incs() -> Tuple[int, ...]:
        incs = [1, 1, 1]
        fast = int(rng.integers(0, 3))
        incs[fast] = rate
        if rng.random() < 0.5:
            incs[int((fast + 1) % 3)] = 0        # a stalled clock too
        return tuple(incs)

    s0 = int(rng.integers(warmup, warmup + ticks // 4))
    w0 = SkewWindow(s0, s0 + int(rng.integers(25, 40)), draw_incs())
    s1 = int(rng.integers(ticks // 2, int(ticks * 0.75)))
    w1 = SkewWindow(s1, s1 + int(rng.integers(25, 40)), draw_incs())
    p0 = int(rng.integers(warmup, ticks // 3))
    part = PartitionWindow(p0, p0 + int(rng.integers(25, 40)),
                           LEADER_TARGET)
    a0 = int(rng.integers(ticks // 3, int(ticks * 0.7)))
    asym = AsymPartitionWindow(a0, a0 + int(rng.integers(20, 35)),
                               LEADER_TARGET,
                               int(rng.integers(0, 2)))  # a voter
    crash = CrashEvent(int(rng.integers(int(ticks * 0.55),
                                        int(ticks * 0.85))))
    return QuorumNemesisPlan(seed=seed, ticks=ticks, peers=3, groups=2,
                             election_ticks=16, lease_ticks=6,
                             max_clock_skew=1, max_skew_rate=rate,
                             write_quorum=2, election_quorum=2,
                             witnesses=(wit,),
                             skews=(w0, w1), partitions=(part,),
                             asym_partitions=(asym,), crashes=(crash,))


def falsification_quorum_plan(seed: int = 0,
                              broken: bool = True) -> QuorumNemesisPlan:
    """DIRECTED split-brain falsification for flexible quorums: pin
    group 0's leadership to peer 0, then isolate peer 0 for a long
    window.  broken=True runs W=1 / E=2 (W + E <= N — the
    non-intersecting geometry config.py refuses without
    unsafe_quorum_geometry): the isolated leader keeps solo-committing
    the acked writes still routed at it while the other two peers
    elect (E=2 holds without it) and commit DIFFERENT entries into the
    same slots — two peers surface different payloads for one
    (group, index) and the harness MUST catch it (the cross-peer
    durability view's changed-content check, log matching, or commit
    monotonicity, whichever observes first).  broken=False runs the
    SAME schedule at W=2: the isolated leader can no longer commit
    alone and the run must pass — proving the harness is sensitive to
    exactly the geometry, not to chaos in general."""
    part = PartitionWindow(60, 170, 0)       # the pinned leader
    return QuorumNemesisPlan(
        seed=seed, ticks=220, peers=3, groups=1,
        election_ticks=10,
        lease_ticks=0, max_clock_skew=0, max_skew_rate=1,
        write_quorum=1 if broken else 2, election_quorum=2,
        unsafe_geometry=broken,
        pin_leader_tick=30, pin_leader_peer=0,
        partitions=(part,),
        prop_rate=1.0, lease_read_rate=0.0, read_index_rate=0.0)


def falsification_witness_plan(seed: int = 0,
                               broken: bool = True) -> QuorumNemesisPlan:
    """DIRECTED stale-lease falsification for witness accounting: pin
    group 0's leadership to peer 1 (a full voter; peer 2 is the
    witness), isolate it at tick 70, and run candidate peer 0's clock
    at 4x so its election timer fires INSIDE the deposed leader's
    still-live lease (lease 12 from the last pre-partition quorum ack
    ~ tick 69; the 16..32-tick timeout draw lands at tick 74..78 of
    real time).  broken=True sets unsafe_witness_lease: the witness
    grants the prevote despite sitting inside the leader's lease
    window, peer 0 wins (E=2 = itself + the witness), commits new
    acked writes — and the isolated leader, lease in hand, serves a
    lease read of the OLD value.  The register invariant MUST catch it
    as a stale lease read.  broken=False runs the SAME schedule with
    the honest witness: the prevote is refused until the witness's own
    election timer clears (tick ~86, after the lease died at ~87 — the
    first honest COMMIT lands later still), so the run must pass —
    proving a witness counted toward the LEASE quorum is exactly the
    bug, not chaos in general.  Lease 18 is the directed sweet spot:
    long enough that the usurper's first committed writes (~tick 80)
    land while the deposed leader still serves (stale window ~80..84),
    short enough that the honest election cannot complete inside it."""
    skew = SkewWindow(60, 130, (4, 1, 1))    # candidate clock at 4x
    part = PartitionWindow(70, 130, 1)       # isolate the pinned leader
    return QuorumNemesisPlan(
        seed=seed, ticks=170, peers=3, groups=1,
        election_ticks=16, lease_ticks=18,
        max_clock_skew=0, max_skew_rate=4,
        witnesses=(2,), write_quorum=2, election_quorum=2,
        broken_witness_lease=broken,
        pin_leader_tick=25, pin_leader_peer=1,
        skews=(skew,), partitions=(part,),
        prop_rate=1.0, lease_read_rate=1.0, read_index_rate=0.0)


# ---------------------------------------------------------------------------
# The node-plane families: lockstep RaftNode clusters over the loopback
# transport (corrupt, snapshot, membership) and over real TCP (tcp,
# tcp_rebind).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NodeCrash:
    """Threaded-cluster plane: kill peer `peer` (0-based, or
    LEADER_TARGET) at `tick`, restart it `down` ticks later."""
    tick: int
    peer: int
    down: int = 30


@dataclasses.dataclass(frozen=True)
class NodeChaosPlan:
    """Scripted scenario for the lockstep RaftNode cluster."""
    seed: int
    ticks: int
    partitions: Tuple[PartitionWindow, ...] = ()
    crashes: Tuple[NodeCrash, ...] = ()
    asym_partitions: Tuple[AsymPartitionWindow, ...] = ()
    skews: Tuple[SkewWindow, ...] = ()
    corruptions: Tuple[CorruptWindow, ...] = ()
    # Snapshot-interleaving knobs (SnapshotChaosRunner): aggressive
    # per-node compaction cadence, retained window, and a fault-free
    # heal window at the end of the run over which survivors must
    # CONVERGE (the post-snapshot convergence invariant).
    compact_every: int = 0
    compact_keep: int = 0
    heal_ticks: int = 0
    prop_rate: float = 0.4

    def digest(self) -> str:
        blob = json.dumps(dataclasses.asdict(self), sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class TcpChaosPlan:
    """Scripted scenario for a RaftNode cluster over the REAL TCP
    transport (transport/tcp.py + its SendFaults seam).  Frames cross
    actual localhost sockets, so arrival interleaving is kernel-
    scheduled: the SCHEDULE is deterministic from the seed, the
    invariants must hold on every run, but the committed history is not
    bit-reproducible (documented in the README fault matrix — this is
    the one plane where a virtual clock does not exist)."""
    seed: int
    ticks: int
    drops: Tuple[DropWindow, ...] = ()
    corruptions: Tuple[CorruptWindow, ...] = ()
    asym_partitions: Tuple[AsymPartitionWindow, ...] = ()
    delays: Tuple[DelayWindow, ...] = ()       # latency in ms units
    heal_ticks: int = 60
    prop_rate: float = 0.5

    def digest(self) -> str:
        blob = json.dumps(dataclasses.asdict(self), sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class MemberEvent:
    """Admin membership op issued at `tick` against every group's
    leader (retried each tick until the leader accepts it):
    op in {add_learner, promote, remove, remove_learner}."""
    tick: int
    op: str
    peer: int


@dataclasses.dataclass(frozen=True)
class NodeBoot:
    """Boot peer slot `peer` (fresh, empty WAL — "a new machine") at
    `tick`; before that the slot is provisioned capacity, down."""
    tick: int
    peer: int


@dataclasses.dataclass(frozen=True)
class MembershipChaosPlan:
    """Scripted membership churn for the lockstep RaftNode cluster:
    node replacement under faults.  `initial_voters` seeds the boot
    config over `peers` provisioned slots; `initial_down` slots start
    unbooted (spare machines)."""
    seed: int
    ticks: int
    peers: int
    initial_voters: Tuple[int, ...]
    initial_down: Tuple[int, ...] = ()
    boots: Tuple[NodeBoot, ...] = ()
    events: Tuple[MemberEvent, ...] = ()
    crashes: Tuple[NodeCrash, ...] = ()
    partitions: Tuple[PartitionWindow, ...] = ()
    drops: Tuple[DropWindow, ...] = ()
    # Base-runner parity (NodeClusterChaosRunner drives this plan too):
    asym_partitions: Tuple[AsymPartitionWindow, ...] = ()
    skews: Tuple[SkewWindow, ...] = ()
    corruptions: Tuple[CorruptWindow, ...] = ()
    heal_ticks: int = 60
    prop_rate: float = 0.5
    # Expected stable config after the script (checked post-heal).
    final_voters: Tuple[int, ...] = ()

    def digest(self) -> str:
        blob = json.dumps(dataclasses.asdict(self), sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class TcpRebindPlan:
    """TCP-plane crash/restart with PORT REBINDING: stop a node (its
    listener closes), restart it `down` ticks later on the SAME port
    and data dir — peers' senders must reconnect and the restarted
    node must catch up.  Same reproducibility posture as TcpChaosPlan
    (deterministic schedule, kernel-scheduled arrivals)."""
    seed: int
    ticks: int
    restarts: Tuple[NodeCrash, ...] = ()
    heal_ticks: int = 80
    prop_rate: float = 0.6

    def digest(self) -> str:
        blob = json.dumps(dataclasses.asdict(self), sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


def generate_corrupt_plan(seed: int, ticks: int = 260,
                          peers: int = 3) -> NodeChaosPlan:
    """Byzantine/corrupted payloads (lockstep wire plane): windows of
    seeded frame corruption — the CRC framing must drop every mangled
    frame (counted), and consensus must ride out the loss."""
    rng = np.random.default_rng(seed ^ 0xC0F)
    warmup = 50
    wins = []
    for i in range(2):
        s = int(rng.integers(warmup + i * ticks // 3,
                             warmup + 20 + i * ticks // 3))
        wins.append(CorruptWindow(s, s + int(rng.integers(30, 50)),
                                  float(rng.uniform(0.15, 0.4))))
    c0 = int(rng.integers(ticks // 2, int(ticks * 0.8)))
    return NodeChaosPlan(seed=seed, ticks=ticks,
                         corruptions=tuple(wins),
                         crashes=(NodeCrash(c0, int(rng.integers(0, peers)),
                                            down=int(rng.integers(25, 40))),))


def generate_snapshot_plan(seed: int, ticks: int = 340,
                           peers: int = 3) -> NodeChaosPlan:
    """Aggressive compaction + InstallSnapshot + crash interleaving
    (lockstep RaftNode plane): every node compacts on a short cadence
    while one follower is crashed long enough to fall below every
    retained floor — its restart must be served by a full state
    transfer, and a second, leader-targeted crash lands while transfers
    are in flight.  After a fault-free heal window the survivors must
    CONVERGE (identical applied state per group)."""
    rng = np.random.default_rng(seed ^ 0x5A7)
    lag_peer = int(rng.integers(0, peers))
    c0 = int(rng.integers(50, 70))
    down = int(rng.integers(150, 190))
    c1 = int(rng.integers(c0 + down + 20, ticks - 40))
    crashes = (NodeCrash(c0, lag_peer, down=down),
               NodeCrash(c1, LEADER_TARGET, down=int(rng.integers(20, 30))))
    return NodeChaosPlan(seed=seed, ticks=ticks, crashes=crashes,
                         compact_every=int(rng.integers(6, 10)),
                         compact_keep=1, heal_ticks=80, prop_rate=0.95)


def generate_tcp_plan(seed: int, ticks: int = 200,
                      peers: int = 3) -> TcpChaosPlan:
    """Chaos under the REAL TCP transport: seeded send-side drops, a
    one-directional (asymmetric) block window, frame corruption, and
    delayed frames — followed by a heal window over which the cluster
    must converge and commit."""
    rng = np.random.default_rng(seed ^ 0x7C9)
    warmup = 40
    s0 = int(rng.integers(warmup, ticks // 3))
    drops = (DropWindow(s0, s0 + int(rng.integers(25, 40)),
                        float(rng.uniform(0.1, 0.25))),)
    s1 = int(rng.integers(ticks // 3, 2 * ticks // 3))
    corr = (CorruptWindow(s1, s1 + int(rng.integers(30, 45)),
                          float(rng.uniform(0.2, 0.4))),)
    src = int(rng.integers(0, peers))
    dst = int((src + 1 + rng.integers(0, peers - 1)) % peers)
    s2 = int(rng.integers(2 * ticks // 3, ticks - 25))
    asym = (AsymPartitionWindow(s2, s2 + int(rng.integers(20, 30)),
                                src, dst),)
    d0 = int(rng.integers(warmup, ticks - 40))
    delays = (DelayWindow(d0, d0 + int(rng.integers(20, 35)),
                          float(rng.uniform(0.1, 0.25)),
                          int(rng.integers(5, 15))),)   # milliseconds
    return TcpChaosPlan(seed=seed, ticks=ticks, drops=drops,
                        corruptions=corr, asym_partitions=asym,
                        delays=delays)


def generate_membership_plan(seed: int, ticks: int = 320,
                             peers: int = 4) -> MembershipChaosPlan:
    """The node-replacement story under faults, seeded: a 3-voter
    cluster over `peers` provisioned slots loses a voter to a
    PERMANENT kill (SIGKILL, never restarted), boots the spare slot as
    a fresh machine, adds it as a learner, promotes it once caught up
    (joint consensus), and removes the dead member — while a drop
    window and a second (transient) crash land mid-churn.  After the
    heal window the cluster must run on the replacement voter set with
    every invariant intact, including RemovedQuorumSafety."""
    rng = np.random.default_rng(seed ^ 0x3E3)
    spare = peers - 1
    dead = int(rng.integers(0, 3))           # the voter that dies
    kill_t = int(rng.integers(50, 70))
    boot_t = kill_t + int(rng.integers(5, 15))
    add_t = boot_t + int(rng.integers(5, 10))
    promote_t = add_t + int(rng.integers(30, 50))
    remove_t = promote_t + int(rng.integers(30, 50))
    # A transient crash of a SURVIVING voter while the learner catches
    # up, and a drop window across the promote.
    surv = [p for p in range(3) if p != dead]
    c1 = int(rng.integers(add_t + 5, promote_t))
    crashes = (NodeCrash(kill_t, dead, down=10 * ticks),   # permanent
               NodeCrash(c1, surv[int(rng.integers(0, 2))],
                         down=int(rng.integers(15, 25))))
    d0 = promote_t - int(rng.integers(5, 15))
    drops = (DropWindow(d0, d0 + int(rng.integers(15, 30)),
                        float(rng.uniform(0.05, 0.15))),)
    final = tuple(sorted(surv + [spare]))
    return MembershipChaosPlan(
        seed=seed, ticks=max(ticks, remove_t + 60), peers=peers,
        initial_voters=(0, 1, 2), initial_down=(spare,),
        boots=(NodeBoot(boot_t, spare),),
        events=(MemberEvent(add_t, "add_learner", spare),
                MemberEvent(promote_t, "promote", spare),
                MemberEvent(remove_t, "remove", dead)),
        crashes=crashes, drops=drops, heal_ticks=80,
        final_voters=final)


def generate_tcp_rebind_plan(seed: int, ticks: int = 180,
                             peers: int = 3) -> TcpRebindPlan:
    """TCP crash/restart with port rebinding (ROADMAP chaos frontier):
    one leader-targeted and one random-follower stop/rebind, spaced so
    the second fires after the first recovered."""
    rng = np.random.default_rng(seed ^ 0x4EB)
    t0 = int(rng.integers(50, 70))
    d0 = int(rng.integers(20, 30))
    t1 = int(rng.integers(t0 + d0 + 20, ticks - 30))
    restarts = (NodeCrash(t0, LEADER_TARGET, down=d0),
                NodeCrash(t1, int(rng.integers(0, peers)),
                          down=int(rng.integers(15, 25))))
    return TcpRebindPlan(seed=seed, ticks=ticks, restarts=restarts)


def generate_node_plan(seed: int, ticks: int = 320,
                       peers: int = 3) -> NodeChaosPlan:
    """Threaded-cluster plan: one leader-targeted kill, one follower
    kill, one partition window — the reference's stop/restart scenarios
    (raftsql_test.go:117-170) as a seeded schedule."""
    rng = np.random.default_rng(seed)
    warmup = 50
    p0 = int(rng.integers(warmup, ticks // 3))
    parts = (PartitionWindow(p0, p0 + int(rng.integers(25, 45)),
                             int(rng.integers(0, peers))),)
    c0 = int(rng.integers(ticks // 3, ticks // 2))
    c1 = int(rng.integers(ticks // 2 + 20, int(ticks * 0.8)))
    crashes = (NodeCrash(c0, LEADER_TARGET, down=int(rng.integers(25, 40))),
               NodeCrash(c1, int(rng.integers(0, peers)),
                         down=int(rng.integers(25, 40))))
    return NodeChaosPlan(seed=seed, ticks=ticks, partitions=parts,
                         crashes=crashes)
