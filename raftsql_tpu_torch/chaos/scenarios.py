"""The fused chaos runners: drive the port's FusedClusterNode through a
seeded `ChaosSchedule`, injecting faults at every seam, checking
invariants every tick.

Port of the fused plane of raftsql_tpu/chaos/scenarios.py:
`FusedChaosRunner` and the three nemesis runners built on it —
`ReadNemesisRunner` (every read mode under skew, partitions and
crashes), `QuorumChaosRunner` (flexible quorums and a witness peer) and
`TransferChaosRunner` (graceful leadership transfers under the same
faults).  Each takes `device` and `commit_rule`.  Fully
deterministic: one thread drives `tick()` manually, fault masks are
numpy draws from the runner's seeded generator (copied to the inbox's
device, never drawn by torch), crashes are simulated in-process, and
the run's result digest is reproducible bit for bit from the seed.  The
node boots from the JAX package's threefry draws (core/threefry.py), so
for the same schedule the digests equal the JAX package's runner's.

Crash simulation ("hard crash"): every open durable fd of the dying
node is redirected to /dev/null before the object is abandoned — a
buffered-but-unflushed byte can then never be resurrected by a later
GC flush into the file the restarted node is appending to.  That IS a
process kill's semantics (userspace buffers lost, flushed page-cache
bytes kept).  A POWER LOSS additionally truncates every file to its
last really-fsynced size, optionally tearing one peer's last record
mid-write (storage/fsio.py records both) — which is exactly the state
WAL._repair_tail and the epoch-repair path exist to recover.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import queue
from typing import Dict, List, Optional, Tuple

import numpy as np

from raftsql_tpu_torch.chaos.invariants import (CommitMonotonic,
                                                DurabilityLedger,
                                                ElectionSafety,
                                                InvariantViolation,
                                                RegisterLinearizability,
                                                check_log_matching)
from raftsql_tpu_torch.chaos.schedule import ChaosSchedule
from raftsql_tpu_torch.config import LEADER, RaftConfig
from raftsql_tpu_torch.core.state import resolve_device
from raftsql_tpu_torch.runtime.db import iter_plain_batches
from raftsql_tpu_torch.runtime.fused import FusedClusterNode
from raftsql_tpu_torch.runtime.node import CLOSED
from raftsql_tpu_torch.storage import fsio
from raftsql_tpu_torch.transport.faults import (asym_partition,
                                                drop_messages,
                                                hold_messages,
                                                partition_peer,
                                                release_messages)


def _redirect_to_devnull(files) -> None:
    """dup2 /dev/null over every open fd so abandoned buffered writers
    can never flush real bytes later."""
    devnull = os.open(os.devnull, os.O_WRONLY)
    try:
        for f in files:
            if f is not None and not f.closed:
                os.dup2(devnull, f.fileno())
    finally:
        os.close(devnull)


def hard_crash_fused(node: FusedClusterNode) -> None:
    """Simulate a process kill of the whole fused cluster process: every
    WAL file handle (and the epoch-commit file) goes to /dev/null, and
    the publish workers are unblocked so the abandoned daemon threads
    exit instead of leaking threads per simulated crash."""
    files = []
    for w in node.wals:
        for s in getattr(w, "shards", (w,)):
            files.append(getattr(s, "_f", None))
    _redirect_to_devnull(files + [node._epoch_f])
    for q in node._pub_qs:
        try:
            q.put_nowait(None)
        except queue.Full:               # pragma: no cover - bounded lag
            pass


def _power_loss(inj: fsio.StorageFaultInjector, data_dir: str,
                tear_peer: int = -1) -> Tuple[int, int]:
    """Apply power-loss semantics to every tracked file under data_dir:
    drop everything after the last real fsync, tearing (keeping a
    partial prefix of) the tear peer's last unsynced record instead of
    dropping it whole.  Returns (files_truncated, records_torn)."""
    torn = dropped = 0
    tear_paths = set()
    if tear_peer >= 0:
        tag = os.sep + f"p{tear_peer + 1}" + os.sep
        for path in inj.tracked_paths():
            if path.startswith(data_dir) and tag in path \
                    and inj.tear_last_write(path):
                torn += 1
                tear_paths.add(path)
    for path in inj.tracked_paths():
        if path.startswith(data_dir) and path not in tear_paths \
                and inj.drop_unsynced(path):
            dropped += 1
    return dropped, torn


def _drain_fused_q(q: "queue.Queue") -> List[Tuple[int, int, List[bytes]]]:
    """Drain a fused commit queue non-blocking into plain
    (group, base_idx, [payload, ...]) batches (sentinels skipped)."""
    batches: List[Tuple[int, int, List[bytes]]] = []
    while True:
        try:
            item = q.get_nowait()
        except queue.Empty:
            return batches
        if item is None:
            continue
        if item is CLOSED:
            return batches
        batches.extend(iter_plain_batches(item))


def schedule_peers(schedule: ChaosSchedule) -> int:
    """Peer count implied by a schedule's targets (min 3)."""
    peers = 3
    for w in schedule.partitions:
        peers = max(peers, w.peer + 1)
    for w in schedule.asym_partitions:
        peers = max(peers, w.src + 1, w.dst + 1)
    for w in schedule.skews:
        peers = max(peers, len(w.incs))
    for ev in schedule.crashes:
        peers = max(peers, ev.tear_peer + 1)
    for f in schedule.fsync_faults:
        peers = max(peers, f.peer + 1)
    for f in schedule.enospc_faults:
        peers = max(peers, f.peer + 1)
    for f in schedule.fsync_stalls:
        peers = max(peers, f.peer + 1)
    return peers


class FusedChaosRunner:
    """Drive a FusedClusterNode through a ChaosSchedule.

    Workload: seeded unique-value PUTs (`SET k<K> v<seq>`) routed by
    key to a group, plus linearizable GETs registered through
    `read_index` and resolved against peer 0's applied state.  Every
    tick: release due delayed messages, apply the tick's fault masks,
    issue workload, dispatch, flush+drain publishes, resolve reads,
    observe invariants.  Crashes (scheduled, or triggered by an
    injected fsync failure) restart the cluster from its WALs and
    verify the durability ledger against the replay.

    `device` is where the node's consensus state steps (CUDA by
    default; raises without a card).  `commit_rule` overrides the
    default config's Phase-7 rule ("pallas" runs the quorum kernels).
    """

    KEYS = 8
    LOG_MATCH_EVERY = 16
    # Which peers' commit queues the engine materializes (peer 0 is the
    # client apply plane).  ReadNemesisRunner sets None (= all): its
    # per-peer read serving state needs every peer's stream.
    PUBLISH_PEERS: Optional[set] = {0}

    def __init__(self, schedule: ChaosSchedule, data_dir: str,
                 cfg: Optional[RaftConfig] = None, steps: int = 1,
                 device="cuda", commit_rule: Optional[str] = None):
        self.sched = schedule
        self.data_dir = data_dir
        self.device = resolve_device(device)
        # Compacting schedules get a small device window so the clamped
        # compaction floor (keep >= log_window) actually advances within
        # a fast run's entry counts.
        self.cfg = cfg or RaftConfig(
            num_groups=4, num_peers=schedule_peers(schedule),
            log_window=16 if schedule.compact_every else 64,
            max_entries_per_msg=4, election_ticks=10,
            heartbeat_ticks=1, tick_interval_s=0.0)
        if commit_rule is not None:
            self.cfg = dataclasses.replace(self.cfg,
                                           commit_rule=commit_rule)
        self.steps = steps
        self.node: Optional[FusedClusterNode] = None
        self.ledger = DurabilityLedger()
        self.lin = RegisterLinearizability()
        self.safety = ElectionSafety(LEADER)
        self.monotonic = CommitMonotonic(self.cfg.num_peers,
                                         self.cfg.num_groups)
        self._kv: Dict[str, str] = {}
        self._applied = np.zeros(self.cfg.num_groups, np.int64)
        self._held: List[Tuple[int, object]] = []
        self._pending_reads: List[Tuple[str, int, int, tuple]] = []
        self._part_peer: Dict[int, int] = {}
        self._asym_src: Dict[int, int] = {}
        self._wseq = 0
        self.final_metrics = None       # NodeMetrics after run()
        self.report: Dict[str, int] = {
            "crashes": 0, "restarts": 0, "partitions": 0,
            "asym_partitions": 0, "skew_ticks": 0,
            "fsync_faults": 0, "torn_write_faults": 0, "torn_writes": 0,
            "enospc_hits": 0, "fsync_stalls": 0, "compactions": 0,
            "unsynced_files_dropped": 0, "dropped_slots": 0,
            "delayed_slots": 0, "log_match_checks": 0,
        }

    # -- lifecycle -----------------------------------------------------

    def _boot(self, first: bool) -> FusedClusterNode:
        node = FusedClusterNode(self.cfg, self.data_dir,
                                seed=self.sched.seed, device=self.device)
        if self.steps > 1:
            node._steps = self.steps
        node.publish_peers = self.PUBLISH_PEERS
        # Flight recorder feed (obs/): device event ring + host spans,
        # dumped next to the seed on invariant failure.  Tracing never
        # touches consensus state, so the run's digests are unchanged.
        node.enable_tracing()
        replayed: Dict[Tuple[int, int], bytes] = {}
        order: List[Tuple[int, int, bytes]] = []
        # Peer 0's stream is the client; the others are drained so
        # their queues do not grow across restarts.
        for p in range(self.cfg.num_peers):
            batches = _drain_fused_q(node.commit_q(p))
            if p == 0:
                for (g, base, datas) in batches:
                    for off, d in enumerate(datas):
                        if d:
                            replayed[(g, base + 1 + off)] = d
                            order.append((g, base + 1 + off, d))
            self._boot_peer_drained(p, batches)
        # Compaction floors: the replay legitimately starts above them
        # (compact() only ever drops published entries — the publish
        # cursor gates the floor).
        floors = np.array([node.plogs[0].start(g)
                           for g in range(self.cfg.num_groups)], np.int64)
        if not first:
            self.ledger.verify_replay(
                replayed, context=f"restart {self.report['restarts']}",
                floors=floors)
            self.report["restarts"] += 1
        # Rebuild the client-visible KV state: the compacted prefix from
        # the durability ledger (the runner's stand-in for the state-
        # machine snapshot real compaction is gated on), then the
        # replayed stream above it (per-group index order; groups are
        # independent key spaces).
        self._kv.clear()
        for g, i, d in sorted(
                (g, i, d) for (g, i), d in self.ledger._committed.items()
                if i <= floors[g]):
            self._apply(g, i, d)
        for g, i, d in sorted(order):
            self._apply(g, i, d)
        self._applied = node._applied[0].copy()
        node.metrics.faults_crashes = self.report["crashes"]
        return node

    def _boot_peer_drained(self, p: int, batches) -> None:
        """Subclass seam: peer p's replay stream was just drained at
        (re)boot — ReadNemesisRunner rebuilds its per-peer read state
        here."""

    def _crash_restart(self, tick: int, power_loss: bool = False,
                       tear_peer: int = -1) -> None:
        hard_crash_fused(self.node)
        self.report["crashes"] += 1
        if power_loss:
            inj = fsio.injector()
            dropped, torn = _power_loss(inj, self.data_dir, tear_peer)
            self.report["unsynced_files_dropped"] += dropped
            self.report["torn_writes"] += torn
        # In-flight state dies with the process: delayed messages and
        # registered-but-unresolved reads (their clients aborted).
        self._held.clear()
        self._pending_reads.clear()
        self.node = self._boot(first=False)

    # -- workload ------------------------------------------------------

    def _apply(self, g: int, idx: int, payload: bytes) -> None:
        self.ledger.record(g, idx, payload)
        parts = payload.decode("utf-8").split(" ")
        if len(parts) == 3 and parts[0] == "SET":
            self._kv[parts[1]] = parts[2]
            self.lin.end_write(parts[2])
        self._applied[g] = max(self._applied[g], idx)

    def _issue(self, rng: np.random.Generator) -> None:
        if rng.random() < self.sched.prop_rate:
            k = int(rng.integers(0, self.KEYS))
            g = k % self.cfg.num_groups
            value = f"v{self._wseq}"
            self._wseq += 1
            self.lin.begin_write(f"k{k}", value)
            self.node.propose_many(g, [f"SET k{k} {value}".encode()])
        if rng.random() < self.sched.read_rate:
            k = int(rng.integers(0, self.KEYS))
            g = k % self.cfg.num_groups
            got = self.node.read_index(g)
            if got:                       # leaderless: client retries later
                target, _ = got
                self._pending_reads.append(
                    (f"k{k}", g, target, self.lin.begin_read(f"k{k}")))

    def _drain_tick(self) -> None:
        """Consume the client (peer 0) commit stream after a tick —
        ReadNemesisRunner overrides to drain every peer into its
        per-peer read state too."""
        for (g, base, datas) in _drain_fused_q(self.node.commit_q(0)):
            for off, d in enumerate(datas):
                if d:
                    self._apply(g, base + 1 + off, d)
        self._applied = np.maximum(self._applied,
                                   self.node._applied[0])

    def _resolve_reads(self) -> None:
        still = []
        for (key, g, target, handle) in self._pending_reads:
            if self._applied[g] >= target:
                self.lin.end_read(handle, self._kv.get(key, ""))
            else:
                still.append((key, g, target, handle))
        self._pending_reads = still

    # -- fault application ---------------------------------------------

    def _apply_faults(self, t: int, rng: np.random.Generator) -> None:
        node = self.node
        due = [h for (rt, h) in self._held if rt <= t]
        self._held = [(rt, h) for (rt, h) in self._held if rt > t]
        for h in due:                    # released mail is subject to
            node.inboxes = release_messages(node.inboxes, h)  # this
        shape = tuple(node.inboxes.v_type.shape)   # tick's masks below
        for w in self.sched.delays:
            if w.start <= t < w.end:
                mask = rng.random(shape) < w.p
                if mask.any():
                    delivered, held = hold_messages(node.inboxes, mask)
                    node.inboxes = delivered
                    self._held.append((t + w.latency, held))
                    self.report["delayed_slots"] += int(mask.sum())
        for w in self.sched.drops:
            if w.start <= t < w.end:
                mask = rng.random(shape) < w.p
                if mask.any():
                    node.inboxes = drop_messages(node.inboxes, mask)
                    self.report["dropped_slots"] += int(mask.sum())
        for wi, w in enumerate(self.sched.partitions):
            if w.start <= t < w.end:
                peer = self._part_peer.get(wi)
                if peer is None:
                    peer = w.peer if w.peer >= 0 \
                        else max(self.node.leader_of(0), 0)
                    self._part_peer[wi] = peer
                    self.report["partitions"] += 1
                node.inboxes = partition_peer(node.inboxes, peer)
        for wi, w in enumerate(self.sched.asym_partitions):
            if w.start <= t < w.end:
                src = self._asym_src.get(wi)
                if src is None:
                    # LEADER_TARGET: the window's one-directional cut is
                    # anchored on whoever leads group 0 at its opening
                    # tick — "dst goes deaf to its leader".
                    src = w.src if w.src >= 0 \
                        else max(self.node.leader_of(0), 0)
                    self._asym_src[wi] = src
                    self.report["asym_partitions"] += 1
                node.inboxes = asym_partition(node.inboxes, src, w.dst)

    def _skew_for(self, t: int) -> Optional[np.ndarray]:
        """Per-peer timer_inc for tick t, None = lockstep.  Later
        windows override earlier ones on overlap."""
        ti = None
        for w in self.sched.skews:
            if w.start <= t < w.end:
                ti = np.asarray(w.incs, np.int32)
        return ti

    # -- invariants ----------------------------------------------------

    def _observe(self, t: int) -> None:
        node = self.node
        roles = node.roles()
        terms = node.states.term.to("cpu", copy=True).numpy()
        self.safety.observe(t, roles, terms)
        commits = node._hard[:, :, 2]
        self.monotonic.observe(t, commits)
        if t % self.LOG_MATCH_EVERY == 0:
            check_log_matching(t, commits, node.plogs)
            self.report["log_match_checks"] += 1

    # -- the run -------------------------------------------------------

    def run(self) -> dict:
        inj = fsio.StorageFaultInjector()
        for f in self.sched.fsync_faults:
            inj.add_rule(os.sep + f"p{f.peer + 1}" + os.sep,
                         fail_at=(f.op,))
        for f in self.sched.torn_writes:
            inj.add_rule(os.sep + f"p{f.peer + 1}" + os.sep,
                         crash_write_at=(f.op,), tag=f.peer)
        for f in self.sched.enospc_faults:
            inj.add_rule(os.sep + f"p{f.peer + 1}" + os.sep,
                         enospc_write_at=(f.op,))
        for f in self.sched.fsync_stalls:
            inj.add_rule(os.sep + f"p{f.peer + 1}" + os.sep,
                         stall_at=tuple(range(f.op, f.op + f.count)),
                         stall_s=f.stall_s)
        crash_at = {ev.tick: ev for ev in self.sched.crashes}
        rng = np.random.default_rng(self.sched.seed + 1)
        with fsio.installed(inj):
            self.node = self._boot(first=True)
            try:
                for t in range(self.sched.ticks):
                    ev = crash_at.get(t)
                    if ev is not None:
                        self._crash_restart(t, ev.power_loss,
                                            ev.tear_peer)
                    self._apply_faults(t, rng)
                    self._issue(rng)
                    ti = self._skew_for(t)
                    if ti is not None:
                        self.report["skew_ticks"] += int(
                            np.abs(ti.astype(np.int64) - 1).sum())
                    self.node.timer_inc = ti
                    try:
                        self.node.tick()
                        # With double-buffered dispatch the tick's
                        # durable phase is stashed; this drain retires
                        # it, so the injected storage faults fire HERE —
                        # same ops, same order, same crash posture as
                        # the serialized pipeline.
                        self.node.publish_flush()
                    except fsio.EnospcError:
                        # Disk full on a WAL append: the tick's durable
                        # barrier cannot complete, so this is fatal
                        # (same posture as a failed fsync) — crash +
                        # restart.  The consumed trigger models the
                        # operator freeing space.
                        self.report["enospc_hits"] += 1
                        self._crash_restart(t, power_loss=False)
                        continue
                    except fsio.FsyncFaultError:
                        # etcd posture: a failed WAL fsync is fatal —
                        # crash the process rather than ack unsynced
                        # data; the restart replays the durable prefix.
                        self.report["fsync_faults"] += 1
                        self._crash_restart(t, power_loss=False)
                        continue
                    except fsio.CrashPointError as e:
                        # Power loss mid-record: tear that record, drop
                        # every unsynced tail, restart.
                        self.report["torn_write_faults"] += 1
                        self._crash_restart(t, power_loss=True,
                                            tear_peer=int(e.tag))
                        continue
                    self._drain_tick()
                    self._resolve_reads()
                    self._observe(t)
                    if self.sched.compact_every and t \
                            and t % self.sched.compact_every == 0 \
                            and self.node.compact(
                                keep=self.sched.compact_keep):
                        self.report["compactions"] += 1
                # Final deep checks + a restart pass so the run always
                # ends with a full durability audit.
                check_log_matching(self.sched.ticks,
                                   self.node._hard[:, :, 2],
                                   self.node.plogs)
                self.report["log_match_checks"] += 1
                self.node.timer_inc = None
                self._crash_restart(self.sched.ticks)
                self.report["fsync_stalls"] = inj.fsync_stalls
                m = self.node.metrics
                m.faults_dropped_msgs = self.report["dropped_slots"]
                m.faults_delayed_msgs = self.report["delayed_slots"]
                m.faults_partitions = self.report["partitions"]
                m.faults_fsync = self.report["fsync_faults"]
                m.faults_enospc = self.report["enospc_hits"]
                m.faults_fsync_stalls = self.report["fsync_stalls"]
                m.faults_skew_ticks = self.report["skew_ticks"]
                # Survives node teardown so tests can assert the
                # exported counters (the /metrics surface).
                self.final_metrics = m
            except InvariantViolation as e:
                # Flight recorder: every invariant failure becomes a
                # post-mortem artifact — the last N ticks of device
                # events plus the host spans, next to the failing seed.
                self._flight_dump(e)
                raise
            finally:
                node, self.node = self.node, None
                if node is not None:
                    node.stop()
        return self._report()

    def _flight_dump(self, err: Exception) -> None:
        from raftsql_tpu_torch.obs.flight import FlightRecorder
        node = self.node
        if node is None:
            return
        FlightRecorder().dump(
            f"fused-seed{self.sched.seed}", repr(err),
            tracer=node.tracer, ring=node.ring, node=node,
            meta={"seed": self.sched.seed,
                  "schedule_digest": self.sched.digest(),
                  "report": dict(self.report)})

    def _report(self) -> dict:
        committed = sorted(
            (g, i, d.decode("utf-8"))
            for (g, i), d in self.ledger._committed.items())
        blob = json.dumps(
            {"committed": committed, "report": self.report,
             "writes": self._wseq, "reads": self.lin.reads_checked},
            sort_keys=True, separators=(",", ":")).encode()
        return {
            "seed": self.sched.seed,
            "ticks": self.sched.ticks,
            "schedule_digest": self.sched.digest(),
            "result_digest": hashlib.sha256(blob).hexdigest()[:16],
            "committed_entries": len(self.ledger),
            "writes_issued": self._wseq,
            "reads_checked": self.lin.reads_checked,
            "safety_observations": self.safety.observations,
            **self.report,
        }


class ReadNemesisRunner(FusedChaosRunner):
    """The read-linearizability nemesis (fused plane): every read mode
    of the lease read plane — lease, ReadIndex, session, follower —
    races the write stream while clock skew, leader-targeted
    partitions, asymmetric cuts, and crashes land.

    Serving model (what a real multi-process deployment would do,
    simulated honestly): every peer's commit stream is drained into a
    PER-PEER KV (`publish_peers = None`), and a read served "at peer
    p" resolves against peer p's applied state — NOT the global truth.
    A partitioned stale leader therefore really can serve an old
    value, and only the lease bound stands between that and a
    linearizability violation:

      * LEASE reads are issued at EVERY peer whose device lease
        (core/step.py Phase 8b) currently covers now + max_clock_skew
        — including a deposed leader that does not know it yet.  Under
        a correctly sized bound (lease_ticks + max_clock_skew <=
        election_ticks / max_skew_rate) the real-time register
        invariant must never fire; the falsification plan
        (schedule.py falsification_plan) oversizes the lease under 4x
        skew and the invariant MUST fire — proving the harness detects
        a broken bound, not just chaos.
      * READINDEX reads ride the base runner's read_index workload.
      * SESSION reads present the watermark of the client's last
        completed write and resolve at a RANDOM peer once its apply
        passes the watermark — checked by SessionConsistency
        (read-your-writes), which unlike the register rule permits
        legally-stale-but-watermark-fresh answers.
      * FOLLOWER reads use the serving peer's own commit index as the
        watermark (the replicated read-index watermark).

    Fully deterministic: same seeded draws as the base runner, digest
    compared across runs by `python -m raftsql_tpu_torch.chaos.run
    --reads`.
    """

    PUBLISH_PEERS: Optional[set] = None       # drain every peer

    def __init__(self, plan, data_dir: str, device="cuda",
                 commit_rule: Optional[str] = None):
        from raftsql_tpu_torch.chaos.invariants import SessionConsistency
        from raftsql_tpu_torch.chaos.schedule import ChaosSchedule as _CS
        sched = _CS(seed=plan.seed, ticks=plan.ticks,
                    partitions=plan.partitions,
                    asym_partitions=plan.asym_partitions,
                    skews=plan.skews, crashes=plan.crashes,
                    prop_rate=plan.prop_rate,
                    read_rate=plan.read_index_rate)
        cfg = RaftConfig(num_groups=plan.groups, num_peers=plan.peers,
                         log_window=64, max_entries_per_msg=4,
                         election_ticks=plan.election_ticks,
                         heartbeat_ticks=1, tick_interval_s=0.0,
                         lease_ticks=plan.lease_ticks,
                         max_clock_skew=plan.max_clock_skew,
                         # Quorum-geometry plans (QuorumNemesisPlan)
                         # carry these; ReadNemesisPlan does not, and
                         # the defaults leave the config on the static
                         # full-voter fast path.
                         write_quorum=getattr(plan, "write_quorum",
                                              None),
                         election_quorum=getattr(plan,
                                                 "election_quorum",
                                                 None),
                         witnesses=getattr(plan, "witnesses",
                                           None) or None,
                         unsafe_quorum_geometry=getattr(
                             plan, "unsafe_geometry", False),
                         unsafe_witness_lease=getattr(
                             plan, "broken_witness_lease", False))
        super().__init__(sched, data_dir, cfg=cfg, device=device,
                         commit_rule=commit_rule)
        self.plan = plan
        P, G = plan.peers, plan.groups
        self._pkv: List[Dict[str, str]] = [dict() for _ in range(P)]
        self._papplied = np.zeros((P, G), np.int64)
        self.session = SessionConsistency()
        # (peer, key, group, target_commit, register handle)
        self._pending_lease: List[tuple] = []
        # (peer, key, group, watermark, mode)
        self._pending_session: List[tuple] = []
        # key -> (group, watermark) of its last COMPLETED write — the
        # session a client would carry (X-Raft-Session).
        self._last_wm: Dict[str, Tuple[int, int]] = {}
        self.report.update({
            "lease_reads": 0, "session_reads": 0, "follower_reads": 0,
            "lease_peers_leased": 0,
        })

    # -- per-peer apply plane -------------------------------------------

    def _note_peer_apply(self, p: int, g: int, idx: int,
                         payload: bytes) -> None:
        parts = payload.decode("utf-8").split(" ")
        if len(parts) == 3 and parts[0] == "SET":
            self._pkv[p][parts[1]] = parts[2]
            # Committed-history feed for the session checker (first
            # peer to surface an index wins; log matching keeps every
            # later copy identical).
            self.session.note_commit(g, idx, parts[1], parts[2])

    def _boot_peer_drained(self, p: int, batches) -> None:
        self._pkv[p] = {}
        for (g, base, datas) in batches:
            for off, d in enumerate(datas):
                if d:
                    self._note_peer_apply(p, g, base + 1 + off, d)

    def _boot(self, first: bool):
        # In-flight per-peer reads die with the process, like the base
        # runner's pending ReadIndex reads.
        self._pending_lease.clear()
        self._pending_session.clear()
        node = super()._boot(first)
        self._papplied = node._applied.copy()
        return node

    def _drain_tick(self) -> None:
        node = self.node
        for p in range(self.cfg.num_peers):
            for (g, base, datas) in _drain_fused_q(node.commit_q(p)):
                for off, d in enumerate(datas):
                    if not d:
                        continue
                    idx = base + 1 + off
                    if p == 0:
                        self._apply(g, idx, d)
                    self._note_peer_apply(p, g, idx, d)
        self._applied = np.maximum(self._applied, node._applied[0])
        self._papplied = np.maximum(self._papplied, node._applied)

    def _apply(self, g: int, idx: int, payload: bytes) -> None:
        super()._apply(g, idx, payload)
        parts = payload.decode("utf-8").split(" ")
        if len(parts) == 3 and parts[0] == "SET":
            # The write just COMPLETED (client apply = ack): its
            # watermark is what a session client would carry forward.
            self._last_wm[parts[1]] = (g, idx)

    # -- workload --------------------------------------------------------

    def _issue(self, rng: np.random.Generator) -> None:
        super()._issue(rng)          # writes + ReadIndex reads
        plan = self.plan
        cfg = self.cfg
        P = cfg.num_peers
        node = self.node
        if rng.random() < plan.lease_read_rate:
            k = int(rng.integers(0, self.KEYS))
            g = k % cfg.num_groups
            key = f"k{k}"
            lc = node._lease_col
            if lc is not None and cfg.lease_ticks > 0:
                now = node._device_steps
                leased = [p for p in range(P)
                          if int(lc[p, g]) > 0
                          and now + cfg.max_clock_skew < int(lc[p, g])]
                self.report["lease_peers_leased"] += len(leased)
                for p in leased:
                    # The lease read a real deployment would serve AT
                    # PEER p: target = p's commit, answer = p's state.
                    target = int(node._hard[p, g, 2])
                    self.report["lease_reads"] += 1
                    self._pending_lease.append(
                        (p, key, g, target,
                         self.lin.begin_read(key, mode="lease")))
        if rng.random() < plan.session_read_rate and self._last_wm:
            keys = sorted(self._last_wm)
            key = keys[int(rng.integers(0, len(keys)))]
            g, wm = self._last_wm[key]
            p = int(rng.integers(0, P))
            self.report["session_reads"] += 1
            self._pending_session.append((p, key, g, wm, "session"))
        if rng.random() < plan.follower_read_rate:
            k = int(rng.integers(0, self.KEYS))
            g = k % cfg.num_groups
            p = int(rng.integers(0, P))
            # Replicated read-index watermark: the serving peer's own
            # commit index at request arrival.
            wm = int(node._hard[p, g, 2])
            self.report["follower_reads"] += 1
            self._pending_session.append((p, f"k{k}", g, wm,
                                          "follower"))

    def _resolve_reads(self) -> None:
        super()._resolve_reads()     # base ReadIndex reads
        still: List[tuple] = []
        for (p, key, g, target, handle) in self._pending_lease:
            if self._papplied[p][g] >= target:
                self.lin.end_read(handle, self._pkv[p].get(key, ""))
            else:
                still.append((p, key, g, target, handle))
        self._pending_lease = still
        still = []
        for (p, key, g, wm, mode) in self._pending_session:
            if self._papplied[p][g] >= wm:
                self.session.check_read(g, key, wm,
                                        self._pkv[p].get(key, ""),
                                        mode=mode)
            else:
                still.append((p, key, g, wm, mode))
        self._pending_session = still

    def _report(self) -> dict:
        r = super()._report()
        r["plan_digest"] = self.plan.digest()
        r["session_reads_checked"] = self.session.reads_checked
        r["reads_by_mode"] = dict(sorted(
            self.lin.reads_by_mode.items()))
        return r


class QuorumChaosRunner(ReadNemesisRunner):
    """The quorum-geometry nemesis (fused plane): flexible
    write/election quorums and witness peers (config.py quorum
    geometry) under the read-nemesis workload and fault families.
    Extends ReadNemesisRunner with three quorum-specific checks:

      * CROSS-PEER commit consistency: every peer's publish stream
        feeds one shared DurabilityLedger keyed (group, index).  Under
        an intersecting geometry (W + E > N) two peers can never
        surface different payloads for one slot — raft's committed-
        entry uniqueness.  The W=1 falsification plan
        (schedule.py falsification_quorum_plan) makes a partitioned
        pinned leader solo-commit acked writes the majority side then
        rewrites; the divergence MUST be caught (this ledger's
        changed-content check, or log matching / commit monotonicity
        if they observe the split first).
      * WITNESS serving audit: a witness's publish stream must stay
        EMPTY (runtime/hostplane.py advances its cursor without
        publishing — it has no apply plane); any payload surfacing
        from a witness is counted in `witness_publishes` and failed by
        the run driver.  The report carries `wal_streams` (every peer
        fsyncs a WAL) vs `apply_streams` (only non-witness peers apply
        — the fsync stream the witness economy saves) and the
        witness's replicated-append count (`witness_appends`, summed
        across crash/restart generations).
      * LEADER PINNING: plans may pin group 0's leadership onto a
        named peer before the fault windows open
        (QuorumNemesisPlan.pin_leader_tick), so directed falsification
        windows can name fixed peer ids.  The stale-lease witness arm
        (schedule.py falsification_witness_plan) relies on it:
        unsafe_witness_lease lets the witness grant a prevote inside
        the deposed leader's live lease, and the resulting stale lease
        read MUST be caught by the register invariant — while the
        honest witness under the SAME schedule must pass.

    Fully deterministic like its bases: digests compared across runs
    by `python -m raftsql_tpu_torch.chaos.run --quorum`.
    """

    def __init__(self, plan, data_dir: str, device="cuda",
                 commit_rule: Optional[str] = None):
        from raftsql_tpu_torch.chaos.invariants import DurabilityLedger
        super().__init__(plan, data_dir, device=device,
                         commit_rule=commit_rule)
        self._witness_set = frozenset(plan.witnesses)
        # Cross-peer commit view: (group, index) -> payload, fed from
        # EVERY peer's stream (the base ledger only sees peer 0's).
        self._xview = DurabilityLedger()
        # witness_appends survives _crash_restart: bank the dying
        # node's counter before each reboot.
        self._wit_banked = 0
        self._pin_done = False
        self.report.update({
            "wal_streams": plan.peers,
            "apply_streams": plan.peers - len(self._witness_set),
            "witness_publishes": 0,
            "pin_transfers": 0,
        })

    def _note_peer_apply(self, p: int, g: int, idx: int,
                         payload: bytes) -> None:
        if p in self._witness_set:
            self.report["witness_publishes"] += 1
        self._xview.record(g, idx, payload)
        super()._note_peer_apply(p, g, idx, payload)

    def _crash_restart(self, tick: int, power_loss: bool = False,
                       tear_peer: int = -1):
        if self.node is not None:
            self._wit_banked += int(self.node.metrics.witness_appends)
        super()._crash_restart(tick, power_loss=power_loss,
                               tear_peer=tear_peer)

    def _apply_faults(self, t: int, rng: np.random.Generator) -> None:
        from raftsql_tpu_torch.runtime.node import TransferRefused
        plan = self.plan
        pt = plan.pin_leader_tick
        if pt >= 0 and pt <= t < pt + 16 and not self._pin_done:
            tgt = plan.pin_leader_peer
            lead = self.node.leader_of(0)
            if lead == tgt:
                self._pin_done = True
            elif lead >= 0:
                try:
                    self.node.transfer_leadership(0, tgt)
                    self.report["pin_transfers"] += 1
                except TransferRefused:
                    pass         # mid-election / in flight: next tick
        super()._apply_faults(t, rng)

    def _report(self) -> dict:
        r = super()._report()
        wit = self._wit_banked
        if self.node is not None:
            wit += int(self.node.metrics.witness_appends)
        r["witness_appends"] = wit
        r["cross_peer_slots"] = len(self._xview)
        return r


class TransferChaosRunner(FusedChaosRunner):
    """The transfer-under-nemesis family (fused plane): graceful
    leadership transfers (runtime/hostplane.py transfer_leadership →
    core/step.py TimeoutNow kernel) race drops, leader-targeted
    partitions, one-directional cuts, clock skew, and crash+restart
    while the acked-PUT workload keeps running — checked by the
    TransferAvailability invariant on top of the standing election-
    safety / durability / linearizability checks:

      * every accepted transfer RESOLVES (completed or aborted) within
        the engine deadline plus a two-election settling margin;
      * a transfer resolving in fault-free air is followed by a probe
        write that must commit within probe_ticks — aborted transfers
        leave the group SERVING, not just unlatched;
      * `must_complete` transfers (falsification_transfer_plan) must
        end `completed`: the deliberately broken kernel
        (cfg.unsafe_transfer — abdicate before the target caught up,
        the §3.10 mistake) hands the election to a peer that cannot
        win it, leadership settles elsewhere, the host records an
        ABORT, and the invariant fires — proving the harness catches
        the broken kernel, not chaos in general.

    Transfer requests are retried each tick while the engine refuses
    them (no leader during a partition, latch already in flight …);
    a request refused for XFER_RETRY_TICKS straight is dropped and
    counted — refusals are load-shedding, not failures.  Fully
    deterministic: same seeded draws as the base runner, digests
    compared across runs by `python -m raftsql_tpu_torch.chaos.run
    --transfers`."""

    XFER_RETRY_TICKS = 60

    def __init__(self, plan, data_dir: str, device="cuda",
                 commit_rule: Optional[str] = None):
        from raftsql_tpu_torch.chaos.invariants import TransferAvailability
        from raftsql_tpu_torch.chaos.schedule import ChaosSchedule as _CS
        sched = _CS(seed=plan.seed, ticks=plan.ticks,
                    drops=plan.drops, partitions=plan.partitions,
                    asym_partitions=plan.asym_partitions,
                    skews=plan.skews, crashes=plan.crashes,
                    prop_rate=plan.prop_rate, read_rate=plan.read_rate)
        cfg = RaftConfig(num_groups=plan.groups, num_peers=plan.peers,
                         log_window=64, max_entries_per_msg=4,
                         election_ticks=plan.election_ticks,
                         heartbeat_ticks=1, tick_interval_s=0.0,
                         unsafe_transfer=plan.unsafe_transfer)
        super().__init__(sched, data_dir, cfg=cfg, device=device,
                         commit_rule=commit_rule)
        self.plan = plan
        self.avail = TransferAvailability(
            election_ticks=plan.election_ticks,
            deadline_ticks=plan.deadline_ticks,
            max_stall_ticks=plan.max_stall_ticks,
            probe_ticks=plan.probe_ticks)
        # Plan events still waiting to be accepted by the engine.
        self._xfer_todo = list(plan.transfers)
        self._seen_events = 0       # consumed prefix of _xfer_events
        self.report.update({
            "transfers_requested": 0, "transfers_completed": 0,
            "transfers_aborted": 0, "transfer_refusals": 0,
            "transfer_drops": 0, "transfer_probes": 0,
            "transfer_probes_confirmed": 0, "max_transfer_stall": 0,
        })

    # -- transfer issuance ----------------------------------------------

    def _resolve_event(self, ev) -> Optional[Tuple[int, int]]:
        """(group, target) for a plan event, or None to retry later.
        target -1 = the leader's successor slot; XFER_LAGGER = the peer
        the first partition window isolated (known once the window has
        opened); group -1 = lowest group led by someone other than the
        resolved target."""
        from raftsql_tpu_torch.chaos.schedule import XFER_LAGGER
        node = self.node
        target = ev.target
        if target == XFER_LAGGER:
            lag = self._part_peer.get(0)
            if lag is None:
                return None          # window not open yet: retry
            target = lag
        group = ev.group
        if group < 0:
            for g in range(self.cfg.num_groups):
                lead = node.leader_of(g)
                if lead >= 0 and lead != target:
                    group = g
                    break
            else:
                return None          # leaderless everywhere: retry
        if target < 0:               # successor slot
            lead = node.leader_of(group)
            if lead < 0:
                return None
            target = (lead + 1) % self.cfg.num_peers
        return group, target

    def _drive_transfers(self, t: int) -> None:
        from raftsql_tpu_torch.runtime.node import TransferRefused
        keep = []
        for ev in self._xfer_todo:
            if ev.tick > t:
                keep.append(ev)
                continue
            if t - ev.tick > self.XFER_RETRY_TICKS:
                self.report["transfer_drops"] += 1
                continue
            resolved = self._resolve_event(ev)
            if resolved is None:
                keep.append(ev)
                continue
            group, target = resolved
            try:
                self.node.transfer_leadership(
                    group, target,
                    deadline_ticks=self.plan.deadline_ticks)
            except TransferRefused:
                self.report["transfer_refusals"] += 1
                keep.append(ev)
                continue
            self.report["transfers_requested"] += 1
            self.avail.note_issued(t, group, ev.must_complete)
        self._xfer_todo = keep

    def _apply_faults(self, t: int, rng: np.random.Generator) -> None:
        super()._apply_faults(t, rng)
        self._drive_transfers(t)

    # -- outcome absorption + serving probes ----------------------------

    def _quiet(self, t0: int, t1: int) -> bool:
        """No scheduled fault overlaps [t0, t1) — a probe armed here
        has clean air to commit in."""
        if t1 >= self.sched.ticks:
            return False
        for w in (self.sched.drops + self.sched.delays
                  + self.sched.partitions + self.sched.asym_partitions
                  + self.sched.skews):
            if w.start < t1 and t0 < w.end:
                return False
        return all(not t0 <= ev.tick < t1 for ev in self.sched.crashes)

    def _apply(self, g: int, idx: int, payload: bytes) -> None:
        super()._apply(g, idx, payload)
        parts = payload.decode("utf-8").split(" ")
        if len(parts) == 3 and parts[0] == "SET":
            self.avail.probe_committed(parts[2])

    def _crash_restart(self, tick: int, power_loss: bool = False,
                       tear_peer: int = -1) -> None:
        # Latches and the outcome log die with the process: outstanding
        # transfers are void, and the new node's event log starts empty.
        self.avail.note_crash()
        self._seen_events = 0
        super()._crash_restart(tick, power_loss, tear_peer)

    def _observe(self, t: int) -> None:
        super()._observe(t)
        events = list(self.node._xfer_events)
        for e in events[self._seen_events:]:
            self.avail.note_outcome(t, e["group"], e["outcome"],
                                    e["stall_ticks"])
            if e["outcome"] == "completed":
                self.report["transfers_completed"] += 1
            else:
                self.report["transfers_aborted"] += 1
            # Post-resolution serving probe: only in clean air — under
            # an active fault window a slow commit is the fault's
            # doing, not the transfer's.
            g = e["group"]
            if self._quiet(t, t + self.plan.probe_ticks + 1):
                value = f"v{self._wseq}"
                self._wseq += 1
                self.lin.begin_write(f"k{g}", value)
                self.node.propose_many(g, [f"SET k{g} {value}".encode()])
                self.avail.arm_probe(t, g, value)
                self.report["transfer_probes"] += 1
        self._seen_events = len(events)
        self.report["max_transfer_stall"] = self.avail.max_stall
        self.report["transfer_probes_confirmed"] = \
            self.avail.probes_confirmed
        self.avail.check(t)
        if t == self.sched.ticks - 1:
            self.avail.final_check(t)

    def _report(self) -> dict:
        r = super()._report()
        r["plan_digest"] = self.plan.digest()
        return r
