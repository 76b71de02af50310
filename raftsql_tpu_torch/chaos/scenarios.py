"""The chaos runners: drive the port's runtimes through seeded
schedules, injecting faults at every seam, checking invariants every
tick.

Port of the fused and node planes of raftsql_tpu/chaos/scenarios.py.
The fused plane: `FusedChaosRunner` and the four nemesis runners built
on it — `ReadNemesisRunner` (every read mode under skew, partitions and
crashes), `QuorumChaosRunner` (flexible quorums and a witness peer),
`TransferChaosRunner` (graceful leadership transfers under the same
faults), `ReshardChaosRunner` (split/merge/migrate verbs of the elastic
keyspace under partitions, drops, crashes, coordinator kills and a
disk fault on the ship path) and `OverloadChaosRunner` (an open-loop
producer at ~2x the drain rate against the bounded admission
controller).  The node plane
(the distributed runtime, runtime/node.py RaftNode): `NodeClusterChaosRunner` (a lockstep cluster over the
loopback transport: crashes, partitions, skew, wire-frame corruption),
`SnapshotChaosRunner` (compaction + InstallSnapshot + crashes, ending in
the convergence invariant), `MembershipChaosRunner` (node replacement
through joint consensus under faults), and the two runners over real
TCP sockets, `TcpClusterChaosRunner` and `TcpRebindChaosRunner`, whose
histories are not bit-reproducible (kernel-scheduled arrival) but whose
invariants must hold.  Each takes `device` and `commit_rule`.  The
fused and lockstep runners are fully
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
import socket
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from raftsql_tpu_torch.chaos.invariants import (CommitMonotonic,
                                                DurabilityLedger,
                                                ElectionSafety,
                                                InvariantViolation,
                                                RegisterLinearizability,
                                                RemovedQuorumSafety,
                                                check_convergence,
                                                check_log_matching)
from raftsql_tpu_torch.chaos.schedule import (LEADER_TARGET, ChaosSchedule,
                                              MembershipChaosPlan,
                                              NodeChaosPlan, TcpChaosPlan,
                                              TcpRebindPlan)
from raftsql_tpu_torch.config import LEADER, RaftConfig
from raftsql_tpu_torch.core.state import resolve_device
from raftsql_tpu_torch.runtime.db import (_expand_commit_item,
                                          iter_plain_batches)
from raftsql_tpu_torch.runtime.fused import FusedClusterNode
from raftsql_tpu_torch.runtime.node import CLOSED, RaftNode
from raftsql_tpu_torch.storage import fsio
from raftsql_tpu_torch.transport.faults import (asym_partition,
                                                drop_messages,
                                                hold_messages,
                                                partition_peer,
                                                release_messages)
from raftsql_tpu_torch.transport.loopback import (LoopbackHub,
                                                  LoopbackTransport)
from raftsql_tpu_torch.transport.tcp import SendFaults, TcpTransport

DEAD_ROLE = -1          # role code for a crashed node's safety-matrix row

# Post-heal settle budget (NodeClusterChaosRunner.run): extra fault-free
# ticks allowed for in-flight apply pipelines to drain before the
# convergence check.  Healthy runs need 1-2 (one batched publish of
# lag); the cap keeps a genuinely diverged peer a loud failure.
SETTLE_TICKS_MAX = 40


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


def hard_crash_node(node: RaftNode) -> None:
    """Simulate a process kill of one RaftNode: WAL fd neutered, then
    detached from the loopback hub (its 'NIC' goes dark)."""
    _redirect_to_devnull([getattr(node.wal, "_f", None)])
    node.transport.stop()


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

    def _make_node(self) -> FusedClusterNode:
        """Construct the engine under test on the runner's device;
        OverloadChaosRunner overrides this to attach the admission
        controller the way the server does."""
        return FusedClusterNode(self.cfg, self.data_dir,
                                seed=self.sched.seed, device=self.device)

    def _boot(self, first: bool) -> FusedClusterNode:
        node = self._make_node()
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


class MeshChaosRunner(FusedChaosRunner):
    """FusedChaosRunner over the MESH runtime (runtime/mesh.py): the
    same seeded schedules, workload, invariants and durability audit,
    with the device step sharded over a groups-only mesh of shard slots
    and the host plane's WALs split per group shard.  Chaos SkewWindow
    schedules drive the sharded step's per-peer timer vector, and
    crash/restart replays from the per-shard WAL dirs.

    Deterministic like the fused runner: sharding is an execution
    detail, never a semantics change (tests/test_torch_parallel.py), so
    schedule and result digests reproduce across runs and EQUAL the
    fused runner's for the same schedule.  The mesh takes the widest
    group-shard count that divides the groups and fits the shard slots
    (RAFTSQL_SHARD_SLOTS, the JAX package's forced host devices), and
    refuses fewer than two group shards."""

    def __init__(self, schedule: ChaosSchedule, data_dir: str,
                 cfg: Optional[RaftConfig] = None, steps: int = 1,
                 device="cuda", commit_rule: Optional[str] = None):
        super().__init__(schedule, data_dir, cfg=cfg, steps=steps,
                         device=device, commit_rule=commit_rule)
        from raftsql_tpu_torch.parallel.sharded import (SHARD_SLOTS_ENV,
                                                        shard_slots)
        from raftsql_tpu_torch.runtime.mesh import MeshConfig
        self.mesh_config = MeshConfig.for_groups(self.cfg,
                                                 device=self.device)
        if self.mesh_config.group_shards < 2:
            raise RuntimeError(
                f"mesh chaos needs >= 2 group shards, have "
                f"{len(shard_slots(self.device))} shard slots for "
                f"{self.cfg.num_groups} groups — count each device as "
                f"several with {SHARD_SLOTS_ENV}=8")
        self.mesh = self.mesh_config.build(device=self.device)

    def _make_node(self):
        from raftsql_tpu_torch.runtime.mesh import MeshClusterNode
        return MeshClusterNode(self.cfg, self.data_dir, self.mesh,
                               seed=self.sched.seed)


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


# ---------------------------------------------------------------------------
# The node plane: lockstep and TCP clusters of the distributed runtime.

def _with_rule(cfg: RaftConfig, commit_rule: Optional[str]) -> RaftConfig:
    return cfg if commit_rule is None \
        else dataclasses.replace(cfg, commit_rule=commit_rule)


class NodeClusterChaosRunner:
    """Lockstep RaftNode cluster under a NodeChaosPlan.

    P RaftNodes over the loopback transport, ticked manually in id
    order (deterministic consensus schedule; envelope ids randomize WAL
    bytes but not the schedule).  Faults: FaultPlan partitions,
    per-node hard crash + restart-from-WAL, leader-targeted kills.
    Invariants: election safety, per-node commit-stream durability
    across restart, and cross-node log matching of live-published
    (committed) entries.

    `device` is where every node's consensus state steps (CUDA by
    default; raises without a card); `commit_rule` overrides the
    config's Phase-7 rule ("pallas" runs the quorum kernels).
    """

    def __init__(self, plan: NodeChaosPlan, tmpdir: str,
                 cfg: Optional[RaftConfig] = None, peers: int = 3,
                 device="cuda", commit_rule: Optional[str] = None):
        self.plan = plan
        self.tmpdir = tmpdir
        self.P = peers
        self.device = resolve_device(device)
        self.cfg = _with_rule(cfg or RaftConfig(
            num_groups=2, num_peers=peers, log_window=64,
            max_entries_per_msg=4, election_ticks=10, heartbeat_ticks=1,
            tick_interval_s=0.0), commit_rule)
        self.hub = LoopbackHub()
        self.nodes: List[Optional[RaftNode]] = [None] * peers
        self.safety = ElectionSafety(LEADER)
        self.monotonic = CommitMonotonic(peers, self.cfg.num_groups)
        # Live-published (committed) history, shared: (g, idx) -> sql.
        self._hist: Dict[Tuple[int, int], str] = {}
        # Per node: everything IT has published live (must survive its
        # own restarts).
        self._published: List[Dict[Tuple[int, int], str]] = [
            {} for _ in range(peers)]
        self.report = {"crashes": 0, "restarts": 0, "partitions": 0,
                       "asym_partitions": 0, "skew_ticks": 0,
                       "corrupt_frames": 0, "commits": 0}
        self._asym_src: Dict[int, int] = {}
        # Peer slots that start UNBOOTED (provisioned spare capacity,
        # membership plans): slot -> first boot tick.  The restart path
        # then boots them fresh — "a new machine joins".
        self._initial_down: Dict[int, int] = {}
        self._t = 0
        # Wire-corruption seam: mangle encoded frames during the plan's
        # corruption windows; the CRC framing must catch every mangled
        # frame (hub.on_corrupt charges the receiving node's metrics).
        # The rng draws per route call, which is deterministic here —
        # the lockstep tick order serializes every send.
        if plan.corruptions:
            rng_c = np.random.default_rng(plan.seed + 3)

            def _mangle(src: int, dst: int, blob: bytes) -> bytes:
                for w in self.plan.corruptions:
                    if w.start <= self._t < w.end \
                            and rng_c.random() < w.p:
                        i = int(rng_c.integers(0, len(blob)))
                        return blob[:i] + bytes([blob[i] ^ 0x5A]) \
                            + blob[i + 1:]
                return blob

            self.hub.mangler = _mangle
            self.hub.on_corrupt = self._note_corrupt

    def _note_corrupt(self, src: int, dst: int) -> None:
        self.report["corrupt_frames"] += 1
        n = self.nodes[dst - 1]
        if n is not None:
            n.metrics.faults_corrupt_frames += 1

    # Subclass hooks (SnapshotChaosRunner): replay observation, per-tick
    # work (compaction cadence), commit application, final invariants.
    def _on_replay(self, p: int,
                   replayed: Dict[Tuple[int, int], str],
                   node: RaftNode) -> None:
        pass

    def _apply_commit(self, p: int, g: int, idx: int, sql: str) -> None:
        pass

    def _pre_tick(self, t: int, healing: bool,
                  rng: np.random.Generator) -> None:
        pass

    def _post_tick(self, t: int, healing: bool) -> None:
        pass

    def _settled(self) -> bool:
        """Post-heal quiescence probe for the bounded settle loop (see
        run()): True once in-flight apply pipelines have drained.  The
        base runner has no apply plane to wait on."""
        return True

    def _final_check(self) -> None:
        pass

    def _data_dir(self, p: int) -> str:
        return os.path.join(self.tmpdir, f"chaos-node-{p + 1}")

    def _boot(self, p: int) -> RaftNode:
        n = RaftNode(p + 1, self.P, self.cfg,
                     LoopbackTransport(self.hub), self._data_dir(p),
                     device=self.device)
        n.enable_tracing()          # flight-recorder feed (host spans)
        n.start(threaded=False)
        # Replay drain: every WAL entry then the nil sentinel
        # (raft.go:122-134).  Verify durability of everything this node
        # ever acked; do NOT fold replay into the shared history —
        # replay includes uncommitted entries that may legally be
        # conflict-truncated later.
        replayed: Dict[Tuple[int, int], str] = {}
        while True:
            try:
                item = n.commit_q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                break
            if item is CLOSED:
                break
            for (g, idx, sql) in _expand_commit_item(item, n):
                replayed[(g, idx)] = sql
        for (g, idx), sql in self._published[p].items():
            if idx <= n.payload_log.start(g):
                # Compacted away before the crash: the entry lives on in
                # the state-machine snapshot the compaction was gated on
                # (the SnapshotChaosRunner's SM carries it; replay
                # legitimately starts above the floor).
                continue
            got = replayed.get((g, idx))
            if got != sql:
                raise InvariantViolation(
                    f"node {p}: committed entry g{g} i{idx} "
                    f"{'lost' if got is None else 'changed'} across "
                    f"restart")
        self._on_replay(p, replayed, n)
        return n

    def _resolve(self, peer: int) -> int:
        if peer != LEADER_TARGET:
            return peer
        for n in self.nodes:
            if n is not None and n.leader_of(0) >= 0:
                return int(n.leader_of(0))
        return 0

    def _drain_live(self) -> None:
        for p, n in enumerate(self.nodes):
            if n is None:
                continue
            while True:
                try:
                    item = n.commit_q.get_nowait()
                except queue.Empty:
                    break
                if item is None or item is CLOSED:
                    continue
                for (g, idx, sql) in _expand_commit_item(item, n):
                    prev = self._hist.setdefault((g, idx), sql)
                    if prev != sql:
                        raise InvariantViolation(
                            f"log matching: node {p} committed g{g} "
                            f"i{idx} {sql!r} but {prev!r} was committed")
                    self._published[p][(g, idx)] = sql
                    self._apply_commit(p, g, idx, sql)
                    self.report["commits"] += 1

    def _observe(self, t: int) -> None:
        G = self.cfg.num_groups
        roles = np.full((self.P, G), DEAD_ROLE, np.int64)
        terms = np.zeros((self.P, G), np.int64)
        commits = np.zeros((self.P, G), np.int64)
        for p, n in enumerate(self.nodes):
            if n is None:
                continue
            roles[p] = n._last_role
            terms[p] = n._hard_np[:, 0]
            commits[p] = n._hard_np[:, 2]
        self.safety.observe(t, roles, terms)
        # Dead rows read 0 — mask them to each node's running floor so
        # a down node never looks like a regression.
        commits = np.maximum(commits, self.monotonic._hi * (roles < 0))
        self.monotonic.observe(t, commits)

    def run(self) -> dict:
        inj = fsio.StorageFaultInjector()   # no rules: forces the
        rng = np.random.default_rng(self.plan.seed + 1)  # python WAL
        crash_at: Dict[int, list] = {}
        for c in self.plan.crashes:
            crash_at.setdefault(c.tick, []).append(c)
        down_until: Dict[int, int] = {}
        total = self.plan.ticks + self.plan.heal_ticks
        with fsio.installed(inj):
            for p in range(self.P):
                if p not in self._initial_down:
                    self.nodes[p] = self._boot(p)
            try:
                for t in range(total):
                    self._t = t
                    # The heal window: no new faults, no new load —
                    # in-flight recovery (restarts, transfers) finishes
                    # and the survivors must converge (_final_check).
                    healing = t >= self.plan.ticks
                    for c in crash_at.get(t, ()):
                        p = self._resolve(c.peer)
                        if self.nodes[p] is None:
                            continue
                        hard_crash_node(self.nodes[p])
                        self.nodes[p] = None
                        down_until[p] = t + c.down
                        self.report["crashes"] += 1
                    for p in [p for p, d in down_until.items()
                              if d <= t]:
                        del down_until[p]
                        self.nodes[p] = self._boot(p)
                        self.report["restarts"] += 1
                    for p in [p for p, bt in self._initial_down.items()
                              if bt <= t]:
                        # Provisioned spare slot comes online: a FRESH
                        # machine (empty WAL) joining the cluster.
                        del self._initial_down[p]
                        self.nodes[p] = self._boot(p)
                        self.report["boots"] = \
                            self.report.get("boots", 0) + 1
                    self.hub.faults.heal()
                    incs: Optional[Tuple[int, ...]] = None
                    if not healing:
                        for w in self.plan.partitions:
                            if w.start <= t < w.end:
                                if t == w.start:
                                    self.report["partitions"] += 1
                                self.hub.faults.isolate(
                                    w.peer + 1, range(1, self.P + 1))
                        for wi, w in enumerate(self.plan.asym_partitions):
                            if w.start <= t < w.end:
                                src = self._asym_src.get(wi)
                                if src is None:
                                    src = self._resolve(w.src)
                                    self._asym_src[wi] = src
                                    self.report["asym_partitions"] += 1
                                self.hub.faults.block(src + 1, w.dst + 1)
                        for w in self.plan.skews:
                            if w.start <= t < w.end:
                                incs = w.incs
                    # Subclass seam (membership runner: seeded per-link
                    # drops, scripted admin churn).  Draw order is fixed,
                    # so determinism survives the hook.
                    self._pre_tick(t, healing, rng)
                    if not healing:
                        if rng.random() < self.plan.prop_rate:
                            alive = [p for p, n in enumerate(self.nodes)
                                     if n is not None]
                            src = alive[int(rng.integers(0, len(alive)))]
                            g = int(rng.integers(0, self.cfg.num_groups))
                            self.nodes[src].propose(
                                g, f"SET k{g} v{t}".encode())
                    for p, n in enumerate(self.nodes):
                        if n is None:
                            continue
                        inc = 1 if incs is None else int(incs[p])
                        if inc != 1:
                            self.report["skew_ticks"] += abs(inc - 1)
                            n.metrics.faults_skew_ticks += abs(inc - 1)
                        n.tick(timer_inc=inc)
                    self._drain_live()
                    self._observe(t)
                    self._post_tick(t, healing)
                # Bounded settle: the heal window can end on the very
                # tick the leader commits its last entry, leaving the
                # followers' applied indexes a publish batch behind
                # (the PR-12 batched commit stream delivers on the NEXT
                # tick).  Tick fault-free until the subclass reports
                # quiescence — deterministic (no load, no rng draws)
                # and bounded, so a peer that never catches up still
                # fails `_final_check` loudly instead of hanging.
                settle = 0
                while settle < SETTLE_TICKS_MAX and not self._settled():
                    self.hub.faults.heal()
                    for n in self.nodes:
                        if n is not None:
                            n.tick()
                    self._drain_live()
                    self._observe(total + settle)
                    settle += 1
                self.report["settle_ticks"] = settle
                self._final_check()
            except InvariantViolation as e:
                self._flight_dump(e)
                raise
            finally:
                for n in self.nodes:
                    if n is not None:
                        n.stop()
        return {"plan_digest": self.plan.digest(),
                "result_digest": self._result_digest(), **self.report}

    def _flight_dump(self, err: Exception) -> None:
        """Host-plane flight dump (this plane has no device ring): the
        first live node's spans, next to the failing seed."""
        from raftsql_tpu_torch.obs.flight import FlightRecorder
        tracer = next((n.tracer for n in self.nodes if n is not None),
                      None)
        FlightRecorder().dump(
            f"node-seed{self.plan.seed}", repr(err), tracer=tracer,
            meta={"seed": self.plan.seed,
                  "plan_digest": self.plan.digest(),
                  "report": dict(self.report)})

    def _result_digest(self) -> str:
        """Digest of the run's committed (unwrapped) history + fault
        counts: identical across two runs of one plan — envelope ids
        randomize WAL bytes but never the lockstep schedule or the
        decoded commit stream."""
        hist = sorted((g, i, s) for (g, i), s in self._hist.items())
        blob = json.dumps({"hist": hist, "report": self.report},
                          sort_keys=True, separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


class SnapshotChaosRunner(NodeClusterChaosRunner):
    """Aggressive compaction + InstallSnapshot + crash interleavings.

    Each node carries a tiny per-group KV state machine applied from
    its commit stream (this runner IS the apply plane), exposed through
    the node's snapshot provider/installer hooks as a JSON blob, and
    compacts its own log on the plan's cadence gated on its own applied
    index — the RaftDB calling convention (runtime/db.py).  The plan
    crashes one follower long enough that every retained log floor
    passes it by: its restart can only be served by a full state
    transfer, while a second (leader-targeted) crash lands after the
    transfer window.  After the fault-free heal window the survivors
    must CONVERGE — same applied index, identical state, the installed
    peer included (chaos/invariants.py check_convergence); this is the
    check log matching cannot give once the log below a floor is gone.
    """

    def __init__(self, plan: NodeChaosPlan, tmpdir: str, peers: int = 3,
                 device="cuda", commit_rule: Optional[str] = None):
        cfg = RaftConfig(num_groups=2, num_peers=peers, log_window=16,
                         max_entries_per_msg=4, election_ticks=10,
                         heartbeat_ticks=1, tick_interval_s=0.0)
        super().__init__(plan, tmpdir, cfg=cfg, peers=peers,
                         device=device, commit_rule=commit_rule)
        G = self.cfg.num_groups
        self._sm: List[List[Dict[str, str]]] = [
            [dict() for _ in range(G)] for _ in range(peers)]
        self._sm_applied = np.zeros((peers, G), np.int64)
        self.report.update({"snapshots_installed": 0,
                            "snapshots_sent": 0, "compactions": 0})

    def _boot(self, p: int) -> RaftNode:
        n = super()._boot(p)
        n.snapshot_provider = lambda g, p=p: self._provide(p, g)
        n.snapshot_installer = \
            lambda g, idx, blob, p=p: self._install(p, g, idx, blob)
        return n

    def _on_replay(self, p: int, replayed, node: RaftNode) -> None:
        # The crash took the SM with it (these dicts ARE the apply
        # plane): rebuild from the replay stream, exactly as RaftDB's
        # delete-and-replay does (reference db.go:27-29).
        G = self.cfg.num_groups
        self._sm[p] = [dict() for _ in range(G)]
        self._sm_applied[p] = 0
        for (g, idx) in sorted(replayed):
            self._apply_sm(p, g, idx, replayed[(g, idx)])

    def _apply_commit(self, p: int, g: int, idx: int, sql: str) -> None:
        self._apply_sm(p, g, idx, sql)

    def _apply_sm(self, p: int, g: int, idx: int, sql: str) -> None:
        parts = sql.split(" ")
        if len(parts) == 3 and parts[0] == "SET":
            self._sm[p][g][parts[1]] = parts[2]
        if idx > self._sm_applied[p, g]:
            self._sm_applied[p, g] = idx

    def _provide(self, p: int, g: int):
        blob = json.dumps(sorted(self._sm[p][g].items())).encode()
        return int(self._sm_applied[p, g]), blob

    def _install(self, p: int, g: int, idx: int, blob: bytes) -> None:
        self._sm[p][g] = dict(json.loads(blob.decode()))
        self._sm_applied[p, g] = idx
        self.report["snapshots_installed"] += 1

    def _post_tick(self, t: int, healing: bool) -> None:
        ce = self.plan.compact_every
        if not ce or not t or t % ce:
            return
        for p, n in enumerate(self.nodes):
            if n is None:
                continue
            applied = {g: int(self._sm_applied[p, g])
                       for g in range(self.cfg.num_groups)}
            if n.compact(applied, keep=self.plan.compact_keep):
                self.report["compactions"] += 1

    def _settled(self) -> bool:
        """Quiesced once every group's survivors agree on the applied
        index — the state-identity half of convergence is then
        `_final_check`'s to judge (a snapshot that installed WRONG
        state converges in index and still fails there)."""
        for g in range(self.cfg.num_groups):
            tops = {int(self._sm_applied[p, g])
                    for p, n in enumerate(self.nodes) if n is not None}
            if len(tops) > 1:
                return False
        return True

    def _final_check(self) -> None:
        self.report["snapshots_sent"] = sum(
            n.metrics.snapshots_sent for n in self.nodes
            if n is not None)
        for g in range(self.cfg.num_groups):
            survivors = [(p, int(self._sm_applied[p, g]), self._sm[p][g])
                         for p, n in enumerate(self.nodes)
                         if n is not None]
            check_convergence(g, survivors, context="post-heal")


def _free_ports(n: int) -> List[int]:
    """n OS-assigned localhost ports (bind-and-release; the runs bind
    them back immediately, and a collision fails loudly on bind)."""
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


class TcpClusterChaosRunner:
    """Chaos under the REAL TCP transport (transport/tcp.py).

    P RaftNodes ticked manually, but their frames cross actual
    localhost sockets through each transport's SendFaults seam: seeded
    send-side drops, ONE-directional blocks (asymmetric partition),
    frame corruption (the receiver's CRC framing must drop + count
    every mangled frame and keep its recv loop alive), and delayed
    frames (out-of-order arrival).  Kernel scheduling orders delivery,
    so this plane is NOT bit-reproducible — the schedule is
    deterministic from the seed and the invariants (election safety,
    commit monotonicity, cross-node log matching of the published
    streams) must hold on every run, which is exactly the guarantee a
    real deployment gets.  After the heal window the cluster must have
    made real progress (commits floor asserted by callers).
    """

    def __init__(self, plan: TcpChaosPlan, tmpdir: str, peers: int = 3,
                 device="cuda", commit_rule: Optional[str] = None):
        self.plan = plan
        self.tmpdir = tmpdir
        self.P = peers
        self.device = resolve_device(device)
        self.cfg = _with_rule(RaftConfig(
            num_groups=2, num_peers=peers, log_window=64,
            max_entries_per_msg=4, election_ticks=10, heartbeat_ticks=1,
            tick_interval_s=0.0), commit_rule)
        self.nodes: List[Optional[RaftNode]] = [None] * peers
        self.safety = ElectionSafety(LEADER)
        self.monotonic = CommitMonotonic(peers, self.cfg.num_groups)
        self._hist: Dict[Tuple[int, int], str] = {}
        self.report = {"commits": 0, "sent_dropped": 0,
                       "sent_corrupted": 0, "sent_delayed": 0,
                       "corrupt_frames_dropped": 0, "asym_partitions": 0}

    def _drain_live(self) -> None:
        for p, n in enumerate(self.nodes):
            if n is None:
                continue
            while True:
                try:
                    item = n.commit_q.get_nowait()
                except queue.Empty:
                    break
                if item is None or item is CLOSED:
                    continue
                for (g, idx, sql) in _expand_commit_item(item, n):
                    prev = self._hist.setdefault((g, idx), sql)
                    if prev != sql:
                        raise InvariantViolation(
                            f"log matching: node {p} committed g{g} "
                            f"i{idx} {sql!r} but {prev!r} was committed")
                    self.report["commits"] += 1

    def _observe(self, t: int) -> None:
        G = self.cfg.num_groups
        roles = np.full((self.P, G), DEAD_ROLE, np.int64)
        terms = np.zeros((self.P, G), np.int64)
        commits = np.zeros((self.P, G), np.int64)
        for p, n in enumerate(self.nodes):
            if n is None:
                continue
            roles[p] = n._last_role
            terms[p] = n._hard_np[:, 0]
            commits[p] = n._hard_np[:, 2]
        self.safety.observe(t, roles, terms)
        commits = np.maximum(commits, self.monotonic._hi * (roles < 0))
        self.monotonic.observe(t, commits)

    def run(self) -> dict:
        ports = _free_ports(self.P)
        urls = [f"127.0.0.1:{port}" for port in ports]
        faults = [SendFaults(self.plan.seed * 131 + p)
                  for p in range(self.P)]
        rng = np.random.default_rng(self.plan.seed + 1)
        try:
            for p in range(self.P):
                tr = TcpTransport(urls, p)
                tr.faults = faults[p]
                n = RaftNode(p + 1, self.P, self.cfg, tr,
                             os.path.join(self.tmpdir,
                                          f"tcp-node-{p + 1}"),
                             device=self.device)
                n.start(threaded=False)
                self.nodes[p] = n
            total = self.plan.ticks + self.plan.heal_ticks
            for t in range(total):
                healing = t >= self.plan.ticks
                for p, f in enumerate(faults):
                    f.heal()
                    drop = corrupt = delay = dsec = 0.0
                    if not healing:
                        for w in self.plan.drops:
                            if w.start <= t < w.end:
                                drop = w.p
                        for w in self.plan.corruptions:
                            if w.start <= t < w.end:
                                corrupt = w.p
                        for w in self.plan.delays:
                            if w.start <= t < w.end:
                                delay = w.p
                                dsec = w.latency / 1000.0
                        for w in self.plan.asym_partitions:
                            if w.start <= t < w.end and p == w.src:
                                f.block(w.dst + 1)
                                if t == w.start:
                                    self.report["asym_partitions"] += 1
                    f.set_rates(drop, corrupt, delay, dsec)
                if not healing and rng.random() < self.plan.prop_rate:
                    g = int(rng.integers(0, self.cfg.num_groups))
                    src = int(rng.integers(0, self.P))
                    self.nodes[src].propose(g, f"SET k{g} v{t}".encode())
                for n in self.nodes:
                    n.tick()
                # Let frames cross the sockets before the next tick:
                # the recv threads stage asynchronously.
                time.sleep(0.002)
                self._drain_live()
                self._observe(t)
        finally:
            for n in self.nodes:
                if n is not None:
                    n.stop()
        self.report["sent_dropped"] = sum(f.dropped for f in faults)
        self.report["sent_corrupted"] = sum(f.corrupted for f in faults)
        self.report["sent_delayed"] = sum(f.delayed for f in faults)
        self.report["corrupt_frames_dropped"] = sum(
            n.metrics.faults_corrupt_frames for n in self.nodes
            if n is not None)
        return {"plan_digest": self.plan.digest(), **self.report}


class MembershipChaosRunner(NodeClusterChaosRunner):
    """Dynamic-membership churn under faults (raftsql_tpu_torch/membership/).

    The node-replacement story, scripted by a MembershipChaosPlan: a
    cluster booted on `initial_voters` over P provisioned slots loses a
    voter to a permanent SIGKILL, boots a spare slot as a FRESH machine
    (empty WAL), adds it as a learner, promotes it through joint
    consensus once caught up, and removes the dead member — while
    drops, partitions, and transient crashes land mid-churn.  Admin ops
    are issued against the group's current leader and retried every
    tick until the applied configuration reflects them (exactly an
    operator's retry loop, including aborting a change whose entry was
    lost with its leader).

    On top of the base invariants (single leader per term, per-node
    durability across restart, log matching, commit monotonicity) every
    tick observes RemovedQuorumSafety — no quorum from a removed
    majority — and the final check asserts every live node converged on
    `plan.final_voters` with zero learners AND that the cluster still
    commits on the post-churn configuration.  Fully deterministic
    (lockstep ticks, seeded draws): two runs of one plan must produce
    identical result digests.
    """

    # Abort-and-reissue horizon for an admin op whose conf entry was
    # lost (leader died holding the one-in-flight latch, proposal
    # dropped): an operator timeout, in ticks.
    RETRY_TICKS = 60

    def __init__(self, plan: MembershipChaosPlan, tmpdir: str,
                 device="cuda", commit_rule: Optional[str] = None):
        cfg = RaftConfig(
            num_groups=2, num_peers=plan.peers, log_window=64,
            max_entries_per_msg=4, election_ticks=10, heartbeat_ticks=1,
            tick_interval_s=0.0, initial_voters=plan.initial_voters)
        super().__init__(plan, tmpdir, cfg=cfg, peers=plan.peers,
                         device=device, commit_rule=commit_rule)
        for b in plan.boots:
            self._initial_down[b.peer] = b.tick
        self.removed_safety = RemovedQuorumSafety(LEADER)
        self._events = sorted(plan.events, key=lambda e: e.tick)
        G = self.cfg.num_groups
        self._ev_done = [0] * G          # per-group next-event cursor
        # g -> (node the pending op was issued at, issue tick).
        self._issued: Dict[int, Tuple[int, int]] = {}
        # report["commits"] at the moment every group settled on the
        # final config — progress after this point proves the new
        # voter set actually commits.
        self._settle_commits: Optional[int] = None
        self.report.update({"boots": 0, "member_ops_applied": 0,
                            "member_op_retries": 0,
                            "member_op_aborts": 0})

    # -- scripted admin churn ------------------------------------------

    def _op_complete(self, g: int, op: str, peer: int) -> bool:
        """The applied config of some live node reflects the op and the
        group left its joint state (replication spreads it from there;
        the next op validates against the leader's view anyway)."""
        for n in self.nodes:
            if n is None or n.membership is None:
                continue
            c = n.membership.config(g)
            if c.is_joint:
                continue
            bit = 1 << peer
            if op == "add_learner" and c.learners & bit:
                return True
            if op == "promote" and c.voters & bit \
                    and not c.learners & bit:
                return True
            if op == "remove" and c.index > 0 \
                    and not (c.voters | c.joint) & bit:
                return True
            if op == "remove_learner" and c.index > 0 \
                    and not c.learners & bit:
                return True
        return False

    def _leader_node(self, g: int) -> Optional[int]:
        for p, n in enumerate(self.nodes):
            if n is not None and n._last_role[g] == LEADER:
                return p
        return None

    def _drive_events(self, t: int) -> None:
        from raftsql_tpu_torch.membership import MembershipError
        for g in range(self.cfg.num_groups):
            i = self._ev_done[g]
            if i >= len(self._events):
                continue
            ev = self._events[i]
            if t < ev.tick:
                continue
            if self._op_complete(g, ev.op, ev.peer):
                self._ev_done[g] += 1
                self._issued.pop(g, None)
                self.report["member_ops_applied"] += 1
                continue
            lead = self._leader_node(g)
            if lead is None:
                continue
            try:
                self.nodes[lead].member_change(g, ev.op, ev.peer)
                self._issued[g] = (lead, t)
            except MembershipError:
                # Not caught up yet / change in flight / transient
                # joint state: the operator retry loop.  If the latch
                # holder sat on an in-flight change past the horizon
                # (its conf entry died with a deposed leader), abort it
                # there and reissue fresh.
                self.report["member_op_retries"] += 1
                src_t = self._issued.get(g)
                if src_t is not None \
                        and t - src_t[1] > self.RETRY_TICKS:
                    src = self.nodes[src_t[0]]
                    if src is not None and src.membership is not None:
                        src.membership.abort_pending(g)
                        self.report["member_op_aborts"] += 1
                    self._issued[g] = (src_t[0], t)

    def _pre_tick(self, t: int, healing: bool,
                  rng: np.random.Generator) -> None:
        if not healing:
            # Per-link drop windows: the loopback hub has no rate seam,
            # so each active window blocks a seeded subset of directed
            # links for THIS tick (heal() lifts them next tick).  Draw
            # count per tick is fixed — determinism holds.
            for w in self.plan.drops:
                if w.start <= t < w.end:
                    for s in range(self.P):
                        for d in range(self.P):
                            if s != d and rng.random() < w.p:
                                self.hub.faults.block(s + 1, d + 1)
        self._drive_events(t)
        if healing and self._needs_settle_load():
            # Keep a trickle of writes flowing until the post-churn
            # config has demonstrably committed (the heal window's
            # no-new-load rule bends exactly this far: proving the
            # final voter set commits IS the recovery being waited on).
            for g in range(self.cfg.num_groups):
                lead = self._leader_node(g)
                if lead is not None:
                    self.nodes[lead].propose(
                        g, f"SET settle{g} t{t}".encode())

    def _needs_settle_load(self) -> bool:
        return self._settle_commits is None \
            or self.report["commits"] <= self._settle_commits + 5

    # -- invariants ----------------------------------------------------

    def _final_mask(self) -> int:
        want = 0
        for v in self.plan.final_voters:
            want |= 1 << v
        return want

    def _post_tick(self, t: int, healing: bool) -> None:
        if self._settle_commits is not None:
            return
        if any(i < len(self._events) for i in self._ev_done):
            return
        want = self._final_mask()
        for n in self.nodes:
            if n is None or n.membership is None:
                continue
            for g in range(self.cfg.num_groups):
                c = n.membership.config(g)
                if c.is_joint or c.voters != want:
                    return
        self._settle_commits = self.report["commits"]

    def _observe(self, t: int) -> None:
        super()._observe(t)
        G = self.cfg.num_groups
        roles = np.full((self.P, G), DEAD_ROLE, np.int64)
        for p, n in enumerate(self.nodes):
            if n is not None:
                roles[p] = n._last_role

        def voter_of(p: int, g: int) -> bool:
            n = self.nodes[p]
            return n is not None and n.membership is not None \
                and bool(n.membership.voter_mask(g) >> p & 1)

        live = [n.membership.voter_mask for n in self.nodes
                if n is not None and n.membership is not None]
        self.removed_safety.observe(t, roles, voter_of, live)

    def _final_check(self) -> None:
        want = self._final_mask()
        for g in range(self.cfg.num_groups):
            for p, n in enumerate(self.nodes):
                if n is None or n.membership is None:
                    continue
                c = n.membership.config(g)
                if c.is_joint or c.voters != want or c.learners:
                    raise InvariantViolation(
                        f"post-heal g={g}: node {p} ended on "
                        f"voters={c.voters:#x} joint={c.is_joint} "
                        f"learners={c.learners:#x}, wanted "
                        f"voters={want:#x} stable")
        if self._settle_commits is None:
            raise InvariantViolation(
                "the scripted membership churn never completed: "
                f"per-group event cursors {self._ev_done} of "
                f"{len(self._events)}")
        if self.report["commits"] <= self._settle_commits:
            raise InvariantViolation(
                "no commits observed on the post-churn configuration "
                f"(stuck at {self._settle_commits})")


class TcpRebindChaosRunner:
    """TCP-plane crash/restart with PORT REBINDING (the ROADMAP chaos
    frontier item): a TcpRebindPlan stops nodes — their listeners
    close, their ports are released — and restarts each on the SAME
    port and data dir `down` ticks later.  Peers' sender threads must
    reconnect through their backoff loop, the rebound listener must
    accept them, and the restarted node must catch up on everything
    committed while it was away.  Same reproducibility posture as
    TcpClusterChaosRunner: the schedule is deterministic from the
    seed, the invariants (election safety, commit monotonicity, log
    matching of published streams) must hold on every run, but
    kernel-scheduled arrival keeps the history non-bit-reproducible.
    """

    def __init__(self, plan: TcpRebindPlan, tmpdir: str, peers: int = 3,
                 device="cuda", commit_rule: Optional[str] = None):
        self.plan = plan
        self.tmpdir = tmpdir
        self.P = peers
        self.device = resolve_device(device)
        self.cfg = _with_rule(RaftConfig(
            num_groups=2, num_peers=peers, log_window=64,
            max_entries_per_msg=4, election_ticks=10, heartbeat_ticks=1,
            tick_interval_s=0.0), commit_rule)
        self.nodes: List[Optional[RaftNode]] = [None] * peers
        self.safety = ElectionSafety(LEADER)
        self.monotonic = CommitMonotonic(peers, self.cfg.num_groups)
        self._hist: Dict[Tuple[int, int], str] = {}
        self._urls: List[str] = []
        self.report = {"commits": 0, "stops": 0, "rebinds": 0}

    def _boot(self, p: int) -> RaftNode:
        tr = TcpTransport(self._urls, p)
        n = RaftNode(p + 1, self.P, self.cfg, tr,
                     os.path.join(self.tmpdir, f"rebind-node-{p + 1}"),
                     device=self.device)
        n.start(threaded=False)
        return n

    def _resolve(self, peer: int) -> int:
        if peer != LEADER_TARGET:
            return peer
        for n in self.nodes:
            if n is not None and n.leader_of(0) >= 0:
                return int(n.leader_of(0))
        return 0

    def _drain_live(self) -> None:
        for p, n in enumerate(self.nodes):
            if n is None:
                continue
            while True:
                try:
                    item = n.commit_q.get_nowait()
                except queue.Empty:
                    break
                if item is None or item is CLOSED:
                    continue
                for (g, idx, sql) in _expand_commit_item(item, n):
                    prev = self._hist.setdefault((g, idx), sql)
                    if prev != sql:
                        raise InvariantViolation(
                            f"log matching: node {p} committed g{g} "
                            f"i{idx} {sql!r} but {prev!r} was committed")
                    self.report["commits"] += 1

    def _observe(self, t: int) -> None:
        G = self.cfg.num_groups
        roles = np.full((self.P, G), DEAD_ROLE, np.int64)
        terms = np.zeros((self.P, G), np.int64)
        commits = np.zeros((self.P, G), np.int64)
        for p, n in enumerate(self.nodes):
            if n is None:
                continue
            roles[p] = n._last_role
            terms[p] = n._hard_np[:, 0]
            commits[p] = n._hard_np[:, 2]
        self.safety.observe(t, roles, terms)
        commits = np.maximum(commits, self.monotonic._hi * (roles < 0))
        self.monotonic.observe(t, commits)

    def run(self) -> dict:
        ports = _free_ports(self.P)
        self._urls = [f"127.0.0.1:{port}" for port in ports]
        rng = np.random.default_rng(self.plan.seed + 1)
        restart_at: Dict[int, list] = {}
        for c in self.plan.restarts:
            restart_at.setdefault(c.tick, []).append(c)
        down_until: Dict[int, int] = {}
        total = self.plan.ticks + self.plan.heal_ticks
        try:
            for p in range(self.P):
                self.nodes[p] = self._boot(p)
            for t in range(total):
                healing = t >= self.plan.ticks
                for c in restart_at.get(t, ()):
                    p = self._resolve(c.peer)
                    if self.nodes[p] is None:
                        continue
                    # Graceful stop: the listener closes and the PORT
                    # IS RELEASED (crash-without-rebind is the node
                    # runner's family; this one is about the rebind).
                    self.nodes[p].stop()
                    self.nodes[p] = None
                    down_until[p] = t + c.down
                    self.report["stops"] += 1
                for p in [p for p, d in down_until.items() if d <= t]:
                    del down_until[p]
                    # Same port, same data dir: replay-from-WAL, then
                    # peers reconnect into the rebound listener.
                    self.nodes[p] = self._boot(p)
                    self.report["rebinds"] += 1
                if not healing and rng.random() < self.plan.prop_rate:
                    alive = [p for p, n in enumerate(self.nodes)
                             if n is not None]
                    src = alive[int(rng.integers(0, len(alive)))]
                    g = int(rng.integers(0, self.cfg.num_groups))
                    self.nodes[src].propose(g, f"SET k{g} v{t}".encode())
                for n in self.nodes:
                    if n is not None:
                        n.tick()
                time.sleep(0.002)
                self._drain_live()
                self._observe(t)
            # Catch-up check: every node is back, and no node's commit
            # trails the cluster max by more than one append batch
            # (the last heartbeat's commit broadcast may be in flight).
            commits = np.stack([n._hard_np[:, 2] for n in self.nodes])
            spread = commits.max(axis=0) - commits.min(axis=0)
            if (spread > self.cfg.max_entries_per_msg).any():
                raise InvariantViolation(
                    f"post-heal catch-up failed: commit spread "
                    f"{spread.tolist()} across rebound nodes")
        finally:
            for n in self.nodes:
                if n is not None:
                    n.stop()
        return {"plan_digest": self.plan.digest(), **self.report}


class ReshardChaosRunner(FusedChaosRunner):
    """The elastic-keyspace nemesis (fused plane): seeded split/merge/
    migrate schedules race partitions, message drops, whole-cluster
    crash+restart, coordinator SIGKILL mid-verb, and disk faults on the
    snapshot ship path, under live acked-PUT load — checked by
    NoAckedWriteLost and NoAvailabilityLoss on top of the standing
    election-safety / durability / linearizability invariants.

    Keyspace model: keys hash onto `plan.nslots` slots; a shared
    `KeyMap` (reshard/keymap.py) routes each slot to a raft group and
    the workload routes writes/reads through it — frozen slots are
    refused up front (the client's 503).  Every group keeps an
    independent keyed store (`_gkv[g]`), and reads resolve against the
    SERVING group's state, so a premature router flip really does serve
    the moved keys from an empty shard.

    The reshard fence is IN the logs: the coordinator's `begin` record
    applies in the source group's own log order, and any keyed write
    applying after it on a moving slot is BOUNCED (never acked, client
    retries after the verb) — closing the late-straggler window by log
    order, not timing.  `flip` grants/`RD` range-deletes close a verb
    id per group, so a stale re-proposed copy can never resurrect rows
    a later verb deleted.

    Coordinator SIGKILL: the coordinator object is discarded mid-verb
    and a fresh one is rebuilt `coordinator_down_ticks` later from the
    journal fold alone (reshard/journal.py) — exactly what a restarted
    coordinator process would do.  Whole-cluster crashes additionally
    rebuild every `_gkv`/fence/journal from the WAL replay (the base
    runner's ledger-audited boot), and each such restart ends in the
    NoAckedWriteLost WAL-fold post-mortem when no verb is in flight.

    Fully deterministic: same seeded draws as the base runner, digests
    compared across runs by `--reshard`.  Port of the JAX package's
    runner: for the same plan the report equals the reference's key for
    key."""

    EXCLUSIVE_EVERY = 32      # steady-state exactly-one-owner cadence

    def __init__(self, plan, data_dir: str, device="cuda",
                 commit_rule: Optional[str] = None):
        from raftsql_tpu_torch.chaos.invariants import (NoAckedWriteLost,
                                                  NoAvailabilityLoss)
        from raftsql_tpu_torch.chaos.schedule import ChaosSchedule as _CS
        from raftsql_tpu_torch.reshard import KeyMap
        sched = _CS(seed=plan.seed, ticks=plan.ticks, drops=plan.drops,
                    partitions=plan.partitions,
                    asym_partitions=plan.asym_partitions,
                    crashes=plan.crashes,
                    prop_rate=plan.prop_rate, read_rate=plan.read_rate)
        cfg = RaftConfig(num_groups=plan.groups, num_peers=plan.peers,
                         log_window=64, max_entries_per_msg=4,
                         election_ticks=plan.election_ticks,
                         heartbeat_ticks=1, tick_interval_s=0.0)
        super().__init__(sched, data_dir, cfg=cfg, device=device,
                         commit_rule=commit_rule)
        self.KEYS = plan.keys
        self.plan = plan
        self.lost = NoAckedWriteLost()
        self.avail = NoAvailabilityLoss(plan.probe_ticks,
                                        plan.verb_deadline_ticks)
        G = plan.groups
        self._km = KeyMap.initial(G, plan.nslots)
        self._gkv: Dict[int, Dict[str, str]] = {g: {} for g in range(G)}
        self._fence: Dict[int, set] = {g: set() for g in range(G)}
        self._flipped: Dict[int, set] = {g: set() for g in range(G)}
        self._closed: Dict[int, set] = {g: set() for g in range(G)}
        self._jrecs: List[dict] = []       # decoded RJ records (dupes ok)
        self._jseen: set = set()           # (id, step, group) applied
        self._jwant: Dict[tuple, int] = {} # (id, step) -> gating group
        self.coord = None
        self._replaying = False
        self._reshard_todo = list(plan.reshards)
        self._kills = set(plan.coordinator_kills)
        self._coord_down_until = -1
        self._xfer_cursor = 0
        self._cutover_started = False
        self._presplit_done = not plan.presplit_transfer
        self._tick_now = 0
        self.report.update({
            "reshard_splits": 0, "reshard_merges": 0,
            "reshard_migrations": 0, "reshard_aborted": 0,
            "reshard_resumed": 0, "reshard_flips": 0,
            "coordinator_kills": 0, "fork_faults": 0,
            "writes_bounced": 0, "copies_discarded": 0,
            "reshard_probes": 0, "reshard_probes_confirmed": 0,
            "moved_checks": 0, "exclusive_checks": 0,
            "keymap_epoch": 0,
        })

    # -- boot / crash ---------------------------------------------------

    def _boot(self, first: bool):
        for g in range(self.cfg.num_groups):
            self._gkv[g].clear()
            self._fence[g].clear()
            self._flipped[g].clear()
            self._closed[g].clear()
        self._jrecs.clear()
        self._jseen.clear()
        self._jwant.clear()
        self.coord = None
        self._replaying = True
        try:
            node = super()._boot(first)
        finally:
            self._replaying = False
        if first and self.plan.fork_fault_op >= 0:
            inj = fsio.injector()
            if inj is not None:
                inj.add_rule(os.sep + "reshard-ship" + os.sep,
                             fail_at=(self.plan.fork_fault_op,))
        self.node = node
        self._rebuild_coordinator()
        return node

    def _rebuild_coordinator(self) -> None:
        from raftsql_tpu_torch.reshard import ReshardCoordinator
        self.coord = ReshardCoordinator(
            self, self._km, num_groups=self.cfg.num_groups,
            broken_flip=self.plan.broken_flip,
            retry_steps=self.plan.retry_steps)
        self.coord.recover(self._jrecs)
        for ev in self.coord.drain_events():
            if ev["kind"] == "resume":
                self.report["reshard_resumed"] += 1
                self.avail.verb_started(self._tick_now, ev["id"])

    def _crash_restart(self, tick: int, power_loss: bool = False,
                       tear_peer: int = -1) -> None:
        self._tick_now = tick
        self.avail.note_crash(tick)
        self._xfer_cursor = 0
        self._cutover_started = False
        super()._crash_restart(tick, power_loss, tear_peer)
        if self.coord is not None and not self.coord.busy \
                and not self._km.frozen:
            self.lost.check_exclusive(
                self._km, self._gkv,
                context=f" (WAL-fold post-mortem, restart at tick "
                        f"{tick})")
            self.report["exclusive_checks"] = self.lost.exclusive_checks

    # -- apply plane: fences + journal fold -----------------------------

    def _apply(self, g: int, idx: int, payload: bytes) -> None:
        from raftsql_tpu_torch.reshard.journal import (decode_rdel,
                                                       decode_record)
        from raftsql_tpu_torch.reshard.keymap import slot_of
        self.ledger.record(g, idx, payload)
        self._applied[g] = max(self._applied[g], idx)
        text = payload.decode("utf-8", "replace")
        rec = decode_record(text)
        if rec is not None:
            vid = int(rec["id"])
            self._jrecs.append(rec)
            self._jseen.add((vid, rec["step"], g))
            slots = set(int(s) for s in rec.get("slots", ()))
            if rec.get("verb") != "migrate":
                if rec["step"] == "begin" and rec.get("src") == g:
                    self._fence[g] |= slots
                elif rec["step"] == "abort" and rec.get("src") == g:
                    self._fence[g] -= slots
                elif rec["step"] == "flip":
                    if rec.get("src") == g:
                        self._fence[g] -= slots
                        self._flipped[g] |= slots
                    if rec.get("dst") == g:
                        self._flipped[g] -= slots
                        self._closed[g].add(vid)
            return
        rd = decode_rdel(text)
        if rd is not None:
            ss = set(int(s) for s in rd["slots"])
            n = int(rd["nslots"])
            for k in [k for k in self._gkv[g]
                      if slot_of(k, n) in ss]:
                del self._gkv[g][k]
            self._closed[g].add(int(rd["id"]))
            return
        parts = text.split(" ")
        if len(parts) == 4 and parts[0] == "CPY":
            vid, key, value = int(parts[1]), parts[2], parts[3]
            if vid in self._closed[g]:
                if not self._replaying:
                    self.report["copies_discarded"] += 1
            else:
                self._gkv[g][key] = value
            return
        if len(parts) == 3 and parts[0] == "SET":
            key, value = parts[1], parts[2]
            s = slot_of(key, self.plan.nslots)
            if s in self._fence[g] or s in self._flipped[g]:
                # The write raced the reshard fence: it applied after
                # the begin/flip record in this group's OWN log order,
                # so every replica discards it identically and the
                # client is never acked (it retries at the new owner).
                if not self._replaying:
                    self.report["writes_bounced"] += 1
                return
            self._gkv[g][key] = value
            self._kv[key] = value
            self.lin.end_write(value)
            if not self._replaying:
                self.lost.note_ack(key, value)
                self.avail.probe_committed(value)

    # -- workload routed by the keymap ----------------------------------

    def _issue(self, rng: np.random.Generator) -> None:
        km = self._km
        if rng.random() < self.sched.prop_rate:
            k = int(rng.integers(0, self.KEYS))
            key = f"k{k}"
            if not km.is_frozen(key):
                g = km.group_of(key)
                value = f"v{self._wseq}"
                self._wseq += 1
                self.lin.begin_write(key, value)
                self.node.propose_many(g, [f"SET {key} {value}".encode()])
        if rng.random() < self.sched.read_rate:
            k = int(rng.integers(0, self.KEYS))
            key = f"k{k}"
            if not km.is_frozen(key):
                g = km.group_of(key)
                got = self.node.read_index(g)
                if got:
                    target, _ = got
                    self._pending_reads.append(
                        (key, g, target, self.lin.begin_read(key)))

    def _resolve_reads(self) -> None:
        still = []
        for (key, g, target, handle) in self._pending_reads:
            if self._applied[g] >= target:
                self.lin.end_read(handle, self._gkv[g].get(key, ""))
            else:
                still.append((key, g, target, handle))
        self._pending_reads = still

    # -- coordinator backend (reshard/coordinator.py protocol) ----------

    def journal(self, group: int, rec: dict, want: bool = True) -> None:
        from raftsql_tpu_torch.reshard.journal import encode_record
        if want:
            self._jwant[(int(rec["id"]), rec["step"])] = int(group)
        self.node.propose_many(int(group),
                               [encode_record(rec).encode()])

    def journal_applied(self, vid: int, step: str) -> bool:
        g = self._jwant.get((int(vid), step))
        return g is not None and (int(vid), step, g) in self._jseen

    def drained(self, group: int, slots) -> bool:
        # The begin fence is already applied (j:begin gated on it), and
        # apply order == log order, so every pre-fence write for the
        # moving slots is in _gkv[group] right now; later ones bounce.
        return True

    def rows_of(self, group: int, slots) -> Dict[str, str]:
        from raftsql_tpu_torch.reshard.keymap import slot_of
        ss = set(int(s) for s in slots)
        return {k: v for k, v in sorted(self._gkv[int(group)].items())
                if slot_of(k, self.plan.nslots) in ss}

    def copy(self, dst: int, rows: Dict[str, str]) -> None:
        vid = self.coord._cur["id"]
        payloads = [f"CPY {vid} {k} {v}".encode()
                    for k, v in sorted(rows.items())]
        if payloads:
            self.node.propose_many(int(dst), payloads)

    def copy_settled(self, dst: int, rows: Dict[str, str]) -> bool:
        kv = self._gkv[int(dst)]
        return all(kv.get(k) == v for k, v in rows.items())

    def rdel(self, group: int, slots, vid: int) -> None:
        from raftsql_tpu_torch.reshard.journal import encode_rdel
        self.node.propose_many(
            int(group),
            [encode_rdel(slots, self.plan.nslots, vid).encode()])

    def rdel_settled(self, group: int, slots, vid: int) -> bool:
        from raftsql_tpu_torch.reshard.keymap import slot_of
        ss = set(int(s) for s in slots)
        return not any(slot_of(k, self.plan.nslots) in ss
                       for k in self._gkv[int(group)])

    def publish(self, keymap) -> None:
        self.report["keymap_epoch"] = keymap.epoch

    def ship(self, group: int, target: int) -> None:
        d = os.path.join(self.data_dir, "reshard-ship")
        os.makedirs(d, exist_ok=True)
        blob = json.dumps(sorted(self._gkv[int(group)].items()),
                          separators=(",", ":")).encode()
        path = os.path.join(d, f"g{group}-p{target}.img")
        with open(path, "wb") as f:
            fsio.write(f, blob)
            fsio.fsync_file(f)

    def cutover(self, group: int, target: int,
                retry: bool = False) -> Optional[str]:
        from raftsql_tpu_torch.runtime.node import TransferRefused
        group, target = int(group), int(target)
        if not self._cutover_started or retry:
            if self.node.leader_of(group) == target:
                self._cutover_started = False
                return "completed"
            try:
                self.node.transfer_leadership(group, target,
                                              deadline_ticks=40)
                self._cutover_started = True
            except TransferRefused:
                return None
        events = self.node._xfer_events
        for i in range(self._xfer_cursor, len(events)):
            if events[i]["group"] == group:
                self._xfer_cursor = i + 1
                self._cutover_started = False
                return "completed" \
                    if events[i]["outcome"] == "completed" else "aborted"
        return None

    # -- verb driving ---------------------------------------------------

    def _resolve_reshard(self, ev) -> Optional[tuple]:
        """(verb, src, dst, slots) for a plan event, or None to retry
        later.  Deterministic: resolved from seed-determined state."""
        km = self._km
        sizes = {g: len(km.slots_of(g)) for g in range(self.cfg.num_groups)}
        live = [g for g, n in sizes.items() if n > 0]
        if not live:
            return None
        if ev.verb == "split":
            src = ev.src if ev.src >= 0 else \
                max(live, key=lambda g: (sizes[g], -g))
            if sizes[src] <= 1:
                return None              # nothing to split
            if ev.dst >= 0:
                dst = ev.dst
            elif km.retired:
                dst = min(km.retired)
            else:
                others = [g for g in range(self.cfg.num_groups)
                          if g != src]
                dst = min(others, key=lambda g: (sizes[g], g))
            # Acked-key-bearing slots first: the verb should always
            # have data to prove itself on.
            owned = sorted(km.slots_of(src))
            from raftsql_tpu_torch.reshard.keymap import slot_of
            hot = set(slot_of(k, km.nslots) for k in self.lost.acked)
            ranked = sorted(owned,
                            key=lambda s: (0 if s in hot else 1, s))
            slots = sorted(ranked[:min(ev.move_slots,
                                       max(1, sizes[src] - 1))])
            return ("split", src, dst, slots)
        if ev.verb == "merge":
            if len(live) < 2:
                return None
            src = ev.src if ev.src >= 0 else \
                min(live, key=lambda g: (sizes[g], g))
            dst = ev.dst if ev.dst >= 0 else \
                max((g for g in live if g != src),
                    key=lambda g: (sizes[g], -g))
            if src == dst:
                return None
            return ("merge", src, dst, None)
        # migrate: dst is a peer
        src = ev.src if ev.src >= 0 else min(live)
        if ev.dst >= 0:
            dst = ev.dst
        else:
            lead = self.node.leader_of(src)
            if lead < 0:
                return None
            dst = (lead + 1) % self.cfg.num_peers
        return ("migrate", src, dst, None)

    def _quiet(self, t0: int, t1: int) -> bool:
        """No scheduled fault overlaps [t0, t1) — clean air for an
        availability probe."""
        if t1 >= self.sched.ticks:
            return False
        for w in (self.sched.drops + self.sched.delays
                  + self.sched.partitions + self.sched.asym_partitions
                  + self.sched.skews):
            if w.start < t1 and t0 < w.end:
                return False
        return all(not t0 <= ev.tick < t1 for ev in self.sched.crashes)

    def _apply_faults(self, t: int, rng: np.random.Generator) -> None:
        self._tick_now = t
        # LEADER_TARGET partitions anchor on plan.part_group's leader
        # (the directed falsification plan aims them at the split's
        # DESTINATION group to starve the copy path).
        for wi, w in enumerate(self.sched.partitions):
            if w.start <= t < w.end and w.peer < 0 \
                    and wi not in self._part_peer:
                self._part_peer[wi] = max(
                    self.node.leader_of(self.plan.part_group), 0)
                self.report["partitions"] += 1
        super()._apply_faults(t, rng)
        self._drive_reshard(t)

    def _presplit(self, t: int) -> None:
        """Falsification warmup: make sure the split's dst group is not
        led by the src group's leader, so the directed partition stalls
        ONLY the copy path.  With `presplit_spare_apply_peer` dst must
        not be led by peer 0 either: peer 0's commit stream is this
        runner's apply plane, and a partition of peer 0 stalls every
        group's journal, the source's included (the JAX package's plan
        lets it, and its broken flip then goes uncaught under the
        partitionable threefry draws)."""
        from raftsql_tpu_torch.runtime.node import TransferRefused
        ev = self.plan.reshards[0]
        ls = self.node.leader_of(ev.src)
        ld = self.node.leader_of(ev.dst)
        if ls < 0 or ld < 0:
            return
        avoid = {ls, 0} if self.plan.presplit_spare_apply_peer else {ls}
        if ld not in avoid:
            self._presplit_done = True
            return
        P = self.cfg.num_peers
        target = next((ld + k) % P for k in range(1, P)
                      if (ld + k) % P not in avoid)
        try:
            self.node.transfer_leadership(ev.dst, target,
                                          deadline_ticks=40)
        except TransferRefused:
            pass

    def _drive_reshard(self, t: int) -> None:
        # Coordinator SIGKILL / delayed rebuild.
        if t in self._kills and self.coord is not None:
            self.coord = None
            self._coord_down_until = t + self.plan.coordinator_down_ticks
            self.report["coordinator_kills"] += 1
        if self.coord is None:
            if t >= self._coord_down_until:
                self._rebuild_coordinator()
            else:
                return
        if not self._presplit_done and t >= 20:
            self._presplit(t)
        # Issue due plan verbs (retried while the coordinator is busy).
        from raftsql_tpu_torch.reshard import ReshardRefused
        keep = []
        for ev in self._reshard_todo:
            if ev.tick > t or self.coord.busy:
                keep.append(ev)
                continue
            resolved = self._resolve_reshard(ev)
            if resolved is None:
                keep.append(ev)
                continue
            verb, src, dst, slots = resolved
            try:
                self.coord.enqueue(verb, src, dst, slots)
            except ReshardRefused:
                keep.append(ev)
        self._reshard_todo = keep
        # Orphan adoption: a begin record can apply AFTER the
        # coordinator that proposed it was killed and rebuilt (the
        # rebuild folded a journal that did not contain it yet).  An
        # idle coordinator re-folds and adopts the orphan verb.
        if not self.coord.busy and self._jrecs:
            from raftsql_tpu_torch.reshard.journal import fold_records
            _, active = fold_records(self._jrecs, self.cfg.num_groups,
                                     self.plan.nslots)
            if active is not None:
                self.coord.recover(self._jrecs)
        self.coord.step()
        for ev in self.coord.drain_events():
            kind = ev["kind"]
            if kind == "begin":
                self.avail.verb_started(t, ev["id"])
            elif kind == "resume":
                self.report["reshard_resumed"] += 1
                self.avail.verb_started(t, ev["id"])
            elif kind == "fork-fault":
                self.report["fork_faults"] += 1
            elif kind == "flip":
                self.report["reshard_flips"] += 1
                moved = [f"k{k}" for k in range(self.KEYS)]
                from raftsql_tpu_torch.reshard.keymap import slot_of
                moved = [k for k in moved
                         if slot_of(k, self.plan.nslots) in
                         set(ev["slots"])]
                self.lost.check_moved(
                    moved, ev["dst"], self._gkv[ev["dst"]],
                    context=f" (verb {ev['id']} {ev['verb']} "
                            f"{ev['src']}->{ev['dst']} at tick {t})")
                self.report["moved_checks"] = self.lost.moved_checks
                # Clients fail closed on the epoch bump: reads pinned
                # to the OLD owner of the moved slots are aborted, not
                # served from a shard about to be range-deleted.
                ss = set(ev["slots"])
                self._pending_reads = [
                    (key, g, target, h)
                    for (key, g, target, h) in self._pending_reads
                    if not (g == ev["src"] and
                            slot_of(key, self.plan.nslots) in ss)]
            elif kind == "done":
                self.avail.verb_resolved()
                key = {"split": "reshard_splits",
                       "merge": "reshard_merges",
                       "migrate": "reshard_migrations"}[ev["verb"]]
                self.report[key] += 1
                if not self._km.frozen:
                    self.lost.check_exclusive(
                        self._km, self._gkv,
                        context=f" (verb {ev['id']} {ev['verb']} done "
                                f"at tick {t})")
                    self.report["exclusive_checks"] = \
                        self.lost.exclusive_checks
            elif kind == "abort":
                self.avail.verb_resolved()
                self.report["reshard_aborted"] += 1
        # Availability probes: writes OUTSIDE the moving range, armed
        # in clean air while a verb is in flight.
        if self.coord is not None and self.coord.busy \
                and t % self.plan.probe_every == 0 \
                and self._quiet(t, t + self.plan.probe_ticks + 1):
            from raftsql_tpu_torch.reshard.keymap import slot_of
            for k in range(self.KEYS):
                key = f"k{k}"
                if not self._km.is_frozen(key):
                    g = self._km.group_of(key)
                    value = f"v{self._wseq}"
                    self._wseq += 1
                    self.lin.begin_write(key, value)
                    self.node.propose_many(
                        g, [f"SET {key} {value}".encode()])
                    self.avail.arm_probe(t, key, value)
                    self.report["reshard_probes"] += 1
                    break

    # -- invariant cadence ----------------------------------------------

    def _observe(self, t: int) -> None:
        super()._observe(t)
        self.avail.check(t)
        self.report["reshard_probes_confirmed"] = \
            self.avail.probes_confirmed
        if t and t % self.EXCLUSIVE_EVERY == 0 \
                and self.coord is not None and not self.coord.busy \
                and not self._km.frozen:
            self.lost.check_exclusive(
                self._km, self._gkv,
                context=f" (steady state at tick {t})")
            self.report["exclusive_checks"] = self.lost.exclusive_checks
        if t == self.sched.ticks - 1:
            self.avail.final_check(t)

    def _report(self) -> dict:
        r = super()._report()
        r["plan_digest"] = self.plan.digest()
        r["keymap"] = self._km.to_doc()
        return r


class OverloadChaosRunner(FusedChaosRunner):
    """Overload nemesis (overload/): an OPEN-LOOP producer offers
    `offered_per_tick` writes every tick — roughly twice what the
    engine drains — plus burst windows, hot-group skew, a fraction of
    writes carrying device-step deadlines, slow-fsync stalls and a
    mid-overload crash+restart.  The bounded admission controller is
    attached to the engine exactly the way the server does it
    (node.overload), so the nemesis exercises the REAL hot path:
    admit() under _prop_lock, stage-shed of expired deadlines before
    any WAL cost, drained() accounting, and the tick-fed drain EWMA.

    Invariants on top of the standing suite (durability ledger +
    restart replay, election safety, commit monotonicity, log
    matching, linearizable reads):

      OVERLOAD-MEMORY — the engine's ACTUAL propose backlog (every
      queue of every peer, measured under _prop_lock each tick) never
      exceeds the plan's hard cap.  This is the falsification seam:
      with `unsafe_no_admission` the controller is NOT attached, the
      producer outruns the drain, and this invariant MUST fire on the
      identical schedule the bounded control survives.

    Goodput and starvation floors are checked by chaos/run.py from
    the report (committed totals are facts of the digested history,
    not per-tick invariants).  Port of the JAX package's runner: for
    the same plan the report equals the reference's key for key."""

    def __init__(self, plan, data_dir: str, device="cuda",
                 commit_rule: Optional[str] = None):
        self.plan = plan
        sched = ChaosSchedule(
            seed=plan.seed, ticks=plan.ticks,
            crashes=tuple(plan.crashes),
            fsync_stalls=tuple(plan.fsync_stalls),
            prop_rate=0.0, read_rate=0.0)   # workload is the open loop
        cfg = RaftConfig(num_groups=plan.groups, num_peers=plan.peers,
                         log_window=64, max_entries_per_msg=4,
                         election_ticks=10, heartbeat_ticks=1,
                         tick_interval_s=0.0)
        super().__init__(sched, data_dir, cfg=cfg, device=device,
                         commit_rule=commit_rule)
        self._t = -1
        self._ov_totals: Dict[str, int] = {
            "admitted": 0, "rejected": 0, "shed_edge": 0,
            "shed_ring": 0, "shed_stage": 0, "shed_commit_wait": 0,
            "brownouts": 0, "queue_depth_peak": 0}
        self.report.update({
            "offered": 0, "overload_admitted": 0,
            "overload_rejected": 0, "overload_shed_stage": 0,
            "overload_brownouts": 0, "overload_depth_peak": 0})

    # -- controller attachment (the server's wiring, replayed) ---------

    def _make_node(self) -> FusedClusterNode:
        from raftsql_tpu_torch.overload import OverloadController
        node = super()._make_node()
        if not self.plan.unsafe_no_admission:
            node.overload = OverloadController(
                self.cfg.num_groups,
                group_cap=self.plan.group_cap,
                total_cap=self.plan.total_cap,
                seed=self.plan.seed,
                tick_interval_s=0.001)
        return node

    def _harvest(self) -> None:
        """Fold the dying (or finished) node's controller counters
        into the run totals — the controller is re-attached fresh at
        every restart, exactly as a restarted server would."""
        node = self.node
        ov = getattr(node, "overload", None) if node is not None else None
        if ov is None:
            return
        doc = ov.metrics_doc()
        for k in ("admitted", "rejected", "shed_edge", "shed_ring",
                  "shed_stage", "shed_commit_wait", "brownouts"):
            self._ov_totals[k] += int(doc[k])
        self._ov_totals["queue_depth_peak"] = max(
            self._ov_totals["queue_depth_peak"],
            int(doc["queue_depth_peak"]))

    def _crash_restart(self, tick: int, power_loss: bool = False,
                       tear_peer: int = -1) -> None:
        self._harvest()
        super()._crash_restart(tick, power_loss, tear_peer)

    # -- the open-loop workload ----------------------------------------

    def _issue(self, rng: np.random.Generator) -> None:
        from raftsql_tpu_torch.overload import Overloaded
        self._t += 1
        t = self._t
        plan = self.plan
        node = self.node
        G = self.cfg.num_groups
        offered = plan.offered_per_tick
        for b in plan.bursts:
            if b.start <= t < b.end:
                offered += b.extra
        keys_per_group = max(1, self.KEYS // G)
        now_step = int(node._device_steps)
        for _ in range(offered):
            if rng.random() < plan.hot_share:
                g = plan.hot_group % G
            else:
                g = int(rng.integers(0, G))
            k = g + G * int(rng.integers(0, keys_per_group))
            dstep = None
            if rng.random() < plan.deadline_rate:
                dstep = now_step + int(rng.integers(plan.deadline_lo,
                                                    plan.deadline_hi + 1))
            value = f"v{self._wseq}"
            self._wseq += 1
            self.report["offered"] += 1
            try:
                node.propose_many(g, [f"SET k{k} {value}".encode()],
                                  deadline_step=dstep)
            except Overloaded:
                continue              # open loop: the producer moves on
            # Only ADMITTED writes enter the linearizability register:
            # a refused write was never acked and may never apply (a
            # deadline-shed admitted write is a begun-but-unacked
            # write, which the register models as forever-concurrent).
            self.lin.begin_write(f"k{k}", value)
        if rng.random() < plan.read_rate:
            k = int(rng.integers(0, self.KEYS))
            g = k % G
            got = node.read_index(g)
            if got:
                target, _ = got
                self._pending_reads.append(
                    (f"k{k}", g, target, self.lin.begin_read(f"k{k}")))

    # -- invariants ----------------------------------------------------

    def _observe(self, t: int) -> None:
        super()._observe(t)
        node = self.node
        with node._prop_lock:
            depth = sum(len(q) for row in node._props for q in row)
        if depth > self.report["overload_depth_peak"]:
            self.report["overload_depth_peak"] = depth
        if depth > self.plan.total_cap:
            raise InvariantViolation(
                f"OVERLOAD-MEMORY: tick {t}: propose backlog {depth} "
                f"exceeds the hard cap {self.plan.total_cap} "
                f"(admission "
                f"{'OFF' if self.plan.unsafe_no_admission else 'on'}, "
                f"offered so far {self.report['offered']})")

    def _report(self) -> dict:
        self._harvest()
        self.report["overload_admitted"] = self._ov_totals["admitted"]
        self.report["overload_rejected"] = self._ov_totals["rejected"]
        self.report["overload_shed_stage"] = \
            self._ov_totals["shed_stage"]
        self.report["overload_brownouts"] = self._ov_totals["brownouts"]
        r = super()._report()
        r["plan_digest"] = self.plan.digest()
        per = [0] * self.cfg.num_groups
        for (g, _i) in self.ledger._committed:
            per[g] += 1
        r["group_commits"] = per
        return r
