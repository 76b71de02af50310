"""RaftNode — the host event loop around the batched device step.

Port of raftsql_tpu/runtime/node.py to PyTorch.  The host half is the
JAX package's, line for line; only the device call sites differ:

  - the consensus state lives on `device` (CUDA by default; a missing
    card raises) and is patched IN PLACE by index writes (core/state.py
    set_group_config, set_transfer_target, install_snapshot_state,
    set_peer_progress), where the JAX package donates and rebinds;
  - the step (core/step.py peer_step_packed) is eager PyTorch, and its
    four outputs come back in ONE device-to-host copy into pinned
    memory (_readback);
  - the idle path allocates nothing new on the device: the zero inbox,
    the zero proposal vector, self_id and the timer_inc and force
    broadcast constants are built once.

Client threads (read_index, lease_read, status, leader_of, ...) read
only the host caches (_last_role, _last_hint, _hard_np): a device leaf
read from another thread could see a half-patched state.

This is the TPU-native re-design of the reference's `raftNode`
(reference raft.go:38-273).  Where the reference's 100ms `serveChannels`
loop drives one vendored raft group (raft.go:204-245), this loop drives the
`peer_step` kernel for ALL G groups at once, then performs the host-side
I/O in the reference's exact durability order (raft.go:227-235):

    device step  →  WAL save (entries + hard state)  →  fsync
                 →  transport send                   →  publish commits

so entries are durable before they are sent, and sent before they are
published — invariant §2d.8 of SURVEY.md.

Host responsibilities (the device owns ordering/quorum math only):
  - staging inbound wire records into dense Inbox arrays;
  - mirroring entry payload bytes into storage.PayloadLog, both for local
    proposals (leader) and accepted appends (follower);
  - attaching payloads to outbound AppendEntries requests;
  - proposal forwarding to the current leader hint (the reference gets
    this from etcd/raft's MsgProp routing);
  - apply-at-commit publishing to the commit queue, with the reference's
    replay protocol: every replayed entry is published first, then a
    `None` sentinel marks the channel current (reference raft.go:122-134,
    consumed by db.go:45-52).
"""
from __future__ import annotations

import logging
import os
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from raftsql_tpu_torch.config import (CANDIDATE, FOLLOWER, LEADER, MSG_REQ,
                                MSG_RESP, NO_VOTE, NO_XFER, PRECANDIDATE,
                                RaftConfig)
from raftsql_tpu_torch.core.state import (host_copy,
                                          install_snapshot_state,
                                          resolve_device,
                                          restore_peer_state,
                                          set_group_config,
                                          set_peer_progress,
                                          set_transfer_target)
from raftsql_tpu_torch.core.step import (IB_NCOLS, INFO_FIELDS,
                                         MSG_FIELDS, peer_step_packed)
from raftsql_tpu_torch.membership import (MembershipLagError,
                                          MembershipManager,
                                          NotLeaderForChange)
from raftsql_tpu_torch.runtime.envelope import (DedupWindow, unwrap,
                                                unwrap_snapshot,
                                                unwrap_snapshot_conf, wrap,
                                                wrap_snapshot,
                                                wrap_snapshot_conf)
from raftsql_tpu_torch.storage.log import PayloadLog
from raftsql_tpu_torch.storage.wal import (WAL, split_uniform_runs,
                                           wal_exists)
from raftsql_tpu_torch.transport.base import (AppendRec, ColRecs,
                                              ProposalRec, SnapshotRec,
                                              TickBatch, Transport, VoteRec)
from raftsql_tpu_torch.transport.codec import CONF_PREFIX as _CONF_PREFIX, \
    is_conf_entry
from raftsql_tpu_torch.utils.metrics import NodeMetrics

log = logging.getLogger("raftsql_tpu_torch.node")

# Commit-queue sentinel marking end-of-stream (the reference closes the
# channel; Python queues need an explicit object).
CLOSED = object()

# Role-code → wire name map for GET /healthz (status()).
_ROLE_NAMES = {FOLLOWER: "follower", CANDIDATE: "candidate",
               LEADER: "leader", PRECANDIDATE: "precandidate"}


class TransferRefused(ValueError):
    """A leadership-transfer request failed validation and was never
    armed: a transfer is already in flight for the group, the target
    already leads, or the target is a learner/non-voter (thesis §3.10
    requires a VOTER target — a learner can never win the election the
    TimeoutNow grant starts).  Subclasses ValueError so the HTTP planes
    answer 400 without a dedicated handler; not-leader refusals raise
    NotLeaderForChange instead (421 + retry hint)."""

    def __init__(self, group: int, why: str):
        super().__init__(f"group {group}: transfer refused: {why}")
        self.group = group
        self.why = why

class _PackedView:
    """Attribute access over columns of a packed numpy array — the
    Outbox/StepInfo face the tick phases consume, backed by free views
    into the ONE host buffer the readback fills (core/step.py packed
    forms)."""

    def __init__(self, **cols):
        self.__dict__.update(cols)


def _view_outbox(arr: np.ndarray) -> _PackedView:
    v = _PackedView(**{n: arr[:, :, i] for i, n in enumerate(MSG_FIELDS)})
    v.a_ents = arr[:, :, IB_NCOLS:]
    return v


def _view_info(ginfo: np.ndarray, next_idx: np.ndarray) -> _PackedView:
    v = _PackedView(**{n: ginfo[:, i] for i, n in enumerate(INFO_FIELDS)})
    v.noop = v.noop.astype(bool)
    v.app_conflict = v.app_conflict.astype(bool)
    v.next_idx = next_idx
    return v


# Discriminator heading a live publish-phase commit item:
# (RAW_BATCH, group, base_idx, [raw_bytes, ...]).  The queue carries
# several item shapes (see runtime/db.py _expand_commit_item); the raw
# form is the only one whose payloads still need envelope unwrap/dedup,
# so it is tagged explicitly rather than sniffed by payload type.
RAW_BATCH = object()


class _ReadBatch:
    """One group's worth of ReadIndex registrations sharing ONE quorum
    round (RaftNode.read_join).  Client threads join the group's
    pending batch and wait on `evt`; the tick thread stamps (target,
    term, reg) when it promotes the batch into the tick's broadcast,
    and whichever thread first observes the quorum (tick tail or a
    transport delivery) publishes `status` and fires the event."""

    __slots__ = ("group", "count", "target", "term", "reg", "status",
                 "evt")

    def __init__(self, group: int):
        self.group = group
        self.count = 0          # joined readers (metrics batch size)
        self.target = -1        # commit index the batch reads at
        self.term = -1          # leader term the round must confirm
        self.reg = -1           # registration tick (round seq binding)
        self.status = ""        # "" pending | "ok" | "not_leader"
        self.evt = threading.Event()
# Same shape, but payloads are PLAIN bytes — no dedup envelopes (the
# fused/mesh runtimes route proposals on the host and never wrap).
# Expansion skips the per-entry unwrap probe, which is a measurable
# share of the consumer at durable-bench saturation.
RAW_PLAIN = object()
# A whole tick's publishes in ONE queue item:
# (RAW_MANY, [(group, base_idx, [plain_bytes, ...]), ...]).  At G=10k
# saturation the fused publish was one queue.put per ready group
# (~10k/tick, ~100 ms of lock/notify traffic); batching them costs the
# consumer one extra loop level and the producer almost nothing.
RAW_MANY = object()


class RaftNode:
    """One consensus node: G raft groups, one peer row each.

    node_id is 1-based like the reference (raft.go:148-151); the device
    peer axis uses node_id - 1.
    """

    # One device step at a time per process.  Eager PyTorch releases the
    # GIL inside every op, so two tick threads stepping at once hand it
    # back and forth op by op (~1000 ops a step): three threaded nodes
    # in one process took ~50 ms a tick on the CPU that way, against
    # ~7 ms a tick with their steps taken in turn (the three-node
    # cluster of tests/test_torch_cluster_sql.py, one torch thread).
    # The JAX package's step is one compiled dispatch and needs no lock.
    _STEP_LOCK = threading.Lock()

    def __init__(self, node_id: int, num_nodes: int, cfg: RaftConfig,
                 transport: Transport, data_dir: str, device="cuda"):
        if cfg.num_peers != num_nodes:
            raise ValueError("cfg.num_peers must equal num_nodes")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.node_id = node_id
        self.self_id = node_id - 1
        self.num_nodes = num_nodes
        # Witness identity (config.py quorum geometry): a witness votes,
        # appends and fsyncs but owns no shard — runtime/db.py reads
        # this flag and installs the discard-only WitnessStateMachine
        # instead of ever invoking the SQLite factory.
        self.witness_self = self.self_id in cfg.witness_set
        self.data_dir = data_dir
        self.transport = transport

        G = cfg.num_groups
        self.commit_q: "queue.Queue" = queue.Queue()
        self.error: Optional[Exception] = None
        self.metrics = NodeMetrics()
        # Host-plane span tracer (raftsql_tpu_torch/obs/spans.py), OFF by
        # default; every hook below gates on it so the disabled tick
        # pays one attribute test (see enable_tracing).
        self.tracer = None

        self._stage_lock = threading.Lock()
        self._stage_votes: Dict[Tuple[int, int], VoteRec] = {}
        self._stage_apps: Dict[Tuple[int, int], AppendRec] = {}
        self._stage_snaps: Dict[int, SnapshotRec] = {}
        # Columnar staging (transport/base.py ColRecs): payload-free
        # messages scatter straight into these [G, P] arrays; record
        # staging (payload appends, and peers speaking the record form)
        # overlays them at inbox-build time.  _stg_a_seq carries the
        # ReadIndex round binding (REQ rows only — a response's seq lives
        # in its sender's numberspace and must never be echoed back).
        # Arrival stamps decide overlay order for mixed delivery forms:
        # each _deliver bumps _arrival once; _stg_a_arr[g, p] is the stamp
        # of the newest COLUMNAR append in the slot, _stage_app_arr the
        # stamp of the staged record — inbox build lets the newer one win,
        # whatever its form ("newest message per (group, src, slot) wins").
        self._stg: np.ndarray = self._fresh_stage_cols()
        self._stg_a_seq = np.zeros((G, num_nodes), np.int64)
        self._stg_a_arr = np.zeros((G, num_nodes), np.int64)
        self._stage_app_arr: Dict[Tuple[int, int], int] = {}
        self._arrival = 0
        # True iff anything was staged since the last inbox build; a
        # clean build reuses the prebuilt all-zero device inbox instead
        # of allocating + converting ~30 arrays per step (at small G the
        # conversions, not the kernel, dominated step cost).
        self._stage_dirty = False
        self._zero_inbox = torch.zeros(
            (G, num_nodes, IB_NCOLS + cfg.max_entries_per_msg),
            dtype=torch.int32, device=self.device)
        self._zero_prop = torch.zeros(G, dtype=torch.int32,
                                      device=self.device)
        self._zero_seq = np.zeros((G, num_nodes), np.int64)

        # InstallSnapshot hooks (wired by the apply layer in resume mode;
        # both unset => full state transfer disabled, catch-up below the
        # compaction floor just logs).  provider(g) -> (applied_idx, blob);
        # installer(g, last_idx, blob) replaces the state machine's state.
        self.snapshot_provider = None
        self.snapshot_installer = None
        self._snap_sent: Dict[Tuple[int, int], int] = {}
        self._snap_due: List[Tuple[int, int, int]] = []
        # Catch-up pacing: (group, dst) -> (next_idx last sent for, tick).
        # Rebuilding + resending the same out-of-window append every tick
        # is pure bandwidth waste; resend only on next_idx progress or
        # after a few ticks without it.
        self._catchup_sent: Dict[Tuple[int, int], Tuple[int, int]] = {}

        self._prop_lock = threading.Lock()
        self._props: List[deque] = [deque() for _ in range(G)]
        # Incremental O(active) bookkeeping for the two per-tick walks
        # that profiled O(G) at G=10k (VERDICT r3 task 4): _prop_len[g]
        # mirrors len(_props[g]) so the tick's prop_n build is one
        # vectorized minimum instead of a 10k-deque generator; _fwd_groups
        # is the set of groups with queued or in-flight-forwarded
        # proposals, so the forwarding walk touches only those.  Both are
        # guarded by _prop_lock, same as the structures they mirror.
        self._prop_len = np.zeros(G, np.int32)
        self._fwd_groups: set = set()
        # Proposals forwarded to a (possibly stale) leader hint, kept as
        # (payload, deadline_tick): if the payload is not observed
        # committed by the deadline, it is re-queued and forwarded again.
        # Without this, a proposal forwarded to a crashed leader is lost
        # and its client hangs forever (the reference inherits the same
        # exposure from etcd/raft's MsgProp forwarding; the batched host
        # plane can do better cheaply).  Commit-observation matches by
        # payload identity — the same content-FIFO quirk as the ack
        # router (SURVEY.md §2d.3).
        self._fwd: List[List[Tuple[bytes, int]]] = [[] for _ in range(G)]
        # Our own proposals accepted into OUR log as leader, still
        # uncommitted: (log_idx, payload).  A deposed (e.g. minority)
        # leader's uncommitted suffix is conflict-truncated by the new
        # leader's first append — without this tracking those proposals
        # vanish and their clients hang forever (the reference loses them
        # the same way through etcd/raft; the envelope dedup makes the
        # requeue-retry safe).  Tick-thread only, no lock.
        self._local: List[List[Tuple[int, bytes]]] = [[] for _ in range(G)]
        self._tick_no = 0

        # Leadership-transfer plane (thesis §3.10, PR 11): one latch per
        # group, armed on the TICK thread (self.state is donated every
        # step; client threads enqueue into _xfer_req instead of
        # patching device state directly).  Deadlines run on the LEASE
        # clock — the same timer units election timeouts count in — so
        # an idle event loop's elided steps cannot stretch a transfer's
        # abort horizon.  _xfer_events is the recent-outcome log flight
        # bundles attach for attribution.
        self._xfer_lock = threading.Lock()
        self._xfer_req: List[Tuple[int, int]] = []
        self._xfer: Dict[int, dict] = {}
        self._xfer_events: deque = deque(maxlen=256)

        self.payload_log = PayloadLog(G)
        # [G] applied index and [G, 3] (term, voted_for, commit) hard-state
        # cache as numpy arrays: every tick compares/updates ALL groups, so
        # these must be vectorized state, not per-group Python objects.
        self._applied = np.zeros(G, np.int64)
        self._prev_role = np.zeros(G, np.int64)     # elections_won metric
        # ReadIndex state (raft §6.4).  Confirmations are bound to
        # request ROUNDS: every append REQ carries this node's tick
        # number (seq); responses echo it.  _resp_echo[g, p] is the
        # newest echoed seq from peer p and _resp_term the term it
        # responded at — a read registered at tick R is quorum-confirmed
        # once enough peers echoed seq >= R at our current term, so a
        # DELAYED pre-registration response can never count.  Role/hint
        # are per-tick host caches (device state is donated; client
        # threads must not touch it).
        self._resp_echo = np.zeros((G, num_nodes), np.int64)
        self._resp_term = np.zeros((G, num_nodes), np.int64)
        self._last_role = np.zeros(G, np.int64)
        self._last_hint = np.full(G, -1, np.int64)
        # Leader-lease clock (config.lease_ticks): leases must be
        # measured in TIMER units (what election timeouts are counted
        # in), not step counts — the event loop runs timer_inc=0 work
        # steps and elides idle steps with timer_inc=k, so steps and
        # timer time diverge freely.  _lease_clock advances with every
        # tick's timer_inc; _round_clock[seq % R] remembers the clock
        # at which round `seq` (= tick number, the seq stamped on
        # outgoing append REQs) went out, so a quorum of seq echoes
        # converts to "a quorum confirmed me at clock c" and the lease
        # runs to c + lease_ticks.  Rounds older than the ring are
        # simply unprovable — the check degrades to ReadIndex.
        self._lease_clock = 0
        self._ROUND_RING = 4096
        self._round_seq = np.full(self._ROUND_RING, -1, np.int64)
        self._round_clock = np.zeros(self._ROUND_RING, np.int64)
        self._dedup = [DedupWindow() for _ in range(G)]
        self._hard_np = np.zeros((G, 3), np.int64)
        self._hard_np[:, 1] = NO_VOTE

        self._stop_evt = threading.Event()
        # Work signal for the event-driven loop (_run): set whenever a
        # proposal, inbound peer batch, or linearizable-read registration
        # arrives, so the next step runs immediately (timer_inc=0)
        # instead of waiting out the tick interval.  The interval-paced
        # steps (timer_inc=1) remain the only ones that advance election
        # and heartbeat timers — real-time raft semantics are unchanged.
        self._work_evt = threading.Event()
        self._stopped = False           # full teardown ran (stop())
        self._thread: Optional[threading.Thread] = None
        self._tick_apps: Dict[Tuple[int, int], AppendRec] = {}
        self._tick_seq = np.zeros((G, num_nodes), np.int64)
        # Serializes the tick's WAL phase against compaction rewrites.
        self._wal_lock = threading.Lock()

        # ---- replay (reference raft.go:122-134 + db.go:27-29 contract).
        self._had_wal = wal_exists(data_dir)
        groups = WAL.replay(data_dir)
        log_terms = {g: [t for (t, _) in gl.entries]
                     for g, gl in groups.items()}
        hard = {g: (gl.hard.term, gl.hard.vote, gl.hard.commit)
                for g, gl in groups.items()}
        starts = {g: (gl.start, gl.start_term) for g, gl in groups.items()}
        self.state = restore_peer_state(cfg, self.self_id, log_terms, hard,
                                        starts=starts, device=self.device)
        for g, gl in groups.items():
            if gl.start:
                self.payload_log.set_start(g, gl.start, gl.start_term)
            self.payload_log.put(g, gl.start + 1,
                                 [d for (_, d) in gl.entries],
                                 [t for (t, _) in gl.entries])
            self._hard_np[g] = (gl.hard.term, gl.hard.vote, gl.hard.commit)
            # Replay publishes the COMMITTED prefix only (then the nil
            # sentinel); the appended-but-uncommitted tail re-publishes
            # through the ordinary commit path once a leader commits it.
            # The reference publishes the WHOLE replayed log
            # (raft.go:130-132) — applying entries a new leader may
            # conflict-truncate: the process-plane chaos harness caught a
            # restarted node keeping such a phantom row in SQLite forever
            # (survivors can then never converge;
            # tests/test_node_loop.py::
            # test_replay_publishes_only_committed_prefix).
            self._applied[g] = min(gl.log_len, gl.hard.commit)
            if gl.dedup is not None:
                # Seed the dedup window from the persisted baseline
                # (storage/wal.py REC_DEDUP) BEFORE replay publishes the
                # retained suffix: the suffix may hold a forward-retry
                # duplicate whose first copy was compacted below the
                # floor — live peers scrub it from their in-memory
                # windows; without the baseline a restarted node would
                # re-apply it and diverge (the snapshot-family chaos
                # sweep caught exactly this).  _decode_entry then layers
                # the above-floor pids on top in index order.
                self._dedup[g].restore(gl.dedup[1])
        self._replay_groups = groups
        # GET /healthz's view (status): role, hint and hard state of ONE
        # tick, swapped in whole at the end of each tick.  The WAL phase
        # moves _hard_np mid-tick, before _last_role, so reading the two
        # apart could show a leader deposed this tick as the leader of
        # the new term (a false two-leaders report to the process chaos
        # runners' election-safety check).
        self._status_view = (self._last_role, self._last_hint,
                             self._hard_np.copy())
        self.wal = WAL(data_dir, segment_bytes=cfg.wal_segment_bytes)
        # Re-seed the fresh handle's dedup baseline (it survives only
        # in-memory per handle, like the conf baseline — which
        # _patch_group_config re-seeds the same way): without this, the
        # first segment unlink after a restart could drop the replayed
        # REC_DEDUP record before any new compaction re-writes it.
        for g, gl in groups.items():
            if gl.dedup is not None:
                self.wal.set_dedup(g, gl.dedup[0], gl.dedup[1])
        # Dynamic membership (raftsql_tpu_torch/membership/): always on — a
        # follower must recognize a conf entry the moment the first one
        # ever commits.  Restore the active config from the WAL: the
        # REC_CONF baseline, then conf ENTRIES committed above it, then
        # appended-but-uncommitted ones back into the pending list.
        self.membership = MembershipManager(
            num_nodes, G, initial_voters=cfg.initial_voters,
            write_quorum=cfg.write_quorum,
            election_quorum=cfg.election_quorum,
            witnesses=cfg.witnesses or (),
            unsafe_geometry=cfg.unsafe_quorum_geometry) \
            if num_nodes <= 64 else None
        if self.membership is not None:
            mm = self.membership
            for g, gl in groups.items():
                if mm.restore(g, gl.conf, gl.entries, gl.start,
                              int(self._hard_np[g, 2])):
                    self._patch_group_config(g, durable=False)
        # Leader view cache for the promote catch-up gate ([G, P]
        # next_idx from the last step's StepInfo).
        self._next_idx = np.ones((G, num_nodes), np.int64)
        dev = self.device
        self._self_arr = torch.tensor(self.self_id, dtype=torch.int32,
                                      device=dev)
        # timer_inc constants for the step call, by value; larger
        # advances (elided idle steps) are added on first use.
        self._ti_arr = {k: torch.tensor(k, dtype=torch.int32, device=dev)
                        for k in (0, 1)}
        # Device-reported minimum ticks until any timer fires; 1 until
        # the first step reports (see _run / core/step.py timer_margin).
        self._timer_margin = 1
        # One-shot broadcast nudge (core/step.py force_bcast): set by
        # read_index so the ReadIndex confirm round goes out on the next
        # step instead of the next heartbeat.  Benign race: a lost
        # concurrent set only delays the round to the heartbeat.
        # ALWAYS shipped as a [G] bool mask (the batched-ReadIndex
        # promote narrows the nudge per group), as in the JAX package,
        # where one dtype from the first tick means one jit entry.
        self._force_bcast = False
        self._fb_arr = (torch.zeros(G, dtype=torch.bool, device=dev),
                        torch.ones(G, dtype=torch.bool, device=dev))
        # Batched ReadIndex (PR 12): client threads join a per-group
        # pending batch (read_join); the tick thread promotes every
        # pending batch into ONE shared quorum round — the broadcast the
        # tick already fires — so N concurrent linearizable reads cost
        # one round per tick instead of one round each.  _rb_pending
        # holds the batch joiners may still enter; _rb_active holds
        # promoted batches awaiting their round's quorum of echoes.
        self._rb_lock = threading.Lock()
        self._rb_pending: Dict[int, _ReadBatch] = {}
        self._rb_active: Dict[int, List[_ReadBatch]] = {}

    # ------------------------------------------------------------------
    # lifecycle

    def start(self, threaded: bool = True) -> None:
        """Publish the WAL replay + sentinel, start the transport, and —
        unless threaded=False (benchmarks/tests that drive `tick()`
        manually for deterministic lockstep) — the tick thread."""
        for g, gl in sorted(self._replay_groups.items()):
            # Committed prefix only — see the _applied restore in
            # __init__ for why the uncommitted tail must NOT reach the
            # state machine here.
            upto = max(0, min(gl.log_len, gl.hard.commit) - gl.start)
            for i, (term, data) in enumerate(gl.entries[:upto]):
                sql = self._decode_entry(g, data, gl.start + 1 + i)
                if sql is not None:
                    self.commit_q.put((g, gl.start + 1 + i, sql))
        self._replay_groups = {}
        self.commit_q.put(None)         # replay-complete sentinel
        # Adopt the transport's fault counters into this node's metrics
        # (transports that count — TcpTransport's corrupt-frame drops —
        # carry a `metrics` attribute; /metrics then reports them).
        if hasattr(self.transport, "metrics"):
            self.transport.metrics = self.metrics
        self.transport.start(self.node_id, self._deliver, self._on_error)
        if threaded:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name=f"raft-node-{self.node_id}")
            self._thread.start()

    def stop(self) -> None:
        # _on_error may have set _stop_evt already (transport failure
        # teardown); the transport/WAL cleanup below must STILL run then —
        # only a completed stop() makes a second call a no-op.
        if self._stopped:
            return
        self._stopped = True
        self._stop_evt.set()
        self._work_evt.set()     # wake a margin-length idle sleep NOW
        self._rb_abort_all()     # unblock batched readers immediately
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.transport.stop()
        self.wal.close()
        self.commit_q.put(CLOSED)

    def _on_error(self, err: Exception) -> None:
        # Transport failure → teardown, error fans out to pending acks
        # (reference raft.go:136-142, db.go:83-95).
        log.error("node %d transport error: %s", self.node_id, err)
        self.error = err
        self._stop_evt.set()
        self._work_evt.set()     # wake a margin-length idle sleep NOW
        self._rb_abort_all()     # unblock batched readers immediately
        self.commit_q.put(CLOSED)

    # ------------------------------------------------------------------
    # client plane

    def enable_tracing(self) -> None:
        """Attach the host-plane span tracer (raftsql_tpu_torch/obs/):
        proposals proposed HERE are followed propose → append →
        replicate → commit (apply/ack stamps come from the RaftDB
        layer).  Idempotent."""
        from raftsql_tpu_torch.obs.spans import SpanTracer
        if self.tracer is None:
            self.tracer = SpanTracer()
        self.wal.obs = self.tracer
        if hasattr(self.transport, "obs"):
            self.transport.obs = self.tracer

    def propose(self, group: int, payload: bytes,
                pid: Optional[int] = None,
                t_parsed: Optional[float] = None) -> None:
        """Enqueue a proposal; routed to the leader on the next tick.

        The payload is wrapped with a unique envelope id so that
        forward-retries after leader failure apply exactly once
        (runtime/envelope.py).  `pid` pins the envelope id instead of
        drawing a fresh one — the CLIENT-retry token (api/client.py
        X-Raft-Retry-Token): a PUT re-sent across a crash or leader
        failover re-proposes under the same id, and the publish-time
        dedup collapses whichever copies commit to one apply.
        `t_parsed` is the HTTP plane's `parsed` stamp for the span
        tracer (obs/spans.py)."""
        if not 0 <= group < self.cfg.num_groups:
            raise ValueError(f"group {group} out of range "
                             f"[0, {self.cfg.num_groups})")
        if self.tracer is not None:
            self.tracer.begin(group, payload.decode("utf-8", "replace"),
                              t=t_parsed)
        with self._prop_lock:
            self._props[group].append(wrap(payload, pid))
            self._prop_len[group] += 1
            self._fwd_groups.add(group)
        self._work_evt.set()

    def propose_many(self, group: int, payloads) -> None:
        """Batch `propose`: one lock hold and envelope pass for a whole
        iterable of payloads (benchmark feeders at G x E per tick would
        otherwise spend the tick budget on lock churn)."""
        if not 0 <= group < self.cfg.num_groups:
            raise ValueError(f"group {group} out of range "
                             f"[0, {self.cfg.num_groups})")
        if self.tracer is not None:
            for p in payloads:
                self.tracer.begin(group, p.decode("utf-8", "replace"))
        wrapped = [wrap(p) for p in payloads]
        with self._prop_lock:
            self._props[group].extend(wrapped)
            self._prop_len[group] += len(wrapped)
            self._fwd_groups.add(group)
        self._work_evt.set()

    def _decode_entry(self, group: int, data: bytes,
                      idx: int = 0) -> Optional[str]:
        """Envelope-aware publish decision: None = skip (empty entry or
        duplicate of an already-applied forwarded proposal).  `idx` is
        the entry's log index — recorded in the dedup window so snapshot
        transfers can ship exactly the window at their applied point."""
        if not data:
            return None
        if data[:1] == _CONF_PREFIX and is_conf_entry(data):
            return None        # membership entry — applied, never SQL
        pid, payload = unwrap(data)
        if pid is not None and self._dedup[group].seen(pid, idx):
            return None
        return payload.decode("utf-8")

    def dedup_for(self, group: int) -> DedupWindow:
        """The group's forward-retry dedup window, for commit-queue
        consumers expanding RAW_BATCH items on their own thread.

        Threading contract (the reason this is an accessor and not a
        reach into _dedup): `seen()` is called by the consumer thread;
        `pairs_upto()`/`restore()` run on the tick thread. DedupWindow
        orders those safely internally; no other methods are
        cross-thread."""
        return self._dedup[group]

    # ------------------------------------------------------------------
    # dynamic membership (raftsql_tpu_torch/membership/)

    def _patch_group_config(self, g: int, durable: bool = True) -> None:
        """Push group g's applied config into the device masks and
        (durable=True) the WAL baseline.  Tick thread (or __init__)."""
        # First conf this node ever sees: leave the static-full-voter
        # fast path so the step reads the masks this patch writes
        # (config.py dynamic_membership; one recompile, conf changes
        # are rare admin events).
        if self.cfg.static_full_voters:
            import dataclasses as _dc
            self.cfg = _dc.replace(self.cfg, dynamic_membership=True)
        mm = self.membership
        vrow, jrow, selfv = mm.device_rows(g, self.self_id)
        set_group_config(self.state, g, vrow, jrow, selfv)   # in place
        c = mm.config(g)
        with self._wal_lock:
            self.wal.set_conf(g, c.index, 0, c.voters, c.joint,
                              c.learners)
        if durable:
            self.metrics.conf_changes_applied += 1

    def propose_conf(self, group: int, entry: bytes) -> None:
        """Queue a conf entry — NO envelope wrap (conf apply is
        idempotent by log index, and the publish plane recognizes conf
        entries by their leading byte; an envelope would hide it)."""
        with self._prop_lock:
            self._props[group].append(entry)
            self._prop_len[group] += 1
            self._fwd_groups.add(group)
        self._work_evt.set()

    def member_change(self, group: int, op: str, peer: int) -> dict:
        """Admin plane: add/remove/promote a peer slot of `group`.

        Accepted at the group's leader only (NotLeaderForChange names
        the hint to retry at); `promote` additionally requires the
        learner to be CAUGHT UP — its replication point within one
        append batch of the leader's commit — so a promotion can never
        stall the new joint quorum behind a cold learner."""
        if self.membership is None:
            raise RuntimeError("membership requires num_peers <= 64")
        if not 0 <= group < self.cfg.num_groups:
            raise ValueError(f"group {group} out of range")
        if self._last_role[group] != LEADER:
            raise NotLeaderForChange(group, self.leader_of(group) + 1)
        if op == "promote":
            commit = int(self._hard_np[group, 2])
            behind = commit - (int(self._next_idx[group, peer]) - 1)
            if behind > self.cfg.max_entries_per_msg:
                raise MembershipLagError(
                    f"group {group}: learner {peer} is {behind} entries "
                    f"behind commit {commit}; let catch-up finish before "
                    "promoting")
        entry = self.membership.make_change(group, op, peer)
        self.propose_conf(group, entry)
        return self.membership.describe(group)

    def members_doc(self) -> dict:
        """GET /members payload: per-group active config + leader."""
        if self.membership is None:
            return {"error": "membership requires num_peers <= 64"}
        out = {}
        for g in range(self.cfg.num_groups):
            d = self.membership.describe(g)
            d["leader"] = self.leader_of(g) + 1      # 1-based, 0 unknown
            out[str(g)] = d
        return {"num_peers": self.num_nodes, "groups": out,
                "witnesses": sorted(self.cfg.witness_set),
                "node": self.node_id}

    def _membership_tick(self, info) -> None:
        """Joint-transition driver: whichever peer currently leads a
        joint group auto-proposes the LEAVE_JOINT (rate-limited), so a
        leader crash between the two phases cannot wedge the group."""
        mm = self.membership
        if mm is None or not mm.joint_groups:
            return
        role = info.role
        for g in list(mm.joint_groups):
            if role[g] == LEADER:
                entry = mm.maybe_leave(g, self._tick_no,
                                       4 * self.cfg.election_ticks)
                if entry is not None:
                    self.propose_conf(g, entry)

    # ------------------------------------------------------------------
    # leadership transfer (raft thesis §3.10, PR 11)

    def transfer_leadership(self, group: int, target: int,
                            deadline_ticks: Optional[int] = None) -> dict:
        """Arm a graceful leadership transfer of `group` to peer slot
        `target` (0-based).  Accepted at the group's leader only; the
        device latch stops proposal intake, waits for the target's
        match_index to catch up, then fires the TimeoutNow grant
        (core/step.py Phase 9).  One transfer in flight per group; the
        host aborts and re-opens intake after `deadline_ticks` of lease
        clock (default 4 election timeouts).  Client-thread safe: the
        latch is armed by the tick thread."""
        cfg = self.cfg
        if not 0 <= group < cfg.num_groups:
            raise ValueError(f"group {group} out of range")
        if not 0 <= target < cfg.num_peers:
            raise ValueError(f"target {target} out of peer-slot range")
        if self._last_role[group] != LEADER:
            self.metrics.transfers_refused += 1
            raise NotLeaderForChange(group, self.leader_of(group) + 1)
        if target == self.self_id:
            self.metrics.transfers_refused += 1
            raise TransferRefused(group, "target already leads")
        if self.membership is not None \
                and not self.membership.is_voter(group, target):
            self.metrics.transfers_refused += 1
            raise TransferRefused(
                group, f"peer {target} is a learner/non-voter")
        if target in cfg.witness_set:
            # Witnesses vote and persist but never lead (config.py
            # quorum geometry): handing one the lease would strand the
            # group — the device gate (core/step.py Phase 1b) would eat
            # the TimeoutNow and the transfer would stall to deadline.
            self.metrics.transfers_refused += 1
            raise TransferRefused(group, f"peer {target} is a witness")
        dl = int(deadline_ticks) if deadline_ticks \
            else 4 * cfg.election_ticks
        with self._xfer_lock:
            if group in self._xfer:
                self.metrics.transfers_refused += 1
                raise TransferRefused(group, "transfer already in flight")
            self._xfer[group] = {"target": target, "from": self.self_id,
                                 "start_tick": self._tick_no,
                                 "deadline_ticks": dl, "deadline": None,
                                 "armed": False}
            self._xfer_req.append((group, target))
        self.metrics.transfers_initiated += 1
        self._work_evt.set()
        return {"group": group, "from": self.node_id,
                "target": target + 1, "deadline_ticks": dl}

    def _transfer_tick(self, info) -> None:
        """Per-tick transfer driver (tick thread): arm queued requests
        into device state, detect completion (we were deposed and the
        hint names the target), and abort past-deadline transfers by
        clearing the latch — which re-opens the group for proposals on
        the very next step."""
        if not (self._xfer or self._xfer_req):
            return
        with self._xfer_lock:
            reqs, self._xfer_req = self._xfer_req, []
            for (g, tgt) in reqs:
                set_transfer_target(self.state, g, tgt)      # in place
                tr = self._xfer.get(g)
                if tr is not None:
                    tr["armed"] = True
                    tr["deadline"] = (self._lease_clock
                                      + tr["deadline_ticks"])
            role = info.role
            hint = info.leader_hint
            for g, tr in list(self._xfer.items()):
                if not tr["armed"]:
                    continue
                outcome = None
                h = int(hint[g])
                if role[g] != LEADER and h == tr["target"]:
                    outcome = "completed"
                elif self._lease_clock >= tr["deadline"]:
                    # Deadline: leadership never settled on the target.
                    # If we still lead, drop the latch so intake
                    # re-opens; if we were deposed elsewhere the latch
                    # already self-cleared.
                    if role[g] == LEADER:
                        set_transfer_target(self.state, g, NO_XFER)
                    outcome = "aborted"
                elif role[g] != LEADER and 0 <= h != tr["target"]:
                    outcome = "aborted"    # someone else won
                if outcome is None:
                    continue
                del self._xfer[g]
                stall = self._tick_no - tr["start_tick"]
                if outcome == "completed":
                    self.metrics.transfers_completed += 1
                else:
                    self.metrics.transfers_aborted += 1
                self.metrics.note_transfer_stall(stall)
                self._xfer_events.append(
                    {"group": g, "from": tr["from"] + 1,
                     "to": tr["target"] + 1, "outcome": outcome,
                     "stall_ticks": int(stall), "tick": self._tick_no})

    def transferring_groups(self) -> set:
        """Groups with a leadership transfer in flight (hot-groups
        `transferring` flag)."""
        with self._xfer_lock:
            return set(self._xfer)

    def transfers_doc(self) -> dict:
        """In-flight latches + the recent-outcome log (flight bundles,
        `GET /metrics` debugging)."""
        with self._xfer_lock:
            inflight = {str(g): {"target": tr["target"] + 1,
                                 "from": tr["from"] + 1,
                                 "start_tick": tr["start_tick"]}
                        for g, tr in self._xfer.items()}
            recent = list(self._xfer_events)
        return {"in_flight": inflight, "recent": recent}

    def leader_of(self, group: int) -> int:
        """Last known leader (0-based peer), -1 if unknown.

        Served from the host-side per-tick cache: the tick thread
        replaces and patches `self.state` in place, so a client thread
        must never read a device leaf."""
        return int(self._last_hint[group])

    def status(self) -> dict:
        """Per-group consensus status for GET /healthz: role, last known
        leader (1-based, 0 unknown), term, and commit index.  Reads only
        the host-side per-tick caches (same client-thread contract as
        leader_of) — a readiness probe must never touch device state."""
        roles, hints, hard = self._status_view
        roles, hints = roles.tolist(), hints.tolist()
        return {
            str(g): {"role": _ROLE_NAMES.get(roles[g], "unknown"),
                     "leader": hints[g] + 1,
                     "term": int(hard[g, 0]),
                     "commit": int(hard[g, 2])}
            for g in range(self.cfg.num_groups)}

    # ------------------------------------------------------------------
    # linearizable reads (ReadIndex, raft §6.4 — beyond the reference's
    # stale-local-read model, db.go:128-130)

    # "No evidence" filler for the lease quorum sort: far below any
    # reachable lease clock, so a peer with no provable confirmation
    # can never contribute a lease-extending stamp (0 would alias the
    # boot-time clock and grant phantom boot leases).
    _NO_LEASE_CLOCK = -(1 << 40)

    def commit_watermark(self, group: int) -> int:
        """This node's current commit index for `group` — the
        replicated read-index watermark follower/session reads wait
        on (X-Raft-Session).  Host cache only; safe from any thread."""
        return int(self._hard_np[group, 2])

    def _lease_eval(self, group: int) -> Optional[Tuple[int, int]]:
        """(commit, remaining_ticks) of this node's leader lease for
        `group`, or None when no lease can be proved at all (leases
        disabled, not leader, §6.4 current-term-commit precondition
        pending).  remaining_ticks <= 0 means the lease has lapsed.

        The lease: each peer's newest seq echo at our current term
        names the newest round it confirmed; mapping seqs to the lease
        clock they departed at and taking the quorum-th largest gives
        the latest clock c at which a full quorum had confirmed our
        leadership (and, by the Phase-8 reset + prevote in-lease rule,
        cannot grant an election probe before c + election_ticks of
        its own clock).  Validity bound: now + max_clock_skew <
        c + lease_ticks."""
        cfg = self.cfg
        if cfg.lease_ticks <= 0 or self._last_role[group] != LEADER:
            return None
        term = int(self._hard_np[group, 0])
        commit = int(self._hard_np[group, 2])
        # try_term_of: client threads race the compactor; degrade, not
        # assert (same contract as read_index).
        if commit < 1 \
                or self.payload_log.try_term_of(group, commit) != term:
            return None
        with self._stage_lock:
            echo = self._resp_echo[group].copy()
            rterm = self._resp_term[group].copy()
        R = self._ROUND_RING
        clocks = np.full(self.num_nodes, self._NO_LEASE_CLOCK, np.int64)
        now = int(self._lease_clock)
        for p in range(self.num_nodes):
            if p == self.self_id:
                continue
            s = int(echo[p])
            if s <= 0 or int(rterm[p]) != term:
                continue
            if int(self._round_seq[s % R]) == s:
                clocks[p] = self._round_clock[s % R]
        clocks[self.self_id] = now
        mm = self.membership
        if mm is not None and not mm.is_default(group):
            q = mm.quorum_nth(group, clocks)
        else:
            # Lease evidence is WRITE-quorum evidence (append acks):
            # under flexible geometry the election quorum intersects
            # every write quorum, so write_size acks fence elections.
            q = int(np.sort(clocks)[self.num_nodes - cfg.write_size])
        return commit, (q + cfg.lease_ticks) - (now + cfg.max_clock_skew)

    def lease_read(self, group: int) -> Optional[int]:
        """Serve a linearizable read from the leader lease: returns the
        read's target commit index, or None when no valid lease covers
        `now + max_clock_skew` (the caller degrades to the ReadIndex
        round — never a silent stale read)."""
        ev = self._lease_eval(group)
        if ev is None:
            return None
        commit, remaining = ev
        if remaining > 0:
            self.metrics.lease_grants += 1
            return commit
        self.metrics.lease_expiries += 1
        return None

    # Cap on how far ahead a published lease deadline may reach: the
    # shm publisher refreshes every millisecond or two, so a short
    # horizon costs no availability while bounding how stale a mapped
    # deadline can be if tick pacing stalls right after a publish.
    _LEASE_HORIZON_S = 0.05

    def lease_deadline_s(self, group: int) -> float:
        """The time.monotonic() instant until which a lease read for
        `group` is provably safe, or 0.0 when no live lease.  This is
        the routing-hint / shm-snapshot surface (runtime/shm.py): the
        remaining lease ticks — already net of max_clock_skew, the
        same bound lease_read enforces — convert to wall time at the
        configured tick interval, capped at _LEASE_HORIZON_S.
        CLOCK_MONOTONIC is system-wide on Linux, so worker processes
        compare the published deadline against their own clock.  No
        metric side effects (this is a telemetry probe, not a served
        read)."""
        ev = self._lease_eval(group)
        if ev is None:
            return 0.0
        _commit, remaining = ev
        if remaining <= 0:
            return 0.0
        interval = max(self.cfg.tick_interval_s, 1e-4)
        return time.monotonic() + min(remaining * interval,
                                      self._LEASE_HORIZON_S)

    def read_index(self, group: int):
        """Register a linearizable read.

        Returns (target_index, registration_tick) when this node leads
        the group AND its commit covers an entry of its CURRENT term —
        raft §6.4's precondition: a fresh leader's commit index may
        still trail entries an earlier leader acked, until its own
        no-op commits.  Returns () when leading but that precondition
        is pending (caller should poll), or None when not leading
        (caller should redirect to `leader_of`)."""
        if self._last_role[group] != LEADER:
            return None
        # Nudge a broadcast round out on the next step: the quorum
        # confirmation (and, while the precondition is pending, the
        # no-op's replication) must not wait for the heartbeat interval.
        self._force_bcast = True
        self._work_evt.set()
        commit = int(self._hard_np[group, 2])
        term = int(self._hard_np[group, 0])
        # try_term_of: this runs on CLIENT threads racing the tick thread
        # and the compactor — a stale commit cache below the compaction
        # floor must degrade to "retry", not an assertion.
        if commit < 1 \
                or self.payload_log.try_term_of(group, commit) != term:
            return ()
        # The read's target is the leader's current commit index; the
        # quorum round that follows confirms no newer leader could have
        # committed past it before registration.  reg = tick_no + 1:
        # only rounds SENT strictly after this registration may confirm
        # it (a send earlier in the in-flight tick predates the commit
        # snapshot just taken).
        return commit, self._tick_no + 1

    def read_ready(self, group: int, reg_tick: int) -> bool:
        """True once a quorum confirmed our leadership on rounds STARTED
        at/after the registration: peers must have echoed a request seq
        >= reg_tick while at our current term.  Echo binding (not tick
        arithmetic) means a response delayed in flight from before the
        registration can never count.

        The (echo, term) pair is written under _stage_lock; reading
        under the same lock keeps the pairing consistent — a torn read
        could pair a new rejection's seq with the previous echo's term
        and count a deposing peer as a confirmation."""
        term = int(self._hard_np[group, 0])
        with self._stage_lock:
            echo = self._resp_echo[group].copy()
            rterm = self._resp_term[group].copy()
        ok = (echo >= reg_tick) & (rterm == term)
        mm = self.membership
        if mm is not None and not mm.is_default(group):
            # Mask-weighted confirmation (joint: both majorities).
            return mm.quorum_confirmed(group, ok, self.self_id)
        # ReadIndex confirmation is write-quorum sized: any election
        # quorum intersects it, so a confirmed round proves no newer
        # leader committed past the registration snapshot.
        return int(ok.sum()) + 1 >= self.cfg.write_size

    # ------------------------------------------------------------------
    # batched ReadIndex (PR 12): all linearizable reads registered
    # between two ticks share the ONE broadcast round the next tick
    # fires, so quorum cost is per-tick, not per-read.

    def read_join(self, group: int) -> Optional[_ReadBatch]:
        """Join the group's pending ReadIndex batch.  Returns a
        _ReadBatch whose `evt` fires once the shared round resolves —
        status "ok" with `target` the commit index to wait on, or
        "not_leader" (re-join or redirect via leader_of).  Returns
        None when this node does not currently lead the group.

        Unlike read_index, no commit snapshot is taken here: the tick
        thread stamps the batch's target at promotion, where commit
        state is frozen (commits only advance on that thread) and the
        confirming round is sent strictly afterwards."""
        if self._last_role[group] != LEADER:
            return None
        with self._rb_lock:
            b = self._rb_pending.get(group)
            if b is None:
                b = _ReadBatch(group)
                self._rb_pending[group] = b
            b.count += 1
        self._work_evt.set()     # promote on a prompt tick, not a timer
        return b

    def _rb_finish(self, b: _ReadBatch, status: str) -> bool:
        """Claim + publish a batch outcome exactly once; False when
        another thread already resolved it (the tick tail and transport
        deliveries race — metrics must count each batch once)."""
        with self._rb_lock:
            if b.status:
                return False
            b.status = status
            if self._rb_pending.get(b.group) is b:
                del self._rb_pending[b.group]
            lst = self._rb_active.get(b.group)
            if lst is not None:
                try:
                    lst.remove(b)
                except ValueError:
                    pass
                if not lst:
                    del self._rb_active[b.group]
        b.evt.set()
        return True

    def _rb_promote(self) -> List[int]:
        """Promote pending batches into this tick's broadcast (tick
        thread ONLY, before the device step: commits advance only on
        this thread, so the (term, commit) snapshot below is frozen,
        and this tick's round — seq = _tick_no — is sent strictly
        after it; that ordering is what makes reg = _tick_no a sound
        registration).  Returns every group whose broadcast must fire
        this tick: freshly promoted batches, batches still waiting on
        the §6.4 no-op, and active batches re-nudged against loss."""
        with self._rb_lock:
            pend = dict(self._rb_pending)
            groups = set(self._rb_active)
        for g, b in pend.items():
            if self._last_role[g] != LEADER:
                self._rb_finish(b, "not_leader")
                continue
            term = int(self._hard_np[g, 0])
            commit = int(self._hard_np[g, 2])
            if commit < 1 \
                    or self.payload_log.try_term_of(g, commit) != term:
                # §6.4 precondition pending: keep the batch joinable —
                # the round this tick fires replicates the no-op whose
                # commit clears the precondition for a later promote.
                groups.add(g)
                continue
            with self._rb_lock:
                if b.status:
                    continue
                if self._rb_pending.get(g) is b:
                    del self._rb_pending[g]     # cut off new joiners
                b.target = commit
                b.term = term
                b.reg = self._tick_no
                self._rb_active.setdefault(g, []).append(b)
            groups.add(g)
        return sorted(groups)

    def _rb_resolve(self) -> None:
        """Resolve active batches whose round completed: called from
        the tick tail and from _deliver (a peer echo may complete the
        quorum between ticks).  Never called under _stage_lock —
        read_ready re-takes it."""
        with self._rb_lock:
            if not self._rb_active:
                return
            items = [b for bs in self._rb_active.values() for b in bs]
        m = self.metrics
        for b in items:
            if b.status:
                continue
            g = b.group
            if self._last_role[g] != LEADER \
                    or int(self._hard_np[g, 0]) != b.term:
                self._rb_finish(b, "not_leader")
            elif self.read_ready(g, b.reg):
                if self._rb_finish(b, "ok"):
                    m.reads_read_index_batched += b.count
                    m.note_read_batch(b.count)

    def _rb_abort_all(self) -> None:
        """Fail every outstanding batch (node stopping): waiting client
        threads must unblock now, not at their deadlines."""
        with self._rb_lock:
            batches = list(self._rb_pending.values()) \
                + [b for bs in self._rb_active.values() for b in bs]
        for b in batches:
            self._rb_finish(b, "not_leader")

    # ------------------------------------------------------------------
    # log compaction (snapshot-resume mode, SURVEY.md §5.4 improvement)

    def compact(self, applied: Dict[int, int], keep: int = 256) -> bool:
        """Drop log prefixes covered by state-machine snapshots.

        `applied[g]` is the index durably applied by the snapshot-capable
        state machine.  Entries up to min(applied, commit) - keep are
        dropped from the payload log, COMPACT floor markers are appended
        to the WAL's active segment, and whole closed segments below
        every floor are unlinked (storage/wal.py compact) — never a
        stop-the-world rewrite of live data, so the tick's WAL phase is
        blocked only for the marker appends + unlinks.  The retained
        `keep` window lets slow followers catch up from the payload log;
        beyond it, the leader ships a full state transfer
        (InstallSnapshot, _send_phase).

        Returns True if anything was compacted.
        """
        # Never compact into the device ring window: the ordinary send
        # path slices payloads for any in-window prev index.
        keep = max(keep, self.cfg.log_window)
        with self._wal_lock:
            changed = False
            floors: Dict[int, Tuple[int, int]] = {}
            for g in range(self.cfg.num_groups):
                commit = int(self._hard_np[g, 2])
                floor = min(applied.get(g, 0), commit,
                            int(self._applied[g])) - keep
                if floor > self.payload_log.start(g):
                    # Persist the dedup window at the new floor FIRST:
                    # the pids at or below it become unrecoverable from
                    # the log the moment the prefix drops, and a replay
                    # without them re-applies any forward-retry
                    # duplicate retained above the floor (REC_DEDUP,
                    # storage/wal.py).  Rides the compaction barrier
                    # (wal.compact syncs after its markers).
                    self.wal.set_dedup(
                        g, floor, self._dedup[g].pairs_upto(floor))
                    self.payload_log.compact(
                        g, floor, self.payload_log.term_of(g, floor))
                    changed = True
                s = self.payload_log.start(g)
                if s > 0:
                    floors[g] = (s, self.payload_log.term_of(g, s))
            if not changed:
                return False
            hard = {g: tuple(int(x) for x in self._hard_np[g])
                    for g in range(self.cfg.num_groups)}
            self.wal.compact(floors, hard)
            self.metrics.compactions += 1
            return True

    # ------------------------------------------------------------------
    # transport plane

    # Column index per field in the packed [G, P, IB_NCOLS+E] staging
    # buffer (core/step.py MSG_FIELDS order; a_ents in the trailing E).
    _COL = {n: i for i, n in enumerate(MSG_FIELDS)}

    def _fresh_stage_cols(self) -> np.ndarray:
        G, P, E = (self.cfg.num_groups, self.num_nodes,
                   self.cfg.max_entries_per_msg)
        return np.zeros((G, P, IB_NCOLS + E), np.int32)

    def _stage_cols(self, src0: int, c) -> None:
        """Scatter one ColRecs into the packed staging buffer
        (stage-lock held).

        Row validation is one vectorized mask (bad groups dropped, same
        contract as the record path)."""
        G = self.cfg.num_groups
        C = self._COL
        if c.n_votes():
            m = (c.v_group >= 0) & (c.v_group < G)
            g = c.v_group[m]
            s = self._stg
            s[g, src0, C["v_type"]] = c.v_type[m]
            s[g, src0, C["v_term"]] = c.v_term[m]
            s[g, src0, C["v_last_idx"]] = c.v_last_idx[m]
            s[g, src0, C["v_last_term"]] = c.v_last_term[m]
            s[g, src0, C["v_granted"]] = c.v_granted[m]
        if c.n_appends():
            m = (c.a_group >= 0) & (c.a_group < G)
            g = c.a_group[m]
            s = self._stg
            s[g, src0, C["a_type"]] = c.a_type[m]
            s[g, src0, C["a_term"]] = c.a_term[m]
            s[g, src0, C["a_prev_idx"]] = c.a_prev_idx[m]
            s[g, src0, C["a_prev_term"]] = c.a_prev_term[m]
            s[g, src0, C["a_commit"]] = c.a_commit[m]
            s[g, src0, C["a_success"]] = c.a_success[m]
            s[g, src0, C["a_match"]] = c.a_match[m]
            self._stg_a_arr[g, src0] = self._arrival
            seq = c.a_seq[m]
            # Seq is the ReadIndex round binding: only REQ rows may set
            # it (we echo the seq of the request we answer).  A response
            # row's seq is the SENDER's tick number — writing it here
            # last-writer-wins could inflate the echo past rounds the
            # peer ever sent, letting read_ready() confirm a ReadIndex
            # with no real quorum round (stale linearizable read).
            req = c.a_type[m] == MSG_REQ
            if req.any():
                self._stg_a_seq[g[req], src0] = seq[req]
            # ReadIndex round bookkeeping for columnar responses.
            rm = (c.a_type[m] == MSG_RESP) & (seq > 0)
            if rm.any():
                rg = g[rm]
                newer = seq[rm] > self._resp_echo[rg, src0]
                rg2 = rg[newer]
                self._resp_echo[rg2, src0] = seq[rm][newer]
                self._resp_term[rg2, src0] = c.a_term[m][rm][newer]

    def _deliver(self, src: int, batch: TickBatch) -> None:
        """Stage inbound records; newest message per (group, src, slot)
        wins, mirroring the dense Inbox overwrite semantics.

        Records that don't fit this node's configuration (unknown group,
        oversized entry batch, bad src) are dropped, not fatal: a
        misconfigured or malicious peer must not tear down this node
        (cf. the reference trusting rafthttp framing, raft.go:268-270)."""
        G, E = self.cfg.num_groups, self.cfg.max_entries_per_msg
        src0 = src - 1
        if not (0 <= src0 < self.num_nodes) or src0 == self.self_id:
            log.warning("node %d: dropping batch from bad src %d",
                        self.node_id, src)
            return
        with self._stage_lock:
            self._arrival += 1
            arrival = self._arrival
            if batch.cols is not None or batch.votes or batch.appends \
                    or batch.snapshots:
                self._stage_dirty = True
            if batch.cols is not None:
                self._stage_cols(src0, batch.cols)
            for v in batch.votes:
                if 0 <= v.group < G:
                    self._stage_votes[(v.group, src0)] = v
            for a in batch.appends:
                if 0 <= a.group < G and a.n <= E \
                        and len(a.payloads) in (0, a.n):
                    self._stage_apps[(a.group, src0)] = a
                    self._stage_app_arr[(a.group, src0)] = arrival
                    if a.type == MSG_RESP and a.seq:
                        # ReadIndex round bookkeeping: newest request-seq
                        # this peer has answered, and at what term.
                        if a.seq > self._resp_echo[a.group, src0]:
                            self._resp_echo[a.group, src0] = a.seq
                            self._resp_term[a.group, src0] = a.term
            for s in batch.snapshots:
                if 0 <= s.group < G:
                    old = self._stage_snaps.get(s.group)
                    if old is None or s.last_idx > old.last_idx:
                        self._stage_snaps[s.group] = s
        if batch.proposals:
            with self._prop_lock:
                for pr in batch.proposals:
                    if 0 <= pr.group < G:
                        self._props[pr.group].append(pr.payload)
                        self._prop_len[pr.group] += 1
                        self._fwd_groups.add(pr.group)
        # This delivery may have carried the echo that completes an
        # active read batch's quorum — resolve NOW (sub-tick read
        # latency), outside _stage_lock (read_ready re-takes it).
        if self._rb_active:
            self._rb_resolve()
        self._work_evt.set()

    # ------------------------------------------------------------------
    # the event loop

    def _run(self) -> None:
        """Event-driven loop with step elision.

        Three kinds of wakeup:
          - WORK (the _work_evt fires): proposals or peer batches
            arrived — step immediately, carrying any timer advance
            accumulated so far (timer_inc = pending).
          - TIMER (interval elapsed): accumulate one tick of timer
            advance; only run a step once the accumulated advance
            reaches the device-reported margin (info.timer_margin — the
            soonest any election/heartbeat timer could fire).  An idle
            node therefore steps about once per heartbeat interval, not
            once per tick interval.
          - STOP.

        The interval-paced timer advance keeps the reference's
        real-time raft semantics (100 ms Tick() cadence, raft.go:207);
        work steps with timer_inc=0 only accelerate message/proposal
        processing between timer boundaries."""
        prof_dir = os.environ.get("RAFTSQL_PROFILE")
        prof = None
        if prof_dir:                     # tick-thread cProfile (§5.1)
            import cProfile
            prof = cProfile.Profile()
            prof.enable()
            prof_path = os.path.join(
                prof_dir, f"raftsql-node{self.node_id}-tick.prof")
            prof_next = time.monotonic() + 5.0
        interval = self.cfg.tick_interval_s
        anchor = time.monotonic()        # last instant pending was credited
        pending = 1                      # first step advances timers
        while not self._stop_evt.is_set():
            if prof is not None and time.monotonic() >= prof_next:
                prof.disable()
                try:
                    prof.dump_stats(prof_path)
                except OSError as e:   # diagnostics must not kill ticks
                    log.warning("profile dump failed: %s", e)
                    prof = None
                else:
                    prof.enable()
                    prof_next = time.monotonic() + 5.0
            now = time.monotonic()
            if interval > 0:
                k = int((now - anchor) / interval)
                if k > 0:
                    # Cap at the margin: after a host stall, elapsed
                    # real time beyond the soonest possible timer fire
                    # must not replay as a burst of catch-up advances
                    # (a timer fires at most once per step anyway).
                    pending = min(pending + k, max(self._timer_margin, 1))
                    anchor += k * interval
                    if anchor < now - interval:
                        anchor = now
            else:
                pending = 1              # untimed config: step each loop
            if self._work_evt.is_set() or pending >= self._timer_margin \
                    or interval <= 0:
                # Clear BEFORE the step: work staged after this point
                # leaves the event set and the wait below returns
                # immediately; work staged before it is consumed by
                # this step.
                self._work_evt.clear()
                try:
                    self.tick(timer_inc=pending)
                except Exception as e:   # pragma: no cover - defensive
                    log.exception("node %d tick failed", self.node_id)
                    self._on_error(e)
                    return
                pending = 0
            # Sleep until the accumulated advance could reach the margin
            # (one heartbeat/election horizon away), or work arrives.
            need = max(self._timer_margin - pending, 1)
            wait = (anchor + need * interval) - time.monotonic()
            if wait > 0:
                self._work_evt.wait(wait)

    def tick(self, advance_timers: bool = True,
             timer_inc: Optional[int] = None) -> None:
        """One full consensus tick: stage → step → WAL → send → publish.

        `timer_inc` is how many tick intervals of election/heartbeat
        timer advance this step applies (see core/step.py); the event
        loop passes its accumulated count.  The boolean shorthand
        `advance_timers` (used by tests and direct drivers) means
        timer_inc=1/0.

        Each phase's wall time accumulates into NodeMetrics (exported via
        GET /metrics as per-tick averages — SURVEY.md §5.1's live-runtime
        profiling), so a slow tick localizes to device step vs WAL fsync
        vs transport vs publish without a profiler attached."""
        if timer_inc is None:
            timer_inc = 1 if advance_timers else 0
        cfg = self.cfg
        G, P, E = cfg.num_groups, cfg.num_peers, cfg.max_entries_per_msg
        m = self.metrics

        # Lease round bookkeeping: this tick's outgoing REQs carry
        # seq = _tick_no; remember the lease clock they depart at
        # (clock first, seq second — a torn cross-thread read then
        # fails the seq match and degrades, never inflates a lease).
        slot = self._tick_no % self._ROUND_RING
        self._round_clock[slot] = self._lease_clock
        self._round_seq[slot] = self._tick_no
        self._lease_clock += timer_inc

        # Staging (snapshot installs + inbox build) is timed separately
        # from the device step — a multi-MB install must not read as "the
        # device step got slow" in /metrics.
        ts = time.monotonic()
        self._install_snapshots()
        inbox, tick_apps = self._build_inbox()
        self._tick_apps = tick_apps

        with self._prop_lock:
            prop_n = np.minimum(self._prop_len, E)
        t0 = time.monotonic()
        m.t_stage_ms += (t0 - ts) * 1e3

        # Promote pending ReadIndex batches into this tick's round and
        # build the force-broadcast [G] mask: the legacy whole-node
        # nudge (read_index) broadcasts everywhere — bitwise what the
        # old scalar True did — while batch work narrows the nudge to
        # just the groups with reads in flight.  The idle path reuses
        # the cached all-False mask: no per-tick allocation, and the
        # step's trajectory is bit-identical to the pre-batcher code.
        rb_groups = self._rb_promote() \
            if (self._rb_pending or self._rb_active) else []
        fb = self._force_bcast
        if fb:
            self._force_bcast = False
        dev = self.device
        if fb or not rb_groups:
            fb_arg = self._fb_arr[fb]
        else:
            fb_mask = np.zeros(G, bool)
            fb_mask[rb_groups] = True
            fb_arg = torch.from_numpy(fb_mask).to(dev)
        ti = self._ti_arr.get(timer_inc)
        if ti is None:
            ti = self._ti_arr[timer_inc] = torch.tensor(
                timer_inc, dtype=torch.int32, device=dev)
        pn = torch.from_numpy(prop_n.astype(np.int32)).to(dev) \
            if prop_n.any() else self._zero_prop
        with RaftNode._STEP_LOCK:
            state, pob, pinfo, nidx, margin = peer_step_packed(
                cfg, self.state, inbox, pn, self._self_arr, ti, fb_arg)
            pob, pinfo, nidx, margin = self._readback(pob, pinfo, nidx,
                                                      margin)
        self.state = state
        outbox = _view_outbox(pob)
        info = _view_info(pinfo, nidx)
        self._next_idx = nidx           # promote catch-up gate cache
        self._timer_margin = max(int(margin), 1)
        t1 = time.monotonic()

        with self._wal_lock:
            self._wal_phase(info)       # durable …
        t2 = time.monotonic()
        self._send_phase(outbox, info)  # … before sent …
        t3 = time.monotonic()
        self._publish_phase(info)       # … before published.
        self._membership_tick(info)     # joint-transition driver
        self._transfer_tick(info)       # leadership-transfer driver
        t4 = time.monotonic()
        m.t_device_ms += (t1 - t0) * 1e3
        m.t_wal_ms += (t2 - t1) * 1e3
        m.t_send_ms += (t3 - t2) * 1e3
        m.t_publish_ms += (t4 - t3) * 1e3
        role = np.asarray(info.role)
        m.elections_won += int(((role == LEADER)
                                & (self._prev_role != LEADER)).sum())
        self._prev_role = role
        self._last_role = role
        self._last_hint = np.asarray(info.leader_hint)
        self._status_view = (role, self._last_hint, self._hard_np.copy())
        self._tick_no += 1
        m.ticks += 1
        # Resolve read batches against the freshest role/echo state:
        # covers quorum=1 (read_ready is immediately true) and role
        # loss; multi-node quorums usually resolve from _deliver when
        # the round's echoes arrive.
        if self._rb_active:
            self._rb_resolve()
        # Re-arm the loop when a leader still has proposal backlog past
        # the per-step E cap (progress was made, more to drain now); a
        # leaderless backlog must NOT spin — it drains once election
        # timers (interval-paced) produce a leader.
        if int(np.asarray(info.prop_accepted).sum()) > 0:
            with self._prop_lock:
                leftover = int(self._prop_len.sum()) > 0
            if leftover:
                self._work_evt.set()

    @staticmethod
    def _readback(pob: torch.Tensor, pinfo: torch.Tensor,
                  nidx: torch.Tensor, margin: torch.Tensor):
        """The step's four outputs in ONE device-to-host copy (core/state.py
        host_copy), flattened into one int32 tensor on the device first.
        Returns numpy (outbox [G, P, IB_NCOLS+E], info [G, INFO_NCOLS],
        next_idx [G, P], margin int)."""
        parts = (pob, pinfo, nidx, margin)
        arr = host_copy(torch.cat([x.reshape(-1).to(torch.int32)
                                   for x in parts]))
        out, off = [], 0
        for x in parts[:3]:
            n = x.numel()
            out.append(arr[off:off + n].reshape(tuple(x.shape)))
            off += n
        return out[0], out[1], out[2], int(arr[off])

    # -- tick phases -----------------------------------------------------

    def _install_snapshots(self) -> None:
        """Apply staged InstallSnapshot transfers (receiver side).

        Only installs strictly ahead of both the local applied point and
        the device commit — snapshots carry committed state, so this
        never regresses; stale/duplicate transfers are dropped.
        """
        if self.snapshot_installer is None:
            # The apply layer registers the installer shortly after node
            # start; keep transfers staged instead of dropping them so a
            # snapshot arriving in that boot window still installs.
            return
        with self._stage_lock:
            snaps, self._stage_snaps = self._stage_snaps, {}
        if not snaps:
            return
        commit = term = None
        for g, rec in snaps.items():
            if commit is None:
                # Host copies (the state is patched in place below);
                # adopted terms are folded back into `term` so a second
                # staged snapshot for the same group sees them.
                commit = self.state.commit.to("cpu", copy=True).numpy()
                term = self.state.term.to("cpu", copy=True).numpy()
            if rec.term < int(term[g]):
                # Raft: reject any RPC whose term < currentTerm — a
                # delayed transfer from a deposed leader must not demote
                # a current-term leader or truncate its tail.
                continue
            if rec.term > int(term[g]):
                # A valid higher-term RPC steps this group down on
                # RECEIPT (raft §5.1), even if the transfer itself turns
                # out to be a duplicate or corrupt below.
                st = self.state                  # in place
                st.term[g] = rec.term
                st.voted_for[g] = NO_VOTE
                st.role[g] = FOLLOWER
                st.votes[g] = False
                term[g] = rec.term
            if rec.last_idx <= max(self._applied[g], int(commit[g])):
                continue
            conf, inner = unwrap_snapshot_conf(rec.blob)
            pairs, sm_blob = unwrap_snapshot(inner)
            try:
                self.snapshot_installer(g, rec.last_idx, sm_blob)
            except Exception as e:
                # A corrupt/truncated transfer must not tear down the
                # node (cf. the _deliver contract); drop it — the leader
                # re-sends after its cooldown.
                log.warning("node %d g%d: snapshot install failed (%s); "
                            "dropped", self.node_id, g, e)
                continue
            # Counted at SM-install time: observers (tests, operators)
            # see the data the moment the state machine has it, while the
            # device-state patch below may still be compiling.
            self.metrics.snapshots_installed += 1
            if pairs is not None:
                # Adopt the sender's dedup window at the transfer point,
                # keeping exactly-once across the state jump.
                self._dedup[g].restore(pairs)
            # The whole install — payload-log reset, WAL marker, device
            # patch, applied floor — is one atomic unit vs. compact()'s
            # multi-call read of the payload log (it holds _wal_lock for
            # its image build); a reset racing that read corrupts the
            # rewritten WAL.
            with self._wal_lock:
                self.payload_log.reset(g, rec.last_idx, rec.last_term)
                self.wal.set_snapshot(g, rec.last_idx, rec.last_term)
                if pairs is not None:
                    # The adopted window must survive a restart too: the
                    # skipped log range below the install boundary can
                    # hold first copies of duplicates retained above it.
                    self.wal.set_dedup(g, rec.last_idx, pairs)
                self.wal.sync()
                install_snapshot_state(self.state, g, rec.last_idx,
                                       rec.last_term, rec.term)  # in place
                self._applied[g] = rec.last_idx
            if conf is not None and self.membership is not None:
                # Adopt the sender's active config at the transfer
                # point (the skipped log range may contain the conf
                # entries that built it).
                cidx, centry = conf
                if self.membership.apply(g, cidx, centry) is not None:
                    self._patch_group_config(g)
            if self._local[g]:
                # Our uncommitted leader-era proposals may or may not be
                # inside the installed state; requeue them all — the
                # transferred dedup window skips any that were, and the
                # rest get their honest retry.
                with self._prop_lock:
                    self._props[g].extendleft(
                        reversed([d for (_, d) in self._local[g]]))
                    self._prop_len[g] += len(self._local[g])
                    self._fwd_groups.add(g)
                self._local[g] = []
            log.info("node %d g%d: installed snapshot at idx %d",
                     self.node_id, g, rec.last_idx)

    def _build_inbox(self):
        """Drain staging into ONE packed [G, P, IB_NCOLS+E] device tensor
        (core/step.py unpack_inbox).  Clean steps (nothing staged since
        the last build) reuse the prebuilt all-zero device tensor — the
        step never writes its inbox, so the same tensor serves every
        clean step and the build costs nothing."""
        cfg = self.cfg
        E = cfg.max_entries_per_msg
        C = self._COL
        with self._stage_lock:
            clean = not self._stage_dirty
        if clean:
            self._tick_seq = self._zero_seq
            return self._zero_inbox, {}
        with self._stage_lock:
            self._stage_dirty = False
            votes, apps = self._stage_votes, self._stage_apps
            app_arr = self._stage_app_arr
            self._stage_votes, self._stage_apps = {}, {}
            self._stage_app_arr = {}
            # The packed columnar staging buffer becomes the inbox base
            # (no copy — a fresh buffer replaces it for the next window);
            # the record dicts overlay it below.  Ownership transfers
            # here: after this drain only this thread touches `stg`, so
            # the single host-to-device copy below can never race a
            # concurrent _deliver scatter.  Columnar appends are always n == 0.
            stg = self._stg
            seq_arr = self._stg_a_seq
            col_arr = self._stg_a_arr
            self._stg = self._fresh_stage_cols()
            self._stg_a_seq = np.zeros_like(seq_arr)
            self._stg_a_arr = np.zeros_like(col_arr)
        for (g, s), v in votes.items():
            stg[g, s, C["v_type"]] = v.type
            stg[g, s, C["v_term"]] = v.term
            stg[g, s, C["v_last_idx"]] = v.last_idx
            stg[g, s, C["v_last_term"]] = v.last_term
            stg[g, s, C["v_granted"]] = v.granted
        stale: List[Tuple[int, int]] = []
        for (g, s), a in apps.items():
            if app_arr.get((g, s), 0) < col_arr[g, s]:
                # A columnar message for this slot arrived AFTER the
                # record was staged: the newer arrival wins, whatever its
                # form.  (An older record REQ displacing a newer columnar
                # response would also mis-bind the seq echo below.)
                stale.append((g, s))
                continue
            stg[g, s, C["a_type"]] = a.type
            stg[g, s, C["a_term"]] = a.term
            stg[g, s, C["a_prev_idx"]] = a.prev_idx
            stg[g, s, C["a_prev_term"]] = a.prev_term
            stg[g, s, C["a_n"]] = a.n
            stg[g, s, C["a_commit"]] = a.commit
            stg[g, s, C["a_success"]] = a.success
            stg[g, s, C["a_match"]] = a.match
            stg[g, s, IB_NCOLS:IB_NCOLS + a.n] = a.ent_terms[:a.n]
            if a.type == MSG_REQ:
                # Bind the seq echo to the request the device will
                # actually process (the record overlays the columnar
                # base, so its seq must overlay too).
                seq_arr[g, s] = a.seq
        for k in stale:
            del apps[k]
        self._tick_seq = seq_arr
        return torch.from_numpy(stg).to(self.device), apps

    def _wal_phase(self, info) -> None:
        """Persist this tick's appends + hard-state changes, one fsync.

        Vectorized over groups: numpy masks pick out only the groups that
        did something this tick (leader append, accepted follower append,
        hard-state delta), so an idle group costs zero Python work — the
        round-1/2 hot loop was O(G) every tick regardless of activity.
        Entry records accumulate across all groups into ONE batched WAL
        call of uniform-term RANGE runs (type-5 records, the same ~4x
        framing cut the fused tick measured — storage/wal.py module
        doc), framed without a per-record Python round trip on the C++
        fast path (native/wal.cc)."""
        term = np.asarray(info.term)
        noop = np.asarray(info.noop)
        prop_acc = np.asarray(info.prop_accepted)
        app_from = np.asarray(info.app_from)
        mm = self.membership
        w_rg: List[int] = []         # RANGE runs: group, start, count,
        w_rs: List[int] = []         # term — plus the flat per-entry
        w_rc: List[int] = []         # payload list in run order.
        w_rt: List[int] = []
        w_data: List[bytes] = []

        def put_run(g: int, start: int, count: int, t: int) -> None:
            w_rg.append(g)
            w_rs.append(start)
            w_rc.append(count)
            w_rt.append(t)

        active = np.nonzero(noop | (prop_acc > 0) | (app_from >= 0))[0]
        # ONE lock hold pops every group's accepted proposals (a per-group
        # acquire inside the loop was ~256 lock round trips per saturated
        # tick at the G=10k/256-active bench shape).
        acc = np.nonzero(prop_acc > 0)[0]
        popped: Dict[int, List[bytes]] = {}
        if acc.size:
            with self._prop_lock:
                for g in acc.tolist():
                    n = int(prop_acc[g])
                    q = self._props[g]
                    popped[g] = [q.popleft() for _ in range(n)]
                    self._prop_len[g] -= n
        for g in active.tolist():
            n_acc = int(prop_acc[g])
            if noop[g] or n_acc:
                base = int(info.prop_base[g])
                t_g = int(term[g])
                if noop[g]:
                    put_run(g, base, 1, t_g)
                    w_data.append(b"")
                    self.payload_log.put(g, base, [b""], [t_g])
                if n_acc:
                    batch = popped[g]
                    # One uniform-term run for the whole accepted batch
                    # (leader appends share the leader's term).
                    put_run(g, base + 1, n_acc, t_g)
                    w_data.extend(batch)
                    self._local[g].extend(
                        zip(range(base + 1, base + 1 + n_acc), batch))
                    self.payload_log.put(g, base + 1, batch,
                                         [t_g] * n_acc)
                    if mm is not None:
                        # Conf entries entering the log as LEADER
                        # appends: index them for apply-at-commit (one
                        # leading-byte test per accepted proposal).
                        for off, d in enumerate(batch):
                            if d[:1] == _CONF_PREFIX and is_conf_entry(d):
                                mm.note_appended(g, base + 1 + off, d)
                    if self.tracer is not None:
                        # Bind spans to their log indexes (envelope
                        # stripped — spans are keyed by plain content).
                        self.tracer.note_append(
                            g, base + 1,
                            [unwrap(p)[1].decode("utf-8", "replace")
                             for p in batch])
                self.metrics.proposals += n_acc
            src = int(app_from[g])
            if src >= 0:
                rec = self._tick_apps.get((g, src))
                if rec is None:      # staged slot raced away; next resend
                    continue         # re-delivers — raft tolerates loss
                start = int(info.app_start[g])
                new_len = int(info.new_log_len[g])
                n_app = int(info.app_n[g])
                for (rs, rc, rt) in split_uniform_runs(
                        start, rec.ent_terms[:n_app]):
                    put_run(g, rs, rc, rt)
                w_data.extend(rec.payloads[:n_app])
                if self.witness_self and n_app:
                    self.metrics.witness_appends += n_app
                self.payload_log.put(g, start, rec.payloads,
                                     rec.ent_terms, new_len=new_len)
                if mm is not None:
                    if info.app_conflict[g]:
                        # Clobbered suffix: conf entries in it never
                        # commit here.
                        mm.note_truncated(g, start)
                    # Conf entries entering as FOLLOWER appends (normal
                    # replication or host catch-up).
                    for off, d in enumerate(rec.payloads[:n_app]):
                        if d[:1] == _CONF_PREFIX and is_conf_entry(d):
                            mm.note_appended(g, start + off, d)
                if info.app_conflict[g] and self._local[g]:
                    # The new leader's suffix clobbered entries we
                    # appended as a (now deposed) leader: requeue their
                    # payloads for a fresh propose/forward round.
                    mine = self._local[g]
                    requeue = [d for (ix, d) in mine if ix >= start]
                    if requeue:
                        with self._prop_lock:
                            self._props[g].extendleft(reversed(requeue))
                            self._prop_len[g] += len(requeue)
                            self._fwd_groups.add(g)
                    self._local[g] = [(ix, d) for (ix, d) in mine
                                      if ix < start]
                if info.app_conflict[g] and self._applied[g] >= start:
                    # Should be unreachable since replay stopped
                    # publishing the uncommitted tail (committed entries
                    # never conflict-truncate); kept as a loud guard —
                    # the reference applies at append and has exactly
                    # this hazard (SURVEY.md §3.2 quirk).
                    log.warning("node %d g%d: conflict truncation below "
                                "applied=%d; state machine may have seen "
                                "an uncommitted entry", self.node_id, g,
                                self._applied[g])
                    self._applied[g] = min(self._applied[g], start - 1)
        # Hard-state delta detection is one vectorized compare over [G, 3].
        hs = np.stack([term, np.asarray(info.voted_for),
                       np.asarray(info.commit)], axis=1)
        hard_changed = np.nonzero((hs != self._hard_np).any(axis=1))[0]
        # Entries land before hard states (etcd wal.Save order): a torn
        # tail can then never leave a hard state referencing lost entries.
        if w_rg:
            self.wal.append_ranges(w_rg, w_rs, w_rc, w_rt, w_data)
        if hard_changed.size:
            self.wal.set_hardstates(hard_changed, hs[hard_changed, 0],
                                    hs[hard_changed, 1],
                                    hs[hard_changed, 2])
            self._hard_np[hard_changed] = hs[hard_changed]
        self.wal.sync()

    def _build_catchups(self, info) -> Dict[Tuple[int, int], AppendRec]:
        """Host-built AppendEntries for followers beyond the device ring.

        The device term ring only describes the last W log positions; a
        follower whose next_idx has fallen out of that window gets empty
        heartbeats from the device (core/step.py Phase 9 window guard).
        The leader HOST owns the full (term, payload) history
        (storage/log.py), so it constructs the out-of-window appends here
        — the analog of etcd MemoryStorage-backed sendAppend for entries
        the in-memory window no longer covers.  Responses flow back
        through the normal device path, advancing next_idx/match until
        the follower re-enters the window.
        """
        cfg = self.cfg
        W, E = cfg.log_window, cfg.max_entries_per_msg
        self._snap_due = []
        role = np.asarray(info.role)
        if not (role == LEADER).any():
            return {}
        next_idx = np.asarray(info.next_idx)            # [G, P]
        log_len = np.asarray(info.new_log_len)          # [G]
        commit = np.asarray(info.commit)
        term = np.asarray(info.term)
        # Margin of 2E: start host catch-up slightly before the hard edge
        # of the ring so a race with concurrent appends cannot strand the
        # follower on garbage ring reads.  The transition-table floor is
        # a second, independent send-suppression edge (core/step.py
        # in_window requires min_acc >= floor): more than K term
        # transitions in the window raise it above the ring edge, and a
        # follower below it would otherwise only ever see empty
        # heartbeats.  Its lag test is the exact complement of the
        # device guard (min_acc = max(next_idx-1, 1) for a non-empty
        # send), needs no race margin — info.floor IS the floor this
        # tick's sends were gated on — and is gated on the follower
        # actually having entries to fetch, which keeps healthy
        # followers out of the scan.
        floor = np.asarray(info.floor)                  # [G]
        lag = (role == LEADER)[:, None] & (next_idx >= 1) \
            & ((next_idx - 1 <= log_len[:, None] - W + 2 * E)
               | ((next_idx <= log_len[:, None])
                  & (np.maximum(next_idx - 1, 1) < floor[:, None])))
        lag[:, self.self_id] = False
        # Prune pacing state for peers that caught back up (its purpose
        # is served) and stale snapshot cooldowns (any in-flight transfer
        # resolves within a few cooldowns) — both maps are bounded at
        # O(G*P) but would otherwise hold dead entries forever.
        if self._catchup_sent:
            for k in [k for k in self._catchup_sent if not lag[k]]:
                del self._catchup_sent[k]
        if self._snap_sent:
            horizon = self._tick_no - 128 * self.cfg.election_ticks
            for k in [k for k, t in self._snap_sent.items()
                      if t < horizon]:
                del self._snap_sent[k]
        out: Dict[Tuple[int, int], AppendRec] = {}
        for g, d in zip(*np.nonzero(lag)):
            g, d = int(g), int(d)
            ni = int(next_idx[g, d])
            prev_sent = self._catchup_sent.get((g, d))
            if prev_sent is not None and prev_sent[0] == ni \
                    and self._tick_no - prev_sent[1] < 4:
                continue        # no progress yet; give the ack time
            avail = self.payload_log.length(g)
            n = min(E, avail - ni + 1)
            got = self.payload_log.try_tail_with_terms(g, ni, n) \
                if n > 0 else None
            if got is None:
                if ni <= self.payload_log.start(g):
                    # Beyond the compacted prefix: needs a full state
                    # transfer (InstallSnapshot), queued by _send_phase.
                    self._snap_due.append((g, d, int(term[g])))
                continue
            prev_term, ents = got
            self._catchup_sent[(g, d)] = (ni, self._tick_no)
            if self.tracer is not None and ents:
                self.tracer.note_replicate(g, ni - 1 + len(ents))
            out[(g, d)] = AppendRec(
                group=g, type=MSG_REQ, term=int(term[g]),
                prev_idx=ni - 1, prev_term=prev_term,
                ent_terms=[t for (t, _) in ents],
                payloads=[p for (_, p) in ents],
                commit=min(int(commit[g]), ni - 1 + len(ents)),
                seq=self._tick_no)
            self.metrics.catchup_appends += 1
        return out

    def _send_phase(self, outbox, info) -> None:
        cfg = self.cfg
        batches: Dict[int, TickBatch] = {}

        def batch_for(dst0: int) -> TickBatch:
            return batches.setdefault(dst0, TickBatch())

        catchups = self._build_catchups(info)

        # Columnar emission (transport/base.py ColRecs): votes and
        # payload-free appends (heartbeats + all responses) ship as
        # fancy-indexed numpy column arrays — zero per-message Python.
        # Only payload-carrying appends (count ∝ real replication
        # traffic) and catch-up substitutions take the record path.
        vg, vd = np.nonzero(outbox.v_type)
        if vg.size:
            v_cols = {f: np.ascontiguousarray(
                getattr(outbox, "v_" + f)[vg, vd], dtype=np.int32)
                for f in ("type", "term", "last_idx", "last_term",
                          "granted")}
            for d in np.unique(vd).tolist():
                rows = vd == d
                b = batch_for(d)
                if b.cols is None:
                    b.cols = ColRecs()
                b.cols.v_group = np.ascontiguousarray(vg[rows],
                                                      dtype=np.int32)
                for f, col in v_cols.items():
                    setattr(b.cols, "v_" + f, col[rows])

        ag, ad = np.nonzero(outbox.a_type)
        emitted = set()
        if ag.size:
            a_type_r = np.asarray(outbox.a_type[ag, ad])
            a_n_r = np.asarray(outbox.a_n[ag, ad])
            # Record path: REQs that carry entries, or whose slot has a
            # pending host catch-up to substitute.
            is_req = a_type_r == MSG_REQ
            rec_rows = is_req & (a_n_r > 0)
            if catchups:
                cu_mask = np.zeros((cfg.num_groups, self.num_nodes), bool)
                for (g, d) in catchups:
                    cu_mask[g, d] = True
                rec_rows |= is_req & cu_mask[ag, ad]
            col_rows = ~rec_rows
            if col_rows.any():
                # seq: REQs carry this tick's number; responses echo the
                # seq of the staged request they answer (ReadIndex round
                # binding, same contract as the record path).
                seq_all = np.where(is_req, np.int64(self._tick_no),
                                   self._tick_seq[ag, ad])
                a_cols = {f: np.ascontiguousarray(
                    getattr(outbox, "a_" + f)[ag, ad], dtype=np.int32)
                    for f in ("type", "term", "prev_idx", "prev_term",
                              "commit", "success", "match")}
                for d in np.unique(ad[col_rows]).tolist():
                    rows = col_rows & (ad == d)
                    b = batch_for(d)
                    if b.cols is None:
                        b.cols = ColRecs()
                    b.cols.a_group = np.ascontiguousarray(
                        ag[rows], dtype=np.int32)
                    for f, col in a_cols.items():
                        setattr(b.cols, "a_" + f, col[rows])
                    b.cols.a_seq = np.ascontiguousarray(
                        seq_all[rows], dtype=np.int64)
            ridx = np.nonzero(rec_rows)[0]
            rg, rd = ag[ridx], ad[ridx]
            a_ents_rows = np.asarray(outbox.a_ents[rg, rd]) \
                if ridx.size else None
            for i, (g, d, tm, prev, pt, n, cm) in enumerate(
                    zip(rg.tolist(), rd.tolist(),
                        np.asarray(outbox.a_term[rg, rd]).tolist(),
                        np.asarray(outbox.a_prev_idx[rg, rd]).tolist(),
                        np.asarray(outbox.a_prev_term[rg, rd]).tolist(),
                        a_n_r[ridx].tolist(),
                        np.asarray(outbox.a_commit[rg, rd]).tolist())):
                cu = catchups.pop((g, d), None)
                if cu is not None:
                    # The device could only offer an empty heartbeat to
                    # this out-of-window follower; substitute the
                    # host-built catch-up append (same slot, newest-wins
                    # semantics).
                    batch_for(d).appends.append(cu)
                    continue
                # The device ring can reference positions below the
                # payload floor (log-length regression after conflict
                # truncation / snapshot install, or a concurrent
                # compaction advancing the floor).  try_slice is
                # atomic against the compactor; on miss, drop the
                # message — the peer is served by catch-up or
                # snapshot on a later tick.
                payloads = self.payload_log.try_slice(g, prev + 1, n)
                if payloads is None:
                    continue
                if self.tracer is not None and n:
                    # Replicate stamp: the entries left for a follower
                    # (first transmission wins per index).
                    self.tracer.note_replicate(g, prev + n)
                batch_for(d).appends.append(AppendRec(
                    group=g, type=MSG_REQ, term=tm,
                    prev_idx=prev, prev_term=pt,
                    ent_terms=a_ents_rows[i, :n].tolist(),
                    payloads=payloads, commit=cm,
                    seq=self._tick_no))
            if catchups:
                emitted_mask = np.zeros(
                    (cfg.num_groups, self.num_nodes), bool)
                emitted_mask[ag, ad] = True
                emitted = {k for k in catchups if emitted_mask[k]}
        for (g, d), cu in catchups.items():
            if (g, d) in emitted:
                # The device emitted a (response) message for this slot;
                # the receiver stages one append per (group, src), newest
                # wins — don't clobber it.  Un-record the pacing entry so
                # the catch-up is rebuilt next tick, not in 4.
                self._catchup_sent.pop((g, d), None)
                continue
            batch_for(d).appends.append(cu)

        # InstallSnapshot dispatch (rate-limited: transfers are bulky and
        # idempotent, a cooldown per (group, peer) is plenty).
        if self._snap_due and self.snapshot_provider is not None:
            cooldown = 8 * cfg.election_ticks
            for g, d, term_g in self._snap_due:
                last = self._snap_sent.get((g, d), -cooldown)
                if self._tick_no - last < cooldown:
                    continue
                got = self.snapshot_provider(g)
                if got is None:
                    continue
                last_idx, blob = got
                if last_idx <= self.payload_log.start(g) \
                        and last_idx < self.payload_log.length(g):
                    # The snapshot doesn't reach the floor the follower
                    # needs (applier lagging behind compaction — cannot
                    # happen through the RaftDB path, which compacts only
                    # below its own applied index); don't send garbage.
                    continue
                self._snap_sent[(g, d)] = self._tick_no
                # Ship the dedup window AS OF the snapshot's applied
                # index inside the blob: without it the receiver either
                # re-applies a forward-retried duplicate the snapshot
                # already contains, or (shipping the live window) skips
                # entries its installed state lacks — both diverge.
                blob = wrap_snapshot(
                    self._dedup[g].pairs_upto(last_idx), blob)
                mm = self.membership
                if mm is not None and not mm.is_default(g):
                    # The transfer skips the log: ship the active
                    # config so the receiver cannot keep a voter set
                    # from before the skipped conf entries.
                    c = mm.config(g)
                    blob = wrap_snapshot_conf(
                        c.index, c.entry(0), blob)
                batch_for(d).snapshots.append(SnapshotRec(
                    group=g, last_idx=last_idx,
                    last_term=self.payload_log.term_of(g, last_idx),
                    term=term_g, blob=blob))
                # Resume replication above the transfer; see
                # set_peer_progress for why this is safe if it is lost.
                set_peer_progress(self.state, g, d, last_idx + 1)
                self.metrics.snapshots_sent += 1
        self._snap_due = []

        # Proposal forwarding: anything still queued while we are not the
        # leader goes to the leader hint, and is tracked for retry until
        # its commit is observed (see _fwd above).  Deadlines are in
        # LEASE-CLOCK (timer) units, not tick numbers: the event-driven
        # loop elides idle steps, so "4 * election_ticks" tick numbers
        # could be many times that in wall time — a proposal forwarded
        # to a leader that died the same instant then sat unreclaimed
        # for tens of seconds while the client's retries all timed out
        # (found by the process-plane read nemesis: the while-down PUT
        # stall).  Timer units track wall time by construction.
        role = info.role
        hint = info.leader_hint
        clock = self._lease_clock
        deadline = clock + 4 * cfg.election_ticks
        with self._prop_lock:
            # O(dirty), not O(G): only groups with queued or in-flight
            # forwarded proposals are walked — at G=10k the full-range
            # walk was most of this phase's Python even with every
            # queue empty.
            for g in list(self._fwd_groups):
                fwd_g = self._fwd[g]
                if fwd_g and role[g] == LEADER:
                    # WE became the leader: an in-flight forward
                    # targeted a PREVIOUS leader and nobody else will
                    # commit it — reclaim everything immediately (the
                    # envelope dedup collapses any copy that did land,
                    # so the requeue is always safe).  Without this,
                    # a proposal forwarded to a leader that crashed
                    # before our own election sat in limbo until the
                    # deadline even though we could accept it NOW.
                    self._props[g].extendleft(
                        reversed([p for (p, _) in fwd_g]))
                    self._prop_len[g] += len(fwd_g)
                    self._fwd[g] = []
                    fwd_g = self._fwd[g]
                if fwd_g:
                    expired = [p for (p, d) in fwd_g if d <= clock]
                    if expired:
                        self._fwd[g] = [(p, d) for (p, d) in fwd_g
                                        if d > clock]
                        self._props[g].extendleft(reversed(expired))
                        self._prop_len[g] += len(expired)
                h = int(hint[g])
                if role[g] != LEADER and h >= 0 and h != self.self_id \
                        and self._props[g]:
                    fwd = list(self._props[g])
                    self._props[g].clear()
                    self._prop_len[g] = 0
                    for p in fwd:
                        batch_for(h).proposals.append(
                            ProposalRec(group=g, payload=p))
                        self._fwd[g].append((p, deadline))
                elif not self._props[g] and not self._fwd[g]:
                    self._fwd_groups.discard(g)

        for dst0, batch in batches.items():
            self.transport.send(dst0 + 1, batch)
            self.metrics.msgs_sent += (len(batch.votes)
                                       + len(batch.appends)
                                       + len(batch.proposals)
                                       + len(batch.snapshots))
            if batch.cols is not None:
                self.metrics.msgs_sent += (batch.cols.n_votes()
                                           + batch.cols.n_appends())

    def _publish_phase(self, info) -> None:
        # Vectorized group selection: only groups whose commit advanced
        # past their applied point do any Python work this tick.
        commit = np.asarray(info.commit)
        ready = np.nonzero(commit > self._applied)[0]
        for g in ready.tolist():
            c = int(commit[g])
            a = int(self._applied[g])
            if self.tracer is not None:
                self.tracer.note_commit(g, c)
            fwd = self._fwd[g]
            # One locked read for the whole newly-committed range — a
            # per-entry get() pays a lock acquisition per entry, which
            # dominated this phase at high commit rates.
            datas = self.payload_log.slice(g, a + 1, c - a)
            # Loud, not silent (and not a stripable assert): a short read
            # here means the host payload log diverged from the device
            # commit (a sync bug) — skipping the missing committed
            # entries would silently fork this replica's state machine.
            if len(datas) != c - a:
                raise RuntimeError(
                    f"g{g}: payload log shorter than commit "
                    f"({a}+{len(datas)} < {c})")
            if fwd:
                # Forwarded proposal observed committed: retire it
                # (exact match — envelope ids are unique).  Tick-thread
                # only (_fwd has no lock); almost always empty — only
                # follower-routed proposals enter it.
                for data in datas:
                    for k, (p, _) in enumerate(fwd):
                        if p == data:
                            del fwd[k]
                            break
            mm = self.membership
            if mm is not None and mm.has_appended(g):
                # Conf entries committing in this range: APPLY (device
                # masks + WAL baseline) and SCRUB them from the SQL
                # apply stream — the state machine sees an empty entry
                # where the conf change sat (raft.go:84-87 parity).
                # Index-driven: zero per-entry work on the hot path.
                for idx, _noted in mm.take_committed(g, a, c):
                    d = datas[idx - a - 1]
                    if not is_conf_entry(d):
                        continue          # stale note (overwritten slot)
                    if mm.apply(g, idx, d) is not None:
                        self._patch_group_config(g)
                    datas[idx - a - 1] = b""
            if any(datas):
                # RAW batch, one queue put per group per tick: the
                # per-entry unwrap/dedup/utf-8 chain (~2.5 µs each, the
                # bulk of this phase at saturation) now runs on the
                # CONSUMER thread (runtime/db.py _expand_commit_item),
                # off the tick's critical path.  All-empty ranges
                # (no-op/conf entries) publish nothing, as before.
                self.commit_q.put((RAW_BATCH, g, a, datas))
            self._applied[g] = c
            self.metrics.commits += c - a
            if self._local[g]:
                # Committed own-proposals need no deposal-requeue cover.
                self._local[g] = [(ix, d) for (ix, d) in self._local[g]
                                  if ix > c]
