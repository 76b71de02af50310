"""RaftDB — apply-side state machine driver with ack routing.

Re-design of the reference's `raftdb` (reference db.go:13-167), batched
over groups:

  - consumes the commit stream and applies each committed command to the
    group's state machine in commit order (db.go:45-57);
  - routes per-proposal acks back to waiting clients by *query identity*:
    a FIFO of callbacks per (group, query); duplicate identical queries
    queue multiple callbacks and the first commit acks the head — the
    reference's exact quirk, preserved (db.go:63-76, 112-118, SURVEY.md
    §2d.3).  Commits originating from replay or other nodes have no
    callback and are skipped (db.go:64-69);
  - write/read split: Propose rejects SELECT, Query requires SELECT
    (db.go:98-110, 123-126);
  - local non-linearizable reads (db.go:128-130);
  - on consensus error, every pending ack receives the error and the DB
    shuts down (db.go:83-95);
  - the constructor consumes the replay stream synchronously until the
    `None` sentinel before returning, so the state machine is caught up to
    the WAL before serving (db.go:40, SURVEY.md §3.1 handshake), then a
    reader thread consumes live commits (db.go:41).

The optional commit listener mirrors every applied commit (and the replay
sentinel) to tests — the reference's `commitListenerC` observability hook
(db.go:19, 48-50, 59-61), which its restart tests depend on.
"""
from __future__ import annotations

import json
import logging
import queue
import threading
import time
from collections import defaultdict, deque
from typing import Callable, Dict, Optional, Tuple

from raftsql_tpu_torch.models.base import StateMachine
from raftsql_tpu_torch.models.sqlite_sm import is_select
from raftsql_tpu_torch.overload import (Overloaded, deadline_steps,
                                  zero_metrics_doc)
from raftsql_tpu_torch.runtime.envelope import unwrap
from raftsql_tpu_torch.transport.codec import is_conf_entry
from raftsql_tpu_torch.runtime.node import (CLOSED, RAW_BATCH, RAW_MANY,
                                      RAW_PLAIN)
from raftsql_tpu_torch.runtime.pipe import RaftPipe
from raftsql_tpu_torch.utils.metrics import LatencyTimer

log = logging.getLogger("raftsql_tpu_torch.db")


def iter_plain_entries(base, datas):
    """Yield (index, decoded_command) for each non-empty entry of one
    plain-payload sub-batch (entries at base+1..).  Lives next to
    _expand_commit_item so the plain wire contract (index base,
    empty-entry skip, utf-8 payloads) has exactly one owner; hot
    consumers (the durable benchmark's drain) use this instead of
    building per-entry (group, index, str) tuples."""
    idx = base
    for d in datas:
        idx += 1
        if d:
            yield idx, d.decode("utf-8")


def iter_plain_batches(item):
    """Yield (group, base_idx, [raw_bytes, ...]) sub-batches of a
    plain-payload commit item — one batch for RAW_PLAIN, the whole
    tick's batches for RAW_MANY.  Same single-owner rationale as
    iter_plain_entries; payloads follow the plain contract (no
    envelopes, empty bytes = no-op entries the consumer skips)."""
    if item[0] is RAW_PLAIN:
        yield item[1], item[2], item[3]
    elif item[0] is RAW_MANY:
        yield from item[1]


def _expand_commit_item(item, node=None, dups=None):
    """Normalize a commit_q item to per-entry (group, index, sql) tuples.

    `dups` (optional list) collects (group, index, sql) for committed
    entries the dedup window SKIPPED — a client-retried or
    forward-retried duplicate that already applied.  The caller must
    still ACK those by query identity (the retry's client is waiting on
    this very commit; without the ack a PUT retried across a crash
    would hang forever even though its first copy applied).

    Four forms, discriminated explicitly:
      - (RAW_BATCH, group, base_idx, [raw_bytes, ...]) — the live
        publish phase's tagged batch (entries at base_idx+1..): one
        queue put per group per tick, with the per-entry envelope
        unwrap / dedup / utf-8 decode done HERE, on the consumer
        thread, off the tick's critical path (`node.dedup_for(g)`
        supplies the per-group DedupWindow — forward-retried
        duplicates apply exactly once);
      - (RAW_PLAIN, group, base_idx, [raw_bytes, ...]) — same shape,
        but payloads are PLAIN (never enveloped): only producers whose
        proposals bypass the wrap/forward path may emit it (the
        fused/mesh runtimes, which route proposals on the host).
        Tagging wrapped payloads RAW_PLAIN would apply entries with
        envelope header bytes prepended;
      - (RAW_MANY, [(group, base_idx, [raw_bytes, ...]), ...]) — a
        whole fused tick's RAW_PLAIN batches in one queue item (same
        plain-payload contract);
      - (group, index, sql_str) — WAL replay per-entry items (the
        nil-sentinel counting protocol must stay item-accurate there);
      - (group, [(index, sql), ...]) — decoded per-group batches (older
        producers/tests).
    """
    if item[0] is RAW_BATCH:
        _, g, base, datas = item
        dedup = node.dedup_for(g) if node is not None else None
        out = []
        for off, data in enumerate(datas):
            if not data or is_conf_entry(data):
                continue                    # no-op/conf entry
            pid, payload = unwrap(data)
            if pid is not None and dedup is not None \
                    and dedup.seen(pid, base + 1 + off):
                if dups is not None:        # retry duplicate: ack, no apply
                    dups.append((g, base + 1 + off,
                                 payload.decode("utf-8")))
                continue
            out.append((g, base + 1 + off, payload.decode("utf-8")))
        return out
    if item[0] is RAW_PLAIN:
        _, g, base, datas = item
        return [(g, base + 1 + off, data.decode("utf-8"))
                for off, data in enumerate(datas)
                if data and not is_conf_entry(data)]
    if item[0] is RAW_MANY:
        return [(g, base + 1 + off, data.decode("utf-8"))
                for (g, base, datas) in item[1]
                for off, data in enumerate(datas)
                if data and not is_conf_entry(data)]
    if len(item) == 2:
        g = item[0]
        return [(g, i, s) for (i, s) in item[1]]
    if len(item) == 3 and isinstance(item[2], str):
        return [item]
    raise TypeError(f"unrecognized commit_q item shape: {item!r:.120}")


class NotLeaderError(Exception):
    """A linearizable read hit a non-leader; retry at `leader` (1-based
    node id, 0 = unknown)."""

    def __init__(self, group: int, leader: int):
        super().__init__(
            f"group {group}: not the leader"
            + (f"; leader is node {leader}" if leader > 0 else ""))
        self.group = group
        self.leader = leader


class ReadTimeout(TimeoutError):
    """A read could not be served within the request timeout — a TYPED,
    RETRYABLE condition (quorum unreachable mid-ReadIndex round, apply
    lagging the read point, a session watermark not yet replicated, or
    leadership lost mid-round without a forward hint).  Subclasses
    TimeoutError so both HTTP planes keep answering 503 Service
    Unavailable (retry-at-will), never a 400; `phase` names which wait
    ran out, so a client log pinpoints the stall."""

    def __init__(self, group: int, phase: str, detail: str):
        super().__init__(f"group {group}: {detail}")
        self.group = group
        self.phase = phase


class AckFuture:
    """The reference's buffered `chan error` (db.go:107): one result,
    delivered once, awaited by one client."""

    def __init__(self):
        self._evt = threading.Event()
        self._err: Optional[Exception] = None
        self._cb = None
        self._cb_mu = threading.Lock()
        self.created = time.monotonic()

    def set(self, err: Optional[Exception]) -> None:
        self._err = err
        self._evt.set()
        with self._cb_mu:
            cb, self._cb = self._cb, None
        if cb is not None:
            cb(err)

    def wait(self, timeout: Optional[float] = None) -> Optional[Exception]:
        if not self._evt.wait(timeout):
            raise TimeoutError("proposal not committed in time")
        return self._err

    def add_done_callback(self, cb) -> None:
        """Deliver the result to `cb(err)` instead of (or in addition
        to) a blocking wait() — the async API plane's bridge.  At most
        one callback; runs on the resolver's thread (the commit
        consumer), or immediately here if already resolved.  Called
        exactly once."""
        with self._cb_mu:
            if not self._evt.is_set():
                self._cb = cb
                return
        cb(self._err)


class RaftDB:
    def __init__(self, sm_factory: Callable[[int], StateMachine],
                 pipe: RaftPipe, num_groups: int = 1,
                 listener=None, resume: bool = False,
                 compact_every: int = 0, compact_keep: int = 1024):
        """resume=True enables snapshot-resume (SURVEY.md §5.4
        improvement): state machines that persist applied_index (see
        SQLiteStateMachine resume mode) skip re-apply of already-applied
        replayed entries, and — when compact_every > 0 — the WAL prefix
        covered by every group's snapshot is compacted away after every
        `compact_every` applies (retaining `compact_keep` entries for
        follower catch-up).  Default off: reference delete-and-replay
        parity (db.go:27-29)."""
        self.pipe = pipe
        self.num_groups = num_groups
        self.listener = listener            # queue-like or None
        self.resume = resume
        self._compact_every = compact_every if resume else 0
        self._compact_keep = compact_keep
        self._applies_since_compact = 0
        # Witness replica (config.py quorum geometry): this node votes,
        # appends and fsyncs — but owns no SQLite shard.  The real
        # sm_factory is never invoked, so no shard file or directory is
        # ever created; committed payloads are discarded at apply time
        # (they are already durable in the WAL, which is all a witness
        # owes the cluster) and every read is refused up front.
        self.witness_self = bool(getattr(pipe.node, "witness_self",
                                         False))
        if self.witness_self:
            from raftsql_tpu_torch.models.witness import \
                WitnessStateMachine
            sm_factory = WitnessStateMachine
        self._sms: Dict[int, StateMachine] = {
            g: sm_factory(g) for g in range(num_groups)}
        if not any(getattr(sm, "has_durable_snapshot", False)
                   for sm in self._sms.values()):
            # All floors would be 0 (volatile applied indexes must not
            # gate WAL compaction) — a guaranteed no-op; don't take
            # _wal_lock for it every compact_every applies.
            self._compact_every = 0
        if resume:
            # Full state transfer for followers beyond the compaction
            # floor (InstallSnapshot) is only sound when re-apply is
            # snapshot-aware, so it rides the resume flag.
            pipe.node.snapshot_provider = self._snapshot_of
            pipe.node.snapshot_installer = self._install_snapshot
        self._mu = threading.Lock()
        self._q2cb: Dict[Tuple[int, str], deque] = defaultdict(deque)  # raftlint: guarded-by=_mu
        self._failed: Optional[Exception] = None
        self._closed = False
        self.latency = LatencyTimer()   # propose→ack, the p50 north star
        # Serving-plane gauge hook (runtime/ring.py RingServer): a
        # callable whose dict is merged into metrics() — ring depth,
        # proposed/completed counts of the multi-worker deployment.
        self.serving_metrics = None
        # Shared-memory snapshot publisher (runtime/shm.py), attached
        # by RingServer when the worker read fast path is on: every
        # applied run is mirrored into the worker-mapped snapshot log
        # (publish_deltas), snapshot installs republish the group's
        # base image.  None keeps the apply path untouched.
        self.shm = None
        # Read-replica stream server (raftsql_tpu/replica/), attached
        # by the server's --replica-listen flag: the shm publisher's
        # tee framed onto TCP for remote replicas.  None keeps the
        # engine inert; metrics() still exports the zeroed `replica`
        # section so the series exist from boot (scripts/check_prom.py
        # requires them).
        self.replica_plane = None
        # Placement controller (raftsql_tpu/placement/), attached by
        # the server's --placement flag; None keeps metrics() and
        # flight bundles unchanged.
        self.placement = None
        # Reshard plane (raftsql_tpu/reshard/plane.py), attached by the
        # server's --reshard flag: the elastic-keyspace coordinator +
        # keymap router.  None keeps /kv, /healthz and metrics()
        # unchanged (the plane compiles in but stays idle).
        self.reshard = None
        # propose→commit (stamped when the committed entry reaches the
        # apply consumer — commit + publish, before apply): the
        # histogram /metrics exports as propose_commit_p50/p95/p99_ms.
        self.latency_commit = LatencyTimer()

        # Synchronous replay consumption (db.go:40): apply until the
        # sentinel so reads see the replayed state before we return.
        self._read_commits(replay=True)
        self._reader = threading.Thread(target=self._read_commits,
                                        daemon=True, name="raftdb-reader")
        self._reader.start()

    # ------------------------------------------------------------------

    def _node_tracer(self):
        """The engine's span tracer, or None (tracing may be enabled
        after construction — resolve per use, it is one getattr)."""
        return getattr(getattr(self.pipe, "node", None), "tracer", None)

    def _ack_one(self, group: int, query: str, err,
                 commit_ts: Optional[float] = None) -> None:
        if self.listener is not None:
            self.listener.put((group, query))
        tracer = self._node_tracer()
        if tracer is not None:
            tracer.note_ack(group, query)
        # Per-group traffic accounting (utils/metrics.py GroupTraffic):
        # the ack leg — proposes/commits are stamped in the host plane.
        traffic = getattr(self.pipe.node, "traffic", None)
        if traffic is not None:
            traffic.add_ack(group)
        with self._mu:
            cbs = self._q2cb.get((group, query))
            if not cbs:
                return                  # replayed or proposed elsewhere
            cb = cbs.popleft()
            if not cbs:
                del self._q2cb[(group, query)]
        cb.set(err)
        self.latency.record(time.monotonic() - cb.created)
        if commit_ts is not None:
            # commit_ts is when this run was drained off the commit
            # queue — the commit observation point, before apply.
            self.latency_commit.record(commit_ts - cb.created)

    def _apply_run(self, run) -> None:
        """Apply a drained run of commits with GROUP COMMIT: entries are
        batched per state machine and applied in one durable transaction
        each (models apply_batch; per-item fallback otherwise), then
        acks/listeners fire in original commit order.  In resume mode
        the state machine itself skips entries at or below its durable
        applied index (atomically under its own lock, racing snapshot
        installs safely) and returns None — so skipped-but-committed
        entries still resolve their acks."""
        commit_ts = time.monotonic()    # commit observation point
        per_g: Dict[int, list] = defaultdict(list)
        for (group, index, query) in run:
            per_g[group].append((query, index))
        errs: Dict[int, list] = {}
        for group, items in per_g.items():
            sm = self._sms[group]
            batch_fn = getattr(sm, "apply_batch", None)
            if batch_fn is not None:
                errs[group] = batch_fn(items)
            else:
                errs[group] = [sm.apply(qy, ix) for (qy, ix) in items]
        if self.shm is not None:
            # Mirror the applied run into the worker-mapped snapshot
            # log BEFORE acks fire: a client whose PUT just acked may
            # immediately session-read at a worker, and the worker's
            # replica must be able to reach that watermark.  Statements
            # that errored are published too — workers re-apply them
            # under the same SAVEPOINT semantics, so replica state
            # stays bit-identical to the engine's.
            try:
                self.shm.publish_deltas(per_g)
            except Exception:                           # noqa: BLE001
                log.exception("shm delta publish failed; disabling")
                self.shm = None
        tracer = self._node_tracer()
        pos = {g: 0 for g in per_g}
        for (group, index, query) in run:
            err = errs[group][pos[group]]
            pos[group] += 1
            if tracer is not None:
                tracer.note_apply(group, index)
            self._ack_one(group, query, err, commit_ts=commit_ts)
        for _ in run:
            self._maybe_compact()

    def _read_commits(self, replay: bool = False) -> None:
        q = self.pipe.commit_q
        while True:
            item = q.get()
            if item is None:
                if self.listener is not None:
                    self.listener.put(None)
                if replay:
                    return
                continue
            if item is CLOSED:
                break
            # Greedy drain (live loop only): everything already queued
            # joins this item's group-committed batch.  The replay pass
            # must stay strictly item-at-a-time — draining could swallow
            # live entries beyond the nil sentinel it returns at.
            # Items arrive per-entry (group, index, sql) from replay, or
            # as per-group RAW batches (group, base_idx, [bytes, ...])
            # from the live publish phase (runtime/node.py) — expanded
            # (unwrap/dedup/decode) HERE so the tick thread pays one
            # queue put per group and none of the per-entry Python.
            dups: list = []
            run = _expand_commit_item(item, self.pipe.node, dups)
            stop = False
            if not replay:
                while len(run) < 256:
                    try:
                        nxt = q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is None:
                        # Preserve the sentinel's position in the
                        # listener protocol relative to this run.
                        self._apply_run(run)
                        run = []
                        if self.listener is not None:
                            self.listener.put(None)
                        continue
                    if nxt is CLOSED:
                        stop = True
                        break
                    run.extend(_expand_commit_item(nxt, self.pipe.node,
                                                   dups))
            if run:
                self._apply_run(run)
            for (group, index, query) in dups:
                # A committed RETRY duplicate: its first copy applied
                # (this run or earlier), so the retrying client's PUT
                # succeeded — ack success without re-applying.
                self._ack_one(group, query, None,
                              commit_ts=time.monotonic())
            if stop:
                break

        # Stream closed: clean shutdown or error teardown (db.go:83-95).
        err = self.pipe.error
        if err is not None:
            with self._mu:
                pending = [cb for cbs in self._q2cb.values() for cb in cbs]
                self._q2cb.clear()
                self._failed = err
            for cb in pending:
                cb.set(err)

    # ------------------------------------------------------------------

    def _snapshot_of(self, group: int):
        """(applied index, image) of `group`'s state machine, or None
        when it has applied nothing: an index-0 image labels no log
        position, and the reference serialized first, which raises on a
        database of 0 pages (a fresh parity-mode group), killing the shm
        and replica planes at boot (raftsql_tpu/runtime/db.py
        `_snapshot_of`)."""
        sm = self._sms[group]
        fn = getattr(sm, "serialize_with_index", None)
        if fn is None:
            return None
        if sm.applied_index() <= 0:
            return None
        idx, blob = fn()
        return (idx, blob) if idx > 0 else None

    # Grace before failing acks orphaned by a snapshot install: commits
    # ABOVE the snapshot still publish normally and must keep their acks.
    SNAPSHOT_ACK_GRACE_S = 5.0

    def _install_snapshot(self, group: int, index: int,
                          blob: bytes) -> None:
        self._sms[group].install(blob, index)
        if self.shm is not None:
            # A state transfer skipped the delta stream: workers must
            # rebuild their replica from the installed image, so the
            # group's base is republished into the snapshot log.
            try:
                self.shm.publish_base(group, blob, index)
            except Exception:                           # noqa: BLE001
                log.exception("shm base publish failed; disabling")
                self.shm = None
        # A state transfer SKIPS the log: proposals whose commits sit
        # INSIDE the snapshot are never published here, so their acks
        # would wait forever (the reference never snapshots and inherits
        # the hang only for lost proposals).  But a pending ack may also
        # belong to a commit ABOVE the snapshot — about to stream in and
        # ack normally — and the two are indistinguishable by (group,
        # query) key.  So: snapshot the exact callbacks pending NOW, give
        # the post-install catch-up a grace window to drain them, and
        # fail only the leftovers with a retriable error.  Hazard,
        # documented: a flushed write may in fact be inside the installed
        # state — a client retrying a non-idempotent statement should
        # verify first (same duplicate exposure as the reference's
        # content-keyed FIFO, db.go:112-118).
        with self._mu:
            stale = [(k, cb) for k, cbs in self._q2cb.items()
                     if k[0] == group for cb in cbs]
        if not stale:
            return
        err = RuntimeError(
            f"group {group}: pending proposal superseded by snapshot "
            f"install at index {index}; state may include the write — "
            "verify before retrying")

        def flush():
            victims = []
            with self._mu:
                for k, cb in stale:
                    cbs = self._q2cb.get(k)
                    if cbs and cb in cbs:
                        cbs.remove(cb)
                        if not cbs:
                            self._q2cb.pop(k, None)
                        victims.append(cb)
            for cb in victims:
                cb.set(err)

        t = threading.Timer(self.SNAPSHOT_ACK_GRACE_S, flush)
        t.daemon = True
        t.start()

    def _maybe_compact(self) -> None:
        if not self._compact_every:
            return
        self._applies_since_compact += 1
        if self._applies_since_compact < self._compact_every:
            return
        self._applies_since_compact = 0
        # Volatile applied indexes (has_durable_snapshot unset/False) are
        # floored at 0: compacting the WAL against state lost on restart
        # would be silent data loss (models/base.py contract).
        applied = {g: (sm.applied_index()
                       if getattr(sm, "has_durable_snapshot", False) else 0)
                   for g, sm in self._sms.items()}
        self.pipe.node.compact(applied, keep=self._compact_keep)

    def propose(self, query: str, group: int = 0,
                token: Optional[int] = None,
                deadline_ms: Optional[float] = None) -> AckFuture:
        """Submit a write; the future resolves after commit + local apply
        (the reference's blocking-PUT contract, httpapi.go:45-49).

        `token` (a client retry token, X-Raft-Retry-Token) pins the
        proposal's envelope id: a client re-sending the same logical
        PUT — after a timeout, a dropped connection, or a crashed
        leader — passes the same token and the publish-time dedup
        window applies whichever copies commit exactly once (the
        duplicate's commit still ACKS, it just doesn't re-apply).

        `deadline_ms` (remaining client budget, X-Raft-Deadline-Ms) is
        converted ONCE here from wall budget to a device-step deadline
        (raftsql_tpu/overload/ discipline) and carried with the queue
        entry, so work already expired at staging time is shed before
        WAL/fsync cost is paid.  Raises `Overloaded` (HTTP 429) when an
        attached admission controller refuses the enqueue; no-op when
        no overload plane is attached."""
        fut = AckFuture()
        if is_select(query):
            fut.set(ValueError("expected non-SELECT"))
            return fut
        if not 0 <= group < self.num_groups:
            fut.set(ValueError(f"group {group} out of range "
                               f"[0, {self.num_groups})"))
            return fut
        node = self.pipe.node
        dstep = None
        if deadline_ms is not None \
                and getattr(node, "overload", None) is not None:
            dstep = deadline_steps(node._device_steps, deadline_ms,
                                   node.cfg.tick_interval_s)
        with self._mu:
            if self._failed is not None:
                fut.set(self._failed)
                return fut
            if self._closed:
                fut.set(RuntimeError("db is closed"))
                return fut
            self._q2cb[(group, query)].append(fut)
        try:
            if dstep is not None:
                self.pipe.propose(group, query.encode("utf-8"), token,
                                  deadline_step=dstep)
            else:
                self.pipe.propose(group, query.encode("utf-8"), token)
        except Overloaded:
            # Refused at the admission edge: nothing was enqueued, so
            # the ack callback must not linger in _q2cb.
            self.abandon(query, group, fut)
            raise
        return fut

    def abandon(self, query: str, group: int, fut: AckFuture) -> None:
        """Deregister a timed-out proposal's callback so it cannot leak in
        `_q2cb` forever (the proposal itself may still commit later; its
        apply is unaffected — only the ack is orphaned)."""
        with self._mu:
            cbs = self._q2cb.get((group, query))
            if cbs is None:
                return
            try:
                cbs.remove(fut)
            except ValueError:
                return
            if not cbs:
                del self._q2cb[(group, query)]

    def pending_for(self, group: int) -> int:
        """Acks still outstanding for `group` — the reshard drain gate:
        a frozen slot's verb may not copy rows until every write that
        was in flight at freeze time either acked or errored."""
        with self._mu:
            return sum(len(d) for (g, _q), d in self._q2cb.items()
                       if g == group)

    def watermark(self, group: int = 0) -> int:
        """This replica's applied index for `group` — the session
        watermark echoed as X-Raft-Session on both HTTP planes.  A
        client that carries the largest watermark it has seen and
        presents it on `mode="session"` reads gets read-your-writes
        and monotonic reads from ANY replica."""
        return int(self._sms[group].applied_index())

    def _wait_applied(self, group: int, target: int, deadline: float,
                      tick: float, phase: str) -> None:
        """Block until the local apply reaches `target` (bounded)."""
        while self._sms[group].applied_index() < target:
            if self._failed is not None:
                raise self._failed
            now = time.monotonic()
            if now > deadline:
                raise ReadTimeout(
                    group, phase,
                    f"apply (at {self._sms[group].applied_index()}) "
                    f"did not reach read point {target} in time")
            time.sleep(min(tick, max(deadline - now, 0.0005)))

    def query(self, query: str, group: int = 0,
              linear: bool = False, timeout: float = 10.0,
              mode: Optional[str] = None, watermark: int = 0,
              deadline_ms: Optional[float] = None,
              brownout: bool = False,
              info: Optional[dict] = None) -> str:
        """Read path, five consistency modes (README read-modes table):

          - "local" (default): the reference's stale local read —
            never touches consensus (db.go:123-130);
          - "session": local read AFTER the replica's apply reaches the
            client-provided `watermark` (X-Raft-Session echo from a
            previous write/read) — read-your-writes + monotonic reads
            at any replica;
          - "follower": local read at the replicated read-index
            watermark — this node's CURRENT commit index — so the
            answer reflects everything this replica knows committed at
            request arrival (fresher than local, no leader round);
          - "linear" (or linear=True): LINEARIZABLE.  Served from the
            leader LEASE when one covers now + max_clock_skew (no
            quorum round, config.lease_ticks), degrading to the
            ReadIndex quorum round (raft §6.4), degrading to
            NotLeaderError (421 + leader hint) off-leader — each
            degradation explicit, never a silent stale read.

        Bounded: every wait raises typed, retryable ReadTimeout (503)
        within `timeout`; leadership lost mid-round surfaces
        NotLeaderError on the next poll, never an unbounded spin."""
        if not is_select(query):
            raise ValueError("expected SELECT")
        if self.witness_self:
            # Refuse up front: a witness applies nothing, so any wait
            # on its applied index would just spin to ReadTimeout.
            raise ValueError(
                "witness replica serves no reads (it owns no shard); "
                "route the query to a full voter")
        if not 0 <= group < self.num_groups:
            raise ValueError(f"group {group} out of range "
                             f"[0, {self.num_groups})")
        if mode is None:
            mode = "linear" if linear else "local"
        node = self.pipe.node
        m = getattr(node, "metrics", None)
        tick = node.cfg.tick_interval_s or 0.001
        if deadline_ms is not None:
            # The client's end-to-end budget bounds every wait below;
            # a tighter server-side timeout still wins.
            timeout = min(timeout, max(float(deadline_ms) / 1000.0, 0.0))
        deadline = time.monotonic() + timeout
        if info is not None:
            info["served"] = mode
        if mode == "local":
            if m is not None:
                m.reads_local += 1
        elif mode == "session":
            if m is not None:
                m.reads_session += 1
            if watermark > 0:
                self._wait_applied(group, watermark, deadline, tick,
                                   "session")
        elif mode == "follower":
            if m is not None:
                m.reads_follower += 1
            wm_fn = getattr(node, "commit_watermark", None)
            target = wm_fn(group) if wm_fn is not None \
                else max(watermark, 0)
            self._wait_applied(group, target, deadline, tick, "follower")
        elif mode == "linear":
            self._linear_wait(node, group, deadline, tick,
                              brownout=brownout, info=info)
        else:
            raise ValueError(f"unknown read mode {mode!r}")
        return self._sms[group].query(query)

    def _linear_wait(self, node, group: int, deadline: float,
                     tick: float, brownout: bool = False,
                     info: Optional[dict] = None) -> None:
        """The linearizable read protocol: lease fast path, then the
        ReadIndex round, each wait bounded by `deadline`.

        Brownout ladder (raftsql_tpu/overload/): when an attached
        governor reports sustained queue pressure, the ReadIndex
        fallback is withheld — the lease fast path still serves full
        linearizability for free, but a lease miss refuses (429) unless
        the client opted in via `brownout=True` (X-Raft-Brownout:
        allow), in which case the read degrades to a session read at
        this replica's current applied point and `info["served"]`
        names the mode actually served.  Never a silent downgrade."""
        m = getattr(node, "metrics", None)
        lease_fn = getattr(node, "lease_read", None)
        lease_on = node.cfg.lease_ticks > 0 and lease_fn is not None
        if lease_on:
            target = lease_fn(group)
            if target is not None:
                if m is not None:
                    m.reads_lease += 1
                self._wait_applied(group, target, deadline, tick,
                                   "lease_apply")
                return
            # Lease unavailable (expired / not leader / precondition
            # pending): degrade to the full quorum round.
            if m is not None:
                m.lease_degrades += 1
        ov = getattr(node, "overload", None)
        if ov is not None:
            path = ov.brownout_read_path(brownout)  # may raise Overloaded
            if path == "session":
                # Opted-in degradation: serve at whatever this replica
                # has applied, skipping the quorum round entirely.
                if info is not None:
                    info["served"] = "session"
                return
        if m is not None:
            m.reads_read_index += 1
        join_fn = getattr(node, "read_join", None)
        if join_fn is not None:
            # Batched ReadIndex (runtime/node.py): join the group's
            # shared per-tick round and sleep on its event — N
            # concurrent readers cost one quorum round per tick, and
            # nobody poll-spins at tick cadence.
            while True:
                b = join_fn(group)
                if b is None:
                    raise NotLeaderError(group,
                                         node.leader_of(group) + 1)
                # A spurious wake on a still-pending batch must keep
                # waiting on the SAME batch — re-joining would bump its
                # count again and double-count this reader in
                # reads_read_index_batched and the batch-size histogram.
                while not b.status:
                    if time.monotonic() > deadline:
                        raise ReadTimeout(
                            group, "confirm",
                            "leadership not re-confirmed "
                            "(no quorum reachable?)")
                    b.evt.wait(max(deadline - time.monotonic(), 0.0))
                if b.status == "ok":
                    self._wait_applied(group, b.target, deadline,
                                       tick, "apply")
                    return
                if time.monotonic() > deadline:
                    raise ReadTimeout(
                        group, "confirm",
                        "leadership not re-confirmed "
                        "(no quorum reachable?)")
                # "not_leader": re-join — once the role cache reflects
                # the loss, join returns None and the typed redirect
                # surfaces.
        while True:
            got = node.read_index(group)
            if got is None:
                raise NotLeaderError(group, node.leader_of(group) + 1)
            if got != ():
                break
            # Leader without a committed current-term entry yet
            # (raft §6.4 precondition) — its no-op is in flight.
            if time.monotonic() > deadline:
                raise ReadTimeout(group, "read_index",
                                  "no current-term commit yet")
            time.sleep(tick)
        target, reg = got
        while not node.read_ready(group, reg):
            # Leadership lost mid-round: surface the typed redirect on
            # the NEXT poll — the round can never confirm and spinning
            # it out to the deadline would stall the client for
            # nothing (the leader hint names where to retry).
            if node.read_index(group) is None:
                raise NotLeaderError(group, node.leader_of(group) + 1)
            if time.monotonic() > deadline:
                raise ReadTimeout(
                    group, "confirm",
                    "leadership not re-confirmed "
                    "(no quorum reachable?)")
            time.sleep(tick)
        self._wait_applied(group, target, deadline, tick, "apply")

    def metrics(self) -> dict:
        def ms(v):
            return round(v * 1e3, 3) if v == v else None   # NaN -> null

        m = self.pipe.node.metrics.snapshot()
        # propose→commit (stamped at the commit observation point,
        # before apply) and propose→ack (after apply, the full
        # blocking-PUT latency the client sees).
        c50, c95, c99 = self.latency_commit.percentiles(
            (0.5, 0.95, 0.99))
        m["propose_commit_p50_ms"] = ms(c50)
        m["propose_commit_p95_ms"] = ms(c95)
        m["propose_commit_p99_ms"] = ms(c99)
        a50, a99 = self.latency.percentiles((0.5, 0.99))
        m["propose_ack_p50_ms"] = ms(a50)
        m["propose_ack_p99_ms"] = ms(a99)
        # Membership observability (raftsql_tpu/membership/): active
        # voter/learner slot totals across groups + applied conf-change
        # count.  Engines without a manager report the static shape.
        node = self.pipe.node
        mm = getattr(node, "membership", None)
        if mm is not None:
            v, l = mm.counts()
        else:
            v, l = node.cfg.num_peers * node.cfg.num_groups, 0
        m["members_voters"] = v
        m["members_learners"] = l
        # Quorum geometry (config.py flexible quorums + witnesses):
        # the per-phase thresholds this deployment runs under and the
        # provisioned witness count — static per config, exported so an
        # operator can read the geometry off any node's /metrics.
        cfg = node.cfg
        m["quorum"] = {
            "write_size": cfg.write_size,
            "election_size": cfg.election_size,
            "witnesses": len(cfg.witness_set),
        }
        # Telemetry plane (PR 8, default on): per-phase tick wall-time
        # histograms and the per-group traffic table with its top-K
        # hot-groups rows — the feed the placement controller consumes.
        prof = getattr(node, "prof", None)
        if prof is not None:
            m["phase_profile"] = prof.snapshot()
        traffic = getattr(node, "traffic", None)
        if traffic is not None:
            xg = getattr(node, "transferring_groups", None)
            m["group_traffic"] = traffic.doc(
                leader_of=getattr(node, "leader_of", None),
                shard_of=getattr(node, "_group_shard_of", None),
                transferring=xg() if callable(xg) else None)
        # Placement controller (raftsql_tpu/placement/): balance gauges
        # + issue counters, when a controller is attached.
        if self.placement is not None:
            m["placement"] = self.placement.metrics_doc()
        # Reshard plane (raftsql_tpu/reshard/): verb counters, per-verb
        # duration histogram, mapping epoch + active-verb gauge.
        if self.reshard is not None:
            m["reshard"] = self.reshard.metrics_doc()
        # Read-replica tier (raftsql_tpu/replica/): stream-server
        # counters when --replica-listen attached a plane; zeros
        # otherwise, so the raftsql_replica_* series exist from boot
        # on every deployment (scripts/check_prom.py requires them).
        if self.replica_plane is not None:
            m["replica"] = self.replica_plane.metrics_doc()
        else:
            m["replica"] = {"subscribers": 0, "deltas_tx": 0,
                            "bases_tx": 0, "resyncs": 0,
                            "refusals": 0, "lag_ms": 0}
        # Overload plane (raftsql_tpu/overload/): admission, per-phase
        # shed, and brownout counters when a controller is attached;
        # zeros otherwise so the raftsql_overload_* series exist from
        # boot on every deployment (scripts/check_prom.py requires
        # them), same contract as the replica section above.
        ovc = getattr(node, "overload", None)
        m["overload"] = (ovc.metrics_doc() if ovc is not None
                         else zero_metrics_doc())
        gcw = getattr(node, "_gcwal", None)
        if gcw is not None:
            # Group-commit batch histogram: peers coalesced per fsync
            # -> count (how well the one-fsync-per-tick lever engages).
            m["wal_gc_batch_hist"] = {
                str(k): v for k, v in sorted(gcw.batch_hist.items())}
        if self.serving_metrics is not None:
            try:
                m.update(self.serving_metrics())
            except Exception:                           # noqa: BLE001
                pass        # a gauge must never break the scrape
        return m

    def render_metrics(self) -> str:
        return json.dumps(self.metrics(), sort_keys=True) + "\n"

    def render_metrics_prom(self) -> str:
        """GET /metrics?format=prom: the same document in the
        Prometheus text exposition (utils/metrics.py prom_render —
        every JSON counter/gauge/histogram becomes a sample; validated
        by scripts/check_prom.py)."""
        from raftsql_tpu_torch.utils.metrics import prom_render
        return prom_render(self.metrics())

    # -- membership admin (raftsql_tpu/membership/) ---------------------

    def members(self) -> dict:
        """GET /members: per-group active configuration + leader."""
        node = self.pipe.node
        fn = getattr(node, "members_doc", None)
        if fn is None:
            return {"error": "engine has no membership plane"}
        return fn()

    def member_change(self, group: int, op: str, peer: int) -> dict:
        """POST /members: propose add/remove/promote of a peer slot.
        Maps the membership plane's not-leader error onto the API's
        NotLeaderError so both HTTP planes answer 421 + the hint."""
        from raftsql_tpu_torch.membership import NotLeaderForChange
        node = self.pipe.node
        fn = getattr(node, "member_change", None)
        if fn is None:
            raise ValueError("engine has no membership plane")
        try:
            return fn(group, op, peer)
        except NotLeaderForChange as e:
            raise NotLeaderError(e.group, e.leader) from e

    def transfer(self, group: int, target: int) -> dict:
        """POST /transfer: arm a graceful leadership transfer of
        `group` to peer slot `target` (0-based, like /members' `peer`;
        thesis §3.10 TimeoutNow — the device plane stalls intake, waits
        for catch-up, fires the grant).  Not-leader maps onto
        NotLeaderError so both HTTP planes answer 421 + the hint;
        validation refusals (in-flight transfer, learner target)
        surface as 400s."""
        from raftsql_tpu_torch.membership import NotLeaderForChange
        node = self.pipe.node
        fn = getattr(node, "transfer_leadership", None)
        if fn is None:
            raise ValueError("engine has no leadership-transfer plane")
        try:
            return fn(group, target)
        except NotLeaderForChange as e:
            raise NotLeaderError(e.group, e.leader) from e

    def render_members(self) -> str:
        return json.dumps(self.members(), sort_keys=True) + "\n"

    # -- readiness (GET /healthz) ---------------------------------------

    def health_doc(self) -> dict:
        """GET /healthz: node id, per-group role / leader hint / term /
        commit (from the engine's host-side status caches) plus each
        group's APPLIED index from the state machines.  Answering at
        all means the process is up and replay finished (the
        constructor blocks on replay); the nemesis and operators read
        role/leader to detect restart completion without a write
        probe."""
        node = self.pipe.node
        status_fn = getattr(node, "status", None)
        groups = status_fn() if status_fn is not None else {
            str(g): {"role": "unknown",
                     "leader": int(node.leader_of(g)) + 1
                     if hasattr(node, "leader_of") else 0}
            for g in range(self.num_groups)}
        # Routing hints (PR 12, api/client.py front router): per-group
        # remaining lease seconds — a client routes linearizable reads
        # to the node reporting a live lease, writes to the leader.
        lease_fn = getattr(node, "lease_deadline_s", None)
        now = time.monotonic()
        for g in range(self.num_groups):
            row = groups.get(str(g))
            if row is not None:
                row["applied"] = int(self._sms[g].applied_index())
                if lease_fn is not None:
                    row["lease_s"] = round(
                        max(lease_fn(g) - now, 0.0), 4)
        doc = {"id": int(getattr(node, "node_id", 0)),
               "ready": True, "groups": groups}
        # Pod deployment (raftsql_tpu/pod/): topology + ownership.  The
        # `hosts` table lets a client pointed at ONE pod host discover
        # the sweep set; `pod_owned` on each group row names which rows
        # THIS host serves (compute is replicated, so every host
        # truthfully reports every group — ownership, not role, is the
        # routing key; api/client.py refresh_hints merges the sweep).
        pod_fn = getattr(node, "pod_doc", None)
        if pod_fn is not None:
            doc["pod"] = pod_fn()
            for g in range(self.num_groups):
                row = groups.get(str(g))
                if row is not None:
                    row["pod_owned"] = bool(node.owns_group(g))
        if self.witness_self:
            # Routers and the chaos harness key off this: witnesses
            # accept writes (forwarded like any follower) but must
            # never be picked as a read target.
            doc["witness"] = True
        # Elastic keyspace (raftsql_tpu/reshard/): the versioned
        # key->group mapping.  Clients cache this and fail closed when
        # a /kv response reports a newer epoch.
        if self.reshard is not None:
            doc["keymap"] = self.reshard.keymap.to_doc()
        # Read-replica tier (raftsql_tpu/replica/): stream listen port,
        # per-subscriber applied/lag tails and — the client sweep's
        # hook — the advertised replica HTTP endpoints, which
        # api/client.py adopts and routes read-mode traffic to.
        if self.replica_plane is not None:
            try:
                doc["replica"] = self.replica_plane.health_doc()
            except Exception:                           # noqa: BLE001
                pass        # readiness must never break on a gauge
        return doc

    def render_health(self) -> str:
        return json.dumps(self.health_doc(), sort_keys=True) + "\n"

    # -- observability exports (raftsql_tpu/obs/) ----------------------

    def trace_doc(self) -> dict:
        """Chrome trace-event JSON of the engine's span tracer + device
        event ring + tick-phase profiler tracks + any worker-process
        trace segments (GET /trace; Perfetto-loadable).  A `--workers N`
        deployment's document is ONE multi-process timeline: the
        engine's spans/phases plus each worker's pid-tagged request
        segment (runtime/ring.py RingServer points
        `trace_segments_dir` at the ring directory the workers flush
        into).  Always a valid (possibly empty) document — tracing off
        just yields no span events."""
        from raftsql_tpu_torch.obs.export import (chrome_trace,
                                                  collect_segments)
        node = self.pipe.node
        tracer = self._node_tracer()
        ring = getattr(node, "ring", None)
        prof = getattr(node, "prof", None)
        if ring is not None:
            ring.drain()
        seg_dir = getattr(self, "trace_segments_dir", None)
        segs = collect_segments(seg_dir) if seg_dir else None
        # One time axis for every track family: the tracer's epoch when
        # tracing is on, else the profiler's.
        base = tracer.t0 if tracer is not None else (
            prof.epoch if prof is not None else 0.0)
        # Cap the counter window: a long-lived ring (keep=4096 ticks)
        # would emit ~20 counter events per tick per (peer, group) —
        # the last 1024 ticks keep the document loadable.
        return chrome_trace(
            tracer.snapshot() if tracer is not None else None,
            ring.rows(last=1024) if ring is not None else None,
            phase_events=prof.events() if prof is not None else None,
            process_segments=segs,
            base_monotonic=base)

    def events_doc(self, last: int = 256) -> dict:
        """Raw observability state (GET /events): the device ring's
        drained per-tick rows plus the host tracer's snapshot."""
        node = self.pipe.node
        tracer = self._node_tracer()
        ring = getattr(node, "ring", None)
        if ring is not None:
            ring.drain()
        return {
            "tracing": tracer is not None or ring is not None,
            "device": ring.rows(last=last) if ring is not None else [],
            "host": tracer.snapshot() if tracer is not None else {},
        }

    def render_trace(self) -> str:
        return json.dumps(self.trace_doc(), sort_keys=True) + "\n"

    def render_events(self) -> str:
        return json.dumps(self.events_doc(), sort_keys=True) + "\n"

    def close(self) -> Optional[Exception]:
        """Shut down, failing (not leaking) any still-pending acks.

        The reference fatals on pending acks (db.go:159-161); failing them
        with an error instead is the conscious improvement — a node with
        in-flight proposals at shutdown (e.g. lost quorum) must still be
        able to close its WAL and state machines cleanly."""
        with self._mu:
            if self._closed:
                return None
            self._closed = True
            pending = [cb for cbs in self._q2cb.values() for cb in cbs]
            self._q2cb.clear()
        for cb in pending:
            cb.set(RuntimeError("db closing with proposal outstanding"))
        if self.replica_plane is not None:
            try:
                self.replica_plane.stop()
            except Exception:                           # noqa: BLE001
                pass
            self.replica_plane = None
        err = self.pipe.close()
        self._reader.join(timeout=10)
        for sm in self._sms.values():
            sm.close()
        return err
