"""Replica side of the read-replica tier: subscriber + facade.

Port of raftsql_tpu/replica/node.py.  A replica process steps no
consensus and never touches the card (the chaos runner and chip_smoke.py
spawn it with CUDA_VISIBLE_DEVICES="", and `python -m
raftsql_tpu_torch.replica` hides the cards itself).

`ReplicaSubscriber` maintains the upstream connection: subscribe with
the high-water {group: applied} resume vector, fold REC frames into
per-group in-memory SQLite replicas exactly as the shm reader's
_catch_up does (KIND_BASE installs only above the local applied index;
KIND_DELTA rides the resume-mode state machine's `index <= applied`
dedup, so replays and re-images are idempotent), track the TABLE
heartbeat (watermark / lease / leader columns, with the lease deadline
re-based onto the replica's own CLOCK_MONOTONIC from the wire's
*remaining* nanoseconds — conservatively early by the one-way
latency), and reconnect with backoff on any error.  A corrupt frame
(CRC mismatch) poisons the connection — framing can't be re-trusted
past the first bad byte — so the subscriber counts it, drops, and
resubscribes; the publisher replays or re-images from the vector.

`ReplicaDB` fronts the subscriber with the same facade surface RaftDB
gives both HTTP planes, so api/http.py and api/aio.py serve a replica
process UNCHANGED.  The read ladder is the shm reader's, transplanted
— and every unprovable mode FAILS CLOSED as a 421 (`ReplicaRefusal`,
a NotLeaderError) carrying the upstream leader hint, pointing the
client back at the authoritative tier:

  * any mode    — refused until the stream has attached (epoch 0);
  * local       — the replica's current fold: arbitrary staleness is
                  this mode's documented contract, served always;
  * session     — refused unless the folded applied index covers the
                  client's X-Raft-Session watermark within a short
                  bounded wait (the engine BLOCKS authoritatively; a
                  WAN replica refuses fast so the client falls back);
  * follower    — refused unless the TABLE heartbeat is fresh
                  (PUB_STALE_NS) and the fold covers the upstream
                  commit watermark it carries;
  * linear      — stream-ReadIndex: wait for a TABLE received AFTER
                  the request arrived (the commit point it carries is
                  then >= every write acked before the read began),
                  require the leader lease to cover local now and the
                  heartbeat to be fresh, wait for the fold to reach
                  that commit point, re-check the lease at serve time.
                  The Paxos-vs-Raft survey's lease envelope, with the
                  one-way-latency-early local deadline as margin.

Proposals, membership changes and transfers refuse with the same 421:
the replica tier is read-only by construction.

`--unsafe-serve` (chaos falsification ONLY) disables the session and
linear gates: the replica then serves below acked watermarks and past
its lease horizon, and `make chaos-replica`'s StaleReadNever invariant
MUST catch it.
"""
from __future__ import annotations

import json
import socket
import threading
import time
from typing import Dict, Optional, Tuple

from raftsql_tpu_torch.models.sqlite_sm import SQLiteStateMachine, is_select
from raftsql_tpu_torch.overload import Overloaded, zero_metrics_doc
from raftsql_tpu_torch.replica import stream as wire
from raftsql_tpu_torch.runtime.db import NotLeaderError
from raftsql_tpu_torch.runtime.shm import KIND_BASE, KIND_DELTA, PUB_STALE_NS

ACK_INTERVAL_S = 0.05
RECONNECT_DELAY_S = 0.1
# Bound on every ladder gate wait: a WAN replica refuses FAST and lets
# the client fall back to the write tier rather than burning the
# client's deadline blocking the way the engine (authoritatively) may.
GATE_WAIT_S = 0.25

_MODES = ("local", "session", "follower", "linear")


class ReplicaRefusal(NotLeaderError):
    """A fail-closed ladder refusal: 421 + the upstream leader hint.
    Subclasses NotLeaderError so both HTTP planes' existing handlers
    route it; `reason` names the failed gate for counters and logs."""

    def __init__(self, group: int, leader: int, reason: str):
        Exception.__init__(
            self, f"group {group}: replica refuses ({reason})"
            + (f"; leader is node {leader}" if leader > 0 else ""))
        self.group = group
        self.leader = leader
        self.reason = reason


class ReplicaSubscriber:
    """Owns the upstream connection and the folded per-group state.

    All folded state (_sms, _tbl, epoch columns, counters) is guarded
    by _cond's lock; the fold thread notifies it on every applied
    advance and TABLE arrival so ladder gates can wait without
    polling."""

    def __init__(self, upstream: Tuple[str, int], advertise: str = ""):
        self.upstream = upstream
        self.advertise = advertise
        self._cond = threading.Condition()
        self._sms: Dict[int, SQLiteStateMachine] = {}  # raftlint: guarded-by=_cond
        self.epoch = 0               # 0 = never attached: refuse all
        self.keymap_epoch = 0
        self.num_groups = 0
        self.connected = False
        self._tbl: Optional[dict] = None   # rx_ns, log_full, rows
        self.bytes_rx = 0
        self.recs_rx = 0
        self.bases_rx = 0
        self.resyncs = 0             # epoch resets + re-images over state
        self.corrupt_frames = 0
        self.connects = 0
        self._stop = threading.Event()
        self._sock: Optional[socket.socket] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="replica-subscribe")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        sock = self._sock
        if sock is not None:
            # shutdown BEFORE close: close() alone leaves the fold
            # thread parked in recv() (the in-flight syscall pins the
            # file description on Linux) — shutdown delivers the EOF.
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self._thread.join(timeout=5)

    # -- connection loop -------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._session()
            except wire.StreamCorruptError:
                # Poisoned framing: count, drop, resubscribe with the
                # resume vector.  Never fold past the first bad byte.
                with self._cond:
                    self.corrupt_frames += 1
            except (wire.StreamClosed, OSError, ValueError):
                pass
            finally:
                with self._cond:
                    self.connected = False
                    self._cond.notify_all()
            self._stop.wait(RECONNECT_DELAY_S)

    def _session(self) -> None:
        sock = socket.create_connection(self.upstream, timeout=5.0)
        self._sock = sock
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(None)
            kind, body = wire.read_frame(sock)
            if kind != wire.K_HELLO:
                raise wire.StreamClosed("expected HELLO")
            hello = wire.decode_hello(body)
            with self._cond:
                if self.epoch and hello["epoch"] != self.epoch:
                    # New engine incarnation: the shm reader's stale-
                    # epoch rule, with refold instead of death — the
                    # stream re-images us from the new log.
                    self._sms.clear()
                    self._tbl = None
                    self.resyncs += 1
                self.epoch = hello["epoch"]
                self.keymap_epoch = hello["keymap_epoch"]
                self.num_groups = max(self.num_groups, hello["groups"])
                resume = {g: sm.applied_index()
                          for g, sm in self._sms.items()}
            sock.sendall(wire.encode_subscribe(self.advertise, resume))
            with self._cond:
                self.connected = True
                self.connects += 1
                self._cond.notify_all()
            last_ack = 0.0
            while not self._stop.is_set():
                kind, body = wire.read_frame(sock)
                with self._cond:
                    self.bytes_rx += len(body) + 9
                if kind == wire.K_REC:
                    self._fold_rec(*wire.decode_rec(body))
                elif kind == wire.K_TABLE:
                    self._fold_table(body)
                now = time.monotonic()
                if now - last_ack >= ACK_INTERVAL_S:
                    with self._cond:
                        acked = {g: sm.applied_index()
                                 for g, sm in self._sms.items()}
                    sock.sendall(wire.encode_ack(acked))
                    last_ack = now
        finally:
            self._sock = None
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    # -- folding ---------------------------------------------------------

    def _fold_rec(self, kind: int, group: int, index: int,
                  payload: bytes) -> None:
        with self._cond:
            sm = self._sms.get(group)
            if sm is None:
                sm = SQLiteStateMachine(":memory:", resume=True)
                self._sms[group] = sm
            self.recs_rx += 1
            if kind == KIND_BASE:
                if index > sm.applied_index():
                    if sm.applied_index() > 0:
                        self.resyncs += 1    # re-imaged over live state
                    sm.install(payload, index)
                    self.bases_rx += 1
            elif kind == KIND_DELTA:
                # resume-mode state machine skips index <= applied —
                # replay and tee overlap are harmless, exactly as in
                # ShmSnapshotReader._catch_up.
                sm.apply(payload.decode("utf-8"), index)
            self._cond.notify_all()

    def _fold_table(self, body: bytes) -> None:
        epoch, keymap_epoch, log_full, rows = wire.decode_table(body)
        now = time.monotonic_ns()
        local = []
        for applied, commit, base, remaining, leader in rows:
            # Re-base the lease onto OUR monotonic clock: early by the
            # one-way latency, never late.
            lease_local = now + remaining if remaining > 0 else 0
            local.append((applied, commit, base, lease_local, leader))
        with self._cond:
            if self.epoch and epoch != self.epoch:
                raise wire.StreamClosed("epoch changed mid-stream")
            self.keymap_epoch = keymap_epoch
            self.num_groups = max(self.num_groups, len(local))
            self._tbl = {"rx_ns": now, "log_full": log_full,
                         "rows": local}
            self._cond.notify_all()

    # -- folded-state accessors (callers hold _cond) ---------------------

    def applied_locked(self, group: int) -> int:
        sm = self._sms.get(group)
        return int(sm.applied_index()) if sm is not None else 0

    def leader_locked(self, group: int) -> int:
        tbl = self._tbl
        if tbl is None or not 0 <= group < len(tbl["rows"]):
            return 0
        return int(tbl["rows"][group][4])

    def heartbeat_age_ns_locked(self) -> int:
        if self._tbl is None:
            return 1 << 62
        return time.monotonic_ns() - self._tbl["rx_ns"]

    def wait_applied_locked(self, group: int, target: int,
                            deadline: float) -> bool:
        while self.applied_locked(group) < target:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            self._cond.wait(remaining)
        return True

    def wait_table_after_locked(self, t0_ns: int,
                                deadline: float) -> Optional[dict]:
        while self._tbl is None or self._tbl["rx_ns"] <= t0_ns:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            self._cond.wait(remaining)
        return self._tbl


class ReplicaDB:
    """The RaftDB facade over a ReplicaSubscriber: both HTTP planes
    serve it unchanged.  Reads run the fail-closed ladder; every write
    or admin verb refuses 421 toward the authoritative tier."""

    def __init__(self, sub: ReplicaSubscriber, unsafe_serve: bool = False,
                 write_cap: int = 0):
        self.sub = sub
        self.unsafe_serve = unsafe_serve
        self.reshard = None          # /kv and POST /reshard answer 503
        self.placement = None
        self._mu = threading.Lock()
        self.hits = {m: 0 for m in _MODES}      # raftlint: guarded-by=_mu
        self.refusals: Dict[str, int] = {}      # raftlint: guarded-by=_mu
        # Write-fallback admission: the redirect lookup contends the
        # fold lock, so a misdirected-write stampede must be shed (429
        # + Retry-After) before it queues unboundedly on _cond and
        # starves the subscriber.  0 = unbounded (seed behaviour).
        self.write_cap = int(write_cap)
        self._write_inflight = 0                # raftlint: guarded-by=_mu
        self._overloaded = 0                    # raftlint: guarded-by=_mu
        self._closed = False

    @property
    def num_groups(self) -> int:
        return max(1, self.sub.num_groups)

    # -- the read ladder -------------------------------------------------

    def _refuse(self, group: int, leader: int, reason: str):
        with self._mu:
            self.refusals[reason] = self.refusals.get(reason, 0) + 1
        raise ReplicaRefusal(group, leader, reason)

    # raftlint: fail-closed
    def query(self, query: str, group: int = 0, linear: bool = False,
              timeout: float = 10.0, mode: Optional[str] = None,
              watermark: int = 0,
              deadline_ms: Optional[float] = None, brownout: bool = False,
              info: Optional[dict] = None) -> str:
        if not is_select(query):
            raise ValueError("replica tier is read-only (expected SELECT)")
        mode = (mode or ("linear" if linear else "local")).lower()
        if mode not in _MODES:
            raise ValueError(f"unknown consistency mode {mode!r}")
        if deadline_ms is not None:
            # The caller's end-to-end budget caps every gate wait; the
            # plane already shed <=0 at the edge.
            timeout = min(float(timeout or GATE_WAIT_S),
                          max(deadline_ms / 1000.0, 0.0))
        if info is not None:
            # The replica never silently downgrades: the mode asked for
            # is the mode served (a failed gate refuses instead), so the
            # served-mode contract header is just the request mode.
            info["served"] = mode
        sub = self.sub
        bound = max(0.01, min(float(timeout or GATE_WAIT_S), GATE_WAIT_S))
        with sub._cond:
            leader = sub.leader_locked(group)
            if sub.epoch == 0:
                self._refuse(group, leader, "no-stream")
            if group < 0 or (sub.num_groups and group >= sub.num_groups):
                raise ValueError(f"group {group} out of range")
            deadline = time.monotonic() + bound
            if mode == "session" and not self.unsafe_serve:
                if not sub.wait_applied_locked(group, watermark, deadline):
                    self._refuse(group, sub.leader_locked(group),
                                 "watermark-uncovered")
            elif mode == "follower":
                if sub.heartbeat_age_ns_locked() > PUB_STALE_NS:
                    self._refuse(group, leader, "heartbeat-stale")
                commit = sub._tbl["rows"][group][1]
                if not sub.wait_applied_locked(group, commit, deadline):
                    self._refuse(group, sub.leader_locked(group),
                                 "apply-lag")
            elif mode == "linear" and not self.unsafe_serve:
                # Stream-ReadIndex: a TABLE received after t0 carries a
                # commit point >= every write acked before this read
                # began; folding to it under a live lease gives the
                # leader-lease linearizability envelope.
                t0 = time.monotonic_ns()
                tbl = sub.wait_table_after_locked(t0, deadline)
                if tbl is None:
                    self._refuse(group, leader, "heartbeat-stale")
                applied_pub, commit, _b, lease, _l = tbl["rows"][group]
                if lease <= 0 or time.monotonic_ns() >= lease:
                    self._refuse(group, sub.leader_locked(group),
                                 "lease-lapsed")
                if not sub.wait_applied_locked(group, commit, deadline):
                    self._refuse(group, sub.leader_locked(group),
                                 "apply-lag")
                # Re-check at serve time: the wait may have outlived
                # the lease that justified the read point.
                tbl = sub._tbl
                if tbl is None \
                        or sub.heartbeat_age_ns_locked() > PUB_STALE_NS:
                    self._refuse(group, sub.leader_locked(group),
                                 "heartbeat-stale")
                lease_now = tbl["rows"][group][3]
                if lease_now <= 0 or time.monotonic_ns() >= lease_now:
                    self._refuse(group, sub.leader_locked(group),
                                 "lease-lapsed")
            sm = sub._sms.get(group)
            if sm is None:
                sm = SQLiteStateMachine(":memory:", resume=True)
                sub._sms[group] = sm
        with self._mu:
            self.hits[mode] += 1
        return sm.query(query)       # sm has its own lock; SQL errors
        #                              surface as the planes' 400 class

    def watermark(self, group: int = 0) -> int:
        with self.sub._cond:
            return self.sub.applied_locked(group)

    # -- the write/admin surface: refuse toward the write tier -----------

    # raftlint: fail-closed
    def _admit_write(self) -> None:
        """Bounded budget on the write-fallback path: each refusal
        still takes the fold lock for the leader hint, so a stampede
        of misdirected writes is shed with a typed Overloaded (the
        planes answer 429 + Retry-After) once `write_cap` lookups are
        already in flight, rather than queueing without bound."""
        with self._mu:
            if self.write_cap > 0 and self._write_inflight >= self.write_cap:
                self.refusals["overloaded"] = \
                    self.refusals.get("overloaded", 0) + 1
                self._overloaded += 1
                raise Overloaded(
                    "replica",
                    min(0.05 * (1 + self._write_inflight), 5.0),
                    "write-fallback budget exhausted")
            self._write_inflight += 1
            return None

    def _leader_hint(self, group: int) -> int:
        # Admission precedes the try: on refusal nothing was admitted,
        # so only a successful admit reaches the decrement.
        self._admit_write()
        try:
            with self.sub._cond:
                return self.sub.leader_locked(group)
        finally:
            with self._mu:
                self._write_inflight -= 1

    def propose(self, query: str, group: int = 0,
                token: Optional[int] = None,
                deadline_ms: Optional[float] = None):
        leader = self._leader_hint(group)
        self._refuse(group, leader, "read-only-tier")

    def abandon(self, query: str, group: int, fut) -> None:
        pass                         # nothing in flight, ever

    def member_change(self, group: int, *a, **k):
        leader = self._leader_hint(group)
        self._refuse(group, leader, "read-only-tier")

    def transfer(self, group: int, *a, **k):
        leader = self._leader_hint(group)
        self._refuse(group, leader, "read-only-tier")

    # -- observability ---------------------------------------------------

    def health_doc(self) -> dict:
        sub = self.sub
        with sub._cond:
            tbl = sub._tbl
            rows = tbl["rows"] if tbl is not None else []
            n = sub.num_groups or len(rows)
            groups = {}
            for g in range(n):
                commit = rows[g][1] if g < len(rows) else 0
                leader = rows[g][4] if g < len(rows) else 0
                applied = sub.applied_locked(g)
                groups[str(g)] = {"role": "replica",
                                  "leader": int(leader),
                                  "applied": int(applied),
                                  "lag": int(max(0, commit - applied))}
            hb = sub.heartbeat_age_ns_locked()
            doc = {"id": 0, "ready": sub.connected, "groups": groups,
                   "replica": {
                       "upstream": f"{sub.upstream[0]}:{sub.upstream[1]}",
                       "epoch": int(sub.epoch),
                       "keymap_epoch": int(sub.keymap_epoch),
                       "connected": bool(sub.connected),
                       "connects": int(sub.connects),
                       "applied": {str(g): int(sub.applied_locked(g))
                                   for g in range(n)},
                       "lag": {g: r["lag"] for g, r in groups.items()},
                       "bytes_rx": int(sub.bytes_rx),
                       "recs_rx": int(sub.recs_rx),
                       "bases_rx": int(sub.bases_rx),
                       "resyncs": int(sub.resyncs),
                       "corrupt_frames": int(sub.corrupt_frames),
                       "heartbeat_age_ms": round(min(hb, 1 << 53) / 1e6,
                                                 3),
                   }}
        if self.unsafe_serve:
            doc["replica"]["unsafe_serve"] = True
        return doc

    def metrics(self) -> dict:
        sub = self.sub
        with self._mu:
            hits = dict(self.hits)
            refusals = dict(self.refusals)
        with sub._cond:
            hb = sub.heartbeat_age_ns_locked()
            m = {
                # The same six-key section the engine exports, so one
                # dashboard reads both tiers (scripts/check_prom.py
                # requires the engine-side series).
                "replica": {
                    "subscribers": 0,
                    "deltas_tx": 0,
                    "bases_tx": 0,
                    "resyncs": int(sub.resyncs),
                    "refusals": sum(refusals.values()),
                    "lag_ms": round(min(hb, 1 << 53) / 1e6, 3),
                },
                "replica_reads": hits,
                "replica_refusals": refusals,
                "replica_stream": {
                    "bytes_rx": int(sub.bytes_rx),
                    "recs_rx": int(sub.recs_rx),
                    "bases_rx": int(sub.bases_rx),
                    "corrupt_frames": int(sub.corrupt_frames),
                    "connects": int(sub.connects),
                },
            }
        # Same overload section the engine exports (zeros-by-default);
        # only the write-fallback budget is live on this tier.
        ov = zero_metrics_doc()
        with self._mu:
            ov["rejected"] = int(self._overloaded)
            ov["total_cap"] = int(self.write_cap)
        m["overload"] = ov
        return m

    def members(self) -> dict:
        return {"replica": True, "upstream":
                f"{self.sub.upstream[0]}:{self.sub.upstream[1]}"}

    def trace_doc(self) -> dict:
        return {"traceEvents": []}

    def events_doc(self, last: int = 256) -> dict:
        return {"events": [], "spans": {}}

    def render_health(self) -> str:
        return json.dumps(self.health_doc(), sort_keys=True) + "\n"

    def render_metrics(self) -> str:
        return json.dumps(self.metrics(), sort_keys=True) + "\n"

    def render_metrics_prom(self) -> str:
        from raftsql_tpu_torch.utils.metrics import prom_render
        return prom_render(self.metrics())

    def render_members(self) -> str:
        return json.dumps(self.members(), sort_keys=True) + "\n"

    def render_trace(self) -> str:
        return json.dumps(self.trace_doc(), sort_keys=True) + "\n"

    def render_events(self) -> str:
        return json.dumps(self.events_doc(), sort_keys=True) + "\n"

    def close(self) -> Optional[Exception]:
        with self._mu:
            if self._closed:
                return None
            self._closed = True
        self.sub.stop()
        with self.sub._cond:
            for sm in self.sub._sms.values():
                try:
                    sm.close()
                except Exception:    # noqa: BLE001
                    pass
        return None
