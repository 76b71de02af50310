"""Engine side of the read-replica tier: the stream server.

Port of raftsql_tpu/replica/publisher.py.

`ReplicaStreamServer` rides the `ShmSnapshotPublisher` tee
(runtime/shm.py): every applied delta run, snapshot base and keymap
flip is mirrored — under the publisher lock, the instant it lands —
into per-subscriber bounded queues, and per-subscriber sender threads
frame them onto TCP (replica/stream.py) interleaved with TABLE
heartbeats carrying the watermark/lease/leader columns.

Bootstrap and resume share one invariant with the shm reader: a
subscriber must never see a delta stream whose prefix it is missing.
Registration runs INSIDE the publisher lock (`stream_register`), so
the returned log head and the first queued tee event are adjacent —
the server replays the publisher's append-only mmap log up to that
head (filtered by the subscriber's resume vector), then drains the
queue.  When the log can no longer cover a subscriber — the mmap
overflowed (`log_full`), or the subscriber's queue lapped — the server
RESYNCs: it discards the queue backlog and ships fresh `KIND_BASE`
images serialized from the live state machines, which the replica's
resume-mode fold makes idempotent.  Overflow therefore kills only the
local worker fast path, never the stream.

`attach_replica_plane(rdb, port)` is the `--replica-listen` wiring for
server/main.py: it reuses the RingServer's publisher when `--workers`
already attached one, else creates a publisher of its own (plus the
2ms refresh thread the lease columns need), then starts the server and
hangs it off `rdb.replica_plane` so /healthz and /metrics export the
tier.
"""
from __future__ import annotations

import logging
import queue
import socket
import tempfile
import threading
import time
from typing import Dict, List, Optional

from raftsql_tpu_torch.replica import stream as wire
from raftsql_tpu_torch.runtime.shm import KIND_BASE, KIND_DELTA

log = logging.getLogger("raftsql.replica")

# Tee events a subscriber may fall behind by before the server stops
# replaying its queue and re-images it from fresh bases instead.
QUEUE_DEPTH = 4096
TABLE_INTERVAL_S = 0.005


def _sever(conn: socket.socket) -> None:
    """shutdown(SHUT_RDWR) BEFORE close: close() alone neither wakes a
    sibling thread parked in recv() on the same socket nor sends the
    FIN while that syscall pins the file description — the peer would
    hang on a connection that is already dead on this side."""
    try:
        conn.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        conn.close()
    except OSError:
        pass


class _Subscriber:
    """One connected replica: its socket, bounded tee queue and the
    acked applied vector it reports back for /healthz lag."""

    def __init__(self, conn: socket.socket, endpoint: str,
                 resume: Dict[int, int]):
        self.conn = conn
        self.endpoint = endpoint
        self.resume = resume
        self.q: "queue.Queue" = queue.Queue(maxsize=QUEUE_DEPTH)
        self.needs_resync = False    # queue lapped: re-image, don't replay
        self.alive = True
        self.acked: Dict[int, int] = dict(resume)
        self.last_ack_ns = time.monotonic_ns()
        self._wmu = threading.Lock()  # raftlint: guarded-by=_wmu (sendall)

    def send(self, frame: bytes) -> None:
        with self._wmu:
            self.conn.sendall(frame)


class ReplicaStreamServer:
    """Accepts replica subscriptions and streams the publisher's
    delta/base log at them.  One accept thread; per subscriber, one
    sender thread (queue drain + TABLE heartbeat) and one reader
    thread (ACK vectors)."""

    def __init__(self, pub, port: int, host: str = ""):
        self.pub = pub
        self.host = host
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(32)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._mu = threading.Lock()
        self._subs: List[_Subscriber] = []   # raftlint: guarded-by=_mu
        self._threads: List[threading.Thread] = []
        # Stream counters (/metrics `replica.*`).
        self.deltas_tx = 0
        self.bases_tx = 0
        self.bytes_tx = 0
        self.resyncs = 0
        pub.tee = self._tee
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="replica-accept")

    def start(self) -> None:
        self._accept_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self.pub.tee is self._tee:
            self.pub.tee = None
        try:
            self._sock.close()
        except OSError:
            pass
        with self._mu:
            subs = list(self._subs)
        for sub in subs:
            sub.alive = False
            _sever(sub.conn)
        for t in list(self._threads):
            t.join(timeout=5)

    # -- tee (called on the APPLY thread, under the publisher lock) ------

    def _tee(self, *event) -> None:
        """Non-blocking fan-out of one publish event.  A full queue
        marks the subscriber for RESYNC instead of blocking: the apply
        thread must never wait on a slow replica."""
        with self._mu:
            subs = list(self._subs)
        for sub in subs:
            if not sub.alive:
                continue
            try:
                sub.q.put_nowait(event)
            except queue.Full:
                sub.needs_resync = True

    # -- per-connection plumbing ----------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return                       # socket closed: shutting down
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True, name="replica-conn")
            with self._mu:
                self._threads.append(t)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        sub: Optional[_Subscriber] = None
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            epoch, keymap_epoch, _full, _rows = self.pub.table_snapshot()
            conn.sendall(wire.encode_hello(epoch, keymap_epoch,
                                           self.pub.num_groups))
            kind, body = wire.read_frame(conn)
            if kind != wire.K_SUB:
                return
            endpoint, resume = wire.decode_subscribe(body)
            sub = _Subscriber(conn, endpoint, resume)
            # Register INSIDE the publisher lock: `head` and the first
            # queued tee event are adjacent — replaying [0, head) then
            # draining the queue reconstructs the full stream.
            head, full = self.pub.stream_register(
                lambda: self._register(sub))
            if full:
                # The mmap log can't cover bootstrap: re-image from
                # fresh serializations instead (counted as a resync —
                # it is one, just at subscribe time).
                self._send_fresh_bases(sub)
                with self._mu:
                    self.resyncs += 1
            else:
                self._replay_log(sub, head)
            reader = threading.Thread(target=self._read_loop, args=(sub,),
                                      daemon=True, name="replica-acks")
            with self._mu:
                self._threads.append(reader)
            reader.start()
            self._send_loop(sub)
        except (wire.StreamClosed, wire.StreamCorruptError, OSError,
                ValueError):
            pass                             # subscriber gone / garbage
        finally:
            if sub is not None:
                sub.alive = False
                with self._mu:
                    if sub in self._subs:
                        self._subs.remove(sub)
            _sever(conn)

    def _register(self, sub: _Subscriber) -> None:
        with self._mu:
            self._subs.append(sub)

    def _replay_log(self, sub: _Subscriber, head: int) -> None:
        """Bootstrap from the publisher's append-only log, skipping
        records the subscriber's resume vector already covers."""
        for kind, group, index, payload in \
                self.pub.read_log_records(0, head):
            if index <= sub.resume.get(group, 0):
                continue                     # replica already folded it
            self._send_rec(sub, kind, group, index, payload)

    def _send_fresh_bases(self, sub: _Subscriber) -> None:
        """RESYNC: ship a fresh image of every group that has state.
        Serialized OUTSIDE the publisher lock (state machines have
        their own); any tee events queued meanwhile land after these
        bases and dedup against them on the replica."""
        for g in range(self.pub.num_groups):
            got = self.pub.fresh_base(g)
            if got is None:
                continue
            idx, blob = got
            self._send_rec(sub, KIND_BASE, g, idx, blob)

    def _send_rec(self, sub: _Subscriber, kind: int, group: int,
                  index: int, payload: bytes) -> None:
        frame = wire.encode_rec(kind, group, index, payload)
        sub.send(frame)
        with self._mu:
            self.bytes_tx += len(frame)
            if kind == KIND_BASE:
                self.bases_tx += 1
            else:
                self.deltas_tx += 1

    def _send_table(self, sub: _Subscriber) -> None:
        epoch, keymap_epoch, full, rows = self.pub.table_snapshot()
        now = time.monotonic_ns()
        out = []
        for applied, commit, base, lease_ns, leader in rows:
            # Lease ships as REMAINING ns against the engine's clock:
            # monotonic bases don't transfer across hosts, and stamping
            # the remainder on arrival leaves the replica's deadline
            # conservatively EARLY by the one-way latency.
            remaining = lease_ns - now if lease_ns > now else 0
            out.append((applied, commit, base, remaining, leader))
        frame = wire.encode_table(epoch, keymap_epoch, full, out)
        sub.send(frame)
        with self._mu:
            self.bytes_tx += len(frame)

    def _send_loop(self, sub: _Subscriber) -> None:
        last_table = 0.0
        while sub.alive and not self._stop.is_set():
            try:
                event = sub.q.get(timeout=TABLE_INTERVAL_S / 2)
            except queue.Empty:
                event = None
            if sub.needs_resync:
                # Drop the lapped backlog, re-image.  Events teed
                # after this drain apply above the fresh bases.
                while True:
                    try:
                        sub.q.get_nowait()
                    except queue.Empty:
                        break
                sub.needs_resync = False
                self._send_fresh_bases(sub)
                with self._mu:
                    self.resyncs += 1
                event = None
            if event is not None:
                self._send_event(sub, event)
            now = time.monotonic()
            if now - last_table >= TABLE_INTERVAL_S:
                self._send_table(sub)
                last_table = now

    def _send_event(self, sub: _Subscriber, event) -> None:
        if event[0] == "deltas":
            for group, items in event[1].items():
                for sql, index in items:
                    self._send_rec(sub, KIND_DELTA, group, index,
                                   sql.encode("utf-8"))
        elif event[0] == "base":
            _, group, index, blob = event
            self._send_rec(sub, KIND_BASE, group, index, blob)
        elif event[0] == "keymap":
            self._send_table(sub)    # next snapshot carries the epoch

    def _read_loop(self, sub: _Subscriber) -> None:
        """Consume ACK frames: the replica's folded applied vector,
        exported as per-subscriber lag on the engine's /healthz."""
        try:
            while sub.alive and not self._stop.is_set():
                kind, body = wire.read_frame(sub.conn)
                if kind == wire.K_ACK:
                    sub.acked.update(wire.decode_ack(body))
                    sub.last_ack_ns = time.monotonic_ns()
        except (wire.StreamClosed, wire.StreamCorruptError, OSError,
                ValueError):
            sub.alive = False

    # -- observability ---------------------------------------------------

    def metrics_doc(self) -> dict:
        """The engine's `replica` /metrics section — the same six keys
        a detached engine zero-fills (runtime/db.py metrics), plus the
        byte counter.  `refusals` is 0 by construction here: refusing
        is the REPLICA's half of the ladder, reported on its own
        /metrics; `lag_ms` is the oldest subscriber's silence since
        its last ACK (0 with no subscribers)."""
        now = time.monotonic_ns()
        with self._mu:
            lag_ms = max((now - s.last_ack_ns for s in self._subs
                          if s.alive), default=0) / 1e6
            return {"subscribers": len(self._subs),
                    "deltas_tx": self.deltas_tx,
                    "bases_tx": self.bases_tx,
                    "resyncs": self.resyncs,
                    "refusals": 0,
                    "lag_ms": round(lag_ms, 3),
                    "bytes_tx": self.bytes_tx}

    def health_doc(self) -> dict:
        """The engine-side `replica` /healthz section: advertised
        subscriber endpoints (the client sweep adopts these) and
        per-subscriber applied/lag."""
        _epoch, _km, _full, rows = self.pub.table_snapshot()
        with self._mu:
            subs = list(self._subs)
            doc = {"listen": self.port,
                   "subscribers": len(subs),
                   "deltas_tx": self.deltas_tx,
                   "bases_tx": self.bases_tx,
                   "resyncs": self.resyncs,
                   "bytes_tx": self.bytes_tx,
                   "endpoints": [s.endpoint for s in subs if s.endpoint]}
        tails = []
        for s in subs:
            lag = {g: max(0, rows[g][0] - s.acked.get(g, 0))
                   for g in range(len(rows))}
            tails.append({"endpoint": s.endpoint,
                          "acked": {str(g): int(n)
                                    for g, n in sorted(s.acked.items())},
                          "lag": {str(g): int(n)
                                  for g, n in sorted(lag.items())}})
        doc["tails"] = tails
        return doc


def attach_replica_plane(rdb, port: int, host: str = ""):
    """Wire `--replica-listen PORT` onto a built RaftDB: reuse the
    RingServer's shm publisher when one is attached (--workers), else
    create a dedicated one (with its own 2ms lease-refresh thread) —
    then start the stream server and export it at rdb.replica_plane."""
    pub = getattr(rdb, "shm", None)
    owned_dir = None
    refresh_stop = None
    if pub is None:
        from raftsql_tpu_torch.runtime.shm import ShmSnapshotPublisher
        owned_dir = tempfile.mkdtemp(prefix="raftsql-replica-")
        pub = ShmSnapshotPublisher(owned_dir, rdb.num_groups)
        # Attach-then-start ordering (runtime/ring.py precedent): the
        # apply thread buffers deltas from the attach instant, start()
        # opens the log with base images below them.
        rdb.shm = pub
        pub.start(rdb._snapshot_of, rdb.watermark)
        node = getattr(getattr(rdb, "pipe", None), "node", None)
        commit_of = getattr(node, "commit_watermark", lambda g: 0)
        leader_of = getattr(node, "leader_of", lambda g: -1)
        lease_of = getattr(node, "lease_deadline_s", lambda g: 0.0)
        refresh_stop = threading.Event()

        def _refresh() -> None:
            while not refresh_stop.is_set():
                try:
                    pub.refresh(commit_of, leader_of, lease_of)
                except Exception:            # noqa: BLE001
                    log.exception("replica shm refresh failed; stopping")
                    return
                refresh_stop.wait(0.002)

        threading.Thread(target=_refresh, daemon=True,
                         name="replica-shm-refresh").start()
    srv = ReplicaStreamServer(pub, port, host)
    srv.start()

    base_stop = srv.stop

    def _stop() -> None:
        base_stop()
        if refresh_stop is not None:
            refresh_stop.set()
            if getattr(rdb, "shm", None) is pub:
                rdb.shm = None
            pub.close()
        if owned_dir is not None:
            import shutil
            shutil.rmtree(owned_dir, ignore_errors=True)

    srv.stop = _stop                         # type: ignore[method-assign]
    rdb.replica_plane = srv
    return srv
