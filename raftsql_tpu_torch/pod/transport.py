"""The pod collective: a per-tick all-gather over host boundaries.

Port of raftsql_tpu/pod/transport.py, unchanged: the frames are JSON
with base64 payloads, byte for byte the JAX package's for the same
gather, so a pod may mix hosts of both packages.

One primitive carries every cross-host plane the pod needs:

    gather(tag, payload) -> [payload_0, ..., payload_{N-1}]

Each process contributes one byte blob per tick and receives every
process's blob, indexed by proc id.  That single collective is

  * the PROPOSE plane — a proposal accepted on any host rides its
    origin's contribution and lands, merged in pod-global sequence
    order, on every host (including the one owning the group's shard);
  * the ACK plane — the owning host's durable-commit acknowledgements
    ride back the same way;
  * the TICK + FSYNC BARRIER — a process only contributes tick t+1's
    gather after finishing tick t's durable phase, so no host's fsync
    can lag the dispatch it framed (the `multihost_utils`-style sync
    point, implemented on host sockets because it synchronizes the
    HOST plane, not device math);
  * the REPLAY exchange at boot (pod/node.py): each host contributes
    the shards it replayed from local disk and receives the full
    cluster image.

Topology is a coordinator star (proc 0 accepts N-1 connections,
collects, broadcasts) — one round trip per tick, no peer discovery.
Failure model is FAIL-STOP AND POD-WIDE: any socket loss (a SIGKILLed
member, a dead coordinator, a partition) raises PodPeerLost, and the
process exits — a pod is one SPMD program, and one host dying kills
the program; the supervisor (chaos/pod.py, or an operator) restarts
the pod, which rebuilds from the merged on-disk replay.  The
coordinator broadcasts an explicit abort frame to survivors first so
they fail fast instead of timing out.

`LocalPodTransport` is the procs == 1 degenerate pod (gather returns
your own contribution) — it lets every pod code path run in-process
for tests and for the `--pod` server's single-host mode.
"""
from __future__ import annotations

import base64
import json
import socket
import struct
import time
from typing import Dict, List, Optional

# One frame per process per collective; 64 MiB bounds a malicious or
# corrupt length prefix, far above any real replay contribution.
_FRAME_LIMIT = 64 << 20
_ABORT_TAG = "!abort"


class PodPeerLost(RuntimeError):
    """A pod member (or the coordinator) is gone: the collective cannot
    complete, and this process must exit so the supervisor can restart
    the pod.  Fail-closed — never proceed on a partial gather."""


class LocalPodTransport:
    """The one-process pod: every collective is the identity."""

    procs = 1
    proc_id = 0

    def __init__(self) -> None:
        self.bytes_tx = 0
        self.bytes_rx = 0
        self.gathers = 0

    def gather(self, tag: str, payload: bytes) -> List[bytes]:
        self.gathers += 1
        return [payload]

    def barrier(self, tag: str) -> None:
        self.gathers += 1

    def close(self) -> None:
        pass


def _send_frame(sock: socket.socket, doc: dict) -> int:
    blob = json.dumps(doc, sort_keys=True,
                      separators=(",", ":")).encode()
    try:
        sock.sendall(struct.pack(">I", len(blob)) + blob)
    except OSError as e:
        raise PodPeerLost(f"pod send failed: {e!r}") from e
    return len(blob) + 4


def _recv_frame(sock: socket.socket) -> dict:
    def read_exact(n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            try:
                chunk = sock.recv(n - len(buf))
            except OSError as e:
                raise PodPeerLost(f"pod recv failed: {e!r}") from e
            if not chunk:
                raise PodPeerLost("pod peer closed the connection")
            buf += chunk
        return buf

    (ln,) = struct.unpack(">I", read_exact(4))
    if ln > _FRAME_LIMIT:
        raise PodPeerLost(f"pod frame length {ln} over limit")
    doc = json.loads(read_exact(ln).decode())
    if doc.get("tag") == _ABORT_TAG:
        raise PodPeerLost("pod aborted by coordinator "
                          f"({doc.get('why', 'peer lost')})")
    return doc


class TcpPodTransport:
    """The coordinator-star collective over localhost/DCN TCP sockets.

    Lockstep protocol: every process calls gather(tag, ...) with the
    SAME tag sequence (the pod tick loop guarantees it), so frames
    never interleave across collectives — a mismatched tag is a
    protocol bug and raises immediately rather than mis-merging
    planes.  Thread model: one thread per process drives the
    collective (the tick thread); no internal locking is needed."""

    def __init__(self, procs: int, proc_id: int, coordinator: str,
                 connect_timeout_s: float = 30.0,
                 io_timeout_s: float = 600.0):
        if procs < 2:
            raise ValueError("TcpPodTransport needs >= 2 processes; "
                             "use LocalPodTransport for procs == 1")
        self.procs = procs
        self.proc_id = proc_id
        self.coordinator = coordinator
        self.bytes_tx = 0
        self.bytes_rx = 0
        self.gathers = 0
        self._io_timeout_s = io_timeout_s
        self._closed = False
        host, port = coordinator.rsplit(":", 1)
        if proc_id == 0:
            self._peers = self._accept_members(host, int(port),
                                               connect_timeout_s)
            self._conn: Optional[socket.socket] = None
        else:
            self._conn = self._dial(host, int(port), connect_timeout_s)
            self._peers = {}

    # -- connection setup ----------------------------------------------

    def _accept_members(self, host: str, port: int,
                        timeout_s: float) -> Dict[int, socket.socket]:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(self.procs)
        srv.settimeout(timeout_s)
        peers: Dict[int, socket.socket] = {}
        try:
            while len(peers) < self.procs - 1:
                try:
                    conn, _ = srv.accept()
                except socket.timeout as e:
                    raise PodPeerLost(
                        f"pod formation timed out: {len(peers) + 1} of "
                        f"{self.procs} processes present") from e
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn.settimeout(self._io_timeout_s)
                reg = _recv_frame(conn)
                p = int(reg["proc"])
                if reg.get("tag") != "!register" or \
                        not 0 < p < self.procs or p in peers:
                    raise PodPeerLost(f"bad pod registration: {reg}")
                peers[p] = conn
        finally:
            srv.close()
        return peers

    def _dial(self, host: str, port: int,
              timeout_s: float) -> socket.socket:
        deadline = time.monotonic() + timeout_s
        last: Optional[Exception] = None
        while time.monotonic() < deadline:
            try:
                conn = socket.create_connection((host, port), timeout=2.0)
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn.settimeout(self._io_timeout_s)
                self.bytes_tx += _send_frame(
                    conn, {"tag": "!register", "proc": self.proc_id})
                return conn
            except OSError as e:   # coordinator not up yet: retry
                last = e
                time.sleep(0.05)
        raise PodPeerLost(f"could not reach pod coordinator "
                          f"{host}:{port}: {last!r}")

    # -- the collective ------------------------------------------------

    def gather(self, tag: str, payload: bytes) -> List[bytes]:
        self.gathers += 1
        if self.proc_id == 0:
            return self._gather_coordinator(tag, payload)
        return self._gather_member(tag, payload)

    def _gather_coordinator(self, tag: str,
                            payload: bytes) -> List[bytes]:
        parts: List[Optional[bytes]] = [None] * self.procs
        parts[0] = payload
        try:
            for p, conn in self._peers.items():
                doc = _recv_frame(conn)
                self.bytes_rx += len(doc.get("data", ""))
                if doc.get("tag") != tag or int(doc.get("proc")) != p:
                    raise PodPeerLost(
                        f"pod collective desync: expected {tag!r} from "
                        f"proc {p}, got {doc.get('tag')!r} from "
                        f"{doc.get('proc')}")
                parts[p] = base64.b64decode(doc["data"])
        except PodPeerLost as e:
            self._abort_survivors(repr(e))
            raise
        out = {"tag": tag,
               "parts": [base64.b64encode(b or b"").decode()
                         for b in parts]}
        for conn in self._peers.values():
            self.bytes_tx += _send_frame(conn, out)
        return [b if b is not None else b"" for b in parts]

    def _gather_member(self, tag: str, payload: bytes) -> List[bytes]:
        self.bytes_tx += _send_frame(
            self._conn, {"tag": tag, "proc": self.proc_id,
                         "data": base64.b64encode(payload).decode()})
        doc = _recv_frame(self._conn)
        if doc.get("tag") != tag:
            raise PodPeerLost(f"pod collective desync: expected "
                              f"{tag!r}, got {doc.get('tag')!r}")
        parts = [base64.b64decode(x) for x in doc["parts"]]
        self.bytes_rx += sum(len(x) for x in parts)
        if len(parts) != self.procs:
            raise PodPeerLost(f"pod gather returned {len(parts)} parts "
                              f"for {self.procs} processes")
        return parts

    def barrier(self, tag: str) -> None:
        self.gather(tag, b"")

    def _abort_survivors(self, why: str) -> None:
        """Best-effort fail-fast fan-out: tell every still-connected
        member the pod is dead so it exits now instead of at its io
        timeout.  Errors here are ignored — we are already failing."""
        for conn in self._peers.values():
            try:
                _send_frame(conn, {"tag": _ABORT_TAG, "why": why})
            except Exception:
                pass

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for conn in self._peers.values():
            try:
                conn.close()
            except OSError:
                pass
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass


def make_transport(procs: int, proc_id: int, coordinator: str,
                   connect_timeout_s: float = 30.0,
                   io_timeout_s: float = 600.0):
    if procs == 1:
        return LocalPodTransport()
    return TcpPodTransport(procs, proc_id, coordinator,
                           connect_timeout_s=connect_timeout_s,
                           io_timeout_s=io_timeout_s)
