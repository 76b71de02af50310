"""TCP transport — the DCN peer message plane between hosts.

Replaces the reference's vendored `etcd/rafthttp` streams (reference
raft.go:170-184, 248-266) with persistent length-prefixed-frame TCP
connections carrying encoded TickBatches:

    frame := u32 payload_len | u32 src_node_id | payload(TickBatch codec)

Liveness model matches rafthttp's: outbound sends to unreachable peers are
dropped (raft re-sends every heartbeat tick), reconnection is automatic
with backoff, and only *local* listener failure is fatal — it surfaces via
on_error and tears the node down (reference raft.go:237-239).

Each peer gets a dedicated sender thread with a bounded queue so a slow or
dead peer can never stall the tick loop.  Accepted connections get TCP
keepalive, standing in for the reference's 3-minute keepalive period
(listener.go:55-57).

Robustness (PR 2 fault matrix):
  * payloads are CRC32-framed (codec.encode_batch_framed) — a frame
    corrupted anywhere between hosts is DROPPED and counted
    (NodeMetrics.faults_corrupt_frames via the `metrics` attribute the
    node wires in), and the recv loop keeps serving later frames;
  * any decode exception is confined to the frame: it can no longer
    kill the connection thread silently — the frame is skipped, the
    length-prefixed stream stays in sync, the listener stays alive;
  * `SendFaults` is the injectable send-side fault seam mirroring
    transport/faults.py's device-plane masks: seeded drop / corrupt /
    delay / one-directional block applied to encoded frames, so the
    chaos harness (chaos/scenarios.py) exercises THIS transport, not a
    stand-in.

Copy of raftsql_tpu/transport/tcp.py for the PyTorch port.
"""
from __future__ import annotations

import logging
import queue
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from raftsql_tpu_torch.transport.base import TickBatch, Transport
from raftsql_tpu_torch.transport.codec import (FrameCorruptError,
                                               decode_batch_framed,
                                               encode_batch_framed)

log = logging.getLogger("raftsql_tpu_torch.tcp")

_FRAME = struct.Struct("<II")
_RECONNECT_S = 0.2
_QUEUE_CAP = 1024
# Upper bound on an inbound frame.  The u32 length field would otherwise
# let a corrupt or hostile peer make us buffer 4 GiB; a frame this large is
# never legitimate (batches are bounded by max_entries_per_msg per group),
# so the connection is dropped instead — the node itself must survive bad
# peers (see runtime/node.py _deliver).
_MAX_FRAME = 64 << 20


class SendFaults:
    """Seeded send-side fault injection for TcpTransport.

    The device plane's chaos masks (transport/faults.py) cannot reach
    this transport — frames leave through real sockets.  This seam
    applies the same fault classes to each ENCODED frame at send time:

      * one-directional blocks (`block`/`unblock`): frames to a blocked
        dst are dropped while the reverse direction flows — the
        asymmetric-partition failure mode;
      * seeded random drop (p_drop), corruption (p_corrupt — one byte
        of the framed payload is flipped, so the receiver's CRC check
        must catch and drop it), and delay (p_delay, delay_s — the
        frame is re-offered later from a timer thread, modeling
        out-of-order arrival).

    Thread-safe; all decisions come from one seeded rng so a given
    (seed, send sequence) reproduces the same fault pattern.
    """

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._blocked: Set[int] = set()
        self.p_drop = 0.0
        self.p_corrupt = 0.0
        self.p_delay = 0.0
        self.delay_s = 0.0
        self.dropped = 0
        self.corrupted = 0
        self.delayed = 0

    def block(self, dst: int) -> None:
        """Stop delivering to node `dst` (1-based) — one direction only."""
        with self._lock:
            self._blocked.add(dst)

    def heal(self) -> None:
        with self._lock:
            self._blocked.clear()

    def set_rates(self, p_drop: float = 0.0, p_corrupt: float = 0.0,
                  p_delay: float = 0.0, delay_s: float = 0.0) -> None:
        with self._lock:
            self.p_drop = p_drop
            self.p_corrupt = p_corrupt
            self.p_delay = p_delay
            self.delay_s = delay_s

    def apply(self, dst: int, blob: bytes
              ) -> Optional[Tuple[bytes, float]]:
        """(possibly-mangled blob, delay_s) — or None to drop."""
        with self._lock:
            if dst in self._blocked:
                self.dropped += 1
                return None
            if self.p_drop and self._rng.random() < self.p_drop:
                self.dropped += 1
                return None
            if self.p_corrupt and self._rng.random() < self.p_corrupt:
                i = int(self._rng.integers(0, len(blob)))
                blob = blob[:i] + bytes([blob[i] ^ 0x5A]) + blob[i + 1:]
                self.corrupted += 1
            if self.p_delay and self._rng.random() < self.p_delay:
                self.delayed += 1
                return blob, self.delay_s
        return blob, 0.0


def parse_peer_url(url: str) -> Tuple[str, int]:
    """Accept the reference's peer URL form `http://host:port`
    (Procfile:2-4) or bare `host:port`."""
    hostport = url.split("://", 1)[-1].rstrip("/")
    host, port = hostport.rsplit(":", 1)
    return host, int(port)


class _PeerSender(threading.Thread):
    def __init__(self, src_id: int, addr: Tuple[str, int],
                 stop_evt: threading.Event):
        super().__init__(daemon=True, name=f"tcp-send-{addr[1]}")
        self.src_id = src_id
        self.addr = addr
        self.q: "queue.Queue[bytes]" = queue.Queue(maxsize=_QUEUE_CAP)
        self._stop = stop_evt
        self._sock: Optional[socket.socket] = None

    def offer(self, blob: bytes) -> None:
        try:
            self.q.put_nowait(blob)
        except queue.Full:        # drop-oldest: raft re-sends anyway
            try:
                self.q.get_nowait()
                self.q.put_nowait(blob)
            except queue.Empty:
                pass

    def _connect(self) -> Optional[socket.socket]:
        try:
            s = socket.create_connection(self.addr, timeout=1.0)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
            return s
        except OSError:
            return None

    def run(self) -> None:
        while not self._stop.is_set():
            try:
                blob = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            sent = False
            while not sent and not self._stop.is_set():
                if self._sock is None:
                    self._sock = self._connect()
                    if self._sock is None:
                        time.sleep(_RECONNECT_S)
                        # Peer down: drop this batch, drain stale queue.
                        break
                try:
                    self._sock.sendall(
                        _FRAME.pack(len(blob), self.src_id) + blob)
                    sent = True
                except OSError:
                    try:
                        self._sock.close()
                    finally:
                        self._sock = None
        if self._sock is not None:
            self._sock.close()


class TcpTransport(Transport):
    def __init__(self, peer_urls: List[str], self_index: int):
        """peer_urls[i] is node i+1's address (reference raft.go:148-151:
        node i serves at peers[i-1])."""
        self.addrs = [parse_peer_url(u) for u in peer_urls]
        self.self_index = self_index          # 0-based
        # Wired by the owning node (runtime/node.py start) so transport
        # fault counters land in the node's /metrics; a bare transport
        # (tests) counts into its own scratch NodeMetrics.
        from raftsql_tpu_torch.utils.metrics import NodeMetrics
        self.metrics = NodeMetrics()
        # Injectable send-side fault seam (chaos harness); None in
        # production.
        self.faults: Optional[SendFaults] = None
        # Observability hook (raftsql_tpu_torch/obs/ SpanTracer.note_event or
        # compatible), wired by the node's enable_tracing: frame
        # send/recv instants land on the host trace timeline.
        self.obs = None
        self._stop_evt = threading.Event()
        self._senders: Dict[int, _PeerSender] = {}
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conn_threads: List[threading.Thread] = []
        self._deliver: Callable[[int, TickBatch], None] = lambda s, b: None
        self._on_error: Callable[[Exception], None] = lambda e: None

    def start(self, node_id: int, deliver, on_error) -> None:
        self._deliver = deliver
        self._on_error = on_error
        host, port = self.addrs[self.self_index]
        try:
            ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            ls.bind((host if host not in ("localhost",) else "127.0.0.1",
                     port))
            ls.listen(16)
            ls.settimeout(0.2)
        except OSError as e:
            on_error(e)
            return
        self._listener = ls
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name=f"tcp-accept-{port}")
        self._accept_thread.start()
        for i, addr in enumerate(self.addrs):
            if i != self.self_index:
                s = _PeerSender(node_id, addr, self._stop_evt)
                s.start()
                self._senders[i + 1] = s

    def _accept_loop(self) -> None:
        assert self._listener is not None
        while not self._stop_evt.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError as e:
                if not self._stop_evt.is_set():
                    self._on_error(e)
                return
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
            t = threading.Thread(target=self._recv_loop, args=(conn,),
                                 daemon=True)
            t.start()
            self._conn_threads.append(t)

    def _recv_loop(self, conn: socket.socket) -> None:
        buf = b""
        conn.settimeout(0.5)
        try:
            while not self._stop_evt.is_set():
                while len(buf) >= _FRAME.size:
                    plen, src = _FRAME.unpack_from(buf)
                    if plen > _MAX_FRAME:
                        log.warning("dropping connection: oversized frame "
                                    "(%d bytes) from src %d", plen, src)
                        return
                    if len(buf) < _FRAME.size + plen:
                        break
                    payload = buf[_FRAME.size:_FRAME.size + plen]
                    buf = buf[_FRAME.size + plen:]
                    # A corrupt or malformed frame must cost exactly that
                    # frame: the length prefix already resynced the
                    # stream, so drop it, count it, keep receiving.
                    # Before this guard a decode exception killed the
                    # connection thread silently and every later frame
                    # with it.
                    try:
                        batch = decode_batch_framed(payload)
                    except (FrameCorruptError, struct.error,
                            ValueError) as e:
                        self.metrics.faults_corrupt_frames += 1
                        log.warning("dropping corrupt frame from src %d "
                                    "(%d bytes): %s", src, plen, e)
                        continue
                    if self.obs is not None:
                        self.obs.note_event("tcp.recv", src=src,
                                            n_bytes=plen)
                    self._deliver(src, batch)
                try:
                    chunk = conn.recv(1 << 16)
                except socket.timeout:
                    continue
                if not chunk:
                    return
                buf += chunk
        except OSError:
            pass
        finally:
            conn.close()

    def send(self, dst: int, batch: TickBatch) -> None:
        if batch.empty():
            return
        sender = self._senders.get(dst)
        if sender is None:
            return
        blob = encode_batch_framed(batch)
        if self.obs is not None:
            self.obs.note_event("tcp.send", dst=dst, n_bytes=len(blob))
        if self.faults is not None:
            got = self.faults.apply(dst, blob)
            if got is None:
                return                       # injected drop / block
            blob, delay = got
            if delay > 0:
                t = threading.Timer(delay, sender.offer, args=(blob,))
                t.daemon = True
                t.start()
                return
        sender.offer(blob)

    def stop(self) -> None:
        self._stop_evt.set()
        if self._listener is not None:
            self._listener.close()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2)
