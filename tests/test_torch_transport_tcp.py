"""The cases of tests/test_transport_tcp.py, on the port (raftsql_tpu_torch,
every RaftNode stepping on the CPU).  The reference file's docstring
follows.

TcpTransport — the DCN peer plane (the rafthttp analog).

The reference trusts vendored etcd/rafthttp streams (reference
raft.go:170-184, 248-266); transport/tcp.py is our from-scratch framed-TCP
replacement, so its wire handling gets direct tests: frame reassembly
across arbitrary recv boundaries, oversized-frame defense, reconnect after
peer restart, and drop-oldest backpressure.
"""
import queue
import socket
import threading
import time


from conftest import free_port
from raftsql_tpu_torch.transport.base import (AppendRec, ProposalRec,
                                              SnapshotRec, TickBatch,
                                              VoteRec)
from raftsql_tpu_torch.transport.codec import encode_batch_framed
from raftsql_tpu_torch.transport.tcp import (_FRAME, _QUEUE_CAP,
                                             _PeerSender, TcpTransport,
                                             parse_peer_url)

import torch

torch.set_num_threads(1)

TIMEOUT = 10.0


def sample_batch() -> TickBatch:
    return TickBatch(
        votes=[VoteRec(group=3, type=1, term=7, last_idx=4, last_term=2,
                       granted=True)],
        appends=[AppendRec(group=1, type=1, term=7, prev_idx=9, prev_term=6,
                           ent_terms=[7, 7], payloads=[b"a", b"bb"],
                           commit=8, seq=41)],
        proposals=[ProposalRec(group=0, payload=b"INSERT")],
        snapshots=[SnapshotRec(group=2, last_idx=11, last_term=5, term=7,
                               blob=b"\x00blob")])


def assert_batches_equal(got: TickBatch, want: TickBatch) -> None:
    assert got.votes == want.votes
    assert got.appends == want.appends
    assert got.proposals == want.proposals
    assert got.snapshots == want.snapshots


class Receiver:
    """One TcpTransport listening on a free port, collecting deliveries
    (slot 1 of a 2-node topology; slot 0 is never bound)."""

    def __init__(self):
        self.port = free_port()
        urls = [f"http://127.0.0.1:{free_port()}",
                f"http://127.0.0.1:{self.port}"]
        self.transport = TcpTransport(urls, 1)
        self.got: "queue.Queue" = queue.Queue()
        self.errors = []
        self.transport.start(2, self._deliver, self.errors.append)

    def _deliver(self, src, batch):
        self.got.put((src, batch))

    def stop(self):
        self.transport.stop()


class TestWire:
    def test_parse_peer_url(self):
        assert parse_peer_url("http://127.0.0.1:12379") == ("127.0.0.1",
                                                            12379)
        assert parse_peer_url("10.0.0.2:99") == ("10.0.0.2", 99)
        assert parse_peer_url("http://h:1/") == ("h", 1)

    def test_frame_reassembly_byte_by_byte(self):
        """Frames split at every possible recv boundary must reassemble."""
        rx = Receiver()
        try:
            blob = encode_batch_framed(sample_batch())
            wire = _FRAME.pack(len(blob), 1) + blob
            with socket.create_connection(("127.0.0.1", rx.port),
                                          timeout=5) as s:
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                for i in range(len(wire)):
                    s.sendall(wire[i:i + 1])
            src, got = rx.got.get(timeout=TIMEOUT)
            assert src == 1
            assert_batches_equal(got, sample_batch())
        finally:
            rx.stop()

    def test_many_frames_in_one_segment(self):
        """Multiple frames coalesced into one send must all deliver, in
        order."""
        rx = Receiver()
        try:
            frames = b""
            for k in range(5):
                b = TickBatch(proposals=[ProposalRec(group=0,
                                                     payload=b"p%d" % k)])
                blob = encode_batch_framed(b)
                frames += _FRAME.pack(len(blob), 1) + blob
            with socket.create_connection(("127.0.0.1", rx.port),
                                          timeout=5) as s:
                s.sendall(frames)
            for k in range(5):
                _, got = rx.got.get(timeout=TIMEOUT)
                assert got.proposals[0].payload == b"p%d" % k
        finally:
            rx.stop()

    def test_oversized_frame_drops_connection(self):
        """A length field over _MAX_FRAME must drop the connection without
        delivering anything or buffering 4 GiB."""
        rx = Receiver()
        try:
            with socket.create_connection(("127.0.0.1", rx.port),
                                          timeout=5) as s:
                s.sendall(_FRAME.pack(1 << 31, 1))
                s.settimeout(TIMEOUT)
                # Receiver closes its side; recv unblocks with EOF (or a
                # reset, also acceptable).
                try:
                    assert s.recv(1) == b""
                except OSError:
                    pass
            assert rx.got.empty()
            assert rx.errors == []      # bad peer is not fatal locally
        finally:
            rx.stop()

    def test_garbage_after_valid_frame(self):
        """A valid frame followed by an oversized header: the first frame
        delivers, then the connection drops."""
        rx = Receiver()
        try:
            blob = encode_batch_framed(sample_batch())
            wire = _FRAME.pack(len(blob), 1) + blob \
                + _FRAME.pack(0xFFFFFFFF, 1)
            with socket.create_connection(("127.0.0.1", rx.port),
                                          timeout=5) as s:
                s.sendall(wire)
            src, got = rx.got.get(timeout=TIMEOUT)
            assert_batches_equal(got, sample_batch())
            assert rx.got.empty()
        finally:
            rx.stop()

    def test_corrupt_frame_skipped_connection_survives(self):
        """A CRC-corrupt frame is dropped + counted, and the SAME
        connection keeps delivering later frames — the recv loop must
        not die with the frame (the pre-hardening behavior killed the
        thread silently)."""
        rx = Receiver()
        try:
            good = encode_batch_framed(sample_batch())
            bad = bytearray(good)
            bad[len(bad) // 2] ^= 0x5A
            wire = (_FRAME.pack(len(bad), 1) + bytes(bad)
                    + _FRAME.pack(len(good), 1) + good)
            with socket.create_connection(("127.0.0.1", rx.port),
                                          timeout=5) as s:
                s.sendall(wire)
                src, got = rx.got.get(timeout=TIMEOUT)
            assert src == 1
            assert_batches_equal(got, sample_batch())
            assert rx.transport.metrics.faults_corrupt_frames == 1
            assert rx.errors == []      # never fatal locally
        finally:
            rx.stop()

    def test_malformed_counts_dropped_not_fatal(self):
        """A frame whose CRC is valid but whose declared record counts
        exceed its bytes (a Byzantine sender) is dropped by the codec's
        bounds validation, and later frames still deliver."""
        import struct as _struct
        import zlib as _zlib
        rx = Receiver()
        try:
            # Declares 1000 votes, carries none.
            payload = _struct.pack("<I", 1000)
            evil = _struct.pack("<I", _zlib.crc32(payload)) + payload
            good = encode_batch_framed(sample_batch())
            wire = (_FRAME.pack(len(evil), 1) + evil
                    + _FRAME.pack(len(good), 1) + good)
            with socket.create_connection(("127.0.0.1", rx.port),
                                          timeout=5) as s:
                s.sendall(wire)
                src, got = rx.got.get(timeout=TIMEOUT)
            assert_batches_equal(got, sample_batch())
            assert rx.transport.metrics.faults_corrupt_frames == 1
        finally:
            rx.stop()


class TestSendFaults:
    def test_send_faults_corrupt_caught_by_receiver(self):
        """End-to-end over real sockets: the send-side fault seam
        corrupts frames, the receiver's CRC drops + counts every one,
        and clean frames still flow once rates reset."""
        from raftsql_tpu_torch.transport.tcp import SendFaults
        rx_port = free_port()
        urls = [f"http://127.0.0.1:{free_port()}",
                f"http://127.0.0.1:{rx_port}"]
        got: "queue.Queue" = queue.Queue()
        rx = TcpTransport(urls, 1)
        rx.start(2, lambda s, b: got.put((s, b)), lambda e: None)
        tx = TcpTransport(urls, 0)
        tx.faults = SendFaults(seed=7)
        tx.faults.set_rates(p_corrupt=1.0)
        tx.start(1, lambda s, b: None, lambda e: None)
        try:
            deadline = time.monotonic() + TIMEOUT
            while rx.metrics.faults_corrupt_frames == 0 \
                    and time.monotonic() < deadline:
                tx.send(2, sample_batch())
                time.sleep(0.05)
            assert rx.metrics.faults_corrupt_frames > 0
            assert tx.faults.corrupted > 0
            assert got.empty()          # nothing corrupt delivered
            tx.faults.set_rates()       # heal: clean frames deliver
            deadline = time.monotonic() + TIMEOUT
            while got.empty() and time.monotonic() < deadline:
                tx.send(2, sample_batch())
                time.sleep(0.05)
            src, batch = got.get(timeout=1)
            assert_batches_equal(batch, sample_batch())
        finally:
            tx.stop()
            rx.stop()

    def test_send_faults_block_is_one_directional(self):
        """block(dst) drops at send; drop/delay counters track."""
        from raftsql_tpu_torch.transport.tcp import SendFaults
        f = SendFaults(seed=0)
        f.block(2)
        assert f.apply(2, b"x") is None
        assert f.apply(3, b"x") == (b"x", 0.0)
        assert f.dropped == 1
        f.heal()
        assert f.apply(2, b"x") == (b"x", 0.0)
        f.set_rates(p_delay=1.0, delay_s=0.25)
        blob, delay = f.apply(2, b"y")
        assert blob == b"y" and delay == 0.25
        assert f.delayed == 1


class TestSenderBackpressure:
    def test_drop_oldest_when_queue_full(self):
        """offer() on a full queue evicts the oldest blob (raft re-sends;
        freshest state wins)."""
        sender = _PeerSender(1, ("127.0.0.1", 1), threading.Event())
        # Not started: queue fills without draining.
        for k in range(_QUEUE_CAP):
            sender.offer(b"old%d" % k)
        assert sender.q.qsize() == _QUEUE_CAP
        sender.offer(b"new")
        assert sender.q.qsize() == _QUEUE_CAP
        drained = []
        while True:
            try:
                drained.append(sender.q.get_nowait())
            except queue.Empty:
                break
        assert b"old0" not in drained       # oldest evicted
        assert drained[-1] == b"new"        # newest kept

    def test_send_to_down_peer_does_not_block(self):
        """send() must return immediately with the peer down (the tick
        loop can never stall on a dead peer)."""
        port = free_port()
        urls = [f"http://127.0.0.1:{port}",
                f"http://127.0.0.1:{free_port()}"]
        tr = TcpTransport(urls, 0)
        tr.start(1, lambda s, b: None, lambda e: None)
        try:
            t0 = time.monotonic()
            for _ in range(50):
                tr.send(2, sample_batch())
            assert time.monotonic() - t0 < 1.0
        finally:
            tr.stop()


class TestReconnect:
    def test_sender_reconnects_after_peer_restart(self):
        """Kill the receiving transport, restart it on the same port, and
        the sender's retry loop must re-deliver without intervention."""
        rx_port = free_port()
        tx_port = free_port()
        urls = [f"http://127.0.0.1:{tx_port}", f"http://127.0.0.1:{rx_port}"]

        got: "queue.Queue" = queue.Queue()
        rx = TcpTransport(urls, 1)
        rx.start(2, lambda s, b: got.put((s, b)), lambda e: None)

        tx = TcpTransport(urls, 0)
        tx.start(1, lambda s, b: None, lambda e: None)
        try:
            deadline = time.monotonic() + TIMEOUT
            while got.empty() and time.monotonic() < deadline:
                tx.send(2, sample_batch())
                time.sleep(0.05)
            src, batch = got.get(timeout=1)
            assert src == 1
            assert_batches_equal(batch, sample_batch())

            rx.stop()
            time.sleep(0.3)             # let the sender's socket die
            while not got.empty():      # drop leftover phase-1 deliveries
                got.get_nowait()        # (phase 2 must prove rx2 receives)
            rx2 = TcpTransport(urls, 1)
            rx2.start(2, lambda s, b: got.put((s, b)), lambda e: None)
            try:
                deadline = time.monotonic() + TIMEOUT
                while got.empty() and time.monotonic() < deadline:
                    tx.send(2, sample_batch())
                    time.sleep(0.05)
                src, batch = got.get(timeout=1)
                assert src == 1
                assert_batches_equal(batch, sample_batch())
            finally:
                rx2.stop()
        finally:
            tx.stop()
            if not rx._stop_evt.is_set():
                rx.stop()

    def test_bind_failure_is_fatal_locally(self):
        """A local listener failure must surface via on_error (reference
        raft.go:237-239: local transport error tears the node down)."""
        port = free_port()
        blocker = socket.socket()
        blocker.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 0)
        blocker.bind(("127.0.0.1", port))
        blocker.listen(1)
        try:
            errors = []
            urls = [f"http://127.0.0.1:{port}",
                    f"http://127.0.0.1:{free_port()}"]
            tr = TcpTransport(urls, 0)
            tr.start(1, lambda s, b: None, errors.append)
            try:
                assert errors, "bind conflict must report an error"
            finally:
                tr.stop()
        finally:
            blocker.close()
