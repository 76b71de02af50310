"""In-process transport: the reference test harness's localhost cluster
(reference raftsql_test.go:16-28) without sockets.

Batches still round-trip through the binary codec so every test exercises
the real wire format.  Delivery is synchronous on the sender's thread into
the receiver's staging (RaftNode.deliver is non-blocking: it only appends
to staging dicts under a lock).

A `FaultPlan` may drop batches between specific nodes — the host-plane
counterpart of transport.faults for the device plane.

Copy of raftsql_tpu/transport/loopback.py for the PyTorch port.
"""
from __future__ import annotations

import struct
import threading
from typing import Callable, Dict, Optional, Set, Tuple

from raftsql_tpu_torch.transport.base import TickBatch, Transport
from raftsql_tpu_torch.transport.codec import (FrameCorruptError,
                                               decode_batch_framed,
                                               encode_batch_framed)


class FaultPlan:
    """Mutable set of blocked (src, dst) node pairs."""

    def __init__(self):
        self._blocked: Set[Tuple[int, int]] = set()
        self._lock = threading.Lock()

    def isolate(self, node: int, universe: range) -> None:
        with self._lock:
            for other in universe:
                self._blocked.add((node, other))
                self._blocked.add((other, node))

    def block(self, src: int, dst: int) -> None:
        """Block ONE direction: dst stops hearing src while src still
        hears dst — the asymmetric-partition failure mode (a dead NIC
        queue, a one-way firewall rule) the chaos matrix schedules."""
        with self._lock:
            self._blocked.add((src, dst))

    def heal(self) -> None:
        with self._lock:
            self._blocked.clear()

    def blocked(self, src: int, dst: int) -> bool:
        with self._lock:
            return (src, dst) in self._blocked


class LoopbackHub:
    """Shared registry wiring N LoopbackTransports together.

    codec=False skips the encode/decode round trip and hands the
    TickBatch object across directly — for benchmarks that measure the
    engine rather than the wire format (tests keep the default True so
    every suite run exercises the real codec)."""

    def __init__(self, faults: Optional[FaultPlan] = None,
                 codec: bool = True):
        self._nodes: Dict[int, Callable[[int, TickBatch], None]] = {}
        self._lock = threading.Lock()
        self.faults = faults or FaultPlan()
        self.codec = codec
        # Wire-corruption seam (chaos harness): a callable
        # (src, dst, blob) -> blob mutating the encoded frame in
        # flight.  The CRC framing then catches the damage at decode
        # and the frame is dropped + counted, exactly as on the TCP
        # path.  None in normal runs.
        self.mangler: Optional[Callable[[int, int, bytes], bytes]] = None
        # Corrupt frames dropped by the CRC check, and an optional
        # per-drop callback (the chaos runner uses it to charge the
        # receiving node's NodeMetrics.faults_corrupt_frames).
        self.corrupt_dropped = 0
        self.on_corrupt: Optional[Callable[[int, int], None]] = None

    def attach(self, node_id: int,
               deliver: Callable[[int, TickBatch], None]) -> None:
        with self._lock:
            self._nodes[node_id] = deliver

    def detach(self, node_id: int) -> None:
        with self._lock:
            self._nodes.pop(node_id, None)

    def route(self, src: int, dst: int, batch) -> None:
        """`batch` is encoded bytes (codec=True) or a TickBatch object."""
        if self.faults.blocked(src, dst):
            return
        with self._lock:
            deliver = self._nodes.get(dst)
        if deliver is None:                # absent peer == dropped message
            return
        if self.codec:
            if self.mangler is not None:
                batch = self.mangler(src, dst, batch)
            try:
                batch = decode_batch_framed(batch)
            except (FrameCorruptError, ValueError, struct.error):
                with self._lock:
                    self.corrupt_dropped += 1
                if self.on_corrupt is not None:
                    self.on_corrupt(src, dst)
                return
        deliver(src, batch)


class LoopbackTransport(Transport):
    def __init__(self, hub: LoopbackHub):
        self.hub = hub
        self.node_id = -1

    def start(self, node_id: int,
              deliver: Callable[[int, TickBatch], None],
              on_error: Callable[[Exception], None]) -> None:
        self.node_id = node_id
        self.hub.attach(node_id, deliver)

    def send(self, dst: int, batch: TickBatch) -> None:
        if batch.empty():
            return
        self.hub.route(self.node_id, dst,
                       encode_batch_framed(batch) if self.hub.codec
                       else batch)

    def stop(self) -> None:
        self.hub.detach(self.node_id)
