"""Wire protocol for the read-replica stream.

Port of raftsql_tpu/replica/stream.py: every frame is byte-identical to
the JAX package's (tests/test_torch_replica.py holds them together).

One TCP connection per subscriber.  Every frame on the wire is

    u32 payload_len | u32 crc32(payload) | payload

— the same length-plus-whole-frame-CRC framing discipline as
transport/codec.py's batch codec: every declared length is bounds-
checked before a single byte is sliced, and a CRC mismatch surfaces as
the typed `StreamCorruptError` so the receiver can DROP the connection
and resubscribe (corruption is a fault to survive, never a crash and
never a silently-wrong row).  `payload` starts with a one-byte frame
kind:

    K_HELLO  server -> replica   JSON: plane identity — epoch,
                                 keymap_epoch, num_groups.  Sent once,
                                 first.  An epoch different from the
                                 one a resuming replica folded under
                                 means a NEW engine incarnation: the
                                 replica discards its state and refolds
                                 from scratch (exactly the shm reader's
                                 "stale epoch => plane dead" rule, with
                                 re-attach instead of death because the
                                 stream can re-image us).
    K_SUB    replica -> server   JSON: advertised endpoint + the
                                 high-water {group: applied} resume
                                 vector.  The publisher replays its
                                 append-only log from the vector, or
                                 ships fresh KIND_BASE images when the
                                 log can no longer cover it (RESYNC).
    K_REC    server -> replica   One log record: kind/group/index
                                 header + payload — runtime/shm.py's
                                 KIND_DELTA (SQL batch) / KIND_BASE
                                 (SQLite image) records verbatim.
    K_TABLE  server -> replica   The shm header row table as a
                                 heartbeat: per-group applied / commit
                                 / base_index / lease / leader.  The
                                 lease ships as *remaining* nanoseconds
                                 (deadline minus the engine's monotonic
                                 now): CLOCK_MONOTONIC bases don't
                                 transfer across hosts, and stamping
                                 the remainder against the replica's
                                 own clock on arrival makes the local
                                 deadline conservatively EARLY by the
                                 one-way latency — safe side.
    K_ACK    replica -> server   JSON: the replica's folded {group:
                                 applied} vector, for /healthz lag.
"""
from __future__ import annotations

import json
import struct
import zlib
from typing import Dict, List, Tuple

# Frame kinds.
K_HELLO = 1
K_SUB = 2
K_REC = 3
K_TABLE = 4
K_ACK = 5

# Largest payload a peer will accept: a KIND_BASE record is a whole
# serialized SQLite image, so the bound tracks the shm plane's default
# capacity (32 MiB) with headroom rather than a "reasonable message"
# bound.  Anything larger is treated as corruption.
MAX_FRAME = 96 << 20

_FRAME = struct.Struct("<II")          # payload_len, crc32(payload)
_REC_HDR = struct.Struct("<BIQ")       # kind, group, index
_TBL_HDR = struct.Struct("<QQBI")      # epoch, keymap_epoch, flags, num_groups
_TBL_ROW = struct.Struct("<QQQQI")     # applied, commit, base_index,
                                       # lease_remaining_ns, leader(1-based)

TBL_FLAG_LOG_FULL = 1


class StreamCorruptError(ValueError):
    """A frame failed its CRC or declared an impossible length.

    The connection is poisoned (framing can't be trusted past the first
    bad byte): the receiver drops it, counts the corruption, and
    resubscribes with its resume vector.  Never an out-of-bounds read,
    never a wrong row.
    """


class StreamClosed(ConnectionError):
    """Orderly or mid-frame EOF from the peer."""


def encode_frame(kind: int, body: bytes) -> bytes:
    payload = bytes([kind]) + body
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def read_exact(sock, n: int) -> bytes:
    """Read exactly n bytes from a socket; StreamClosed on EOF."""
    chunks: List[bytes] = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise StreamClosed(f"eof after {got}/{n} bytes")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(sock) -> Tuple[int, bytes]:
    """Read one frame; returns (kind, body).

    Raises StreamClosed on EOF at a frame boundary or mid-frame, and
    StreamCorruptError on a CRC mismatch or an impossible length.
    """
    hdr = read_exact(sock, _FRAME.size)
    length, crc = _FRAME.unpack(hdr)
    if length < 1 or length > MAX_FRAME:
        raise StreamCorruptError(f"frame length {length} out of bounds")
    payload = read_exact(sock, length)
    if zlib.crc32(payload) != crc:
        raise StreamCorruptError("frame crc mismatch")
    return payload[0], payload[1:]


# --- HELLO ----------------------------------------------------------------

def encode_hello(epoch: int, keymap_epoch: int, num_groups: int) -> bytes:
    body = json.dumps({"epoch": epoch, "keymap_epoch": keymap_epoch,
                       "groups": num_groups}).encode()
    return encode_frame(K_HELLO, body)


def decode_hello(body: bytes) -> Dict[str, int]:
    doc = json.loads(body.decode())
    return {"epoch": int(doc["epoch"]),
            "keymap_epoch": int(doc["keymap_epoch"]),
            "groups": int(doc["groups"])}


# --- SUBSCRIBE / ACK ------------------------------------------------------

def encode_subscribe(endpoint: str, applied: Dict[int, int]) -> bytes:
    body = json.dumps({"endpoint": endpoint,
                       "applied": {str(g): int(n)
                                   for g, n in applied.items()}}).encode()
    return encode_frame(K_SUB, body)


def decode_subscribe(body: bytes) -> Tuple[str, Dict[int, int]]:
    doc = json.loads(body.decode())
    applied = {int(g): int(n)
               for g, n in dict(doc.get("applied", {})).items()}
    return str(doc.get("endpoint", "")), applied


def encode_ack(applied: Dict[int, int]) -> bytes:
    body = json.dumps({"applied": {str(g): int(n)
                                   for g, n in applied.items()}}).encode()
    return encode_frame(K_ACK, body)


def decode_ack(body: bytes) -> Dict[int, int]:
    doc = json.loads(body.decode())
    return {int(g): int(n)
            for g, n in dict(doc.get("applied", {})).items()}


# --- REC ------------------------------------------------------------------

def encode_rec(kind: int, group: int, index: int, payload: bytes) -> bytes:
    return encode_frame(K_REC, _REC_HDR.pack(kind, group, index) + payload)


def decode_rec(body: bytes) -> Tuple[int, int, int, bytes]:
    if len(body) < _REC_HDR.size:
        raise StreamCorruptError("short REC header")
    kind, group, index = _REC_HDR.unpack_from(body, 0)
    return kind, group, index, body[_REC_HDR.size:]


# --- TABLE ----------------------------------------------------------------

def encode_table(epoch: int, keymap_epoch: int, log_full: bool,
                 rows: List[Tuple[int, int, int, int, int]]) -> bytes:
    """rows: per group (applied, commit, base_index, lease_remaining_ns,
    leader 1-based / 0 unknown)."""
    flags = TBL_FLAG_LOG_FULL if log_full else 0
    body = bytearray(_TBL_HDR.pack(epoch, keymap_epoch, flags, len(rows)))
    for row in rows:
        body += _TBL_ROW.pack(*row)
    return encode_frame(K_TABLE, bytes(body))


def decode_table(body: bytes):
    """Returns (epoch, keymap_epoch, log_full, rows)."""
    if len(body) < _TBL_HDR.size:
        raise StreamCorruptError("short TABLE header")
    epoch, keymap_epoch, flags, n = _TBL_HDR.unpack_from(body, 0)
    need = _TBL_HDR.size + n * _TBL_ROW.size
    if n > 1 << 20 or len(body) < need:
        raise StreamCorruptError("TABLE row count out of bounds")
    rows = [_TBL_ROW.unpack_from(body, _TBL_HDR.size + i * _TBL_ROW.size)
            for i in range(n)]
    return epoch, keymap_epoch, bool(flags & TBL_FLAG_LOG_FULL), rows


def parse_hostport(spec: str, default_port: int = 9220) -> Tuple[str, int]:
    """'host:port' / 'host' -> (host, port); tolerant of bare ports."""
    spec = spec.strip()
    if ":" in spec:
        host, _, port = spec.rpartition(":")
        return host or "127.0.0.1", int(port)
    if spec.isdigit():
        return "127.0.0.1", int(spec)
    return spec, default_port
