"""Binary codec for TickBatch — flat, fixed-width, little-endian.

SURVEY.md §2b V2 calls for a flat array-friendly encoding at the wire
boundary instead of protobuf: every record is a fixed-layout struct with
byte payloads appended, so encode/decode is a linear scan with no schema
machinery.  The same layout is shared with the C++ runtime shim.

Frame := u32 n_votes  | VoteRec*
         u32 n_appends| AppendRec*
         u32 n_props  | ProposalRec*
         u32 n_snaps  | SnapshotRec*
         [ColSection]                      (trailing, optional)
VoteRec     := u32 group | u8 type | q term | q last_idx | q last_term | u8 granted
AppendRec   := u32 group | u8 type | q term | q prev_idx | q prev_term
             | q commit | u8 success | q match | q seq | u16 n
             | q ent_term * n | (u32 len | bytes) * n_payloads(=n for REQ, 0 resp)
ProposalRec := u32 group | u32 len | bytes
SnapshotRec := u32 group | q last_idx | q last_term | q term | u32 len | bytes
ColSection  := u32 nv | (i32[nv] per field: v_group v_type v_term v_last_idx
                         v_last_term v_granted — fields omitted when nv==0)
             | u32 na | (i32[na] per field: a_group a_type a_term a_prev_idx
                         a_prev_term a_commit a_success a_match,
                         then i64[na] a_seq — omitted when na==0)
The ColSection carries the columnar payload-free fast path (base.py
ColRecs): raw little-endian array dumps, decoded with zero per-record
work.  Decoders treat trailing bytes after the snapshot section as a
ColSection; its presence is optional for senders.

CRC framing (the wire transports' form):

    framed := u32 crc32(frame) | frame

`encode_batch_framed`/`decode_batch_framed` wrap the flat encoding in a
whole-frame CRC32, and `decode_batch` itself bounds-validates every
declared count/length against the remaining bytes — so a corrupted,
truncated, or Byzantine frame surfaces as `FrameCorruptError` (or
`struct.error`) at the codec boundary, for the receiver to DROP and
count, never as an out-of-bounds read, a silently-truncated payload, or
a crashed recv thread.  The reference trusts rafthttp framing outright
(reference raft.go:268-270); a multi-host deployment cannot.

Copy of raftsql_tpu/transport/codec.py for the PyTorch port: the frames
are byte-identical to the JAX package's (tests/test_torch_codec.py).
"""
from __future__ import annotations

import struct
import zlib
from typing import List, Tuple

import numpy as np

from raftsql_tpu_torch.config import MSG_REQ
from raftsql_tpu_torch.transport.base import (AppendRec, ColRecs,
                                              ProposalRec, SnapshotRec,
                                              TickBatch, VoteRec)

_U32 = struct.Struct("<I")
_VOTE = struct.Struct("<IBqqqB")
_APP = struct.Struct("<IBqqqqBqqH")
_PLEN = struct.Struct("<I")
_SNAP = struct.Struct("<Iqqq")


class FrameCorruptError(ValueError):
    """A wire frame failed its CRC or structural validation: drop the
    frame (and count it) — raft re-sends, and a bad peer must not crash
    the receiver."""


# ---------------------------------------------------------------------------
# Conf-change entries (dynamic membership, raftsql_tpu_torch/membership/).
#
# A membership change travels THROUGH the replicated log as a marked
# entry payload — the new record kind of the entry plane.  The first
# byte discriminates against the other payload forms on the wire and in
# the WAL: 0x01 = proposal envelope, 0x02/0x04 = snapshot wrappers
# (runtime/envelope.py), printable bytes = bare SQL.  Conf entries are
# NEVER enveloped (their apply is idempotent by log index, and the
# publish plane must recognize them with one leading-byte test), and
# they are scrubbed from the SQL apply stream at commit — the apply
# plane sees an empty entry where a conf change sat, exactly like the
# reference skipping empty/conf entries (raft.go:84-87).
#
# Every conf entry carries the FULL target configuration (voter mask,
# joint mask, learner mask as u64 slot bitmasks — P <= 64), so applying
# one is an unconditional set: re-delivery, forward-retry, and replay
# are idempotent, and the newest entry alone describes the active
# config.  Two-phase joint style (C_old,new -> C_new, one in flight per
# group, raftsql_tpu_torch/membership/manager.py):
#   ENTER_JOINT: voters = C_new, joint = C_old  (both majorities rule)
#   LEAVE_JOINT: voters = joint = C_new         (stable again)
#   LEARNER:     voter masks unchanged, learner set edited (1-phase —
#                learners are outside every quorum, so no joint needed)

CONF_MAGIC = 0x03
CONF_PREFIX = bytes([CONF_MAGIC])
CONF_KIND_LEARNER = 1
CONF_KIND_ENTER_JOINT = 2
CONF_KIND_LEAVE_JOINT = 3
_CONF = struct.Struct("<BBQQQ")     # magic, kind, voters, joint, learners


def encode_conf_entry(kind: int, voters_mask: int, joint_mask: int,
                      learners_mask: int) -> bytes:
    return _CONF.pack(CONF_MAGIC, kind, voters_mask, joint_mask,
                      learners_mask)


def is_conf_entry(data: bytes) -> bool:
    return len(data) == _CONF.size and data[0] == CONF_MAGIC


def decode_conf_entry(data: bytes):
    """(kind, voters_mask, joint_mask, learners_mask), or None when the
    payload is not a conf entry."""
    if not is_conf_entry(data):
        return None
    _, kind, voters, joint, learners = _CONF.unpack(data)
    return kind, voters, joint, learners


def encode_batch(batch: TickBatch) -> bytes:
    out = [_U32.pack(len(batch.votes))]
    for v in batch.votes:
        out.append(_VOTE.pack(v.group, v.type, v.term, v.last_idx,
                              v.last_term, int(v.granted)))
    out.append(_U32.pack(len(batch.appends)))
    for a in batch.appends:
        out.append(_APP.pack(a.group, a.type, a.term, a.prev_idx,
                             a.prev_term, a.commit, int(a.success), a.match,
                             a.seq, len(a.ent_terms)))
        out.append(struct.pack(f"<{len(a.ent_terms)}q", *a.ent_terms))
        if a.type == MSG_REQ:
            assert len(a.payloads) == len(a.ent_terms), \
                "append REQ must carry one payload per entry"
            for p in a.payloads:
                out.append(_PLEN.pack(len(p)))
                out.append(p)
    out.append(_U32.pack(len(batch.proposals)))
    for pr in batch.proposals:
        out.append(_U32.pack(pr.group))
        out.append(_PLEN.pack(len(pr.payload)))
        out.append(pr.payload)
    out.append(_U32.pack(len(batch.snapshots)))
    for s in batch.snapshots:
        out.append(_SNAP.pack(s.group, s.last_idx, s.last_term, s.term))
        out.append(_PLEN.pack(len(s.blob)))
        out.append(s.blob)
    # Columnar section (trailing, optional): raw little-endian array
    # bytes — no per-record packing at all (base.py ColRecs).
    c = batch.cols
    if c is not None and (c.n_votes() or c.n_appends()):
        out.append(_U32.pack(c.n_votes()))
        if c.n_votes():
            for f in _COL_V:
                out.append(np.ascontiguousarray(
                    getattr(c, f), dtype=np.int32).tobytes())
        out.append(_U32.pack(c.n_appends()))
        if c.n_appends():
            for f in _COL_A:
                out.append(np.ascontiguousarray(
                    getattr(c, f),
                    dtype=np.int64 if f == "a_seq" else np.int32).tobytes())
    return b"".join(out)


_COL_V = ("v_group", "v_type", "v_term", "v_last_idx", "v_last_term",
          "v_granted")
_COL_A = ("a_group", "a_type", "a_term", "a_prev_idx", "a_prev_term",
          "a_commit", "a_success", "a_match", "a_seq")


def decode_batch(blob: bytes) -> TickBatch:
    """Decode one flat frame, bounds-validating EVERY declared count and
    length against the remaining bytes.  A frame that declares more
    records/bytes than it carries (truncation, corruption, or a hostile
    peer) raises struct.error — the original blob slicing silently
    truncated payloads instead, handing short entry bytes to the raft
    log."""
    off = 0
    end = len(blob)

    def take(fmt: struct.Struct) -> Tuple:
        nonlocal off
        vals = fmt.unpack_from(blob, off)
        off += fmt.size
        return vals

    def need(nbytes: int, what: str) -> None:
        if nbytes < 0 or end - off < nbytes:
            raise struct.error(
                f"frame truncated in {what}: {nbytes} bytes declared, "
                f"{end - off} remain")

    batch = TickBatch()
    (nv,) = take(_U32)
    need(nv * _VOTE.size, "vote section")
    for _ in range(nv):
        g, t, term, li, lt, gr = take(_VOTE)
        batch.votes.append(VoteRec(group=g, type=t, term=term, last_idx=li,
                                   last_term=lt, granted=bool(gr)))
    (na,) = take(_U32)
    need(na * _APP.size, "append section")
    for _ in range(na):
        g, t, term, pi, pt, cm, su, ma, seq, n = take(_APP)
        need(8 * n, "append entry terms")
        terms = list(struct.unpack_from(f"<{n}q", blob, off))
        off += 8 * n
        payloads: List[bytes] = []
        if t == MSG_REQ:
            for _ in range(n):
                (plen,) = take(_PLEN)
                need(plen, "append payload")
                payloads.append(blob[off:off + plen])
                off += plen
        batch.appends.append(AppendRec(
            group=g, type=t, term=term, prev_idx=pi, prev_term=pt,
            ent_terms=terms, payloads=payloads, commit=cm,
            success=bool(su), match=ma, seq=seq))
    (np_,) = take(_U32)
    need(np_ * (_U32.size + _PLEN.size), "proposal section")
    for _ in range(np_):
        (g,) = take(_U32)
        (plen,) = take(_PLEN)
        need(plen, "proposal payload")
        batch.proposals.append(ProposalRec(group=g,
                                           payload=blob[off:off + plen]))
        off += plen
    if off < len(blob):
        (ns,) = take(_U32)
        need(ns * (_SNAP.size + _PLEN.size), "snapshot section")
        for _ in range(ns):
            g, li, lt, term = take(_SNAP)
            (blen,) = take(_PLEN)
            need(blen, "snapshot blob")
            batch.snapshots.append(SnapshotRec(
                group=g, last_idx=li, last_term=lt, term=term,
                blob=blob[off:off + blen]))
            off += blen
    if off < len(blob):
        cols = ColRecs()
        (nv_,) = take(_U32)
        # Bound-check declared counts against the remaining bytes BEFORE
        # any frombuffer: a truncated or corrupt frame must surface as a
        # codec-level decode error (struct.error, matching the record
        # sections above), not a ValueError deep inside numpy.
        if nv_ * 4 * len(_COL_V) > len(blob) - off:
            raise struct.error(
                f"columnar vote section truncated: {nv_} rows declared, "
                f"{len(blob) - off} bytes remain")
        for f in _COL_V:
            arr = np.frombuffer(blob, np.dtype("<i4"), nv_, off)
            setattr(cols, f, arr)
            off += 4 * nv_
        (na_,) = take(_U32)
        if na_ * (4 * (len(_COL_A) - 1) + 8) > len(blob) - off:
            raise struct.error(
                f"columnar append section truncated: {na_} rows declared, "
                f"{len(blob) - off} bytes remain")
        for f in _COL_A:
            dt = np.dtype("<i8") if f == "a_seq" else np.dtype("<i4")
            arr = np.frombuffer(blob, dt, na_, off)
            setattr(cols, f, arr)
            off += dt.itemsize * na_
        if nv_ or na_:
            batch.cols = cols
    return batch


def encode_batch_framed(batch: TickBatch) -> bytes:
    """Flat encoding prefixed with a whole-frame CRC32 — the form the
    wire transports ship (loopback included, so every test run crosses
    the production framing)."""
    payload = encode_batch(batch)
    return _U32.pack(zlib.crc32(payload)) + payload


def decode_batch_framed(blob: bytes) -> TickBatch:
    """Verify the frame CRC, then decode.  Raises FrameCorruptError on
    any mismatch — a flipped bit anywhere in the frame is caught here,
    BEFORE record decoding can misinterpret corrupt lengths/ids."""
    if len(blob) < _U32.size:
        raise FrameCorruptError(f"frame too short ({len(blob)} bytes)")
    (crc,) = _U32.unpack_from(blob)
    payload = blob[_U32.size:]
    if zlib.crc32(payload) != crc:
        raise FrameCorruptError(
            f"frame CRC mismatch ({len(blob)} bytes)")
    return decode_batch(payload)
