"""Decoder of the program's write-ahead log, as it lies on disk.

A frozen copy of the replay half of raftsql_tpu_torch/storage/wal.py
(record layout, segment order, log-matching replay), so that the
benchmark reads the WAL by its own code.  It imports nothing of the
program.

Record layout:  u32 crc32(body) | u32 body_len | body
  body := u8 type | fields
  1 ENTRY:     u32 group | u64 index | u64 term | bytes data
  2 HARDSTATE: u32 group | u64 term | i64 vote | u64 commit
  3 SNAPSHOT:  u32 group | u64 index | u64 term
  4 COMPACT:   u32 group | u64 index | u64 term
  5 RANGE:     u32 group | u64 start | u64 term | u32 count
               | u32 lens[count] | bytes payloads
  6 EPOCH, 7 CONF, 8 DEDUP: read past (they carry no entries).
Under WAL group commit every peer's records share one log, keyed by the
flat group id peer * G + group.
"""
from __future__ import annotations

import os
import re
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

_HDR = struct.Struct("<II")
_ENTRY = struct.Struct("<BIQQ")
_HARD = struct.Struct("<BIQqQ")
_SNAP = struct.Struct("<BIQQ")
_RANGE = struct.Struct("<BIQQI")
_SEG_RE = re.compile(r"^wal-(\d+)\.log$")


@dataclass
class GroupLog:
    entries: List[Tuple[int, bytes]] = field(default_factory=list)
    start: int = 0
    commit: int = 0


@dataclass
class Replay:
    groups: Dict[int, GroupLog] = field(default_factory=dict)
    torn: int = 0             # records that failed their CRC or length


def _entry(groups, group, index, term, data):
    gl = groups.setdefault(group, GroupLog())
    pos = index - gl.start
    if pos < 1:
        return
    if pos <= len(gl.entries):
        if gl.entries[pos - 1][0] == term:
            gl.entries[pos - 1] = (term, data)
        else:
            del gl.entries[pos - 1:]
            gl.entries.append((term, data))
    elif pos == len(gl.entries) + 1:
        gl.entries.append((term, data))
    else:
        gl.entries.clear()
        gl.start = index - 1
        gl.entries.append((term, data))


def _blob(blob: bytes, rp: Replay) -> bool:
    groups = rp.groups
    off = 0
    n = len(blob)
    while off + _HDR.size <= n:
        crc, blen = _HDR.unpack_from(blob, off)
        body = blob[off + _HDR.size: off + _HDR.size + blen]
        if len(body) != blen or zlib.crc32(body) != crc:
            rp.torn += 1
            return False
        off += _HDR.size + blen
        rtype = body[0]
        if rtype == 1:
            _, group, index, term = _ENTRY.unpack_from(body)
            _entry(groups, group, index, term, body[_ENTRY.size:])
        elif rtype == 5:
            _, group, start, term, count = _RANGE.unpack_from(body)
            lens = struct.unpack_from(f"<{count}I", body, _RANGE.size)
            pos = _RANGE.size + 4 * count
            for i, ln in enumerate(lens):
                _entry(groups, group, start + i, term, body[pos: pos + ln])
                pos += ln
        elif rtype == 2:
            _, group, _term, _vote, commit = _HARD.unpack_from(body)
            groups.setdefault(group, GroupLog()).commit = commit
        elif rtype in (3, 4):
            _, group, index, _term = _SNAP.unpack_from(body)
            gl = groups.setdefault(group, GroupLog())
            if index > gl.start:
                if rtype == 3:
                    gl.entries.clear()
                else:
                    del gl.entries[:min(index - gl.start, len(gl.entries))]
                gl.start = index
    if off != n:
        rp.torn += 1
        return False
    return True


def replay(dirname: str) -> Replay:
    """Every segment of `dirname` in sequence order; a torn record stops
    the replay (and is counted)."""
    segs = []
    for name in os.listdir(dirname):
        m = _SEG_RE.match(name)
        if m:
            segs.append((int(m.group(1)), os.path.join(dirname, name)))
    rp = Replay()
    for _seq, path in sorted(segs):
        with open(path, "rb") as f:
            if not _blob(f.read(), rp):
                break
    return rp
