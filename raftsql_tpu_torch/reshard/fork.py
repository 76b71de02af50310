"""Snapshot fork: split one SQLite image into two disjoint shards.

A SPLIT freezes intake on the source group, takes a consistent image
(`SQLiteStateMachine.serialize`, which already handles the py3.10
`VACUUM INTO` fallback), and forks it by hash slot: every row of the
keyed table whose key hashes into the moving slot set goes to the new
group's image, the rest stay.  The two outputs are real standalone
SQLite files whose keyed-row union is exactly the source — the
disjoint-union property tests/test_reshard.py pins.

The fork works purely through file-backed connections and an ATTACHed
source, so it runs identically on py3.10 (no Connection.serialize /
deserialize) and newer interpreters.

Copy of raftsql_tpu/reshard/fork.py.
"""
from __future__ import annotations

import os
import shutil
import sqlite3
import tempfile
from typing import Iterable, Tuple

from .keymap import slot_of

# Tables that are replication plumbing, not user data: they are copied
# to BOTH forks verbatim (each side keeps its applied floor / journal).
META_TABLES = ("_raft_meta", "_reshard_journal")


def _copy_side(srcp: str, outp: str, table: str, keycol: str,
               slots: frozenset, nslots: int, keep_moving: bool) -> bytes:
    conn = sqlite3.connect(outp)
    try:
        conn.create_function(
            "raftslot", 1, lambda k: slot_of(str(k), nslots))
        conn.execute("ATTACH DATABASE ? AS src", (srcp,))
        rows = conn.execute(
            "SELECT name, sql FROM src.sqlite_master "
            "WHERE type='table' AND sql IS NOT NULL").fetchall()
        slotlist = ",".join(str(s) for s in sorted(slots)) or "-1"
        pred = "IN" if keep_moving else "NOT IN"
        for name, sql in rows:
            if name.startswith("sqlite_"):
                continue
            conn.execute(sql)
            if name == table:
                conn.execute(
                    f"INSERT INTO {name} SELECT * FROM src.{name} "
                    f"WHERE raftslot({keycol}) {pred} ({slotlist})")
            elif name in META_TABLES:
                conn.execute(
                    f"INSERT INTO {name} SELECT * FROM src.{name}")
            # other user tables are not slot-addressable; they stay with
            # the source shard only
            elif not keep_moving:
                conn.execute(
                    f"INSERT INTO {name} SELECT * FROM src.{name}")
        conn.commit()
        conn.execute("DETACH DATABASE src")
        conn.execute("VACUUM")
    finally:
        conn.close()
    with open(outp, "rb") as f:
        return f.read()


def fork_by_slots(image: bytes, slots: Iterable[int], nslots: int,
                  table: str = "kv",
                  keycol: str = "k") -> Tuple[bytes, bytes]:
    """Fork a serialized SQLite image by hash slot.

    Returns `(moving, staying)` images: `moving` holds exactly the
    keyed rows whose slot is in `slots`, `staying` holds the rest plus
    every non-keyed table.  Both carry the meta tables unchanged.
    """
    moving_set = frozenset(int(s) for s in slots)
    d = tempfile.mkdtemp(prefix="raftsql-fork-")
    try:
        srcp = os.path.join(d, "src.db")
        with open(srcp, "wb") as f:
            f.write(image)
        moving = _copy_side(srcp, os.path.join(d, "moving.db"),
                            table, keycol, moving_set, nslots, True)
        staying = _copy_side(srcp, os.path.join(d, "staying.db"),
                             table, keycol, moving_set, nslots, False)
        return moving, staying
    finally:
        shutil.rmtree(d, ignore_errors=True)


def fork_state_machine(sm, slots: Iterable[int], nslots: int,
                       table: str = "kv", keycol: str = "k"):
    """(applied_index, moving_image, staying_image) from a live state
    machine — the index labels BOTH forks' log position."""
    index, image = sm.serialize_with_index()
    moving, staying = fork_by_slots(image, slots, nslots, table, keycol)
    return index, moving, staying
