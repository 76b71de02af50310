"""The elastic keyspace on the port (raftsql_tpu_torch/reshard/): router,
journal, fork, coordinator, the serving plane, and the placement
controller's keyspace verbs.

The first half is the port's copy of tests/test_reshard.py (every case;
the end-to-end `elastic` case stays `slow`, as in the reference) and of
tests/test_quorum_geometry.py's witness refusal.  The second half holds
the port to the JAX package: slot numbers, keymap documents and journal
strings byte for byte (they are replicated through the raft logs and
stored in each group's `_reshard_journal` table, a format both packages'
data dirs share), the journal fold, the snapshot fork, both packages'
coordinators stepped over the same in-memory backend, and the placement
verbs' choices; then the port's own points: the plane reads only host
caches on its coordinator thread, MIGRATE ships a 0-page database, and
the fused server with --reshard runs split, merge and migrate through
POST /reshard with every acked /kv write read back.
"""
import http.client
import json
import os
import sqlite3
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from raftsql_tpu.reshard import coordinator as jcoordinator
from raftsql_tpu.reshard import fork as jfork
from raftsql_tpu.reshard import journal as jjournal
from raftsql_tpu.reshard import keymap as jkeymap
from raftsql_tpu_torch.reshard.coordinator import (ReshardCoordinator,
                                                   ReshardRefused)
from raftsql_tpu_torch.reshard.fork import fork_by_slots, fork_state_machine
from raftsql_tpu_torch.reshard.journal import (decode_rdel, decode_record,
                                               encode_rdel, encode_record,
                                               fold_records)
from raftsql_tpu_torch.reshard.keymap import KeyMap, slot_of

torch.set_num_threads(1)

TIMEOUT = 30.0


# -- keymap -----------------------------------------------------------------


def test_slot_of_stable_and_bounded():
    assert all(0 <= slot_of(f"k{i}", 16) < 16 for i in range(200))
    assert slot_of("alpha", 16) == slot_of("alpha", 16)
    # The ring spreads keys: no single slot swallows the keyspace.
    slots = {slot_of(f"k{i}", 16) for i in range(200)}
    assert len(slots) > 8


def test_keymap_move_retire_epoch():
    km = KeyMap.initial(2, 8)
    assert km.epoch == 0 and km.slots == [0, 1] * 4
    assert km.live_groups() == [0, 1]
    assert km.move([0, 2], 1) == 1
    assert km.slots_of(0) == [4, 6]
    assert km.slots_of(1) == [0, 1, 2, 3, 5, 7]
    # Retiring a group that still owns slots is refused.
    with pytest.raises(ValueError):
        km.retire(0)
    km.move([4, 6], 1)
    assert km.retire(0) == 3
    assert km.live_groups() == [1] and 0 in km.retired
    # A later move back ONTO the retired group revives it.
    km.move([0], 0)
    assert 0 not in km.retired and km.live_groups() == [0, 1]


def test_keymap_freeze_is_not_a_routing_change():
    km = KeyMap.initial(2, 8)
    km.freeze([3, 5])
    assert km.epoch == 0          # hygiene, not a routing change
    assert km.frozen == {3, 5}
    frozen_key = next(k for k in (f"k{i}" for i in range(100))
                      if km.slot_of(k) == 3)
    assert km.is_frozen(frozen_key)
    km.unfreeze([3])
    assert not km.is_frozen(frozen_key) and km.frozen == {5}


def test_keymap_doc_roundtrip():
    km = KeyMap.initial(3, 16)
    km.move([1, 4, 7], 2)
    km.freeze([9])
    doc = km.to_doc()
    back = KeyMap.from_doc(json.loads(json.dumps(doc)))
    assert back.to_doc() == doc
    assert back.epoch == 1 and back.frozen == {9}


# -- journal ----------------------------------------------------------------


def _rec(vid, step, verb="split", src=0, dst=1, slots=(0, 2), nslots=8):
    return {"id": vid, "verb": verb, "step": step, "src": src,
            "dst": dst, "slots": sorted(slots), "nslots": nslots}


def test_record_encode_decode():
    rec = _rec(3, "copied")
    assert decode_record(encode_record(rec)) == rec
    assert decode_record(encode_record(rec).encode()) == rec
    for junk in ("", "RJ!not json", "INSERT INTO kv", b"\xff\xfe", None):
        assert decode_record(junk) is None
    rd = decode_rdel(encode_rdel([2, 0], 8, 5))
    assert rd == {"id": 5, "slots": [0, 2], "nslots": 8}
    assert decode_rdel("RD!{bad") is None


def test_fold_any_order_with_duplicates():
    """The journal fold must collapse re-proposed duplicates and sort
    by verb id: the coordinator re-journals idempotently whenever a
    proposal may have been lost at a deposed leader."""
    v1 = [_rec(1, s) for s in ("begin", "copied", "flip", "done")]
    # After v1, group 1 owns {0,1,2,3,5,7} — a merge moves ALL of it.
    v2 = [_rec(2, s, verb="merge", src=1, dst=0,
               slots=[0, 1, 2, 3, 5, 7])
          for s in ("begin", "copied", "flip", "done")]
    records = list(reversed(v1)) + v2 + v1 + [v2[0]]   # shuffled + dups
    km, active = fold_records(records, num_groups=2, nslots=8)
    assert active is None
    # v1 moved slots {0,2} to g1, then v2 merged g1's keyspace into g0
    # and retired g1: everything lands on g0.
    assert set(km.slots) == {0}
    assert km.retired == {1}
    assert km.epoch == 3          # move, move, retire
    assert km.frozen == set()


def test_fold_active_verb_freezes_until_flipped():
    km, active = fold_records([_rec(1, "begin")], num_groups=2, nslots=8)
    assert active is not None and active["id"] == 1
    assert "flip" not in active["steps"]
    assert km.frozen == {0, 2} and km.epoch == 0
    # Once the flip record is in the log the slots belong to dst and
    # are NOT frozen — only the cleanup half remains.
    km, active = fold_records(
        [_rec(1, "begin"), _rec(1, "copied"), _rec(1, "flip")],
        num_groups=2, nslots=8)
    assert active is not None
    assert km.slots[0] == 1 and km.slots[2] == 1
    assert km.frozen == set() and km.epoch == 1
    # A migrate in flight never freezes slots (keyspace doesn't move).
    km, active = fold_records(
        [_rec(2, "begin", verb="migrate", slots=[])],
        num_groups=2, nslots=8)
    assert active is not None and km.frozen == set()


# -- snapshot fork ----------------------------------------------------------


def _rows_of_image(image: bytes, sql: str):
    with tempfile.NamedTemporaryFile(suffix=".db") as f:
        f.write(image)
        f.flush()
        conn = sqlite3.connect(f.name)
        try:
            return conn.execute(sql).fetchall()
        finally:
            conn.close()


def test_fork_disjoint_union(tmp_path):
    """Key-range fork: two standalone DBs, keyed rows disjoint by
    slot, union exactly the source; meta tables on BOTH sides,
    non-keyed tables stay with the source shard.  Runs through
    `SQLiteStateMachine.serialize`, so it exercises the py3.10
    `VACUUM INTO` fallback on interpreters without
    Connection.serialize.  resume=True so the `_raft_meta` applied
    floor exists — the meta table both forks must carry."""
    from raftsql_tpu_torch.models.sqlite_sm import SQLiteStateMachine
    sm = SQLiteStateMachine(str(tmp_path / "src.db"), resume=True)
    try:
        sm.apply("CREATE TABLE kv (k TEXT PRIMARY KEY, v TEXT)", 1)
        src_rows = {}
        for i in range(40):
            k, v = f"key-{i}", f"val|{i}"     # '|' probes value safety
            src_rows[k] = v
            sm.apply("INSERT INTO kv VALUES "
                     f"('{k}', '{v}')", i + 2)
        sm.apply("CREATE TABLE sidecar (n INTEGER)", 42)
        sm.apply("INSERT INTO sidecar VALUES (7)", 43)
        nslots = 8
        moving_slots = [0, 3, 5]
        index, moving, staying = fork_state_machine(
            sm, moving_slots, nslots)
        assert index == 43
    finally:
        sm.close()
    got_m = dict(_rows_of_image(moving, "SELECT k, v FROM kv"))
    got_s = dict(_rows_of_image(staying, "SELECT k, v FROM kv"))
    # Disjoint...
    assert not set(got_m) & set(got_s)
    # ...partitioned exactly by slot...
    assert all(slot_of(k, nslots) in set(moving_slots) for k in got_m)
    assert all(slot_of(k, nslots) not in set(moving_slots)
               for k in got_s)
    # ...and the union IS the source, values intact.
    union = dict(got_m)
    union.update(got_s)
    assert union == src_rows
    assert got_m            # the slot choice actually moved something
    # Meta tables ride on both forks; non-keyed tables stay.
    for img in (moving, staying):
        names = {r[0] for r in _rows_of_image(
            img, "SELECT name FROM sqlite_master WHERE type='table'")}
        assert "_raft_meta" in names
    assert _rows_of_image(staying,
                          "SELECT n FROM sidecar") == [(7,)]
    assert not _rows_of_image(
        moving, "SELECT name FROM sqlite_master "
                "WHERE type='table' AND name='sidecar'") \
        or _rows_of_image(moving, "SELECT n FROM sidecar") == []


# -- coordinator ------------------------------------------------------------


class MemBackend:
    """In-memory coordinator backend: journal/copy/rdel apply
    instantly (the 'cluster' never starves), which makes each step()
    advance exactly one state — crash points are then just step
    counts.  `records` doubles as the durable journal a rebuilt
    coordinator folds."""

    def __init__(self, keymap: KeyMap):
        self.nslots = keymap.nslots
        self.kv = {g: {} for g in
                   range(len(set(keymap.slots) | keymap.retired))}
        self.records = []
        self.applied = set()
        self.published = []
        self.shipped = []
        self.cutover_outcome = "completed"

    def seed(self, keymap: KeyMap, n: int = 32):
        for i in range(n):
            k = f"k{i}"
            self.kv[keymap.group_of(k)][k] = f"v{i}"

    def journal(self, group, rec, want=True):
        self.records.append(dict(rec))
        self.applied.add((int(rec["id"]), rec["step"]))

    def journal_applied(self, vid, step):
        return (int(vid), step) in self.applied

    def drained(self, group, slots):
        return True

    def rows_of(self, group, slots):
        ss = set(int(s) for s in slots)
        return {k: v for k, v in self.kv[int(group)].items()
                if slot_of(k, self.nslots) in ss}

    def copy(self, dst, rows):
        self.kv[int(dst)].update(rows)

    def copy_settled(self, dst, rows):
        return all(self.kv[int(dst)].get(k) == v
                   for k, v in rows.items())

    def rdel(self, group, slots, vid):
        for k in list(self.rows_of(group, slots)):
            del self.kv[int(group)][k]

    def rdel_settled(self, group, slots, vid):
        return not self.rows_of(group, slots)

    def publish(self, km):
        self.published.append(km.epoch)

    def ship(self, src, dst):
        self.shipped.append((int(src), int(dst)))

    def cutover(self, src, dst, retry=False):
        return self.cutover_outcome


def _coord(num_groups=2, nslots=8):
    km = KeyMap.initial(num_groups, nslots)
    be = MemBackend(km)
    be.seed(km)
    return ReshardCoordinator(be, km, num_groups=num_groups), be, km


def _run(coord, max_steps=50):
    for _ in range(max_steps):
        if not coord.busy:
            return
        coord.step()
    raise AssertionError(f"verb did not finish: {coord.doc()}")


def test_split_moves_rows_and_bumps_epoch():
    coord, be, km = _coord()
    before = dict(be.kv[0])
    moving = [0, 2]
    moved = {k: v for k, v in before.items()
             if slot_of(k, 8) in set(moving)}
    assert moved                  # seed covered the moving slots
    coord.enqueue("split", 0, 1, moving)
    assert km.frozen == {0, 2}    # intake refused while in flight
    _run(coord)
    assert km.epoch == 1 and km.slots[0] == 1 and km.slots[2] == 1
    assert km.frozen == set()
    for k, v in moved.items():
        assert be.kv[1][k] == v           # arrived at dst...
        assert k not in be.kv[0]          # ...and cleaned off src
    assert coord.counters["splits"] == 1
    assert be.published and be.published[-1] == 1


def test_merge_retires_source_and_migrate_ships():
    coord, be, km = _coord()
    src_rows = dict(be.kv[1])
    coord.enqueue("merge", 1, 0)
    _run(coord)
    assert km.retired == {1} and set(km.slots) == {0}
    assert all(be.kv[0][k] == v for k, v in src_rows.items())
    assert not be.kv[1]
    assert coord.counters["merges"] == 1
    # A full-slot split IS a merge (enqueue normalizes the verb).
    coord2, be2, km2 = _coord()
    coord2.enqueue("split", 1, 0, km2.slots_of(1))
    _run(coord2)
    assert coord2.counters["merges"] == 1 and km2.retired == {1}
    # Migrate never touches the keyspace; it ships + cuts over.
    coord.enqueue("migrate", 0, 2)
    _run(coord)
    assert be.shipped == [(0, 2)]
    assert coord.counters["migrations"] == 1
    assert km.epoch == 2          # unchanged by the migrate


def test_enqueue_refusals():
    coord, be, km = _coord()
    with pytest.raises(ReshardRefused):
        coord.enqueue("rotate", 0, 1)              # unknown verb
    with pytest.raises(ReshardRefused):
        coord.enqueue("split", 0, 1, [1])          # slot owned by g1
    with pytest.raises(ReshardRefused):
        coord.enqueue("split", 0, 0, [0])          # src == dst
    coord.enqueue("split", 0, 1, [0])
    with pytest.raises(ReshardRefused):
        coord.enqueue("split", 0, 1, [2])          # one verb at a time


def _rebuilt(be, num_groups=2, nslots=8):
    """A coordinator restarted after SIGKILL: fresh object, fresh
    boot-time keymap, state rebuilt ONLY from the journal fold."""
    km = KeyMap.initial(num_groups, nslots)
    coord = ReshardCoordinator(be, km, num_groups=num_groups)
    coord.recover(be.records)
    return coord, km


def test_sigkill_before_copy_fence_aborts():
    """Crash after `begin` but before the `copied` fence reached the
    log: rows may be half-copied into dst.  Recovery must UNDO the
    partial copies, release the freeze, and leave the router exactly
    where it was — never guess forward past an unfenced copy."""
    coord, be, km = _coord()
    src_before = dict(be.kv[0])
    coord.enqueue("split", 0, 1, [0, 2])
    coord.step()                  # j:begin -> drain
    coord.step()                  # drain: rows copied into dst
    assert any(slot_of(k, 8) in (0, 2) for k in be.kv[1])
    del coord                     # SIGKILL: fence never journaled

    coord2, km2 = _rebuilt(be)
    assert coord2.busy
    _run(coord2)
    assert coord2.counters["aborted"] == 1
    assert coord2.counters["resumed"] == 1
    assert coord2.counters["splits"] == 0
    assert km2.epoch == 0 and km2.slots == KeyMap.initial(2, 8).slots
    assert km2.frozen == set()
    assert be.kv[0] == src_before              # src untouched
    assert not any(slot_of(k, 8) in (0, 2) for k in be.kv[1])


def test_sigkill_after_copy_fence_resumes_forward():
    """Crash once `copied` is journaled: dst durably holds the rows,
    so recovery must finish the verb FORWARD (flip + cleanup), not
    abort — an abort here would orphan the copies."""
    coord, be, km = _coord()
    moved = {k: v for k, v in be.kv[0].items()
             if slot_of(k, 8) in (0, 2)}
    coord.enqueue("split", 0, 1, [0, 2])
    coord.step()                  # j:begin -> drain
    coord.step()                  # drain -> copy
    coord.step()                  # copy settled -> journal 'copied'
    assert ("copied" in {r["step"] for r in be.records})
    del coord                     # SIGKILL mid-verb

    coord2, km2 = _rebuilt(be)
    _run(coord2)
    assert coord2.counters["splits"] == 1
    assert coord2.counters["resumed"] == 1
    assert coord2.counters["aborted"] == 0
    assert km2.epoch == 1 and km2.slots[0] == 1 and km2.slots[2] == 1
    for k, v in moved.items():
        assert be.kv[1][k] == v and k not in be.kv[0]


def test_sigkill_after_flip_finishes_cleanup():
    coord, be, km = _coord()
    coord.enqueue("split", 0, 1, [0, 2])
    for _ in range(5):            # through j:flip (router flipped)
        coord.step()
    assert "flip" in {r["step"] for r in be.records}
    del coord

    coord2, km2 = _rebuilt(be)
    assert km2.epoch == 1         # fold already applied the flip
    _run(coord2)
    assert coord2.counters["splits"] == 1
    assert not any(slot_of(k, 8) in (0, 2) for k in be.kv[0])
    assert "done" in {r["step"] for r in be.records}


def test_migrate_disk_fault_aborts_cleanly():
    coord, be, km = _coord()

    def bad_ship(src, dst):
        raise OSError("injected fork fault")
    be.ship = bad_ship
    coord.enqueue("migrate", 0, 2)
    _run(coord)
    assert coord.counters["aborted"] == 1
    assert coord.counters["fork_faults"] == 1
    assert km.epoch == 0          # keyspace untouched


def test_metrics_doc_always_carries_all_verbs():
    coord, be, km = _coord()
    doc = coord.metrics_doc()
    assert doc["active"] == 0 and doc["epoch"] == 0
    assert set(doc["duration"]) == {"split", "merge", "migrate"}
    for verb in doc["duration"]:
        h = doc["duration"][verb]
        assert h["count"] == 0 and "inf" in h["bucket"]
    coord.enqueue("split", 0, 1, [0])
    _run(coord)
    h = coord.metrics_doc()["duration"]["split"]
    assert h["count"] == 1 and h["bucket"]["inf"] == 1


# -- shm plane: mapping-epoch fail-closed -----------------------------------


def test_shm_reader_fails_closed_on_keymap_epoch(tmp_path):
    """A router flip publishes the new mapping epoch into the shm
    header; a worker whose cached epoch lags MUST fall back to the
    ring path (None) — recoverably, unlike an engine-epoch mismatch —
    until it refreshes and revalidates."""
    from raftsql_tpu_torch.runtime.shm import (ShmSnapshotPublisher,
                                         ShmSnapshotReader)
    pub = ShmSnapshotPublisher(str(tmp_path), num_groups=1)
    pub.start(lambda g: None, lambda g: 0)
    rdr = ShmSnapshotReader(str(tmp_path))
    try:
        pub.publish_deltas({0: [("CREATE TABLE t (v TEXT)", 1),
                                ("INSERT INTO t VALUES ('x')", 2)]})
        got = rdr.try_read("local", 0, "SELECT count(*) FROM t")
        assert got is not None and got[0].strip() == "|1|"
        pub.set_keymap_epoch(1)   # reshard flip behind the worker
        assert rdr.try_read("local", 0,
                            "SELECT count(*) FROM t") is None
        assert rdr.keymap_epoch() == 1
        rdr.note_keymap_epoch(1)  # worker refreshed its mapping
        got = rdr.try_read("local", 0, "SELECT count(*) FROM t")
        assert got is not None and got[0].strip() == "|1|"
    finally:
        rdr.close()
        pub.close()


# -- api client: mapping-epoch adoption (satellite: unknown-group refresh) --


def _client():
    from raftsql_tpu_torch.api.client import RaftSQLClient
    return RaftSQLClient([10001, 10002], timeout_s=0.2,
                         backoff_s=0.001, backoff_cap_s=0.002)


def _km_doc(epoch, nslots=8, groups=2):
    return KeyMap(nslots, [s % groups for s in range(nslots)],
                  epoch=epoch).to_doc()


def test_client_adopts_only_newer_keymaps():
    c = _client()
    assert c.keymap_epoch() is None
    assert c._note_keymap(_km_doc(2)) is True
    assert c.keymap_epoch() == 2
    # Stale and equal sweeps must NOT roll the router back.
    assert c._note_keymap(_km_doc(1)) is False
    assert c._note_keymap(_km_doc(2)) is False
    assert c.keymap_epoch() == 2
    assert c._note_keymap(_km_doc(3)) is True
    assert c._note_keymap("junk") is False
    assert c.keymap_epoch() == 3
    # The cached epoch is pinned onto every /kv request.
    assert c._kv_headers()["X-Raft-Keymap-Epoch"] == "3"


def test_client_put_kv_refreshes_on_409_and_retries():
    """The mapping-epoch bump path: a split moved the keyspace under
    this client, the server refuses the pinned epoch with 409 + the
    CURRENT mapping, and the client must adopt it and retry the same
    write immediately (breaking the node rotation, not backing off)."""
    c = _client()
    c._note_keymap(_km_doc(1))
    attempts = []

    def fake_raw(node, method, path="/", body="", headers=None,
                 timeout_s=None):
        attempts.append((node, (headers or {}).get(
            "X-Raft-Keymap-Epoch")))
        if (headers or {}).get("X-Raft-Keymap-Epoch") != "4":
            return 409, {}, json.dumps(
                {"error": "keymap epoch mismatch",
                 "keymap": _km_doc(4)})
        return 204, {"X-Raft-Session": "9",
                     "X-Raft-Keymap-Epoch": "4"}, ""

    c.raw = fake_raw
    assert c.put_kv("alpha", "1", deadline_s=5) == 9
    assert c.keymap_epoch() == 4
    # One refused probe at the stale epoch, then the retry pins the
    # adopted epoch — no second trip around the ring in between.
    assert attempts[0][1] == "1" and attempts[1][1] == "4"
    assert len(attempts) == 2


def test_client_epoch_echo_triggers_healthz_sweep():
    """A SUCCESSFUL /kv response that echoes a newer epoch than the
    cache means the keyspace moved without refusing us (the slot
    landed on the same group): the client must sweep /healthz so its
    NEXT request pins the current epoch."""
    c = _client()
    swept = []

    def fake_health(node, timeout_s=2.0):
        swept.append(node)
        return {"keymap": _km_doc(2)}

    c.health = fake_health
    c._note_kv_epoch({"X-Raft-Keymap-Epoch": "2"})   # cache empty
    assert swept and c.keymap_epoch() == 2
    swept.clear()
    # Echo of the SAME epoch: no sweep.  Stale echo: no sweep either
    # (epochs only move forward; an old server answer is not news).
    c._note_kv_epoch({"X-Raft-Keymap-Epoch": "2"})
    c._note_kv_epoch({"X-Raft-Keymap-Epoch": "1"})
    c._note_kv_epoch({"X-Raft-Keymap-Epoch": "junk"})
    assert not swept
    c._note_kv_epoch({"X-Raft-Keymap-Epoch": "5"})
    assert swept


def test_client_get_kv_404_is_none_not_error():
    c = _client()

    def fake_raw(node, method, path="/", body="", headers=None,
                 timeout_s=None):
        if path.endswith("/missing"):
            return 404, {"X-Raft-Keymap-Epoch": "0"}, "no such key"
        return 200, {"X-Raft-Keymap-Epoch": "0"}, "value"

    c.raw = fake_raw
    assert c.get_kv("missing", deadline_s=5) is None
    assert c.get_kv("present", deadline_s=5) == "value"


# -- the live serving plane (both HTTP planes) ------------------------------


@pytest.fixture(params=["threaded", "aio"])
def elastic(request, tmp_path):
    """Single-node 4-group cluster with the reshard plane attached and
    its coordinator thread running — the `--reshard` server wiring."""
    from raftsql_tpu_torch.api.aio import AioSQLServer
    from raftsql_tpu_torch.api.http import SQLServer
    from raftsql_tpu_torch.config import RaftConfig
    from raftsql_tpu_torch.models.sqlite_sm import SQLiteStateMachine
    from raftsql_tpu_torch.reshard.plane import ReshardPlane
    from raftsql_tpu_torch.runtime.db import RaftDB
    from raftsql_tpu_torch.runtime.pipe import RaftPipe
    from raftsql_tpu_torch.transport.loopback import (LoopbackHub,
                                                LoopbackTransport)
    cfg = RaftConfig(num_groups=4, num_peers=1, tick_interval_s=0.005,
                     log_window=64, max_entries_per_msg=4)
    pipe = RaftPipe.create(1, 1, cfg, LoopbackTransport(LoopbackHub()),
                           data_dir=str(tmp_path / "raftsql-1"),
                           device="cpu")
    rdb = RaftDB(lambda g: SQLiteStateMachine(
        str(tmp_path / f"kv-g{g}.db")), pipe, num_groups=4)
    plane = ReshardPlane(rdb, nslots=16,
                         ship_dir=str(tmp_path / "ship"))
    plane.start()
    srv_cls = SQLServer if request.param == "threaded" else AioSQLServer
    srv = srv_cls(0, rdb, host="127.0.0.1", timeout_s=TIMEOUT)
    srv.start()
    yield srv, rdb, plane
    srv.stop()
    plane.stop()
    rdb.close()


def _raw_kv(srv, method, key, body=b"", headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                      timeout=10)
    try:
        conn.request(method, f"/kv/{key}", body=body,
                     headers=headers or {})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def _await_idle(plane, deadline_s=20.0):
    deadline = time.monotonic() + deadline_s
    while plane.coord.busy:
        if time.monotonic() > deadline:
            raise AssertionError(f"verb stuck: {plane.doc()}")
        time.sleep(0.02)


@pytest.mark.slow
def test_elastic_keyspace_end_to_end(elastic):
    """The full serving-plane story on a live node: keyed writes over
    the hash ring, a split and a merge through POST /reshard, epoch
    fail-closed refusals, client-side mapping adoption, reshard
    metrics, and finally a journal re-fold into a FRESH plane proving
    the router state is entirely log-derived."""
    from raftsql_tpu_torch.api.client import RaftSQLClient, SQLError
    from raftsql_tpu_torch.reshard.plane import ReshardPlane
    srv, rdb, plane = elastic
    cli = RaftSQLClient([srv.port], timeout_s=5.0, backoff_s=0.01)

    kv = {f"k{i}": f"v{i}|{i}" for i in range(24)}   # '|' in values
    for k, v in kv.items():
        assert cli.put_kv(k, v, deadline_s=TIMEOUT) is not None
    for k, v in kv.items():
        assert cli.get_kv(k, deadline_s=TIMEOUT) == v
    assert cli.get_kv("never-written", deadline_s=TIMEOUT) is None

    # /healthz carries the mapping; the client swept it while probing.
    assert cli.refresh_keymap() == 0

    # SPLIT: move half of group 0's slots to group 2.
    owned = plane.keymap.slots_of(0)
    moving = owned[:len(owned) // 2]
    doc = cli.reshard("split", 0, 2, moving, deadline_s=TIMEOUT)
    assert doc["verb"] == "split" and doc["id"] >= 1
    _await_idle(plane)
    assert plane.keymap.epoch == 1
    assert all(plane.keymap.slots[s] == 2 for s in moving)

    # Every acked write survives the move, read back THROUGH the
    # client, which adopts the bumped epoch along the way (the 409
    # fail-closed path: its cached epoch 0 is now stale).
    for k, v in kv.items():
        assert cli.get_kv(k, deadline_s=TIMEOUT) == v, k
    assert cli.keymap_epoch() == plane.keymap.epoch
    # Writes route to the NEW owner after the flip.
    moved_key = next((k for k in kv
                      if plane.keymap.slot_of(k) in set(moving)), None)
    if moved_key is not None:
        assert cli.put_kv(moved_key, "rewritten",
                          deadline_s=TIMEOUT) is not None
        assert cli.get_kv(moved_key, deadline_s=TIMEOUT) == "rewritten"
        kv[moved_key] = "rewritten"

    # A request pinned to a stale epoch is refused with the CURRENT
    # mapping attached — the raw-HTTP view of what the client handled.
    status, hdrs, body = _raw_kv(srv, "GET", "k0",
                                 headers={"X-Raft-Keymap-Epoch": "0"})
    assert status == 409
    refused = json.loads(body)
    assert refused["keymap"]["epoch"] == plane.keymap.epoch
    assert int(hdrs.get("X-Raft-Keymap-Epoch")) == plane.keymap.epoch

    # Frozen-slot intake is refused up front with a retry hint.
    s0 = plane.keymap.slot_of("k0")
    plane.keymap.freeze([s0])
    try:
        status, hdrs, _ = _raw_kv(srv, "PUT", "k0", body=b"nope")
        assert status == 503 and hdrs.get("Retry-After")
    finally:
        plane.keymap.unfreeze([s0])

    # MERGE group 3 into group 1; group 3 retires from the router.
    cli.reshard("merge", 3, 1, deadline_s=TIMEOUT)
    _await_idle(plane)
    assert 3 in plane.keymap.retired
    assert 3 not in plane.keymap.live_groups()
    for k, v in kv.items():
        assert cli.get_kv(k, deadline_s=TIMEOUT) == v, k

    # Verb hygiene over the wire: unknown verb and busy-coordinator
    # are 409s, surfaced as SQLError by the client.
    with pytest.raises(SQLError):
        cli.reshard("rotate", 0, 1, deadline_s=TIMEOUT)

    # /metrics carries the reshard counters + per-verb histograms.
    m = rdb.metrics()
    assert m["reshard"]["splits"] == 1
    assert m["reshard"]["merges"] == 1
    assert m["reshard"]["epoch"] == plane.keymap.epoch
    assert m["reshard"]["duration"]["split"]["count"] == 1

    # The router never holds truth the logs don't: folding the
    # replicated journal tables into a FRESH plane rebuilds the exact
    # same mapping.
    want = plane.keymap.to_doc()
    rebuilt = ReshardPlane(rdb, nslots=plane.keymap.nslots,
                           ship_dir=plane.ship_dir)
    try:
        rebuilt.recover_from_db()
        got = rebuilt.keymap.to_doc()
        assert got == want
        assert not rebuilt.coord.busy     # no verb left in flight
    finally:
        rdb.reshard = plane               # restore the live plane


# -- quorum geometry: a witness owns no shard (test_quorum_geometry.py) -----


def test_reshard_refuses_migrate_to_witness():
    class _Backend:
        def journal(self, group, rec):
            pass

        def publish(self, km):
            pass

    coord = ReshardCoordinator(_Backend(), KeyMap.initial(2, 8),
                               num_groups=2, witness_peers=(1,))
    with pytest.raises(ReshardRefused, match="witness"):
        coord.enqueue("migrate", 0, 1)
    # A full-voter destination is accepted (refusal is typed, not a
    # blanket migrate ban).
    assert coord.enqueue("migrate", 0, 0) >= 1


# -- parity with the JAX package --------------------------------------------


def _seeded_keys(seed, n):
    """`n` keys from a numpy seed: ASCII, '|' and quotes, and non-ASCII
    code points (crc32 runs over the UTF-8 bytes)."""
    rng = np.random.default_rng(seed)
    alphabet = list("abcxyz019|'_-") + ["é", "ß", "λ", "中", "🙂"]
    out = []
    for _ in range(n):
        ln = int(rng.integers(1, 12))
        out.append("".join(alphabet[int(i)] for i in
                           rng.integers(0, len(alphabet), ln)))
    return out


@pytest.mark.parametrize("nslots", [16, 64, 1000])
def test_slot_of_equals_jax(nslots):
    keys = _seeded_keys(nslots, 10_000)
    got = [slot_of(k, nslots) for k in keys]
    assert got == [jkeymap.slot_of(k, nslots) for k in keys]
    assert len(set(got)) > min(nslots, 100) // 2


def _keymap_script(km, rng, groups, steps=60):
    """Apply a seeded sequence of keymap verbs; the document after each
    step, as JSON text (what /healthz and a 409 carry)."""
    docs = []
    for _ in range(steps):
        op = int(rng.integers(0, 5))
        if op == 0:
            slots = rng.choice(km.nslots, int(rng.integers(1, 4)),
                               replace=False).tolist()
            km.move(slots, int(rng.integers(0, groups)))
        elif op == 1:
            try:
                km.retire(int(rng.integers(0, groups)))
            except ValueError:
                pass
        elif op == 2:
            km.freeze(rng.choice(km.nslots, 2, replace=False).tolist())
        elif op == 3:
            km.unfreeze(rng.choice(km.nslots, 3, replace=False).tolist())
        else:
            km = type(km).from_doc(json.loads(json.dumps(km.to_doc())))
        docs.append(json.dumps(km.to_doc(), sort_keys=True))
    return docs


@pytest.mark.parametrize("seed", range(3))
def test_keymap_documents_equal_jax(seed):
    groups, nslots = 4, 16
    port = _keymap_script(KeyMap.initial(groups, nslots),
                          np.random.default_rng(seed), groups)
    jax_ = _keymap_script(jkeymap.KeyMap.initial(groups, nslots),
                          np.random.default_rng(seed), groups)
    assert port == jax_


def _records(seed, n=40):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        verb = ("split", "merge", "migrate")[int(rng.integers(0, 3))]
        step = jjournal.STEPS[int(rng.integers(0, len(jjournal.STEPS)))]
        recs.append({"id": int(rng.integers(1, 9)), "verb": verb,
                     "step": step, "src": int(rng.integers(0, 4)),
                     "dst": int(rng.integers(0, 4)),
                     "slots": sorted(set(rng.integers(0, 16, 3).tolist())),
                     "nslots": 16})
    return recs


def test_journal_strings_equal_jax():
    for rec in _records(0):
        text = encode_record(rec)
        assert text == jjournal.encode_record(rec)
        assert decode_record(text) == jjournal.decode_record(text) == rec
        assert decode_record(text.encode()) == rec
        rd = encode_rdel(rec["slots"][::-1], 16, rec["id"])
        assert rd == jjournal.encode_rdel(rec["slots"][::-1], 16,
                                          rec["id"])
        assert decode_rdel(rd) == jjournal.decode_rdel(rd)
    for junk in ("", "RJ!{", "RJ![1]", 'RJ!{"id":1}', "RD!{}", b"\xff",
                 None, 7):
        assert decode_record(junk) == jjournal.decode_record(junk)
        assert decode_rdel(junk) == jjournal.decode_rdel(junk)


def _fold_view(km, active):
    if active is not None:
        active = dict(active, steps=sorted(active["steps"]))
    return km.to_doc(), active


@pytest.mark.parametrize("seed", range(4))
def test_fold_records_equals_jax_over_shuffled_duplicates(seed):
    """Streams a coordinator journals (a split, a merge, a migrate, an
    aborted split and a verb left in flight), shuffled and with
    duplicates, fold to the same (keymap, active verb) in both
    packages, and to the same result as the stream in order."""
    coord, be, km = _coord(num_groups=4, nslots=16)
    coord.enqueue("split", 0, 1, [0, 4])
    _run(coord)
    coord.enqueue("merge", 2, 3)
    _run(coord)
    coord.enqueue("migrate", 1, 2)
    _run(coord)
    be.ship = lambda src, dst: (_ for _ in ()).throw(OSError("fault"))
    coord.enqueue("migrate", 3, 1)
    _run(coord)
    coord.enqueue("split", 1, 0, [4])
    coord.step()                       # left in flight, pre-fence
    records = list(be.records)
    rng = np.random.default_rng(seed)
    stream = records + [records[int(i)] for i in
                        rng.integers(0, len(records), len(records) // 2)]
    stream = [stream[int(i)] for i in rng.permutation(len(stream))]
    want = _fold_view(*fold_records(records, num_groups=4, nslots=16))
    got = _fold_view(*fold_records(stream, num_groups=4, nslots=16))
    ref = _fold_view(*jjournal.fold_records(stream, num_groups=4,
                                            nslots=16))
    assert got == ref == want
    assert want[1] is not None and want[1]["id"] == 5


def test_fork_by_slots_row_sets_equal_jax(tmp_path):
    """Seeded rows, '|' and quotes in keys and values: both packages'
    forks hold the same row sets, disjoint by slot, whose union is the
    source; the meta tables ride on both sides."""
    rng = np.random.default_rng(7)
    src = tmp_path / "src.db"
    conn = sqlite3.connect(src)
    conn.execute("CREATE TABLE kv (k TEXT PRIMARY KEY, v TEXT)")
    conn.execute("CREATE TABLE _reshard_journal (rec TEXT NOT NULL)")
    conn.execute("INSERT INTO _reshard_journal VALUES (?)",
                 (encode_record(_rec(1, "begin")),))
    keys = sorted(set(_seeded_keys(11, 300)))
    rows = {k: f"v{int(rng.integers(0, 1 << 30))}|'" for k in keys}
    conn.executemany("INSERT INTO kv VALUES (?, ?)", rows.items())
    conn.commit()
    conn.close()
    image = src.read_bytes()
    moving_slots = sorted(set(rng.integers(0, 16, 6).tolist()))
    port = fork_by_slots(image, moving_slots, 16)
    ref = jfork.fork_by_slots(image, moving_slots, 16)
    for got, want in zip(port, ref):
        assert _rows_of_image(got, "SELECT k, v FROM kv ORDER BY k") \
            == _rows_of_image(want, "SELECT k, v FROM kv ORDER BY k")
        assert _rows_of_image(got, "SELECT rec FROM _reshard_journal") \
            == _rows_of_image(want, "SELECT rec FROM _reshard_journal")
    moving = dict(_rows_of_image(port[0], "SELECT k, v FROM kv"))
    staying = dict(_rows_of_image(port[1], "SELECT k, v FROM kv"))
    assert not set(moving) & set(staying)
    assert {**moving, **staying} == rows
    assert all(slot_of(k, 16) in moving_slots for k in moving)
    assert moving and staying


class TwinBackend(MemBackend):
    """MemBackend over either package's slot_of, recording every call
    the coordinator makes (the stream both coordinators must equal)."""

    def __init__(self, keymap, slot_fn):
        super().__init__(keymap)
        self._slot = slot_fn
        self.calls = []
        self.fail_ship = False

    def rows_of(self, group, slots):
        ss = set(int(s) for s in slots)
        return {k: v for k, v in self.kv[int(group)].items()
                if self._slot(k, self.nslots) in ss}

    def journal(self, group, rec, want=True):
        self.calls.append(("journal", int(group), dict(rec), want))
        super().journal(group, rec, want)

    def copy(self, dst, rows):
        self.calls.append(("copy", int(dst), sorted(rows.items())))
        super().copy(dst, rows)

    def rdel(self, group, slots, vid):
        self.calls.append(("rdel", int(group), sorted(slots), vid))
        super().rdel(group, slots, vid)

    def publish(self, km):
        self.calls.append(("publish", km.to_doc()))
        super().publish(km)

    def ship(self, src, dst):
        if self.fail_ship:
            raise OSError("injected fork fault")
        super().ship(src, dst)


def _twin_run(mod_coord, mod_keymap, scenario):
    """Drive one package's coordinator through `scenario`; returns the
    transcript: events, backend calls, final keymap, counters, metrics
    and the keyed state of every group."""
    km = mod_keymap.KeyMap.initial(4, 16)
    be = TwinBackend(km, mod_keymap.slot_of)
    be.seed(km, 48)
    coord = mod_coord.ReshardCoordinator(be, km, num_groups=4)
    events = []

    def run(c, max_steps=60):
        for _ in range(max_steps):
            if not c.busy:
                break
            c.step()
        events.extend(c.drain_events())

    def kill_after(c, steps):
        for _ in range(steps):
            c.step()
        events.extend(c.drain_events())
        k2 = mod_keymap.KeyMap.initial(4, 16)
        c2 = mod_coord.ReshardCoordinator(be, k2, num_groups=4)
        c2.recover(be.records)
        return c2, k2

    if scenario == "split":
        coord.enqueue("split", 0, 1, [0, 4, 8])
        run(coord)
    elif scenario == "merge":
        coord.enqueue("merge", 3, 2)
        run(coord)
        coord.enqueue("split", 2, 3, [3])   # a retired group revives
        run(coord)
    elif scenario == "migrate":
        coord.enqueue("migrate", 1, 2)
        run(coord)
    elif scenario.startswith("kill_"):
        steps = {"kill_before_fence": 2, "kill_after_fence": 3,
                 "kill_after_flip": 5}[scenario]
        coord.enqueue("split", 0, 1, [0, 4])
        coord, km = kill_after(coord, steps)
        run(coord)
    elif scenario == "disk_fault":
        be.fail_ship = True
        coord.enqueue("migrate", 0, 2)
        run(coord)
    assert not coord.busy
    events.extend(coord.drain_events())
    metrics = coord.metrics_doc()
    return {"events": events, "calls": be.calls, "keymap": km.to_doc(),
            "counters": dict(coord.counters), "metrics": metrics,
            "kv": {g: sorted(kv.items()) for g, kv in be.kv.items()},
            "shipped": be.shipped, "published": be.published}


@pytest.mark.parametrize("scenario", [
    "split", "merge", "migrate", "kill_before_fence", "kill_after_fence",
    "kill_after_flip", "disk_fault"])
def test_coordinators_equal_jax_over_one_backend(scenario):
    """Both packages' coordinators, stepped over the same in-memory
    backend through the same verbs and SIGKILL points, emit the same
    events and backend calls and end on the same keymap, counters,
    duration histograms and keyed state."""
    from raftsql_tpu_torch.reshard import coordinator, keymap
    got = _twin_run(coordinator, keymap, scenario)
    want = _twin_run(jcoordinator, jkeymap, scenario)
    assert got == want
    assert got["events"]


# -- the placement controller's keyspace verbs ------------------------------


class _Traffic:
    def __init__(self, rates):
        self._mu = threading.Lock()
        self._rate_p = np.asarray(rates, np.float64)

    def _advance_rates_locked(self):
        pass


class _PlaneStub:
    """The ReshardPlane surface the controller reads: keymap, per-slot
    PUT counters and enqueue (recording, or refusing)."""

    def __init__(self, km, hits, refuse):
        self.keymap = km
        self.slot_hits = hits
        self.refuse = refuse
        self.verbs = []

    def enqueue(self, verb, src, dst, slots=None):
        if self.refuse:
            raise RuntimeError("reshard verb already in flight")
        self.verbs.append((verb, src, dst,
                           None if slots is None else list(slots)))
        return {"verb": verb, "src": src, "dst": dst}


def _placement_choices(Placement, KM, seed):
    rng = np.random.default_rng(seed)
    groups, nslots = 5, 32
    km = KM.initial(groups, nslots)
    if seed % 2:                       # a retired group to revive
        km.move(km.slots_of(4), 0)
        km.retire(4)
    rates = rng.uniform(0, 100, groups)
    hits = rng.zipf(1.3, nslots).tolist() if seed % 3 else [0] * nslots
    out = []
    for refuse in (False, True):
        eng = type("E", (), {"traffic": _Traffic(rates)})()
        pc = Placement(eng)
        pc.reshard = _PlaneStub(km, hits, refuse)
        out.append((pc.split_hottest(), pc.merge_coldest(),
                    pc.reshard.verbs,
                    {k: v for k, v in pc.metrics_doc().items()
                     if k.startswith("reshard_")}))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_placement_keyspace_verbs_equal_jax(seed):
    """split_hottest (the traffic-weighted heaviest-first partition, or
    halving by count without per-slot hits) and merge_coldest choose the
    same verbs as the JAX controller on the same rates and slot hits;
    refusals count alike."""
    from raftsql_tpu.placement.controller import PlacementController as J
    from raftsql_tpu_torch.placement.controller import \
        PlacementController as P
    got = _placement_choices(P, KeyMap, seed)
    assert got == _placement_choices(J, jkeymap.KeyMap, seed)
    assert got[0][2] and got[0][3]["reshard_issued"] == 2
    assert got[1][3]["reshard_refused"] == 2


# -- the serving plane on the port's engine ---------------------------------


def _fused(tmp_path, groups=4):
    from raftsql_tpu_torch.server.main import build_fused_node
    return build_fused_node(groups=groups, peers=3, tick=0.005,
                            data_prefix=str(tmp_path / "raftsql"),
                            device="cpu")


def _leaders(rdb, groups, deadline_s=30.0):
    node = rdb.pipe.node
    until = time.monotonic() + deadline_s
    while any(node.leader_of(g) < 0 for g in range(groups)):
        assert time.monotonic() < until, "no leaders"
        time.sleep(0.02)
    return [node.leader_of(g) for g in range(groups)]


def test_plane_reads_host_caches_on_its_thread(tmp_path, monkeypatch):
    """`drained` and `cutover`, the two points where the coordinator's
    thread meets the device plane, read the host plane's numpy caches:
    no tensor is read back on the calling thread while a cutover moves
    a leader and completes."""
    from raftsql_tpu_torch.reshard.plane import ReshardPlane
    rdb = _fused(tmp_path, groups=2)
    try:
        plane = ReshardPlane(rdb, nslots=8, ship_dir=str(tmp_path / "s"))
        lead = _leaders(rdb, 2)
        me = threading.get_ident()
        reads = []
        for name in ("item", "tolist", "numpy", "cpu", "to", "__int__",
                     "__index__", "__bool__", "__float__"):
            orig = getattr(torch.Tensor, name)

            def spy(self, *a, _orig=orig, _name=name, **kw):
                if threading.get_ident() == me:
                    reads.append(_name)
                return _orig(self, *a, **kw)
            monkeypatch.setattr(torch.Tensor, name, spy)
        assert plane.drained(0, [0]) in (True, False)
        target = (lead[1] + 1) % 3
        until = time.monotonic() + 30.0
        out = plane.cutover(1, target)
        while out is None:
            assert time.monotonic() < until, "cutover never completed"
            time.sleep(0.02)
            out = plane.cutover(1, target)
        assert out == "completed"
        assert plane.drained(1, [1]) in (True, False)
        monkeypatch.undo()
        assert reads == []
        assert rdb.pipe.node.leader_of(1) == target
    finally:
        monkeypatch.undo()
        rdb.close()


def test_migrate_ships_a_zero_page_group(tmp_path):
    """MIGRATE's ship on a group whose only applied command failed (its
    index consumed, its database still 0 pages): the JAX package's plane
    raises ("unable to serialize 'main'", so its verb never ships and
    keeps retrying); the port's writes an image that install()
    restores."""
    from raftsql_tpu.models.sqlite_sm import SQLiteStateMachine as JSM
    from raftsql_tpu.reshard.plane import ReshardPlane as JPlane
    from raftsql_tpu_torch.models.sqlite_sm import SQLiteStateMachine
    from raftsql_tpu_torch.reshard.plane import ReshardPlane

    class _DB:
        num_groups = 2
        pipe = None

        def __init__(self, sms):
            self._sms = sms

    def failed_only(cls, name):
        sm = cls(str(tmp_path / f"{name}.db"))
        assert sm.apply("INSERT INTO missing VALUES (1)", 1) is not None
        assert sm.applied_index() == 1
        return sm

    jdb = _DB([failed_only(JSM, "j0"), failed_only(JSM, "j1")])
    jplane = JPlane(jdb, nslots=8, ship_dir=str(tmp_path / "jship"))
    with pytest.raises(sqlite3.OperationalError, match="serialize"):
        jplane.ship(1, 2)
    db = _DB([failed_only(SQLiteStateMachine, "p0"),
              failed_only(SQLiteStateMachine, "p1")])
    plane = ReshardPlane(db, nslots=8, ship_dir=str(tmp_path / "ship"))
    plane.ship(1, 2)
    (name,) = os.listdir(tmp_path / "ship")
    assert name == "g1-p2-i1.img"
    dst = SQLiteStateMachine(str(tmp_path / "restored.db"))
    dst.install((tmp_path / "ship" / name).read_bytes(), 1)
    assert dst.applied_index() == 1
    assert dst.apply("CREATE TABLE t (v text)", 2) is None
    assert dst.apply("INSERT INTO t (v) VALUES ('x')", 3) is None
    assert dst.query("SELECT v FROM t") == "|x|\n"


def test_verb_from_and_to_groups_without_keys(tmp_path):
    """A split from a group that no keyed write has reached, and one into
    such a group, both resolve on the port (the JAX package's plane
    raises "no such table: kv" on every step and never resolves them)."""
    from raftsql_tpu_torch.reshard.plane import ReshardPlane
    rdb = _fused(tmp_path)
    try:
        plane = ReshardPlane(rdb, nslots=16, ship_dir=str(tmp_path / "s"))
        plane.start()
        _leaders(rdb, 4)
        key = next(f"k{i}" for i in range(200)
                   if plane.keymap.group_of(f"k{i}") == 1)
        g, sql = plane.kv_put(key, "v")
        assert rdb.propose(sql, g).wait(TIMEOUT) is None
        plane.enqueue("split", 0, 2, plane.keymap.slots_of(0)[:2])
        _await_idle(plane, TIMEOUT)
        moving = [plane.keymap.slot_of(key)]
        plane.enqueue("split", 1, 3, moving)
        _await_idle(plane, TIMEOUT)
        assert plane.keymap.epoch == 2
        assert plane.keymap.group_of(key) == 3
        g, sql = plane.kv_get(key)
        assert plane.kv_value(rdb.query(sql, g)) == "v"
        assert plane.coord.counters["splits"] == 2
        plane.stop()
    finally:
        rdb.close()


def test_recover_marks_only_groups_with_a_journal(tmp_path):
    """A restarted plane counts a group as holding the journal table only
    when that group's own journal has rows.  (The JAX package's
    recover_from_db tests the records of every group folded so far, so
    after a verb journaled on group 0 every later group counts as having
    the table, and a flip grant into one of them fails: no such table.)"""
    from raftsql_tpu_torch.reshard.plane import ReshardPlane
    rdb = _fused(tmp_path)
    try:
        plane = ReshardPlane(rdb, nslots=16, ship_dir=str(tmp_path / "s"))
        plane.start()
        _leaders(rdb, 4)
        for i in range(40):
            g, sql = plane.kv_put(f"k{i}", "v")
            assert rdb.propose(sql, g).wait(TIMEOUT) is None
        plane.enqueue("split", 0, 2, plane.keymap.slots_of(0)[:1])
        _await_idle(plane, TIMEOUT)
        plane.stop()
        fresh = ReshardPlane(rdb, nslots=16, ship_dir=str(tmp_path / "s"))
        fresh.recover_from_db()
        assert fresh._ddl_done == {0, 2}          # src journal, dst grant
        assert fresh.keymap.to_doc() == plane.keymap.to_doc()
        fresh.start()
        fresh.enqueue("split", 1, 3, fresh.keymap.slots_of(1)[:1])
        _await_idle(fresh, TIMEOUT)
        assert fresh._journal_rows(3)             # the grant landed
        fresh.stop()
    finally:
        rdb.close()


def test_fused_server_reshard_end_to_end(tmp_path):
    """The --fused --reshard server on the port (build_fused_node, 3
    peers, the aio plane) with placement attached: keyed writes over
    the hash ring, a split, a merge and a migrate through POST
    /reshard, every acked write read back after each verb, a stale
    epoch refused with 409 and the current keymap, a frozen slot
    refused with 503 + Retry-After, the reshard counters in /metrics,
    split_hottest from the controller, and the journal re-folded into a
    fresh plane to the same keymap."""
    from raftsql_tpu_torch.api.aio import AioSQLServer
    from raftsql_tpu_torch.api.client import RaftSQLClient
    from raftsql_tpu_torch.reshard.plane import ReshardPlane
    from raftsql_tpu_torch.server.main import attach_placement, \
        attach_reshard
    rdb = _fused(tmp_path)
    pc = attach_placement(rdb, interval_s=3600.0)
    plane = attach_reshard(rdb, nslots=16,
                           ship_dir=str(tmp_path / "ship"))
    srv = AioSQLServer(0, rdb, host="127.0.0.1", timeout_s=TIMEOUT)
    srv.start()
    try:
        assert pc.reshard is plane
        cli = RaftSQLClient([srv.port], timeout_s=5.0, backoff_s=0.01)
        kv = {f"k{i}": f"v{i}|{i}" for i in range(24)}
        for k, v in kv.items():
            assert cli.put_kv(k, v, deadline_s=TIMEOUT) is not None

        def read_back(what):
            for k, v in kv.items():
                assert cli.get_kv(k, deadline_s=TIMEOUT) == v, (what, k)

        read_back("before")
        owned = plane.keymap.slots_of(0)
        cli.reshard("split", 0, 2, owned[:len(owned) // 2],
                    deadline_s=TIMEOUT)
        _await_idle(plane, TIMEOUT)
        read_back("split")
        cli.reshard("merge", 3, 1, deadline_s=TIMEOUT)
        _await_idle(plane, TIMEOUT)
        assert 3 in plane.keymap.retired
        read_back("merge")
        lead = rdb.pipe.node.leader_of(1)
        cli.reshard("migrate", 1, (lead + 1) % 3, deadline_s=TIMEOUT)
        _await_idle(plane, TIMEOUT)
        assert rdb.pipe.node.leader_of(1) == (lead + 1) % 3
        read_back("migrate")
        status, hdrs, body = _raw_kv(srv, "GET", "k0",
                                     headers={"X-Raft-Keymap-Epoch": "0"})
        assert status == 409
        assert json.loads(body)["keymap"] == plane.keymap.to_doc()
        s0 = plane.keymap.slot_of("k0")
        plane.keymap.freeze([s0])
        try:
            status, hdrs, _ = _raw_kv(srv, "PUT", "k0", body=b"nope")
            assert status == 503 and hdrs.get("Retry-After")
        finally:
            plane.keymap.unfreeze([s0])
        m = rdb.metrics()["reshard"]
        assert (m["splits"], m["merges"], m["migrations"]) == (1, 1, 1)
        assert m["epoch"] == plane.keymap.epoch == 3
        # The controller's split-hottest, on the keyspace the PUTs hit.
        doc = pc.split_hottest()
        assert doc is not None and doc["verb"] == "split"
        _await_idle(plane, TIMEOUT)
        read_back("split_hottest")
        assert pc.metrics_doc()["reshard_issued"] == 1
        want = plane.keymap.to_doc()
        rebuilt = ReshardPlane(rdb, nslots=16, ship_dir=plane.ship_dir)
        rebuilt.recover_from_db()
        assert rebuilt.keymap.to_doc() == want
        assert not rebuilt.coord.busy
        rdb.reshard = plane
    finally:
        srv.stop()
        plane.stop()
        pc.stop()
        rdb.close()


RESHARD_FAMILIES = (
    "raftsql_reshard_splits", "raftsql_reshard_merges",
    "raftsql_reshard_migrations", "raftsql_reshard_aborted",
    "raftsql_reshard_resumed", "raftsql_reshard_epoch",
    "raftsql_reshard_active", "raftsql_reshard_duration_split_count",
    "raftsql_reshard_duration_merge_count",
    "raftsql_reshard_duration_migrate_count",
    "raftsql_placement_reshard_issued",
    "raftsql_placement_reshard_refused")


def test_cli_workers_reshard_process(tmp_path):
    """`python -m raftsql_tpu_torch.server.main --fused --workers 2
    --placement --reshard --trace` as a process: keyed PUTs through the
    workers (ring op 7), a split through POST /reshard at a worker (op
    6), every acked write read back, a stale epoch refused with 409,
    each worker's shm reads failing closed across the flip and serving
    again once it adopted the epoch, scripts/check_prom.py --url clean
    with the raftsql_reshard_* families, GET /trace valid, SIGTERM exit
    0.  (The JAX package's workers answer 400 to /kv and POST
    /reshard.)"""
    import signal
    import socket
    import subprocess
    import sys
    import urllib.request

    from raftsql_tpu_torch.api.client import RaftSQLClient
    from raftsql_tpu_torch.obs.export import validate_chrome_trace
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "raftsql_tpu_torch.server.main", "--fused",
         "--workers", "2", "--placement", "--reshard", "--trace",
         "--groups", "4", "--port", str(port), "--tick", "0.004",
         "--device", "cpu"], cwd=str(tmp_path), env=env,
        stdout=open(tmp_path / "server.log", "wb"),
        stderr=subprocess.STDOUT)
    cli = RaftSQLClient([port], timeout_s=10, backoff_s=0.01)

    def metrics():
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            return json.loads(r.read())

    try:
        cli.wait_healthy(0, deadline_s=90)
        for g in range(4):
            cli.put("CREATE TABLE t (v text)", group=g, deadline_s=60)
            cli.put("INSERT INTO t (v) VALUES ('x')", group=g,
                    deadline_s=60)
        kv = {f"k{i}": f"v{i}" for i in range(16)}
        for k, v in kv.items():
            assert cli.put_kv(k, v, deadline_s=TIMEOUT) is not None
        for k, v in kv.items():
            assert cli.get_kv(k, deadline_s=TIMEOUT) == v

        def shm(n=24):
            """n local reads; the largest per-worker counters seen."""
            best = {}
            for i in range(n):
                cli.get("SELECT count(*) FROM t", group=i % 4,
                        deadline_s=30)
                r = metrics()["reads"]
                for k in ("shm_hits", "shm_keymap_adoptions"):
                    best[k] = max(best.get(k, 0), r[k])
            return best

        before = shm()
        assert before["shm_hits"] > 0 and before["shm_keymap_adoptions"] == 0
        doc = cli.reshard("split", 0, 1, [0, 4], deadline_s=TIMEOUT)
        assert doc["verb"] == "split"
        until = time.monotonic() + TIMEOUT
        while metrics()["reshard"]["splits"] < 1:
            assert time.monotonic() < until, metrics()["reshard"]
            time.sleep(0.05)
        after = shm(48)
        assert after["shm_keymap_adoptions"] >= 1
        assert after["shm_hits"] > 0
        for k, v in kv.items():
            assert cli.get_kv(k, deadline_s=TIMEOUT) == v, k
        assert cli.keymap_epoch() == 1
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/kv/k0",
            headers={"X-Raft-Keymap-Epoch": "0"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 409
        assert json.loads(e.value.read())["keymap"]["epoch"] == 1
        prom = subprocess.run(
            [sys.executable, os.path.join(root, "scripts", "check_prom.py"),
             "--url", f"http://127.0.0.1:{port}"],
            capture_output=True, text=True, timeout=120)
        assert prom.returncode == 0, prom.stdout + prom.stderr
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics?format=prom",
                timeout=10) as r:
            text = r.read().decode()
        for fam in RESHARD_FAMILIES:
            assert f"\n{fam} " in text or f"\n{fam}{{" in text, fam
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/trace", timeout=30) as r:
            trace = json.loads(r.read())
        validate_chrome_trace(trace)
        names = {str(e.get("name")) for e in trace["traceEvents"]}
        assert {"ring.kv", "ring.reshard"} <= names, sorted(names)[:40]
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            code = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
    assert code == 0, (tmp_path / "server.log").read_text()[-3000:]
