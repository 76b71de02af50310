"""The port's shared-memory snapshot plane
(raftsql_tpu_torch/runtime/shm.py) beside the JAX package's.

Every test of tests/test_shm.py on the port (device="cpu"), of which
`test_ring_client_shm_fastpath_and_restart_fallback` fails on the JAX
package (its shm plane disables itself at boot: see
test_empty_group_snapshot) and passes here.  Plus: the region file after
one publish script is byte-identical to the JAX package's but for the
two fields set from the clock or a random draw (the header's `epoch`
and `pub_ns`), each package's reader serves the other's region, and the
empty-database snapshot repair.

The JAX file's coverage:

Covers the fail-closed contract from every angle the nemesis can't
reach deterministically:
  - publisher → reader round trips for every read mode, including the
    lease-gated linear fast path;
  - the seqlock: a writer parked inside its critical section makes
    readers fall back (never serve torn state), and a concurrent
    publish/read storm never yields a row count that goes backwards;
  - epoch pinning: an engine crash/restart re-creates the region under
    a fresh epoch and the OLD mapping permanently fails closed — at
    the RingClient level that means the ring path silently takes over;
  - log overflow and an unserializable group both fail the WHOLE plane
    closed rather than serve a truncated delta stream;
  - pre-start deltas buffer until the base images open the log, so a
    replica can never replay a stream whose prefix it is missing;
  - batched ReadIndex (runtime/node.py read_join): concurrent linear
    reads on the distributed runtime share quorum rounds, and the
    batch metrics attribute them.
"""
import os
import struct
import threading
import time
import types

import pytest
import torch

from raftsql_tpu.runtime import shm as jshm
from raftsql_tpu_torch.runtime.shm import (DEFAULT_BYTES,
                                           ShmSnapshotPublisher,
                                           ShmSnapshotReader)

torch.set_num_threads(1)

TIMEOUT = 30.0


def _mk_pair(tmp, groups=1, size=None):
    pub = ShmSnapshotPublisher(str(tmp), num_groups=groups, size=size)
    pub.start(lambda g: None, lambda g: 0)
    rdr = ShmSnapshotReader(str(tmp))
    return pub, rdr


SCHEMA = "CREATE TABLE t (k INTEGER PRIMARY KEY, v TEXT)"


# -- round trips ------------------------------------------------------------


def test_local_and_session_roundtrip(tmp_path):
    pub, rdr = _mk_pair(tmp_path)
    try:
        pub.publish_deltas({0: [(SCHEMA, 1)]})
        pub.publish_deltas({0: [(f"INSERT INTO t VALUES ({k}, 'v{k}')",
                                 k + 2) for k in range(5)]})
        got = rdr.try_read("local", 0, "SELECT count(*) FROM t")
        assert got is not None
        rows, wm = got
        assert rows.strip() == "|5|" and wm == 6
        # Session at a covered watermark serves; an uncovered one MUST
        # fall back (the engine blocks for the watermark, we can't).
        assert rdr.try_read("session", 0, "SELECT count(*) FROM t",
                            watermark=6) is not None
        assert rdr.try_read("session", 0, "SELECT count(*) FROM t",
                            watermark=7) is None
        # Unknown mode / out-of-range group: fail closed, not raise.
        assert rdr.try_read("weird", 0, "SELECT 1") is None
        assert rdr.try_read("local", 3, "SELECT 1") is None
        # SQL errors surface through the authoritative ring path.
        assert rdr.try_read("local", 0, "SELECT boom FROM missing") is None
        # Non-SELECT must fall back for the engine's 400 — and must NOT
        # mutate the worker-side replica on the way.
        assert rdr.try_read("local", 0, "DELETE FROM t") is None
        got = rdr.try_read("local", 0, "SELECT count(*) FROM t")
        assert got is not None and got[0].strip() == "|5|"
    finally:
        rdr.close()
        pub.close()


def test_follower_and_linear_gates(tmp_path):
    """follower needs applied >= commit; linear additionally needs a
    live published lease and a fresh publisher heartbeat."""
    pub, rdr = _mk_pair(tmp_path)
    try:
        pub.publish_deltas({0: [(SCHEMA, 1), ("INSERT INTO t VALUES "
                                              "(1, 'a')", 2)]})
        # Commit column still 0: a follower read serves at watermark 0,
        # where the replica has no table yet — SQL error → fall back.
        # No lease yet → linear falls back too.
        assert rdr.try_read("follower", 0, "SELECT count(*) FROM t") is None
        assert rdr.try_read("linear", 0, "SELECT count(*) FROM t") is None
        # Stamp commit + a live lease the way the RingServer refresh
        # thread does; linear now serves.
        pub.refresh(lambda g: 2, lambda g: 0,
                    lambda g: time.monotonic() + 0.05)
        got = rdr.try_read("linear", 0, "SELECT count(*) FROM t")
        assert got is not None and got[0].strip() == "|1|"
        assert rdr.try_read("follower", 0, "SELECT count(*) FROM t") \
            is not None
        assert rdr.leader_of(0) == 1
        # Linearizability across the refresh window: a write applied
        # (and thus acked — publish_deltas runs before acks) but whose
        # commit column the ~2ms refresh thread hasn't restamped yet
        # MUST be visible to a linear read.  Serving at the stale
        # commit column here would drop an acked PUT.
        pub.refresh(lambda g: 2, lambda g: 0,
                    lambda g: time.monotonic() + 5.0)
        pub.publish_deltas({0: [("INSERT INTO t VALUES (2, 'b')", 3)]})
        got = rdr.try_read("linear", 0, "SELECT count(*) FROM t")
        assert got is not None and got[0].strip() == "|2|"
        # An expired lease fails closed again.
        pub.refresh(lambda g: 2, lambda g: 0, lambda g: 0.0)
        assert rdr.try_read("linear", 0, "SELECT count(*) FROM t") is None
        # Commit ahead of applied: follower can't prove freshness.
        pub.refresh(lambda g: 99, lambda g: 0,
                    lambda g: time.monotonic() + 0.05)
        assert rdr.try_read("follower", 0, "SELECT 1") is None
        assert rdr.try_read("linear", 0, "SELECT 1") is None
    finally:
        rdr.close()
        pub.close()


# -- seqlock ----------------------------------------------------------------


def test_seqlock_writer_in_critical_fails_closed(tmp_path):
    """A writer parked mid-critical-section (odd seq) makes readers
    fall back after bounded retries — never serve possibly-torn state
    — and the reader recovers as soon as the write completes."""
    pub, rdr = _mk_pair(tmp_path)
    try:
        pub.publish_deltas({0: [(SCHEMA, 1)]})
        assert rdr.try_read("local", 0, "SELECT count(*) FROM t") \
            is not None
        with pub._lock:
            pub._seq += 1                        # odd: "mid-update"
            pub._write_header(time.monotonic_ns())
        assert rdr.try_read("local", 0, "SELECT count(*) FROM t") is None
        with pub._lock:
            pub._seq += 1                        # even: consistent
            pub._write_header(time.monotonic_ns())
        assert rdr.try_read("local", 0, "SELECT count(*) FROM t") \
            is not None
    finally:
        rdr.close()
        pub.close()


def test_seqlock_concurrent_publish_read_storm(tmp_path):
    """Reads racing a continuously-publishing writer: every successful
    read parses and the observed row count never goes backwards (the
    seqlock retry path, exercised for real)."""
    pub, rdr = _mk_pair(tmp_path)
    try:
        pub.publish_deltas({0: [(SCHEMA, 1)]})
        stop = threading.Event()
        state = {"n": 0}

        def writer():
            # Paced (the JAX file's writer is not): an unpaced writer
            # holds the GIL while the reader's SQLite calls release it,
            # so one catch-up can chase its backlog for minutes
            # (unpaced, this test took 53 s and the JAX file's copy
            # 613 s, each run alone on one CPU host).
            while not stop.is_set():
                k = state["n"]
                pub.publish_deltas(
                    {0: [(f"INSERT INTO t VALUES ({k}, 'v')", k + 2)]})
                state["n"] = k + 1
                time.sleep(0.0002)
        th = threading.Thread(target=writer, daemon=True)
        th.start()
        last = 0
        hits = 0
        deadline = time.monotonic() + 1.0
        while time.monotonic() < deadline:
            got = rdr.try_read("local", 0, "SELECT count(*) FROM t")
            if got is None:
                continue
            n = int(got[0].strip().strip("|"))
            assert n >= last, (n, last)
            last = n
            hits += 1
        stop.set()
        th.join(5)
        assert hits > 0 and last > 0
    finally:
        rdr.close()
        pub.close()


# -- fail-closed hard states ------------------------------------------------


def test_epoch_change_permanently_kills_reader(tmp_path):
    """An engine restart re-creates the region under a fresh epoch: the
    old mapping must refuse to serve FOREVER (its replicas may hold
    state from the previous life), while a fresh mapping works."""
    pub, rdr = _mk_pair(tmp_path)
    pub.publish_deltas({0: [(SCHEMA, 1)]})
    assert rdr.try_read("local", 0, "SELECT 1") is not None
    pub.close()
    pub2 = ShmSnapshotPublisher(str(tmp_path), num_groups=1)
    pub2.start(lambda g: None, lambda g: 0)
    try:
        pub2.publish_deltas({0: [(SCHEMA, 1)]})
        assert rdr.try_read("local", 0, "SELECT 1") is None
        assert rdr._dead
        # ... and stays dead even though the region itself is valid.
        assert rdr.try_read("local", 0, "SELECT 1") is None
        rdr2 = ShmSnapshotReader(str(tmp_path))
        assert rdr2.try_read("local", 0, "SELECT 1") is not None
        rdr2.close()
    finally:
        rdr.close()
        pub2.close()


def test_log_overflow_fails_whole_plane_closed(tmp_path):
    """Once the append-only log is full the publisher flags the region
    and every reader goes dead — a truncated delta stream must never
    serve."""
    pub = ShmSnapshotPublisher(str(tmp_path), num_groups=1, size=1)
    pub.start(lambda g: None, lambda g: 0)     # min region: ~1 MiB log
    rdr = ShmSnapshotReader(str(tmp_path))
    try:
        big = "-- " + "x" * 600_000            # two of these overflow
        pub.publish_deltas({0: [(SCHEMA, 1)]})
        pub.publish_deltas({0: [(big, 2)]})
        assert not pub.log_full
        pub.publish_deltas({0: [(big, 3)]})
        assert pub.log_full
        assert rdr.try_read("local", 0, "SELECT 1") is None
        assert rdr._dead
    finally:
        rdr.close()
        pub.close()


def test_unserializable_applied_group_fails_closed(tmp_path):
    """A group with applied state but no base image would leave
    replicas a truncated stream — start() fails the whole plane."""
    pub = ShmSnapshotPublisher(str(tmp_path), num_groups=2)
    pub.start(lambda g: None, lambda g: 7 if g == 1 else 0)
    rdr = ShmSnapshotReader(str(tmp_path))
    try:
        assert pub.log_full
        assert rdr.try_read("local", 0, "SELECT 1") is None
    finally:
        rdr.close()
        pub.close()


def test_pre_start_deltas_buffer_until_log_opens(tmp_path):
    """Deltas published before start() (applies racing engine boot)
    flush AFTER the base images, in arrival order — the replica's
    stream prefix is always complete."""
    pub = ShmSnapshotPublisher(str(tmp_path), num_groups=1)
    pub.publish_deltas({0: [(SCHEMA, 1)]})
    pub.publish_deltas({0: [("INSERT INTO t VALUES (1, 'early')", 2)]})
    pub.start(lambda g: None, lambda g: 0)
    rdr = ShmSnapshotReader(str(tmp_path))
    try:
        got = rdr.try_read("local", 0, "SELECT v FROM t")
        assert got is not None and got[0].strip() == "|early|"
        assert got[1] == 2
    finally:
        rdr.close()
        pub.close()


def test_default_region_size_env_floor():
    assert DEFAULT_BYTES == 32 << 20


# -- RingClient integration: fast path + restart fallback -------------------


def _mk_rdb(tmp):
    from raftsql_tpu_torch.config import RaftConfig
    from raftsql_tpu_torch.models.sqlite_sm import SQLiteStateMachine
    from raftsql_tpu_torch.runtime.db import RaftDB
    from raftsql_tpu_torch.runtime.fused import FusedClusterNode, FusedPipe

    cfg = RaftConfig(num_groups=2, num_peers=3, log_window=32,
                     max_entries_per_msg=4, tick_interval_s=0.0)
    node = FusedClusterNode(cfg, os.path.join(tmp, "data"), device="cpu")
    node.start(interval_s=0.0005)
    pipe = FusedPipe(node)

    def smf(g):
        return SQLiteStateMachine(os.path.join(tmp, f"g{g}.db"))

    return RaftDB(smf, pipe, num_groups=2)


def test_ring_client_shm_fastpath_and_restart_fallback(tmp_path):
    """The worker-side fast path serves local/session GETs from the
    mapping (hits counted, watermark echoed), and after a simulated
    engine restart (region re-created under a new epoch) the SAME
    client keeps answering correctly through the ring path."""
    from raftsql_tpu_torch.runtime.ring import RingClient, RingServer

    rdb = _mk_rdb(str(tmp_path))
    ring_dir = str(tmp_path / "rings")
    srv = RingServer(rdb, ring_dir, workers=1)
    srv.start()
    rc = RingClient(ring_dir, 0)
    try:
        assert rc._shm is not None, "shm plane should attach"
        assert rc.propose("CREATE TABLE t (v text)").wait(30) is None
        assert rc.propose("INSERT INTO t (v) VALUES ('x')").wait(30) \
            is None
        wm = rc.watermark(0)
        assert wm > 0
        deadline = time.monotonic() + TIMEOUT
        while rc._shm_hits == 0 and time.monotonic() < deadline:
            assert rc.query("SELECT count(*) FROM t", mode="session",
                            watermark=wm).strip() == "|1|"
            time.sleep(0.005)
        assert rc._shm_hits > 0, "fast path never served"
        # Simulate the engine dying and restarting: the snapshot region
        # is re-created under a fresh epoch.  The client's mapping goes
        # permanently dead and every read silently takes the ring.
        pub2 = ShmSnapshotPublisher(ring_dir, num_groups=2)
        pub2.start(lambda g: None, lambda g: 0)
        before = rc._shm_fallbacks
        assert rc.query("SELECT count(*) FROM t", mode="local") \
            .strip() == "|1|"
        assert rc._shm_fallbacks > before
        assert rc._shm._dead
        pub2.close()
    finally:
        rc.close()
        srv.stop()
        rdb.close()


# -- batched ReadIndex (distributed runtime) --------------------------------


def test_batched_read_index_shares_rounds(tmp_path):
    """Concurrent linear reads at a lease-less leader ride the batched
    ReadIndex path: all succeed with read-your-writes, the batch
    counter attributes them, and a follower still refuses."""
    from raftsql_tpu_torch.config import LEADER, RaftConfig
    from raftsql_tpu_torch.models.sqlite_sm import SQLiteStateMachine
    from raftsql_tpu_torch.runtime.db import NotLeaderError, RaftDB
    from raftsql_tpu_torch.runtime.pipe import RaftPipe
    from raftsql_tpu_torch.transport.loopback import (LoopbackHub,
                                                      LoopbackTransport)

    hub = LoopbackHub()
    cfg = RaftConfig(num_groups=1, num_peers=3, tick_interval_s=0.005,
                     election_ticks=10, log_window=64,
                     max_entries_per_msg=4)
    dbs = []
    for i in range(3):
        pipe = RaftPipe.create(
            i + 1, 3, cfg, LoopbackTransport(hub),
            data_dir=os.path.join(str(tmp_path), f"raftsql-{i + 1}"),
            device="cpu")
        dbs.append(RaftDB(
            lambda g, i=i: SQLiteStateMachine(
                os.path.join(str(tmp_path), f"db-{i}.db")),
            pipe, num_groups=1))
    try:
        assert dbs[0].propose("CREATE TABLE t (v text)").wait(TIMEOUT) \
            is None
        deadline = time.monotonic() + TIMEOUT
        lead = None
        while lead is None and time.monotonic() < deadline:
            for i, db in enumerate(dbs):
                if db.pipe.node._last_role[0] == LEADER:
                    lead = i
            time.sleep(0.02)
        assert lead is not None
        assert dbs[lead].propose(
            "INSERT INTO t (v) VALUES ('w')").wait(TIMEOUT) is None

        errs = []

        def rloop():
            try:
                for _ in range(3):
                    got = dbs[lead].query("SELECT count(*) FROM t",
                                          mode="linear", timeout=TIMEOUT)
                    assert got.strip() == "|1|", got
            except Exception as e:             # noqa: BLE001
                errs.append(e)
        threads = [threading.Thread(target=rloop, daemon=True)
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not errs, errs
        m = dbs[lead].pipe.node.metrics
        # Every read went through the batcher (a read may re-join a
        # second round across a tick boundary, so >=, not ==).
        assert m.reads_read_index_batched >= 24
        assert m.reads_read_index >= 24
        # The hist stamps batch sizes at promote; a re-joined read
        # lands in two promoted batches but confirms once.
        assert sum(int(k) * v for k, v in m.read_batch_hist.items()) \
            >= m.reads_read_index_batched
        # A follower's read_join refuses (the db layer surfaces the
        # typed redirect).
        fol = (lead + 1) % 3
        assert dbs[fol].pipe.node.read_join(0) is None
        with pytest.raises(NotLeaderError):
            dbs[fol].query("SELECT 1", mode="linear", timeout=2.0)
    finally:
        for db in dbs:
            try:
                db.close()
            except Exception:                  # noqa: BLE001
                pass


# -- byte parity of the region with the JAX package -------------------------

# Header fields set from a random draw or the clock, excepted from the
# byte comparison: `epoch` (secrets.randbits at creation) and `pub_ns`
# (time.monotonic_ns at each publish).
_HDR_FIELDS = ("magic", "version", "flags", "num_groups", "epoch", "seq",
               "log_head", "log_cap", "pub_ns", "keymap_epoch")
_FROM_CLOCK_OR_DRAW = ("epoch", "pub_ns")


def _base_image():
    from raftsql_tpu_torch.models.sqlite_sm import SQLiteStateMachine
    sm = SQLiteStateMachine(":memory:", resume=True)
    sm.apply(SCHEMA, 1)
    sm.apply("INSERT INTO t VALUES (1, 'base')", 2)
    idx, blob = sm.serialize_with_index()
    sm.close()
    return idx, blob


def _publish_script(mod, d, blob_of):
    """One publish script (base images, pre-start and direct deltas, a
    snapshot base, two refreshes, a keymap flip): the same calls into
    either package's publisher.  Returns the region's bytes."""
    pub = mod.ShmSnapshotPublisher(str(d), num_groups=3, size=1)
    pub.publish_deltas({0: [("INSERT INTO t VALUES (3, 'early')", 3)]})
    pub.start(lambda g: blob_of if g == 0 else None,
              lambda g: 2 if g == 0 else 0)
    pub.publish_deltas({0: [("INSERT INTO t VALUES (4, 'a')", 4)],
                        2: [(SCHEMA, 1), ("INSERT INTO t VALUES (1, 'z')",
                                          2)]})
    pub.refresh(lambda g: 4 - g, lambda g: g % 3 - 1,
                lambda g: 1234.5 + g if g != 1 else 0.0)
    pub.publish_base(1, blob_of[1], 7)
    pub.publish_deltas({1: [("INSERT INTO t VALUES (8, 'b')", 8)]})
    pub.set_keymap_epoch(5)
    pub.refresh(lambda g: 9, lambda g: 0, lambda g: 99.25)
    with open(mod.shm_path(str(d)), "rb") as f:
        data = f.read()
    pub.close()
    return data


def test_region_bytes_identical_to_jax(tmp_path):
    blob_of = _base_image()
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    j = _publish_script(jshm, tmp_path / "j", blob_of)
    t = _publish_script(__import__("raftsql_tpu_torch.runtime.shm",
                                   fromlist=["x"]), tmp_path / "t",
                        blob_of)
    assert len(j) == len(t)
    hj = dict(zip(_HDR_FIELDS, jshm._HDR.unpack_from(j, 0)))
    ht = dict(zip(_HDR_FIELDS, jshm._HDR.unpack_from(t, 0)))
    for k in _HDR_FIELDS:
        if k not in _FROM_CLOCK_OR_DRAW:
            assert hj[k] == ht[k], k
    assert ht["log_head"] > 0 and ht["keymap_epoch"] == 5
    assert j[jshm._HDR.size:] == t[jshm._HDR.size:]
    # The rows carry the script's lease deadlines, not the clock.
    row = struct.unpack_from("<QQQQIi", t, 64)
    assert row == (4, 9, 2, 99_250_000_000, 1, 0)


def test_each_package_reads_the_others_region(tmp_path):
    """The region is a format shared between processes: a JAX worker's
    reader serves the port's publisher and the other way round."""
    for pub_mod, rdr_cls in ((__import__("raftsql_tpu_torch.runtime.shm",
                                         fromlist=["x"]),
                              jshm.ShmSnapshotReader),
                             (jshm, ShmSnapshotReader)):
        d = tmp_path / pub_mod.__name__
        d.mkdir()
        pub = pub_mod.ShmSnapshotPublisher(str(d), num_groups=1)
        pub.start(lambda g: None, lambda g: 0)
        rdr = rdr_cls(str(d))
        try:
            pub.publish_deltas({0: [(SCHEMA, 1)] + [
                (f"INSERT INTO t VALUES ({k}, 'v')", k + 2)
                for k in range(3)]})
            got = rdr.try_read("session", 0, "SELECT count(*) FROM t",
                               watermark=4)
            assert got is not None and got[0].strip() == "|3|" \
                and got[1] == 4
        finally:
            rdr.close()
            pub.close()


# -- the empty-database snapshot repair --------------------------------------


def _snapshot_of(db_cls, sm):
    """RaftDB._snapshot_of of either package on one state machine (it
    reads nothing else of the RaftDB)."""
    return db_cls._snapshot_of(types.SimpleNamespace(_sms={0: sm}), 0)


@pytest.mark.parametrize("where", ["memory", "file"])
def test_empty_group_snapshot(tmp_path, where):
    """A parity-mode group (no --resume: MEMORY journal, 0 pages until
    its first write) and a group whose only applied command failed (its
    index consumed, still 0 pages).  The JAX package's
    RaftDB._snapshot_of and SQLiteStateMachine.serialize_with_index
    raise ("unable to serialize 'main'"), which disables the JAX shm
    plane and kills a --replica-listen engine at boot; the port's return
    None for the fresh group and a restorable image for the other."""
    import sqlite3

    from raftsql_tpu.models.sqlite_sm import SQLiteStateMachine as JSM
    from raftsql_tpu.runtime.db import RaftDB as JDB
    from raftsql_tpu_torch.models.sqlite_sm import SQLiteStateMachine
    from raftsql_tpu_torch.runtime.db import RaftDB

    def path(name):
        return ":memory:" if where == "memory" \
            else str(tmp_path / f"{name}.db")

    # The JAX package: both calls raise.
    jfresh, jfailed = JSM(path("jfresh")), JSM(path("jfailed"))
    assert jfailed.apply("INSERT INTO missing VALUES (1)", 1) is not None
    assert jfailed.applied_index() == 1
    with pytest.raises(sqlite3.OperationalError, match="serialize"):
        _snapshot_of(JDB, jfresh)
    for sm in (jfresh, jfailed):
        with pytest.raises(sqlite3.OperationalError, match="serialize"):
            sm.serialize_with_index()
    # The port: None, then an image that install() restores.
    fresh, failed = (SQLiteStateMachine(path("fresh")),
                     SQLiteStateMachine(path("failed")))
    assert _snapshot_of(RaftDB, fresh) is None
    assert failed.apply("INSERT INTO missing VALUES (1)", 1) is not None
    idx, blob = _snapshot_of(RaftDB, failed)
    assert idx == 1 and len(blob) > 0
    assert failed.serialize_with_index() == (idx, blob)
    dst = SQLiteStateMachine(path("dst"))
    dst.install(blob, idx)
    assert dst.applied_index() == 1
    assert dst.apply("CREATE TABLE t (v text)", 2) is None
    assert dst.apply("INSERT INTO t (v) VALUES ('x')", 3) is None
    assert dst.query("SELECT count(*) FROM t").strip() == "|1|"
    # A group with pages serializes as before.
    assert fresh.apply(SCHEMA, 1) is None
    assert _snapshot_of(RaftDB, fresh)[0] == 1
    for sm in (jfresh, jfailed, fresh, failed, dst):
        sm.close()
