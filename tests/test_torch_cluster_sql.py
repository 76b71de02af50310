"""The cases of tests/test_cluster_sql.py, on the port (raftsql_tpu_torch,
every RaftNode stepping on the CPU).  The reference file's docstring
follows.

End-to-end in-process cluster tests — the reference test scenarios.

Ports of the reference's raftsql_test.go onto the TPU-native stack: a real
3-node cluster in one process (loopback transport instead of localhost
HTTP, reference raftsql_test.go:19), real WAL dirs, real SQLite files,
concurrent per-node proposals, node stop/restart with WAL replay counted
through the commit-listener nil-sentinel protocol (db.go:26, 48-50).
"""
import os
import queue
import sqlite3
import threading
import time

import pytest

from raftsql_tpu_torch.config import RaftConfig
from raftsql_tpu_torch.models.sqlite_sm import SQLiteStateMachine
from raftsql_tpu_torch.runtime.db import RaftDB
from raftsql_tpu_torch.runtime.pipe import RaftPipe
from raftsql_tpu_torch.transport.loopback import LoopbackHub, LoopbackTransport

import torch

torch.set_num_threads(1)

TICK = 0.005
TIMEOUT = 30.0


class Cluster:
    """The reference's test harness struct (raftsql_test.go:11-28)."""

    def __init__(self, n: int, tmpdir: str, groups: int = 1):
        self.n = n
        self.tmpdir = tmpdir
        self.groups = groups
        self.hub = LoopbackHub()
        self.cfg = RaftConfig(num_groups=groups, num_peers=n,
                              tick_interval_s=TICK, election_ticks=10,
                              log_window=64, max_entries_per_msg=4)
        self.dbs = [None] * n
        self.apply(self.new_node)

    def new_node(self, i: int, listener=None) -> None:
        if self.dbs[i] is not None:
            return
        pipe = RaftPipe.create(
            i + 1, self.n, self.cfg, LoopbackTransport(self.hub),
            data_dir=os.path.join(self.tmpdir, f"raftsql-{i + 1}"),
            device="cpu")
        dbpath = os.path.join(self.tmpdir, f"testcase-{i}.db")
        self.dbs[i] = RaftDB(lambda g: SQLiteStateMachine(dbpath),
                             pipe, num_groups=self.groups,
                             listener=listener)

    def stop_node(self, i: int) -> None:
        if self.dbs[i] is not None:
            self.dbs[i].close()
            self.dbs[i] = None

    def apply(self, f) -> None:
        """Concurrent per-node ops under a waitgroup
        (reference raftsql_test.go:79-90)."""
        errs = []

        def wrap(i):
            try:
                f(i)
            except Exception as e:          # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=wrap, args=(i,))
                   for i in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        if errs:
            raise errs[0]

    def create_entries(self) -> int:
        """Schema + one insert per node, proposed concurrently from
        different nodes (reference raftsql_test.go:54-77)."""
        err = self.dbs[0].propose(
            "CREATE TABLE main.t (id int primary key asc, nodeid text)"
        ).wait(TIMEOUT)
        assert err is None, err

        def insert(i):
            q = f'INSERT INTO main.t (nodeid) VALUES ("{i}")'
            e = self.dbs[i].propose(q).wait(TIMEOUT)
            assert e is None, e

        self.apply(insert)
        return 1 + self.n

    def wait_rows(self, i: int, needles, timeout=TIMEOUT,
                  q="SELECT * from main.t") -> str:
        """Poll node i's local replica until all needles appear (local
        reads are stale by design, reference raftsql_test.go:150-158)."""
        deadline = time.monotonic() + timeout
        while True:
            v = self.dbs[i].query(q)
            if all(nd in v for nd in needles):
                return v
            if time.monotonic() > deadline:
                raise AssertionError(f"node {i}: {needles} not in {v!r}")
            time.sleep(0.01)

    def close(self) -> None:
        self.apply(lambda i: self.dbs[i].close() if self.dbs[i] else None)


@pytest.fixture
def tmp_cluster(tmp_path):
    clus = Cluster(3, str(tmp_path))
    yield clus
    clus.close()


def test_new_db(tmp_cluster):
    """Reference TestNewDB (raftsql_test.go:92-115)."""
    clus = tmp_cluster
    clus.create_entries()

    def check(i):
        db = clus.dbs[i]
        with pytest.raises(Exception):
            db.query("SELECT * from main.x")     # no such table
        v = clus.wait_rows(i, ["||0|", "||1|", "||2|"])
        assert v.count("\n") == 3, v

    clus.apply(check)


def test_restart_db(tmp_cluster):
    """Reference TestRestartDB (raftsql_test.go:117-171)."""
    clus = tmp_cluster
    expected = clus.create_entries()

    # Node 1 must have everything applied (hence WAL-durable) before the
    # crash, or the replay count below is racy.
    clus.wait_rows(1, ["||0|", "||1|", "||2|"])
    clus.stop_node(1)

    # Add an entry while node 1 is down.
    err = clus.dbs[2].propose(
        'INSERT INTO main.t (nodeid) VALUES ("foo")').wait(TIMEOUT)
    assert err is None, err

    # Restart node 1 behind a partition: WAL replay is local, so the
    # replay count is exact, and the stale-read check below is
    # deterministic instead of racing leader catch-up.  (The reference
    # wins the same race only because its ticks are 100ms,
    # raftsql_test.go:134-158.)
    clus.hub.faults.isolate(2, range(1, 4))       # node index 1 == id 2
    db1cc: "queue.Queue" = queue.Queue()
    done = threading.Event()
    threading.Thread(
        target=lambda: (clus.new_node(1, listener=db1cc), done.set()),
        daemon=True).start()
    n = 0
    while True:
        item = db1cc.get(timeout=TIMEOUT)
        if item is None:
            break
        n += 1
    assert n == expected, f"expected {expected}, got {n} replay entries"
    assert done.wait(TIMEOUT)

    # 'foo' must NOT be in node 1's replica yet — still out of sync
    # (raftsql_test.go:150-158 documents the stale-read model).
    v = clus.dbs[1].query("SELECT * from main.t")
    assert "||foo|" not in v, f'"foo" already in db! {v}'

    # Heal: the missed write streams in from the leader; await it on the
    # listener (raftsql_test.go:159).
    clus.hub.faults.heal()
    while True:
        item = db1cc.get(timeout=TIMEOUT)
        if item is not None and "foo" in item[1]:
            break

    def check(i):
        clus.wait_rows(i, ["||foo|"])

    clus.apply(check)


def test_duplicate_identical_queries_fifo(tmp_cluster):
    """The q2cb FIFO path for duplicate in-flight identical queries —
    untested in the reference (SURVEY.md §4 gap, db.go:70-75)."""
    clus = tmp_cluster
    err = clus.dbs[0].propose(
        "CREATE TABLE main.d (x text)").wait(TIMEOUT)
    assert err is None, err
    q = 'INSERT INTO main.d (x) VALUES ("same")'
    futs = [clus.dbs[0].propose(q) for _ in range(4)]
    for f in futs:
        assert f.wait(TIMEOUT) is None
    clus.wait_rows(0, ["|same|"], q="SELECT * from main.d")
    v = clus.dbs[0].query("SELECT count(*) from main.d")
    assert v == "|4|\n", v


def test_propose_select_rejected(tmp_cluster):
    err = tmp_cluster.dbs[0].propose("SELECT 1").wait(TIMEOUT)
    assert err is not None and "non-SELECT" in str(err)


def test_query_non_select_rejected(tmp_cluster):
    with pytest.raises(ValueError, match="expected SELECT"):
        tmp_cluster.dbs[0].query("INSERT INTO t VALUES (1)")


def test_bad_sql_propagates_apply_error(tmp_cluster):
    err = tmp_cluster.dbs[0].propose(
        "INSERT INTO main.nosuch VALUES (1)").wait(TIMEOUT)
    assert err is not None


def test_transport_error_fans_out_to_pending_acks(tmp_cluster):
    """Transport failure → every pending ack receives the error and the
    node tears down (reference raft.go:136-142, db.go:83-95).

    The proposing node is partitioned first so its proposals can never
    commit, then the transport's on_error callback fires — the exact path
    a fatal listener failure takes (transport/tcp.py _accept_loop)."""
    clus = tmp_cluster
    err = clus.dbs[0].propose("CREATE TABLE main.e (x text)").wait(TIMEOUT)
    assert err is None, err

    clus.hub.faults.isolate(1, range(1, 4))       # node index 0 == id 1
    futs = [clus.dbs[0].propose(
        f'INSERT INTO main.e (x) VALUES ("{k}")') for k in range(3)]
    time.sleep(0.1)                               # let them enter flight
    for f in futs:
        assert not f._evt.is_set()                # stuck without quorum

    boom = RuntimeError("transport exploded")
    clus.dbs[0].pipe.node._on_error(boom)

    for f in futs:
        assert f.wait(TIMEOUT) is boom            # fan-out, not a hang
    # The node is down: new proposals fail fast with the same error.
    assert clus.dbs[0].propose(
        'INSERT INTO main.e (x) VALUES ("late")').wait(TIMEOUT) is boom
    clus.hub.faults.heal()
    clus.stop_node(0)
    # Survivors keep running (they hold quorum without the dead node).
    err = clus.dbs[1].propose(
        'INSERT INTO main.e (x) VALUES ("alive")').wait(TIMEOUT)
    assert err is None, err


def test_multi_group_isolation(tmp_path):
    """Groups are independent logs applied to independent DB files — the
    batched engine's reason to exist (BASELINE.json north star)."""
    hub = LoopbackHub()
    cfg = RaftConfig(num_groups=3, num_peers=3, tick_interval_s=TICK,
                     log_window=64, max_entries_per_msg=4)
    dbs = []
    for i in range(3):
        pipe = RaftPipe.create(
            i + 1, 3, cfg, LoopbackTransport(hub),
            data_dir=str(tmp_path / f"raftsql-{i + 1}"), device="cpu")
        dbs.append(RaftDB(
            lambda g, i=i: SQLiteStateMachine(
                str(tmp_path / f"multi-{i}-g{g}.db")),
            pipe, num_groups=3))
    try:
        for g in range(3):
            err = dbs[0].propose(
                f"CREATE TABLE main.t (v text)", group=g).wait(TIMEOUT)
            assert err is None, err
            err = dbs[g].propose(
                f'INSERT INTO main.t (v) VALUES ("g{g}")',
                group=g).wait(TIMEOUT)
            assert err is None, err
        deadline = time.monotonic() + TIMEOUT
        for i in range(3):
            for g in range(3):
                while True:
                    v = dbs[i].query("SELECT * from main.t", group=g)
                    if f"|g{g}|" in v:
                        assert v == f"|g{g}|\n", v   # no cross-group leak
                        break
                    assert time.monotonic() < deadline
                    time.sleep(0.01)
    finally:
        for db in dbs:
            db.close()


def test_follower_catchup_beyond_ring_window(tmp_path):
    """A restarted follower whose lag exceeds the on-device term ring (W)
    can no longer be served by device-built appends (core/step.py window
    guard sends it empty heartbeats).  The leader HOST must feed it
    catch-up appends from the payload log (runtime/node.py
    _build_catchups) until it re-enters the window."""
    hub = LoopbackHub()
    cfg = RaftConfig(num_groups=1, num_peers=3, tick_interval_s=TICK,
                     log_window=16, max_entries_per_msg=4)
    dirs = [str(tmp_path / f"raftsql-{i + 1}") for i in range(3)]
    paths = [str(tmp_path / f"cu-{i}.db") for i in range(3)]

    def boot(i):
        pipe = RaftPipe.create(i + 1, 3, cfg, LoopbackTransport(hub),
                               data_dir=dirs[i], device="cpu")
        return RaftDB(lambda g, i=i: SQLiteStateMachine(paths[i]), pipe)

    dbs = [boot(i) for i in range(3)]
    try:
        err = dbs[0].propose("CREATE TABLE main.t (v int)").wait(TIMEOUT)
        assert err is None, err
        dbs[1].close()
        dbs[1] = None
        # Push the live pair far past the dead node's position + W.
        for k in range(3 * cfg.log_window):
            err = dbs[0].propose(
                f"INSERT INTO main.t (v) VALUES ({k})").wait(TIMEOUT)
            assert err is None, err
        dbs[1] = boot(1)
        deadline = time.monotonic() + TIMEOUT
        while True:
            # The restarted replica may not have replayed/caught up the
            # CREATE yet: local reads are stale by design, so "no such
            # table" is a legitimate transient — keep polling.
            try:
                v = dbs[1].query("SELECT count(*) from main.t")
            except sqlite3.OperationalError as e:
                v = repr(e)
            if v == f"|{3 * cfg.log_window}|\n":
                break
            assert time.monotonic() < deadline, \
                f"follower stalled at {v!r}"
            time.sleep(0.02)
        # The leader really used the host path.
        assert any(db is not None
                   and db.metrics()["catchup_appends"] > 0
                   for db in dbs)
    finally:
        for db in dbs:
            if db is not None:
                db.close()


def test_follower_catchup_below_table_floor(tmp_path):
    """A follower whose next_idx falls below the leader's term-transition
    table floor (more than K transitions behind — here K=2 with repeated
    re-elections) is unservable by device appends even INSIDE the ring
    window: the send guard (core/step.py in_window) suppresses real
    batches, so without the floor clause in _build_catchups' lag test
    the follower would see empty heartbeats forever.  The leader host
    must feed it catch-up appends from the payload log."""
    hub = LoopbackHub()
    cfg = RaftConfig(num_groups=1, num_peers=3, tick_interval_s=TICK,
                     log_window=32, max_entries_per_msg=4,
                     term_table_slots=2)
    dirs = [str(tmp_path / f"raftsql-{i + 1}") for i in range(3)]
    paths = [str(tmp_path / f"fl-{i}.db") for i in range(3)]

    def boot(i):
        pipe = RaftPipe.create(i + 1, 3, cfg, LoopbackTransport(hub),
                               data_dir=dirs[i], device="cpu")
        return RaftDB(lambda g, i=i: SQLiteStateMachine(paths[i]), pipe)

    dbs = [boot(i) for i in range(3)]
    inserted = 0
    try:
        err = dbs[0].propose("CREATE TABLE main.t (v int)").wait(TIMEOUT)
        assert err is None, err
        dbs[2].close()
        dbs[2] = None

        def put(n):
            nonlocal inserted
            for _ in range(n):
                err = None
                for src in (0, 1) * 5:      # whichever is up forwards to
                    if dbs[src] is None:    # the current leader
                        continue
                    err = dbs[src].propose(
                        f"INSERT INTO main.t (v) VALUES ({inserted})"
                    ).wait(TIMEOUT)
                    if err is None:
                        break
                assert err is None, err
                inserted += 1

        # K+1 = 3 term transitions while node 2 is down, with a few
        # entries each so every transition stays inside the ring window
        # — the floor (oldest of the last K=2 transitions) then sits
        # ABOVE node 2's position while the ring still covers it.
        # Alternate WHICH of the live pair restarts: the survivor wins
        # the next election, so every cycle really bumps the term.
        put(2)
        for cyc in range(3):
            i = cyc % 2
            dbs[i].close()
            dbs[i] = None
            time.sleep(40 * TICK)
            dbs[i] = boot(i)
            put(2)
        dbs[2] = boot(2)
        deadline = time.monotonic() + TIMEOUT
        while True:
            # "no such table" is a legitimate transient on the freshly
            # restarted replica (stale local reads by design): its
            # parity-mode SQLite was rebuilt from a replayed prefix
            # that may predate the CREATE — poll until catch-up
            # delivers it.
            try:
                v = dbs[2].query("SELECT count(*) from main.t")
            except sqlite3.OperationalError as e:
                v = repr(e)
            if v == f"|{inserted}|\n":
                break
            assert time.monotonic() < deadline, \
                f"follower stalled below the table floor at {v!r}"
            time.sleep(0.02)
        assert any(db is not None
                   and db.metrics()["catchup_appends"] > 0
                   for db in dbs)
    finally:
        for db in dbs:
            if db is not None:
                db.close()
