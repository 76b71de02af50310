"""The native run apply of the port's SQLite state machine
(raftsql_tpu_torch/native/sqlite_apply.cc through models/sqlite_sm.py
`apply_runs`).

A drained run of commits is applied to every file-backed group it touches
in one native call.  Parity: the same command stream, over several
file-backed groups, through the native call and through the JAX package's
`SQLiteStateMachine.apply_batch` (the reference) gives each entry the same
error class, `str` and SQLite code, and every table the same rows.  Then
`RaftDB._apply_run` on a fused node (CPU): acks in commit order, a parked
read released, a read right after an ack, and the counters that split the
native entries from those applied one state machine at a time.
"""
import os
import queue
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from raftsql_tpu.models.sqlite_sm import SQLiteStateMachine as JSM
from raftsql_tpu_torch.config import RaftConfig
from raftsql_tpu_torch.models.sqlite_sm import SQLiteStateMachine, apply_runs
from raftsql_tpu_torch.runtime.db import RaftDB
from raftsql_tpu_torch.runtime.node import CLOSED
from raftsql_tpu_torch.utils.metrics import NodeMetrics

torch.set_num_threads(1)

T = "CREATE TABLE t (k INTEGER PRIMARY KEY, v TEXT)"

# name -> (resume, [(group, command), ...]) in run order; indexes are the
# position in the stream + 1, unless the case gives (group, command, index).
CASES = {
    "dml": (False, [
        (0, T), (0, "INSERT INTO t VALUES (1, 'a')"),
        (0, "INSERT INTO t VALUES (2, 'b')"),
        (0, "UPDATE t SET v = 'c' WHERE k = 1"),
        (0, "INSERT INTO t VALUES (2, 'u') ON CONFLICT(k) DO UPDATE "
            "SET v = excluded.v"),
        (0, "INSERT INTO t VALUES (3, 'n') ON CONFLICT(k) DO UPDATE "
            "SET v = excluded.v"),
        (0, "DELETE FROM t WHERE k = 1"),
        (0, "INSERT INTO t (v) VALUES ('auto') RETURNING k")]),
    "ddl": (False, [
        (0, T), (0, "CREATE INDEX tv ON t (v)"),
        (0, "ALTER TABLE t ADD COLUMN w INTEGER DEFAULT 7"),
        (0, "INSERT INTO t (k, v) VALUES (1, 'x')"),
        (0, "CREATE TABLE u (a)"), (0, "DROP TABLE u"),
        (0, "CREATE TABLE u (b, c)"), (0, "INSERT INTO u VALUES (1, 2)"),
        (0, "CREATE TABLE t (again)"), (0, "DROP INDEX nope")]),
    "primary_key_violation": (False, [
        (0, T), (0, "INSERT INTO t VALUES (1, 'a')"),
        (0, "INSERT INTO t VALUES (1, 'b')"),
        (0, "INSERT INTO t VALUES (2, 'c')")]),
    "syntax_error": (False, [
        (0, T), (0, "INSRT INTO t VALUES (1)"), (0, "UPDATE t SET"),
        (0, "INSERT INTO t VALUES (1, 'after')")]),
    "no_such_table": (False, [
        (0, "INSERT INTO missing VALUES (1)"), (0, T),
        (0, "UPDATE t SET nope = 1"), (0, "SELECT * FROM missing"),
        (0, "INSERT INTO t VALUES (1, 'ok')")]),
    "two_statements": (False, [
        (0, T), (0, "INSERT INTO t VALUES (1, 'a'); "
                    "INSERT INTO t VALUES (2, 'b')"),
        (0, "INSERT INTO t VALUES (3, 'c');;"),
        (0, "INSERT INTO t VALUES (4, 'd'); -- c\nDELETE FROM t"),
        (0, "INSERT INTO t VALUES (5, 'e'); /**/x"),
        (0, "INSERT INTO t VALUES (6, 'f');\v")]),
    "trailing_semicolon_and_comment": (False, [
        (0, T), (0, "INSERT INTO t VALUES (1, 'a');"),
        (0, "INSERT INTO t VALUES (2, 'b') -- trailing"),
        (0, "INSERT INTO t VALUES (3, 'c'); /* block */ /* two */"),
        (0, "INSERT INTO t VALUES (4, 'd'); /* unterminated"),
        (0, "INSERT INTO t VALUES (5, 'e');\t\r\n\f "),
        (0, "-- a comment first\nINSERT INTO t VALUES (6, 'f')"),
        (0, " ; INSERT INTO t VALUES (7, 'g')")]),
    "empty_and_refused": (False, [
        (0, T), (0, ""), (0, "   "), (0, "-- only a comment"),
        (0, "/* only */"), (0, ";"),
        (0, "INSERT INTO t VALUES (1, 'nul\0')"),
        (0, "INSERT INTO t VALUES (2, 'ünïcode ✓')")]),
    "insert_or_fail_undone_by_savepoint": (False, [
        (0, T), (0, "INSERT INTO t VALUES (1, 'kept')"),
        (0, "INSERT OR FAIL INTO t VALUES (2, 'a'), (3, 'b'), (1, 'dup')"),
        (0, "INSERT OR IGNORE INTO t VALUES (2, 'a'), (1, 'dup')")]),
    "transaction_control_in_a_command": (False, [
        (0, T), (0, "INSERT INTO t VALUES (1, 'a')"), (0, "COMMIT"),
        (0, "INSERT INTO t VALUES (2, 'b')"), (0, "ROLLBACK"),
        (0, "SAVEPOINT inner"), (0, "RELEASE _apply"),
        (0, "INSERT INTO t VALUES (3, 'c')"), (0, "BEGIN")]),
    "resume_meta_and_floor": (True, [
        (0, T, 1), (0, "INSERT INTO t VALUES (1, 'a')", 2),
        (0, "INSERT INTO t VALUES (2, 'b')", 3),
        (1, T, 1), (1, "INSERT INTO t VALUES (1, 'z')", 4),
        (0, "INSERT INTO t VALUES (3, 'c')", 0)]),
    "interleaved_groups": (False, [
        (2, T), (0, T), (1, T), (0, "INSERT INTO t VALUES (1, 'g0')"),
        (2, "INSERT INTO t VALUES (1, 'g2')"),
        (1, "INSERT INTO t VALUES (1, 'g1')"),
        (0, "INSERT INTO t VALUES (1, 'dup')"),
        (2, "UPDATE t SET v = 'g2b' WHERE k = 1"),
        (1, "DROP TABLE t"), (1, "INSERT INTO t VALUES (2, 'gone')")]),
}


def _entries(stream):
    return [(e[0], e[1], e[2] if len(e) > 2 else i + 1)
            for i, e in enumerate(stream)]


def _tables(conn) -> dict:
    names = [r[0] for r in conn.execute(
        "SELECT name FROM sqlite_master WHERE type = 'table' "
        "ORDER BY name")]
    return {n: conn.execute(f'SELECT * FROM "{n}" ORDER BY rowid')
            .fetchall() for n in names}


def _outcome(e):
    if e is None:
        return None
    return (type(e).__name__, str(e), getattr(e, "sqlite_errorcode", None),
            getattr(e, "sqlite_errorname", None))


def _run_both(tmp_path, resume, entries, floors=None):
    """The entries through the native run apply (one call over every
    group) and through the reference's apply_batch a group; returns
    (native state machines, reference state machines, outcomes a side
    in stream order)."""
    groups = sorted({g for g, _c, _i in entries})
    os.makedirs(tmp_path / "nat", exist_ok=True)
    os.makedirs(tmp_path / "ref", exist_ok=True)
    nat = {g: SQLiteStateMachine(str(tmp_path / "nat" / f"g{g}.db"),
                                 resume=resume) for g in groups}
    ref = {g: JSM(str(tmp_path / "ref" / f"g{g}.db"), resume=resume)
           for g in groups}
    for g, floor in (floors or {}).items():
        for sms in (nat, ref):
            assert sms[g].apply_batch([(T, floor)]) == [None]
    per_g = {g: [(c, i) for gg, c, i in entries if gg == g] for g in groups}
    got, ns = apply_runs([(nat[g], per_g[g]) for g in groups])
    assert ns > 0
    want = {g: ref[g].apply_batch(per_g[g]) for g in groups}
    pos = {g: 0 for g in groups}
    outs = []
    for g, _c, _i in entries:
        k = groups.index(g)
        outs.append((_outcome(got[k][pos[g]]),
                     _outcome(want[g][pos[g]])))
        pos[g] += 1
    return nat, ref, outs


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_native_run_apply_matches_the_reference(tmp_path, case):
    resume, stream = CASES[case]
    entries = _entries(stream)
    floors = {0: 2} if case == "resume_meta_and_floor" else None
    nat, ref, outs = _run_both(tmp_path, resume, entries, floors)
    for n, ((a, b), (g, c, _i)) in enumerate(zip(outs, entries)):
        assert a == b, (n, g, c)
    for g in nat:
        assert _tables(nat[g]._conn) == _tables(ref[g]._conn), g
        assert nat[g].applied_index() == ref[g].applied_index(), g
    if case == "resume_meta_and_floor":
        # Index 2 sat at the floor and was skipped (no row 1 of 'a').
        assert nat[0].rows("SELECT k FROM t ORDER BY k") == [(2,), (3,)]
        assert nat[0].rows("SELECT v FROM _raft_meta") == [(3,)]
    if case == "insert_or_fail_undone_by_savepoint":
        assert nat[0].rows("SELECT k FROM t ORDER BY k") == [(1,), (2,)]


def test_apply_batch_of_a_file_goes_native_and_memory_stays(tmp_path):
    """apply_batch keeps its contract through the native call (replay
    and single-group callers); a `:memory:` database has no native
    connection."""
    sm = SQLiteStateMachine(str(tmp_path / "a.db"), resume=True)
    mem = SQLiteStateMachine(":memory:", resume=True)
    assert sm._native is not None and mem._native is None
    for s in (sm, mem):
        assert s.apply(T, 1) is None
        assert s.apply("INSERT INTO t VALUES (1, 'a')", 2) is None
        assert s.apply_batch([]) == []
        assert str(s.apply("INSERT INTO t VALUES (1, 'b')", 3)) \
            == "UNIQUE constraint failed: t.k"
        assert s.query("SELECT * FROM t") == "|1|a|\n"
        assert s.applied_index() == 3
    sm.close()
    assert sm._native is None


@pytest.mark.parametrize("resume", [False, True])
def test_install_reopens_the_native_handle(tmp_path, resume):
    """install() of a snapshot replaces the file and reopens the native
    connection on it; the next run applies on top of the image (in
    resume mode serialize() also closes and reopens the connection
    around its journal-mode flip)."""
    src = SQLiteStateMachine(str(tmp_path / "src.db"), resume=resume)
    src.apply_batch([(T, 1), ("INSERT INTO t VALUES (1, 'img')", 2)])
    index, blob = src.serialize_with_index()
    assert index == 2
    assert src.apply("INSERT INTO t VALUES (2, 'after')", 3) is None
    dst = SQLiteStateMachine(str(tmp_path / "dst.db"), resume=resume)
    dst.apply_batch([("CREATE TABLE old (x)", 1)])
    before = dst._native
    dst.install(blob, index)
    assert dst._native is not None and dst._native is not before
    (errs,), _ns = apply_runs([(dst, [("INSERT INTO t VALUES (3, 'next')",
                                       3)])])
    assert errs == [None]
    assert dst.query("SELECT * FROM t ORDER BY k") == "|1|img|\n|3|next|\n"
    assert dst.rows("SELECT name FROM sqlite_master WHERE name = 'old'") \
        == []
    assert dst.applied_index() == 3
    if resume:
        assert dst.rows("SELECT v FROM _raft_meta") == [(3,)]


# -- RaftDB._apply_run on a fused node (CPU) ---------------------------------

def _fused_db(tmp_path, memory_groups=(2,), groups=3):
    from raftsql_tpu_torch.runtime.fused import FusedClusterNode, FusedPipe
    cfg = RaftConfig(num_groups=groups, num_peers=3, tick_interval_s=0.005)
    node = FusedClusterNode(cfg, str(tmp_path / "fused"), device="cpu")
    node.start(interval_s=0.005)

    def sm_factory(g):
        if g in memory_groups:
            return SQLiteStateMachine(":memory:")
        return SQLiteStateMachine(str(tmp_path / f"g{g}.db"))
    lst = queue.Queue()
    rdb = RaftDB(sm_factory, FusedPipe(node), num_groups=groups,
                 listener=lst)
    t_end = time.monotonic() + 60
    while not all(node.leader_of(g) >= 0 for g in range(groups)):
        assert time.monotonic() < t_end, "no leaders"
        time.sleep(0.01)
    return rdb, lst


def _drain(q):
    out = []
    while True:
        try:
            out.append(q.get_nowait())
        except queue.Empty:
            return out


def test_a_run_over_groups_acks_in_commit_order_and_releases_reads(
        tmp_path):
    rdb, lst = _fused_db(tmp_path)
    node = rdb.pipe.node
    runs = []
    gate = threading.Event()
    gate.set()
    real = rdb._apply_run

    def held(run):
        gate.wait()
        runs.append(list(run))
        real(run)
    rdb._apply_run = held
    try:
        for g in range(3):
            assert rdb.propose(T, g).wait(30) is None
        _drain(lst)
        runs.clear()
        m = node.metrics
        base = (m.apply_native_runs, m.apply_native_entries,
                m.apply_py_entries)
        gate.clear()
        # The first write's run holds the apply; the rest queue behind it
        # and drain as one run over the three groups.
        first = rdb.propose("INSERT INTO t VALUES (0, 'first')", 0)
        t_end = time.monotonic() + 30
        while node.commit_watermark(0) <= rdb.watermark(0):
            assert time.monotonic() < t_end
            time.sleep(0.005)
        writes = [(0, "INSERT INTO t VALUES (1, 'a')"),
                  (1, "INSERT INTO t VALUES (1, 'b')"),
                  (2, "INSERT INTO t VALUES (1, 'c')"),
                  (0, "INSERT INTO t VALUES (1, 'dup')"),
                  (1, "INSRT bad"),
                  (2, "INSERT INTO nope VALUES (1)"),
                  (1, "UPDATE t SET v = 'b2' WHERE k = 1")]
        seen = {}

        def on_ack(g, q):
            def cb(err):
                # Runs on the apply thread just after the ack: the read
                # must see the write.
                seen[(g, q)] = (err, rdb.local_query(
                    "SELECT v FROM t ORDER BY k", g))
            return cb
        futs = []
        for g, q in writes:
            f = rdb.propose(q, g)
            f.add_done_callback(on_ack(g, q))
            futs.append(f)
        want = {g: sum(1 for gg, _q in writes if gg == g) for g in range(3)}
        want[0] += 1
        while any(node.commit_watermark(g) < rdb.watermark(g) + want[g]
                  for g in range(3)):
            assert time.monotonic() < t_end
            time.sleep(0.005)
        time.sleep(0.1)                 # a few ticks: all published
        # A linear read at group 1's commit point parks on the apply.
        woke = threading.Event()
        target = node.commit_watermark(1)
        w = rdb.park(1, target, woke.set)
        assert w is not None and not woke.is_set()
        gate.set()
        assert first.wait(30) is None
        errs = [f.wait(30) for f in futs]
        assert woke.wait(30)
        rdb.settle_read(1, target, "apply")
        assert w.t1 is not None
    finally:
        gate.set()
        rdb.close()
    assert [e is None for e in errs] == [True, True, True, False, False,
                                         False, True]
    assert str(errs[3]) == "UNIQUE constraint failed: t.k"
    assert 'near "INSRT": syntax error' in str(errs[4])
    assert str(errs[5]) == "no such table: nope"
    # Acks fire in commit order: the order of the runs' entries.
    acked = [a for a in _drain(lst) if a is not None]
    assert acked == [(g, q) for run in runs for g, _i, q in run]
    assert any(len({g for g, _i, _q in run if g != 2}) == 2
               for run in runs), runs
    assert seen[(0, writes[0][1])][1] == "|first|\n|a|\n"
    assert seen[(1, writes[6][1])][1] == "|b2|\n"
    assert seen[(2, writes[2][1])][1] == "|c|\n"
    # Groups 0 and 1 are files (one native call a run), group 2 is
    # `:memory:` (applied from Python).
    m = node.metrics
    n0 = sum(1 for g, _q in writes if g != 2) + 1
    assert m.apply_native_entries - base[1] == n0
    assert m.apply_py_entries - base[2] == len(writes) + 1 - n0
    assert m.apply_native_runs - base[0] == sum(
        1 for run in runs if any(g != 2 for g, _i, _q in run))
    assert m.t_apply_sqlite_ms > 0
    assert m.t_apply_ms >= m.t_apply_sqlite_ms
    snap = m.snapshot()["apply"]
    assert snap["native_entries"] == m.apply_native_entries
    assert snap["py_entries"] == m.apply_py_entries


def test_a_witness_applies_from_python_and_counts_so():
    """A witness replica (no shard) keeps the per-state-machine apply:
    its entries count as apply_py_entries, none as native."""
    q = queue.Queue()
    pipe = SimpleNamespace(
        node=SimpleNamespace(metrics=NodeMetrics(), witness_self=True,
                             cfg=SimpleNamespace(tick_interval_s=0.01,
                                                 lease_ticks=0)),
        commit_q=q, error=None)
    pipe.close = lambda: (q.put(CLOSED), None)[1]
    q.put(None)
    rdb = RaftDB(SQLiteStateMachine, pipe, num_groups=2)
    for i in range(1, 6):
        q.put((i % 2, i, f"INSERT INTO t VALUES ({i})"))
    t_end = time.monotonic() + 10
    m = pipe.node.metrics
    while m.apply_py_entries < 5:
        assert time.monotonic() < t_end
        time.sleep(0.005)
    rdb.close()
    assert m.apply_native_entries == 0 and m.apply_native_runs == 0
    assert rdb.watermark(1) == 5 and rdb.watermark(0) == 4
