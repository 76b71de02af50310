"""Reads parked on the apply (raftsql_tpu_torch/runtime/db.py RaftDB.park).

A read whose read point the local apply has not reached waits on its
group's registry of waiters and is woken by whichever path moves the
applied index: the live apply, the replay at boot and a snapshot install.
Its deadline, the apply's failure and `close()` end the wait with the
errors the polling loop raised.  A group with no waiter costs the apply
thread no lock.  Over HTTP (api/aio.py) a linear GET takes its read point
on the event loop and parks there, so it holds none of the 8 read-pool
threads while the apply catches up; on the node runtime its batched
ReadIndex round runs in the pool first.
"""
import http.client
import os
import queue
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from raftsql_tpu_torch.api.aio import AioSQLServer
from raftsql_tpu_torch.config import LEADER, RaftConfig
from raftsql_tpu_torch.models.sqlite_sm import SQLiteStateMachine
from raftsql_tpu_torch.runtime import db as db_mod
from raftsql_tpu_torch.runtime.db import RaftDB, ReadTimeout
from raftsql_tpu_torch.runtime.node import CLOSED
from raftsql_tpu_torch.runtime.pipe import RaftPipe
from raftsql_tpu_torch.server.main import build_fused_node
from raftsql_tpu_torch.transport.loopback import (LoopbackHub,
                                                  LoopbackTransport)
from raftsql_tpu_torch.utils.metrics import NodeMetrics

torch.set_num_threads(1)


class _SM:
    """A state machine that only counts: its answer is its index."""

    def __init__(self, group):
        self._applied = 0

    def applied_index(self):
        return self._applied

    def apply_batch(self, items):
        for _q, i in items:
            self._applied = max(self._applied, i)
        return [None] * len(items)

    def install(self, blob, index):
        self._applied = index

    def query(self, q):
        return f"|{self._applied}|\n"

    def close(self):
        pass


class _Pipe:
    def __init__(self):
        self.node = SimpleNamespace(
            metrics=NodeMetrics(),
            cfg=SimpleNamespace(tick_interval_s=0.01, lease_ticks=0))
        self.commit_q = queue.Queue()
        self.error = None

    def close(self):
        self.commit_q.put(CLOSED)
        return self.error


def _db(groups=2):
    pipe = _Pipe()
    pipe.commit_q.put(None)             # the replay ends at once
    return RaftDB(_SM, pipe, num_groups=groups, listener=queue.Queue())


def _commit(rdb, group, lo, hi):
    """Hand entries lo..hi of `group` to the apply and wait for them."""
    rdb.pipe.commit_q.put((group, [(i, f"s{i}") for i in range(lo, hi + 1)]))
    t_end = time.monotonic() + 10
    while rdb.watermark(group) < hi:
        assert time.monotonic() < t_end, "the apply did not run"
        time.sleep(0.001)


class _CountingLock:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0

    def __enter__(self):
        self.n += 1
        return self._lock.__enter__()

    def __exit__(self, *exc):
        return self._lock.__exit__(*exc)


def test_the_apply_of_the_target_releases_a_waiter_and_not_before():
    rdb = _db()
    try:
        evt = threading.Event()
        w = rdb.park(0, 5, evt.set)
        assert w is not None and rdb._waiters[0] == [w]
        _commit(rdb, 0, 1, 4)
        _commit(rdb, 1, 1, 9)           # another group's apply
        assert not evt.is_set() and w.t1 is None
        _commit(rdb, 0, 5, 6)
        assert evt.wait(5) and w.t1 >= w.t0
        assert rdb._waiters[0] == []
        rdb.settle_read(0, 5, "apply")  # served: no raise
        m = rdb.pipe.node.metrics
        assert (m.reads_parked, m.read_wakes, m.read_waiters_max,
                m.read_wait_timeouts) == (1, 1, 1, 0)
        assert m.t_read_wait_ms > 0
        # A read point the apply already passed parks nothing.
        assert rdb.park(0, 6, evt.set) is None
        assert m.reads_parked == 1
    finally:
        rdb.close()


def test_a_snapshot_install_releases_its_waiters():
    rdb = _db()
    try:
        evt, late = threading.Event(), threading.Event()
        rdb.park(1, 9, evt.set)
        rdb.park(1, 12, late.set)
        rdb._install_snapshot(1, 10, b"image")
        assert evt.is_set() and not late.is_set()
        assert len(rdb._waiters[1]) == 1
    finally:
        rdb.close()


def test_the_replay_releases_its_waiters():
    """Waiters exist before the replay at boot ends: one parked while
    the constructor still replays is woken by the replayed entries."""
    pipe = _Pipe()
    box, replaying = [], threading.Event()

    class Capture(RaftDB):
        def _read_commits(self, replay=False):
            if replay:
                box.append(self)
                replaying.set()
            return super()._read_commits(replay)

    built = []
    t = threading.Thread(target=lambda: built.append(
        Capture(_SM, pipe, num_groups=1)))
    t.start()
    assert replaying.wait(10)
    rdb = box[0]
    evt = threading.Event()
    assert rdb.park(0, 3, evt.set) is not None
    pipe.commit_q.put((0, 1, "a"))
    pipe.commit_q.put((0, 2, "b"))
    time.sleep(0.05)
    assert not evt.is_set() and t.is_alive()
    pipe.commit_q.put((0, 3, "c"))
    assert evt.wait(5)
    pipe.commit_q.put(None)
    t.join(10)
    assert built and built[0] is rdb
    rdb.close()


def test_the_deadline_gives_read_timeout_without_a_sleep(monkeypatch):
    rdb = _db()
    try:
        def refuse(_s):
            raise AssertionError("the read slept")
        monkeypatch.setattr(db_mod.time, "sleep", refuse)
        t0 = time.monotonic()
        with pytest.raises(ReadTimeout) as e:
            rdb._wait_applied(0, 10, time.monotonic() + 0.1, 0.01, "apply")
        monkeypatch.undo()
        assert time.monotonic() - t0 >= 0.1
        assert e.value.phase == "apply" and e.value.group == 0
        assert "did not reach read point 10 in time" in str(e.value)
        assert rdb._waiters[0] == [] and rdb._n_parked == 0
        m = rdb.pipe.node.metrics
        assert (m.reads_parked, m.read_wakes, m.read_wait_timeouts) == (
            1, 0, 1)
        assert m.t_read_wait_ms >= 100
    finally:
        rdb.close()


def _waiting_read(rdb, target):
    """A thread blocked in `_wait_applied` for up to 30 s; its outcome
    lands in the returned list."""
    out = []

    def read():
        try:
            rdb._wait_applied(0, target, time.monotonic() + 30, 0.01,
                              "apply")
            out.append(None)
        except Exception as e:                          # noqa: BLE001
            out.append(e)
    t = threading.Thread(target=read)
    t.start()
    t_end = time.monotonic() + 10
    while not rdb._waiters[0]:
        assert time.monotonic() < t_end
        time.sleep(0.001)
    return t, out


def test_a_failed_apply_wakes_and_raises_its_error():
    rdb = _db()
    t, out = _waiting_read(rdb, 7)
    t0 = time.monotonic()
    boom = RuntimeError("consensus failed")
    rdb.pipe.error = boom
    rdb.pipe.commit_q.put(CLOSED)
    t.join(10)
    assert out == [boom] and time.monotonic() - t0 < 5
    # A read that comes after the failure raises it at once.
    with pytest.raises(RuntimeError, match="consensus failed"):
        rdb._wait_applied(0, 7, time.monotonic() + 30, 0.01, "apply")
    rdb.close()


def test_close_wakes_and_raises_read_timeout():
    rdb = _db()
    t, out = _waiting_read(rdb, 7)
    t0 = time.monotonic()
    rdb.close()
    t.join(10)
    assert len(out) == 1 and isinstance(out[0], ReadTimeout)
    assert "did not reach read point 7" in str(out[0])
    assert time.monotonic() - t0 < 5
    assert rdb.park(0, 8, lambda: None) is None


def test_a_group_without_waiters_takes_no_lock_on_the_apply():
    rdb = _db(groups=3)
    try:
        lock = rdb._wmu = _CountingLock()
        for k in range(20):
            _commit(rdb, k % 3, k // 3 * 2 + 1, k // 3 * 2 + 2)
        assert lock.n == 0
        evt = threading.Event()
        rdb.park(1, 1000, evt.set)
        assert lock.n == 1
        _commit(rdb, 0, 100, 101)
        _commit(rdb, 2, 100, 101)
        assert lock.n == 1              # other groups' applies: no lock
        _commit(rdb, 1, 100, 101)
        assert lock.n == 2 and not evt.is_set()
        _commit(rdb, 1, 102, 1000)
        assert evt.wait(5) and lock.n == 3
    finally:
        rdb.close()


# -- over HTTP: a linear GET parks on the loop, not in the pool --------

def _get(port, group, sql, out, i):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", "/", body=sql.encode(),
                     headers={"X-Raft-Group": str(group),
                              "X-Consistency": "linear"})
        r = conn.getresponse()
        out[i] = (r.status, r.read().decode())
    finally:
        conn.close()


def _put(port, group, sql):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("PUT", "/", body=sql.encode(),
                     headers={"X-Raft-Group": str(group)})
        r = conn.getresponse()
        r.read()
        return r.status
    finally:
        conn.close()


def test_64_linear_gets_park_without_holding_pool_threads(tmp_path):
    """With the apply held back, 64 concurrent linear GETs on 8 groups
    all park at once (the 8 pool threads could hold at most 8 waits)
    and none answers; released, each answers with every write that
    was acknowledged before it was sent, and with the write that was
    committed but not yet applied when it arrived."""
    G, N = 8, 64
    rdb = build_fused_node(groups=G, peers=3, tick=0.01,
                           data_prefix=str(tmp_path / "raftsql"),
                           device="cpu")
    srv = AioSQLServer(0, rdb, host="127.0.0.1", timeout_s=60.0)
    srv.start()
    gate = threading.Event()
    gate.set()
    pool_threads = set()
    try:
        node = rdb.pipe.node
        t_end = time.monotonic() + 60
        while not all(node.leader_of(g) >= 0 for g in range(G)):
            assert time.monotonic() < t_end, "no leaders"
            time.sleep(0.02)
        for g in range(G):
            assert _put(srv.port, g, "CREATE TABLE t (v TEXT)") == 204
            assert _put(srv.port, g, "INSERT INTO t VALUES ('acked')") == 204
        for sm in rdb._sms.values():
            real = sm.apply_batch

            def held(items, real=real):
                gate.wait()
                return real(items)
            sm.apply_batch = held
        local_query = rdb.local_query

        def counted(query, group=0):
            pool_threads.add(threading.get_ident())
            return local_query(query, group)
        rdb.local_query = counted
        gate.clear()
        # One write a group that commits but cannot apply.
        puts = [threading.Thread(target=_put, args=(
            srv.port, g, "INSERT INTO t VALUES ('committed')"))
            for g in range(G)]
        for t in puts:
            t.start()
        t_end = time.monotonic() + 30
        while not all(node.commit_watermark(g) > rdb.watermark(g)
                      for g in range(G)):
            assert time.monotonic() < t_end, "the writes did not commit"
            time.sleep(0.01)
        out = [None] * N
        gets = [threading.Thread(target=_get, args=(
            srv.port, i % G, "SELECT v FROM t ORDER BY v", out, i))
            for i in range(N)]
        for t in gets:
            t.start()
        t_end = time.monotonic() + 30
        while rdb._n_parked < N:
            assert time.monotonic() < t_end, (rdb._n_parked, out)
            time.sleep(0.01)
        time.sleep(0.2)
        assert out == [None] * N and not pool_threads
        assert node.metrics.read_waiters_max >= N
        gate.set()
        for t in gets + puts:
            t.join(60)
        assert all(o is not None and o[0] == 200 for o in out), out
        assert all("|acked|" in o[1] and "|committed|" in o[1]
                   for o in out), out
        assert 0 < len(pool_threads) <= 8
        m = node.metrics
        assert m.read_wakes <= m.reads_parked and m.read_wakes >= N
        assert m.read_wait_timeouts == 0
    finally:
        gate.set()
        srv.stop()
        rdb.close()


def test_node_path_runs_its_read_round_in_the_pool(tmp_path):
    """Over three RaftNodes (the Procfile cluster's runtime, on a
    loopback hub) a linear GET first joins the batched ReadIndex round
    (`read_join`, in the pool), then waits for the apply: the leader
    answers with the write it acknowledged, a follower refuses with
    421 and the leader's id."""
    hub = LoopbackHub()
    cfg = RaftConfig(num_groups=1, num_peers=3, tick_interval_s=0.005,
                     election_ticks=10, log_window=64,
                     max_entries_per_msg=4)
    dbs, srvs = [], []
    try:
        for i in range(3):
            pipe = RaftPipe.create(
                i + 1, 3, cfg, LoopbackTransport(hub),
                data_dir=os.path.join(str(tmp_path), f"raftsql-{i + 1}"),
                device="cpu")
            dbs.append(RaftDB(
                lambda g, i=i: SQLiteStateMachine(
                    os.path.join(str(tmp_path), f"db-{i}.db")),
                pipe, num_groups=1))
            srvs.append(AioSQLServer(0, dbs[-1], host="127.0.0.1",
                                     timeout_s=30.0))
            srvs[-1].start()
        t_end = time.monotonic() + 30
        while True:
            lead = [i for i, db in enumerate(dbs)
                    if db.pipe.node._last_role[0] == LEADER]
            if lead:
                lead = lead[0]
                break
            assert time.monotonic() < t_end, "no leader elected"
            time.sleep(0.02)
        assert _put(srvs[lead].port, 0, "CREATE TABLE t (v TEXT)") == 204
        assert _put(srvs[lead].port, 0, "INSERT INTO t VALUES ('a')") == 204
        out = [None, None]
        _get(srvs[lead].port, 0, "SELECT v FROM t", out, 0)
        _get(srvs[(lead + 1) % 3].port, 0, "SELECT v FROM t", out, 1)
        assert out[0] == (200, "|a|\n"), out
        assert out[1][0] == 421, out
        assert dbs[lead].pipe.node.metrics.reads_read_index_batched >= 1
    finally:
        for srv in srvs:
            srv.stop()
        for db in dbs:
            db.close()
