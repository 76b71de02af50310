"""The cases of tests/test_linear_reads.py, on the port (three
RaftNodes on the CPU over LoopbackHub).  The reference file's docstring
follows.

Linearizable reads (ReadIndex, raft §6.4) — beyond reference parity.

The reference serves GETs from the local replica and documents the
staleness (db.go:128-130, raftsql_test.go:150-158).  `query(...,
linear=True)` upgrades a read: only the group's current leader serves
it, after a quorum re-confirms its leadership on a round started after
the call and the local apply catches up to the read point.  These tests
pin the three behaviors that make that linearizable:

  - read-your-writes at the leader, immediately after the ack;
  - non-leaders refuse with the leader's identity (no silent staleness);
  - a leader cut off from its quorum cannot serve (no stale reads from
    a deposed leader that doesn't know it yet).
"""
import os
import time

import pytest
import torch

from raftsql_tpu_torch.config import LEADER, RaftConfig
from raftsql_tpu_torch.models.sqlite_sm import SQLiteStateMachine
from raftsql_tpu_torch.runtime.db import NotLeaderError, RaftDB
from raftsql_tpu_torch.runtime.pipe import RaftPipe
from raftsql_tpu_torch.transport.loopback import (FaultPlan, LoopbackHub,
                                            LoopbackTransport)

torch.set_num_threads(1)

TICK = 0.005
TIMEOUT = 30.0


@pytest.fixture
def cluster(tmp_path):
    faults = FaultPlan()
    hub = LoopbackHub(faults=faults)
    cfg = RaftConfig(num_groups=1, num_peers=3, tick_interval_s=TICK,
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
    yield dbs, faults
    for db in dbs:
        try:
            db.close()
        except Exception:
            pass


def leader_index(dbs, timeout=TIMEOUT) -> int:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for i, db in enumerate(dbs):
            node = db.pipe.node
            if node._last_role[0] == LEADER:
                return i
        time.sleep(0.02)
    raise AssertionError("no leader elected")


def test_linear_read_your_writes_at_leader(cluster):
    dbs, _ = cluster
    assert dbs[0].propose("CREATE TABLE t (v text)").wait(TIMEOUT) is None
    lead = leader_index(dbs)
    for k in range(5):
        assert dbs[lead].propose(
            f"INSERT INTO t (v) VALUES ('k{k}')").wait(TIMEOUT) is None
        # Immediately after the ack, a linear read at the leader must see
        # the write (the ack already implies local apply; the quorum
        # round proves the leader is still current).
        got = dbs[lead].query("SELECT count(*) FROM t", linear=True,
                              timeout=TIMEOUT)
        assert got == f"|{k + 1}|\n", got


def test_linear_read_rejected_at_follower(cluster):
    dbs, _ = cluster
    assert dbs[0].propose("CREATE TABLE t (v text)").wait(TIMEOUT) is None
    lead = leader_index(dbs)
    follower = (lead + 1) % 3
    # Followers must refuse rather than serve a possibly-stale answer,
    # and must say who the leader is.
    with pytest.raises(NotLeaderError) as ei:
        dbs[follower].query("SELECT count(*) FROM t", linear=True,
                            timeout=5.0)
    assert ei.value.leader == lead + 1
    # Plain (reference-parity) reads still work on followers — but they
    # are STALE by design, so poll until the follower's replica has
    # applied the schema (reference raftsql_test.go:159-170).
    deadline = time.monotonic() + TIMEOUT
    while True:
        try:
            assert dbs[follower].query(
                "SELECT count(*) FROM t").startswith("|")
            break
        except Exception:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def test_linear_read_blocked_without_quorum(cluster):
    """A leader partitioned from its quorum must NOT serve a linear read
    — that is the exact staleness window ReadIndex closes (the deposed
    leader may not know a new leader committed past it)."""
    dbs, faults = cluster
    assert dbs[0].propose("CREATE TABLE t (v text)").wait(TIMEOUT) is None
    lead = leader_index(dbs)
    faults.isolate(lead + 1, range(1, 4))
    # Allow in-flight quorum confirmations to drain past reg_tick + 2.
    time.sleep(20 * TICK)
    t0 = time.monotonic()
    with pytest.raises((TimeoutError, NotLeaderError)):
        dbs[lead].query("SELECT count(*) FROM t", linear=True, timeout=1.5)
    assert time.monotonic() - t0 < 10.0
    faults.heal()
