"""The lease_cluster cases and the two joint-confirmation cases of
tests/test_read_plane.py, on the port (three RaftNodes on the CPU over
LoopbackHub; the lease kernel held to the JAX package's).  The
reference file's docstring follows.

The lease-based read plane (config.lease_ticks) and its chaos
falsification harness.

Covers the read plane's acceptance spine:
  - leader leases serve linearizable reads without a quorum round, and
    metrics attribute every read to its mode;
  - a partitioned leader's lease EXPIRES (never a silent stale read),
    and the degraded path surfaces typed, retryable errors within the
    request timeout;
  - session (X-Raft-Session) and follower watermark reads give
    read-your-writes at any replica;
  - ReadIndex/lease quorum confirmation under JOINT consensus needs
    both halves of the config;
  - the read nemesis (chaos/scenarios.py ReadNemesisRunner) and the
    lease FALSIFICATION pair: a deliberately mis-sized lease bound
    under 4x clock skew must be CAUGHT by the read-linearizability
    invariant, and the same schedule with a correct bound must pass.
"""
import os
import time

import numpy as np
import pytest
import torch

from raftsql_tpu_torch.config import LEADER, RaftConfig
from raftsql_tpu_torch.models.sqlite_sm import SQLiteStateMachine
from raftsql_tpu_torch.runtime.db import NotLeaderError, RaftDB, ReadTimeout
from raftsql_tpu_torch.runtime.pipe import RaftPipe
from raftsql_tpu_torch.transport.loopback import (FaultPlan, LoopbackHub,
                                            LoopbackTransport)

torch.set_num_threads(1)

TICK = 0.005
TIMEOUT = 30.0


@pytest.fixture
def lease_cluster(tmp_path):
    """3-node loopback cluster with leases ON, sized safely for the
    lockstep (rate-1) clock: lease 6 + skew 1 < election 10."""
    faults = FaultPlan()
    hub = LoopbackHub(faults=faults)
    cfg = RaftConfig(num_groups=1, num_peers=3, tick_interval_s=TICK,
                     election_ticks=10, log_window=64,
                     max_entries_per_msg=4,
                     lease_ticks=6, max_clock_skew=1)
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


def _leader(dbs, timeout=TIMEOUT) -> int:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for i, db in enumerate(dbs):
            if db.pipe.node._last_role[0] == LEADER:
                return i
        time.sleep(0.02)
    raise AssertionError("no leader elected")


def test_lease_serves_linear_reads(lease_cluster):
    """At a healthy leader, linearizable reads ride the lease (no
    quorum round), read-your-writes holds, and the /metrics read
    counters attribute the path."""
    dbs, _ = lease_cluster
    assert dbs[0].propose("CREATE TABLE t (v text)").wait(TIMEOUT) is None
    lead = _leader(dbs)
    node = dbs[lead].pipe.node
    for k in range(4):
        assert dbs[lead].propose(
            f"INSERT INTO t (v) VALUES ('k{k}')").wait(TIMEOUT) is None
        got = dbs[lead].query("SELECT count(*) FROM t", mode="linear",
                              timeout=TIMEOUT)
        assert got == f"|{k + 1}|\n", got
    m = node.metrics
    # At a healthy heartbeat-confirmed leader the lease covers most of
    # these reads; any degrade must have gone through ReadIndex, never
    # served stale.
    assert m.reads_lease + m.reads_read_index == 4
    assert m.reads_lease >= 1
    assert m.lease_grants >= 1
    # The metrics doc nests them under "reads" (prom round-trip).
    doc = dbs[lead].metrics()
    assert doc["reads"]["lease"] == m.reads_lease


def test_lease_expires_under_partition_typed_timeout(lease_cluster):
    """A leader cut from its quorum must LOSE its lease within the
    bound (no silent stale read), and the degraded ReadIndex round
    must surface a TYPED retryable error within the request timeout —
    the bounded-poll-loop satellite."""
    dbs, faults = lease_cluster
    assert dbs[0].propose("CREATE TABLE t (v text)").wait(TIMEOUT) is None
    lead = _leader(dbs)
    node = dbs[lead].pipe.node
    # Healthy: the lease is live.
    dbs[lead].query("SELECT count(*) FROM t", mode="linear",
                    timeout=TIMEOUT)
    faults.isolate(lead + 1, range(1, 4))
    # Wait out the lease bound (lease_ticks + skew, in ticks) plus the
    # in-flight echo window.
    time.sleep(30 * TICK)
    assert node.lease_read(0) is None, \
        "partitioned leader still claims a lease past its bound"
    t0 = time.monotonic()
    with pytest.raises((TimeoutError, NotLeaderError)) as ei:
        dbs[lead].query("SELECT count(*) FROM t", mode="linear",
                        timeout=1.5)
    took = time.monotonic() - t0
    assert took < 5.0, f"read poll did not respect its timeout ({took})"
    if isinstance(ei.value, TimeoutError):
        # The typed class names the stalled phase for client logs.
        assert isinstance(ei.value, ReadTimeout)
        assert ei.value.phase in ("confirm", "read_index")
    assert node.metrics.lease_expiries >= 1
    faults.heal()


def test_session_read_your_writes_any_replica(lease_cluster):
    """A session read presenting the write's watermark must see it at
    ANY replica — the X-Raft-Session contract."""
    dbs, _ = lease_cluster
    assert dbs[0].propose("CREATE TABLE t (v text)").wait(TIMEOUT) is None
    lead = _leader(dbs)
    assert dbs[lead].propose(
        "INSERT INTO t (v) VALUES ('mine')").wait(TIMEOUT) is None
    wm = dbs[lead].watermark(0)
    assert wm >= 2
    for i in range(3):
        got = dbs[i].query("SELECT count(*) FROM t", mode="session",
                           watermark=wm, timeout=TIMEOUT)
        assert got == "|1|\n", (i, got)
    m = dbs[(lead + 1) % 3].pipe.node.metrics
    assert m.reads_session >= 1


def test_follower_mode_reads_at_commit_watermark(lease_cluster):
    """mode="follower": the replica serves once its apply reaches its
    OWN commit watermark — fresher than a stale local read, no leader
    round.  A follower that has replicated the write must return it."""
    dbs, _ = lease_cluster
    assert dbs[0].propose("CREATE TABLE t (v text)").wait(TIMEOUT) is None
    lead = _leader(dbs)
    assert dbs[lead].propose(
        "INSERT INTO t (v) VALUES ('x')").wait(TIMEOUT) is None
    follower = (lead + 1) % 3
    deadline = time.monotonic() + TIMEOUT
    while True:
        got = dbs[follower].query("SELECT count(*) FROM t",
                                  mode="follower", timeout=TIMEOUT)
        if got == "|1|\n":
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"follower never caught up: {got!r}")
        time.sleep(0.05)
    assert dbs[follower].pipe.node.metrics.reads_follower >= 1


def test_unknown_read_mode_rejected(lease_cluster):
    dbs, _ = lease_cluster
    with pytest.raises(ValueError, match="unknown read mode"):
        dbs[0].query("SELECT 1", mode="strong")


def test_joint_consensus_confirmation_needs_both_halves():
    """ReadIndex confirmation AND the lease quorum clock under a joint
    C_old,new config must have a majority of BOTH masks — a read
    served on one half alone could miss a leader the other half
    elected mid-membership-change."""
    from raftsql_tpu_torch.membership import MembershipManager
    mm = MembershipManager(4, 1, initial_voters=(0, 1, 2))
    entry = mm.make_change(0, "add_learner", 3)
    assert mm.apply(0, 5, entry) is not None
    entry = mm.make_change(0, "promote", 3)  # -> joint {0,1,2,3}/{0,1,2}
    assert mm.apply(0, 6, entry) is not None
    assert mm.config(0).is_joint

    # quorum_confirmed: self=0.  {0,1} confirms old (2 of {0,1,2}) but
    # not new (2 of 4 needs 3) -> must NOT confirm.
    ok = np.array([False, True, False, False])
    assert not mm.quorum_confirmed(0, ok, 0)
    # {0,1,3} confirms both halves.
    ok = np.array([False, True, False, True])
    assert mm.quorum_confirmed(0, ok, 0)

    # quorum_nth (the lease clock): the min of both masks' majorities.
    vals = np.array([100, 90, 0, 95])        # peer 2 never confirmed
    # old {0,1,2}: 2nd largest of (100,90,0) = 90; new {0,1,2,3}: 3rd
    # largest of (100,90,0,95) = 90.
    assert mm.quorum_nth(0, vals) == 90
    vals = np.array([100, 0, 0, 95])
    # old majority falls to 0 -> the stale half gates the lease.
    assert mm.quorum_nth(0, vals) == 0


def test_masked_lease_kernel_joint_min():
    """Device-side: the joint lease clock is the min of both masks'
    quorum values (core/step.py Phase 8b uses exactly this pair) — the
    port's masked_quorum_match_index held to the JAX package's on the
    same numpy inputs: the reference's case, then seeded random rows
    and masks (empty masks included)."""
    import jax.numpy as jnp
    from raftsql_tpu.ops.quorum import \
        masked_quorum_match_index as jax_mqmi
    from raftsql_tpu_torch.ops.quorum import masked_quorum_match_index

    def both(resp, new, old):
        t = torch.minimum(
            masked_quorum_match_index(torch.from_numpy(resp),
                                      torch.from_numpy(new)),
            masked_quorum_match_index(torch.from_numpy(resp),
                                      torch.from_numpy(old)))
        j = jnp.minimum(jax_mqmi(jnp.asarray(resp), jnp.asarray(new)),
                        jax_mqmi(jnp.asarray(resp), jnp.asarray(old)))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        return t.numpy()

    q = both(np.asarray([[50, 40, 0, 45]], np.int32),
             np.asarray([[True, True, True, True]]),
             np.asarray([[True, True, True, False]]))
    # new: 3rd largest of (50,40,0,45)=40; old: 2nd of (50,40,0)=40.
    assert int(q[0]) == 40
    rng = np.random.default_rng(7)
    for P in (3, 4, 5, 7):
        resp = rng.integers(0, 1000, (64, P)).astype(np.int32)
        both(resp, rng.random((64, P)) < 0.7, rng.random((64, P)) < 0.7)
