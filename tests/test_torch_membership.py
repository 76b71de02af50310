"""The port's membership plane beside the JAX package's, on the CPU.

Four layers, each held exactly (every consensus leaf is int32 or bool,
every doc a dict):

  * the state patchers (core/state.py set_group_config(_stacked),
    set_transfer_target(_stacked)): the same patches on the same state,
    leaf for leaf, including the demotion of leader and candidate rows
    a new config leaves without a vote;
  * the host manager (membership/manager.py): one op sequence on both
    managers gives equal describe() docs and equal encoded entries, and
    the geometry refusals of the JAX package's quorum-geometry tests;
  * the fused lifecycle (add_learner 3, promote 3 through joint
    consensus, remove 0) on a 4-slot cluster booted on voters {0,1,2},
    at seed 7, under the point rule and the pallas rule (K2's plain
    version on real C_old,new masks), then a restart that rebuilds each
    peer's config from its REC_CONF baseline.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raftsql_tpu.chaos.scenarios import _drain_fused_q as j_drain
from raftsql_tpu.config import RaftConfig as JConfig
from raftsql_tpu.core import state as jstate
from raftsql_tpu.membership import MembershipError as JMembershipError
from raftsql_tpu.membership import MembershipManager as JManager
from raftsql_tpu.runtime.fused import FusedClusterNode as JNode
from raftsql_tpu.storage import fsio as jfsio
from raftsql_tpu_torch import convert
from raftsql_tpu_torch.chaos.scenarios import _drain_fused_q as t_drain
from raftsql_tpu_torch.config import CANDIDATE, LEADER, NO_XFER
from raftsql_tpu_torch.config import RaftConfig as TConfig
from raftsql_tpu_torch.core import cluster as tcluster
from raftsql_tpu_torch.core import state as tstate
from raftsql_tpu_torch.membership import MembershipError as TMembershipError
from raftsql_tpu_torch.membership import MembershipManager as TManager
from raftsql_tpu_torch.runtime.fused import FusedClusterNode as TNode

torch.set_num_threads(1)


# -- the patchers -------------------------------------------------------

def _seeded_stack(P=4, G=6, seed=3):
    """A stacked boot state with leader, candidate and follower rows and
    partial tallies, as numpy (JAX field names)."""
    cfg = TConfig(num_groups=G, num_peers=P, log_window=16,
                  max_entries_per_msg=4, initial_voters=(0, 1, 2))
    d = convert.to_numpy(tcluster.init_cluster_state(cfg, seed, "cpu"))
    rng = np.random.default_rng(seed)
    d["role"] = rng.choice([0, CANDIDATE, LEADER], (P, G)).astype(np.int32)
    d["leader_hint"] = rng.integers(-1, P, (P, G)).astype(np.int32)
    d["votes"] = rng.random((P, G, P)) < 0.5
    return d


def _both(d):
    js = jstate.PeerState(**{k: jnp.asarray(v) for k, v in d.items()})
    ts = convert.peer_state_from_numpy(d, device="cpu")
    return js, ts


def _assert_equal(js, ts, what):
    got = convert.to_numpy(ts)
    for name in jstate.PeerState._fields:
        np.testing.assert_array_equal(got[name],
                                      np.asarray(getattr(js, name)),
                                      err_msg=f"{what}: {name}")


def test_stacked_patchers_equal_jax_leaf_for_leaf():
    d = _seeded_stack()
    js, ts = _both(d)
    P = d["role"].shape[0]
    rows = [(p, g) for p in range(P) for g in range(d["role"].shape[1])]
    demoted = 0
    rng = np.random.default_rng(11)
    for i, (p, g) in enumerate(rows):
        v = rng.random(P) < 0.6
        j = rng.random(P) < 0.6 if i % 3 else v
        selfv = bool(v[p] or j[p]) if i % 4 else False
        demoted += (not selfv) and d["role"][p, g] != 0
        js = jstate.set_group_config_stacked(js, p, g, jnp.asarray(v),
                                             jnp.asarray(j), selfv)
        ts = tstate.set_group_config_stacked(ts, p, g, v, j, selfv)
        _assert_equal(js, ts, f"config ({p}, {g})")
        tgt = NO_XFER if i % 2 else (p + 1) % P
        js = jstate.set_transfer_target_stacked(js, p, g, tgt)
        ts = tstate.set_transfer_target_stacked(ts, p, g, tgt)
        _assert_equal(js, ts, f"transfer ({p}, {g})")
    # The sequence demoted leader and candidate rows on both sides.
    assert demoted >= 3
    assert not (convert.to_numpy(ts)["role"] == d["role"]).all()


def test_single_peer_patchers_equal_jax():
    d = _seeded_stack()
    one = {k: (v if k in ("rng", "tick") else v[0]) for k, v in d.items()}
    one["role"][:] = LEADER                 # every row leads: demote all
    js, ts = _both(one)
    for g in range(one["role"].shape[0]):
        v = np.array([False, True, True, g % 2 == 0])
        js = jstate.set_group_config(js, g, jnp.asarray(v), jnp.asarray(v),
                                     False)
        ts = tstate.set_group_config(ts, g, v, v, False)
        js = jstate.set_transfer_target(js, g, g % 3)
        ts = tstate.set_transfer_target(ts, g, g % 3)
    _assert_equal(js, ts, "single peer")
    assert (ts.role == 0).all() and (ts.leader_hint == -1).all()


# -- the manager ----------------------------------------------------------

OPS = [(0, "add_learner", 3), (0, "promote", 3), (1, "remove", 2),
       (2, "add", 3), (2, "remove_learner", 3), (1, "promote", 3),
       (0, "remove", 0), (3, "add_learner", 0)]


def _drive(mm):
    """Every op of OPS through make_change, each applied at the next log
    index and, when it opens a joint config, left by maybe_leave: the
    encoded entries and every describe() doc, or the refusal text."""
    out = []
    idx = {}
    for g, op, peer in OPS:
        try:
            entry = mm.make_change(g, op, peer)
        except Exception as e:                     # noqa: BLE001
            out.append(("refused", g, op, type(e).__name__, str(e)))
            continue
        idx[g] = idx.get(g, 0) + 1
        mm.apply(g, idx[g], entry)
        out.append((entry, mm.describe(g), mm.counts()))
        leave = mm.maybe_leave(g, 100 * idx[g], 1)
        if leave is not None:
            idx[g] += 1
            mm.apply(g, idx[g], leave)
            out.append((leave, mm.describe(g), mm.counts()))
    return out


def test_manager_op_sequence_equals_jax():
    got = _drive(TManager(4, 4, initial_voters=(0, 1, 2)))
    want = _drive(JManager(4, 4, initial_voters=(0, 1, 2)))
    assert got == want
    assert sum(1 for o in got if o[0] == "refused") >= 1
    assert sum(1 for o in got if o[0] != "refused") >= 6


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_manager_refuses_intersection_hole_and_witness_only(pkg):
    Manager, Error = ((TManager, TMembershipError) if pkg == "torch"
                      else (JManager, JMembershipError))

    def promote_third(mm):
        mm.apply(0, 1, mm.make_change(0, "add", 2))
        return mm.make_change(0, "promote", 2)

    mm = Manager(3, 1, initial_voters=(0, 1), write_quorum=1,
                 election_quorum=2)
    with pytest.raises(Error, match="non-intersecting"):
        promote_third(mm)
    assert promote_third(Manager(3, 1, initial_voters=(0, 1),
                                 write_quorum=1, election_quorum=2,
                                 unsafe_geometry=True))
    mm = Manager(3, 1, witnesses=(1, 2))
    with pytest.raises(Error, match="only witness voters"):
        mm.make_change(0, "remove", 0)
    assert mm.make_change(0, "remove", 2)


# -- the fused lifecycle ---------------------------------------------------

def _lifecycle(Node, Config, drain_q, path, rule, **node_kw):
    """The JAX package's fused membership lifecycle (a 4-slot cluster on
    voters {0,1,2}: add_learner 3, promote 3, remove 0 on group 0; group
    1 untouched), recording what must match: at each step the tick it
    took, members_doc, the hard-state mirror and every peer's log
    lengths; then the configs a restart rebuilds from the WALs."""
    cfg = Config(num_groups=2, num_peers=4, log_window=32,
                 max_entries_per_msg=4, election_ticks=10,
                 heartbeat_ticks=1, tick_interval_s=0.0,
                 initial_voters=(0, 1, 2), commit_rule=rule)
    rec = []
    node = Node(cfg, path, seed=7, **node_kw)
    node.publish_peers = {0}
    node.enable_membership()
    mm = node.membership
    ticks = [0]

    def until(pred, what, limit=600):
        for _ in range(limit):
            if pred():
                break
            node.tick()
            node.publish_flush()
            drain_q(node.commit_q(0))
            ticks[0] += 1
        assert pred(), what
        rec.append((what, ticks[0], node.members_doc(),
                    node._hard.tolist(),
                    [[pl.length(g) for g in range(2)] for pl in node.plogs]))

    try:
        until(lambda: node.leader_of(0) >= 0 and node.leader_of(1) >= 0,
              "elected")
        node.member_change(0, "add_learner", 3)
        until(lambda: mm.config(0).learners == 0b1000, "learner")
        node.propose_many(0, [b"SET a 1", b"SET b 2"])
        lead = node.leader_of(0)
        until(lambda: node.plogs[3].length(0)
              == node.plogs[lead].length(0) > 0, "learner caught up")
        node.member_change(0, "promote", 3)
        until(lambda: mm.config(0).voters == 0b1111
              and not mm.config(0).is_joint, "promoted")
        node.member_change(0, "remove", 0)
        until(lambda: mm.config(0).voters == 0b1110
              and not mm.config(0).is_joint, "removed")
        c0 = int(node._hard[node.leader_of(0), 0, 2])
        node.propose_many(0, [b"SET c 3"])
        until(lambda: int(node._hard[max(node.leader_of(0), 0), 0, 2])
              > c0, "commits on {1,2,3}")
        assert mm.config(1).voters == 0b0111 and mm.config(1).index == 0
        assert node.metrics.conf_changes_applied >= 5
        rec.append(("conf_changes_applied",
                    node.metrics.conf_changes_applied))
    finally:
        node.stop()
    node2 = Node(cfg, path, seed=7, **node_kw)
    node2.publish_peers = {0}
    node2.enable_membership()
    try:
        mm2 = node2.membership
        assert mm2.config(0).voters == 0b1110 and not mm2.config(0).is_joint
        assert mm2.config(1).voters == 0b0111
        rec.append(("restart", [mm2.describe(g) for g in range(2)],
                    [{g: c for g, c in sorted(node2._replayed_conf[p]
                                              .items())}
                     for p in range(4)],
                    node2._conf_cursor.tolist()))
    finally:
        node2.stop()
    return rec


@pytest.mark.parametrize("rule", ["point", "pallas"])
def test_fused_lifecycle_and_restart_equal_jax(tmp_path, monkeypatch,
                                               rule):
    from raftsql_tpu_torch.ops import pallas_quorum as pq
    calls = {"k1": 0, "k2": 0, "k2_joint": 0}
    k1, k2 = pq.pallas_quorum_commit_index, \
        pq.pallas_masked_quorum_commit_index

    def spy_k1(*a, **kw):
        calls["k1"] += 1
        return k1(*a, **kw)

    def spy_k2(*a, **kw):
        calls["k2"] += 1
        calls["k2_joint"] += bool(
            (kw["voters"] != kw["voters_joint"]).any())
        return k2(*a, **kw)

    monkeypatch.setattr(pq, "pallas_quorum_commit_index", spy_k1)
    monkeypatch.setattr(pq, "pallas_masked_quorum_commit_index", spy_k2)
    got = _lifecycle(TNode, TConfig, t_drain, str(tmp_path / "port"), rule,
                     device="cpu")
    # The JAX package writes REC_CONF baselines from its Python WAL
    # backend only (its native backend documents the gap); an installed
    # storage injector with no rules selects that backend, as its own
    # membership runtimes do.  The port has only the Python backend.
    with jfsio.installed(jfsio.StorageFaultInjector()):
        want = _lifecycle(JNode, JConfig, j_drain, str(tmp_path / "jax"),
                          rule)
    assert got == want
    # The restart rebuilt every peer's config from its REC_CONF
    # baseline (conf index 8: the LEAVE_JOINT of the removal).
    assert [c.get(0, (0,))[0] for c in got[-1][2]] == [8, 8, 8, 8]
    doc = got[-3][2]
    assert doc["groups"]["0"]["voters"] == [1, 2, 3]
    assert doc["groups"]["1"]["voters"] == [0, 1, 2]
    if rule == "pallas":
        # Every tick after enable_membership took the masked rule (K2's
        # plain version on the CPU), on C_old,new masks during the
        # joint phases; K1 never ran.
        assert calls["k1"] == 0 and calls["k2"] > 0
        assert calls["k2_joint"] > 0
    else:
        assert calls == {"k1": 0, "k2": 0, "k2_joint": 0}
