"""The port's RaftNode beside the JAX package's through a lifecycle:
membership change, leadership transfer, InstallSnapshot below the
compaction floor and restart from the WAL, in lockstep on the CPU.

The harness (tests/test_torch_node.py `Side`) compares every tick's
packed info, hard state, device state and commit stream of every live
node, and the WAL bytes at the end, with zero tolerance.
"""
import numpy as np
import pytest
import torch

from raftsql_tpu.storage import fsio as jfsio
from raftsql_tpu_torch.storage import fsio as tfsio
from raftsql_tpu_torch.ops import pallas_quorum as pq
from test_torch_node import JAX, PORT, Side, _propose, _tick_both
# raftlint: disable=unused-import -- counted_ids is a pytest fixture
from test_torch_node import counted_ids

torch.set_num_threads(1)


@pytest.mark.parametrize("rule", ["point", "pallas"])
def test_lifecycle_equal(tmp_path, counted_ids, monkeypatch, rule):
    """On 4 slots booted on voters {0,1,2}: add_learner 3 and promote it
    through joint consensus in group 0, a leadership transfer in group
    1, a node stopped while the others compact past its log, restarted
    from its WAL and brought back by InstallSnapshot, and at the end a
    restart of every node from its WAL."""
    calls = {"k1": 0, "k2": 0}
    k1, k2 = pq.pallas_quorum_commit_index, \
        pq.pallas_masked_quorum_commit_index

    def spy_k1(*a, **kw):
        calls["k1"] += 1
        return k1(*a, **kw)

    def spy_k2(*a, **kw):
        calls["k2"] += 1
        return k2(*a, **kw)

    monkeypatch.setattr(pq, "pallas_quorum_commit_index", spy_k1)
    monkeypatch.setattr(pq, "pallas_masked_quorum_commit_index", spy_k2)
    cfg = dict(num_groups=4, num_peers=4, log_window=16,
               max_entries_per_msg=4, election_ticks=10, heartbeat_ticks=1,
               tick_interval_s=0.0, initial_voters=(0, 1, 2),
               commit_rule=rule)
    docs = []
    # Both sides on their Python WAL backends (a rule-free injector each):
    # the lifecycle's restart replays REC_CONF baselines, which the native
    # backends of both packages do not write.
    with jfsio.installed(jfsio.StorageFaultInjector()), \
            tfsio.installed(tfsio.StorageFaultInjector()):
        sides = (Side(JAX, cfg, str(tmp_path / "jax")),
                 Side(PORT, cfg, str(tmp_path / "port")))
        j = sides[0]
        for p in range(4):
            assert sides[0].boot(p) == sides[1].boot(p)
        rng = np.random.default_rng(5)
        victim = None
        for t in range(300):
            if t in (40, 80, 110):
                op = {40: "add_learner", 80: "promote", 110: "remove"}[t]
                peer = 3 if op != "remove" else 0
                lead = j.leader(0)
                if lead is not None:
                    got = [s.call(lead, "member_change", 0, op, peer)
                           for s in sides]
                    assert got[0] == got[1], (t, got)
                    docs.append(got[0])
            if t == 120:
                lead = j.leader(1)
                tgt = next(p for p in (1, 2, 3) if p != lead)
                got = [s.call(lead, "transfer_leadership", 1, tgt)
                       for s in sides]
                assert got[0] == got[1]
                docs.append(got[0])
            if t == 150:
                victim = next(p for p in (1, 2, 3)
                              if p not in (j.leader(0), j.leader(1)))
                for s in sides:
                    s.stop(victim)
            if 150 < t < 220 and t % 5 == 0:
                for s in sides:
                    for p, n in enumerate(s.nodes):
                        if n is not None:
                            applied = {g: int(s.applied[p, g])
                                       for g in range(4)}
                            n.compact(applied, keep=16)
            if t == 220:
                assert sides[0].boot(victim) == sides[1].boot(victim)
            for _ in range(3 if 150 < t < 220 else 1):
                _propose(sides, rng, t, rate=0.8 if t < 240 else 0.0)
            _tick_both(sides, t)
        installed = [n.metrics.snapshots_installed for n in j.nodes]
        assert installed[victim] > 0, installed
        assert [n.metrics.snapshots_installed for n in sides[1].nodes] \
            == installed
        assert [n.metrics.conf_changes_applied for n in j.nodes] \
            == [n.metrics.conf_changes_applied for n in sides[1].nodes]
        assert [n.metrics.transfers_completed for n in j.nodes] \
            == [n.metrics.transfers_completed for n in sides[1].nodes]
        for s in sides:
            for p in range(4):
                s.stop(p)
        assert sides[0].wal_bytes() == sides[1].wal_bytes()
        # Restart every node from its WAL: replay and the rebuilt state
        # (REC_CONF baseline, compaction floors) equal, then more ticks.
        for p in range(4):
            assert sides[0].boot(p) == sides[1].boot(p)
        for t in range(300, 330):
            _propose(sides, rng, t)
            _tick_both(sides, t)
        for s in sides:
            for p in range(4):
                s.stop(p)
    assert docs and all(isinstance(d, (dict, str)) for d in docs)
    assert j.nodes == [None] * 4
    if rule == "pallas":
        # Voters {0,1,2} of 4 slots: the masked rule (K2's plain version
        # on the CPU) from the first tick, on C_old,new masks in the
        # joint phases; K1 never ran.
        assert calls["k1"] == 0 and calls["k2"] > 0
    else:
        assert calls == {"k1": 0, "k2": 0}
