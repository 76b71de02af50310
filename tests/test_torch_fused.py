"""The port's durable fused runtime beside the JAX package's.

Both FusedClusterNodes boot from the same seed (the port draws the JAX
package's threefry draws, so the two initial states are equal leaf for
leaf), run CPU ticks in lockstep and take the same proposals.  The
committed stream of every peer, the hard-state mirror, the leader hints and the
publish cursors must be equal; the WAL files the two write must be the
same bytes and replay through the JAX package's storage/wal.py; and the
port's node must replay its own WAL after a restart.
"""
import os

import numpy as np
import pytest
import torch

from raftsql_tpu.config import RaftConfig as JConfig
from raftsql_tpu.runtime.db import _expand_commit_item as j_expand
from raftsql_tpu.runtime.fused import FusedClusterNode as JNode
from raftsql_tpu.storage.wal import WAL as JWAL
from raftsql_tpu_torch.config import RaftConfig as TConfig
from raftsql_tpu_torch.runtime.db import _expand_commit_item as t_expand
from raftsql_tpu_torch.runtime.fused import FusedClusterNode as TNode

torch.set_num_threads(1)


def cfg_kw(**kw):
    args = dict(num_groups=6, num_peers=3, log_window=32,
                max_entries_per_msg=4, tick_interval_s=0.0,
                commit_rule="pallas")
    args.update(kw)
    return args


def drain(node, peer, expand):
    out = []
    q = node.commit_q(peer)
    while True:
        try:
            item = q.get_nowait()
        except Exception:
            return out
        if isinstance(item, tuple):        # skip None / CLOSED sentinels
            out.extend(expand(item))


def pair(tmp_path, group_commit=False, **kw):
    jcfg, tcfg = JConfig(**cfg_kw(**kw)), TConfig(**cfg_kw(**kw))
    jn = JNode(jcfg, str(tmp_path / "jax"), group_commit=group_commit,
               seed=7)
    tn = TNode(tcfg, str(tmp_path / "torch"), group_commit=group_commit,
               seed=7, device="cpu")
    for name in jn.states._fields:
        a = np.asarray(getattr(jn.states, name))
        b = getattr(tn.states, name).numpy()
        np.testing.assert_array_equal(
            b.view(np.uint32) if name == "rng" else b, a, err_msg=name)
    return jn, tn


def lockstep(jn, tn, ticks, rng, groups):
    for t in range(ticks):
        if t % 3 == 0:
            for g in range(groups):
                k = int(rng.integers(0, 4))
                batch = [f"SET k{t}-{i} g{g}".encode() for i in range(k)]
                jn.propose_many(g, batch)
                tn.propose_many(g, batch)
        jn.tick()
        tn.tick()
        np.testing.assert_array_equal(tn._hints, jn._hints, err_msg=str(t))
        np.testing.assert_array_equal(tn._hard, jn._hard, err_msg=str(t))


def wal_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("group_commit,steps",
                         [(False, 1), (True, 1), (False, 4)])
def test_fused_node_matches_jax_and_writes_same_wal(tmp_path, monkeypatch,
                                                     group_commit, steps):
    monkeypatch.setenv("RAFTSQL_FUSED_STEPS", str(steps))
    jn, tn = pair(tmp_path, group_commit=group_commit)
    lockstep(jn, tn, 150, np.random.default_rng(0), 6)
    for n in (jn, tn):
        n.publish_flush()
    for p in range(3):
        a = drain(jn, p, j_expand)
        b = drain(tn, p, t_expand)
        assert a == b, p
        assert len(a) > 100
    np.testing.assert_array_equal(tn._applied, jn._applied)
    jn.stop()
    tn.stop()
    ja, ta = wal_bytes(tmp_path / "jax"), wal_bytes(tmp_path / "torch")
    assert ja.keys() == ta.keys() and ja
    for k in ja:
        assert ja[k] == ta[k], k
    # The port's WAL replays through the JAX package's reader.
    if not group_commit:
        for p in range(3):
            d = str(tmp_path / "torch" / f"p{p + 1}")
            logs = JWAL.replay(d)
            assert sum(len(gl.entries) for gl in logs.values()) > 100
            for g, gl in logs.items():
                assert gl.hard.commit == tn._hard[p, g, 2]


def test_fused_node_restart_replays(tmp_path):
    jn, tn = pair(tmp_path)
    lockstep(jn, tn, 90, np.random.default_rng(1), 6)
    tn.stop()
    jn.stop()
    before = drain(tn, 0, t_expand)
    hard = tn._hard.copy()
    cfg = TConfig(**cfg_kw())
    t2 = TNode(cfg, str(tmp_path / "torch"), device="cpu")
    replayed = drain(t2, 0, t_expand)
    # The replay re-publishes exactly what was published before the stop
    # (group by group, in index order); the hard states come back.
    assert sorted(replayed) == sorted(before) and len(before) > 50
    np.testing.assert_array_equal(t2._hard, hard)
    # The restarted cluster keeps committing.
    for g in range(6):
        t2.propose_many(g, [f"SET after g{g}".encode()])
    for _ in range(60):
        t2.tick()
    t2.publish_flush()
    after = drain(t2, 0, t_expand)
    assert sum(1 for (_, _, q) in after if q.startswith("SET after")) == 6
    t2.stop()


def test_unported_planes_raise(tmp_path, monkeypatch):
    """The native payload log (ROADMAP Queue 1 item 9) raises; the obs,
    membership and transfer planes are ported and answer."""
    cfg = TConfig(**cfg_kw())
    monkeypatch.setenv("RAFTSQL_FUSED_NATIVE_PLOG", "1")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 9"):
        TNode(cfg, str(tmp_path / "native"), device="cpu")
    monkeypatch.delenv("RAFTSQL_FUSED_NATIVE_PLOG")
    tn = TNode(cfg, str(tmp_path / "t"), device="cpu")
    tn.enable_tracing()
    assert tn.tracer is not None and tn.ring is not None
    from raftsql_tpu_torch.runtime.node import TransferRefused
    with pytest.raises(TransferRefused, match="no leader"):
        tn.transfer_leadership(0, 1)
    tn.enable_membership()
    assert tn.cfg.dynamic_membership and tn.membership is not None
    from raftsql_tpu_torch.membership import MembershipError
    with pytest.raises(MembershipError, match="already a voter"):
        tn.member_change(0, "add", 1)
    assert tn.member_change(0, "remove", 2)["pending"]
    tn.stop()
