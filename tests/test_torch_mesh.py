"""The port's mesh runtime (raftsql_tpu_torch/runtime/mesh.py) beside the
port's fused runtime and the JAX package's mesh runtime.

The port's mesh takes shard slots of the CPU (RAFTSQL_SHARD_SLOTS=8, as
the JAX suite forces 8 host devices in tests/conftest.py):

  * mesh <-> fused and port <-> JAX equivalence: hard states, leader
    hints, publish cursors and EACH GROUP's applied stream, on full
    voters, a peers x groups mesh, masked membership and per-peer skew.
    The interleaving of groups in the one drained stream is not
    compared: the mesh publishes from one worker per group shard, so
    that order across groups is not defined (the JAX package's own
    tests/test_mesh.py compares it and fails for that reason);
  * acked writes through RaftDB + FusedPipe over the mesh node;
  * ShardedWAL: routing, replay merge, re-shard refusal, and the same
    bytes per shard dir as the JAX package's ShardedWAL;
  * skew on the mesh: lockstep and skewed elections differ, and the
    mesh_skew chaos family reproduces with the fused skew family's
    digests.
"""
import os
import queue

import numpy as np
import pytest
import torch

from raftsql_tpu.config import RaftConfig as JConfig
from raftsql_tpu.runtime.db import _expand_commit_item as j_expand
from raftsql_tpu.runtime.mesh import (MeshClusterNode as JMeshNode,
                                      MeshConfig as JMeshConfig,
                                      ShardedWAL as JShardedWAL)
from raftsql_tpu_torch.config import RaftConfig
from raftsql_tpu_torch.runtime.db import _expand_commit_item
from raftsql_tpu_torch.runtime.fused import FusedClusterNode
from raftsql_tpu_torch.runtime.mesh import (MeshClusterNode, MeshConfig,
                                            ShardedWAL)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def eight_slots(monkeypatch):
    monkeypatch.setenv("RAFTSQL_SHARD_SLOTS", "8")


def cfg_kw(num_peers=4, num_groups=8, seed=7, **kw):
    kw.setdefault("log_window", 32)
    kw.setdefault("max_entries_per_msg", 4)
    kw.setdefault("election_ticks", 10)
    kw.setdefault("heartbeat_ticks", 1)
    kw.setdefault("tick_interval_s", 0.0)
    return dict(num_groups=num_groups, num_peers=num_peers, seed=seed, **kw)


def cfg_for(**kw):
    return RaftConfig(**cfg_kw(**kw))


def drain(node, expand=_expand_commit_item, peer=0):
    out = []
    q = node.commit_q(peer)
    while True:
        try:
            item = q.get_nowait()
        except queue.Empty:
            break
        if isinstance(item, tuple):
            out.extend(expand(item))
    return out


def per_group(rows) -> dict:
    out = {}
    for g, i, d in rows:
        d = d.encode() if isinstance(d, str) else bytes(d)
        out.setdefault(int(g), []).append((int(i), d))
    return out


# -- MeshConfig ---------------------------------------------------------

def test_mesh_config_validation(monkeypatch):
    with pytest.raises(ValueError, match="positive"):
        MeshConfig(peer_shards=0, group_shards=4)
    mc = MeshConfig(peer_shards=2, group_shards=4)
    assert mc.total_devices == 8
    with pytest.raises(ValueError, match="not divisible"):
        mc.validate(cfg_for(num_peers=3, num_groups=8))
    with pytest.raises(ValueError, match="not divisible"):
        mc.validate(cfg_for(num_peers=4, num_groups=6))
    mc.validate(cfg_for(num_peers=4, num_groups=8))
    with pytest.raises(ValueError, match="devices"):
        MeshConfig(peer_shards=4, group_shards=4).build(device="cpu")
    assert mc.build(device="cpu").shape == {"peers": 2, "groups": 4}
    monkeypatch.delenv("RAFTSQL_SHARD_SLOTS")
    with pytest.raises(ValueError, match="devices"):
        mc.build(device="cpu")


def test_mesh_config_for_groups_picks_widest_divisor():
    # 8 slots, 12 groups: the widest divisor of 12 that fits is 6.
    mc = MeshConfig.for_groups(cfg_for(num_groups=12), device="cpu")
    assert mc.group_shards == 6 and mc.peer_shards == 1
    mc = MeshConfig.for_groups(cfg_for(num_groups=12), peer_shards=2,
                               device="cpu")
    assert mc.group_shards == 4 and mc.peer_shards == 2
    # The JAX package picks the same over its 8 forced host devices.
    jm = JMeshConfig.for_groups(JConfig(**cfg_kw(num_groups=12)))
    assert jm.group_shards == 6


# -- ShardedWAL ---------------------------------------------------------

def _append_same(w):
    w.append_ranges([0, 3, 6], [1, 1, 1], [2, 1, 1], [1, 1, 1],
                    [b"a", b"b", b"c", b"d"])
    w.set_hardstates(np.array([0, 3, 6]), np.array([1, 1, 1]),
                     np.array([0, 1, 2]), np.array([2, 1, 1]))
    w.sync()
    w.close()


def _files(root) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_sharded_wal_routes_and_replays(tmp_path):
    from raftsql_tpu_torch.storage.wal import WAL, wal_exists
    d = str(tmp_path / "p1")
    _append_same(ShardedWAL(d, num_shards=4, groups_per_shard=2))
    for j in (0, 1, 3):
        assert wal_exists(str(tmp_path / "p1" / f"s{j}"))
    assert WAL.replay(str(tmp_path / "p1" / "s2")) == {}
    s0 = WAL.replay(str(tmp_path / "p1" / "s0"))
    assert set(s0) == {0}
    assert [dt for (_, dt) in s0[0].entries] == [b"a", b"b"]
    merged = ShardedWAL.replay(d, 4, 2)
    assert set(merged) == {0, 3, 6}
    assert merged[3].hard.vote == 1
    assert [dt for (_, dt) in merged[6].entries] == [b"d"]
    # The JAX package's ShardedWAL writes the same bytes in every shard
    # dir for the same appends.
    jd = str(tmp_path / "jax" / "p1")
    _append_same(JShardedWAL(jd, num_shards=4, groups_per_shard=2))
    assert _files(d) == _files(jd)


def test_sharded_wal_refuses_reshard(tmp_path):
    d = str(tmp_path / "p1")
    w = ShardedWAL(d, num_shards=2, groups_per_shard=4)
    w.append_ranges([5], [1], [1], [1], [b"x"])   # shard 1 under gl=4
    w.sync()
    w.close()
    with pytest.raises(ValueError, match="different group-shard"):
        ShardedWAL.replay(d, 2, 2)   # gl=2 would put group 5 in shard 2


def test_sharded_wal_refuses_dispatch_framing(tmp_path):
    # The mesh runtime runs one step per dispatch, so no dispatch over
    # shards is epoch-framed; a framing call says so instead of writing
    # markers that no commit point across the shard dirs would close.
    w = ShardedWAL(str(tmp_path / "p0"), num_shards=2, groups_per_shard=2)
    with pytest.raises(NotImplementedError, match="one step per dispatch"):
        w.epoch_mark(1, end=False)
    w.close()


def test_mesh_node_refuses_reshard(tmp_path):
    cfg = cfg_for()
    node = MeshClusterNode(cfg, str(tmp_path),
                           MeshConfig(group_shards=4).build(device="cpu"))
    node.stop()
    with pytest.raises(ValueError, match="re-sharding"):
        MeshClusterNode(cfg, str(tmp_path),
                        MeshConfig(group_shards=2).build(device="cpu"))


# -- mesh <-> fused <-> JAX mesh equivalence ----------------------------

def _run_pair(tmp_path, ticks, membership=None, skew_windows=(),
              group_shards=4, peer_shards=1, num_peers=4):
    """Drive the port's FusedClusterNode, the port's MeshClusterNode and
    the JAX package's MeshClusterNode through the SAME seeded workload
    (and skew schedule); hard states, hints, publish cursors and each
    group's applied stream must be equal at every check."""
    # The port runs K1/K2's plain versions (commit_rule="pallas"); the
    # JAX package's Pallas call does not lower inside its shard_map on
    # the CPU, so its mesh runs the same rule as the windowed scan.
    cfg = cfg_for(num_peers=num_peers, commit_rule="pallas")
    jcfg = JConfig(**cfg_kw(num_peers=num_peers, commit_rule="windowed"))
    fused = FusedClusterNode(cfg, str(tmp_path / "fused"), seed=3,
                             device="cpu")
    meshn = MeshClusterNode(
        cfg, str(tmp_path / "mesh"), MeshConfig(
            peer_shards=peer_shards,
            group_shards=group_shards).build(device="cpu"), seed=3)
    jmesh = JMeshNode(jcfg, str(tmp_path / "jax"), JMeshConfig(
        peer_shards=peer_shards, group_shards=group_shards).build(),
        seed=3)
    nodes = (fused, meshn, jmesh)
    if membership is not None:
        for n in nodes:
            n.enable_membership(initial_voters=membership)
    rng = np.random.default_rng(0)
    seq = 0
    applied = [{}, {}, {}]
    try:
        for t in range(ticks):
            for g in range(cfg.num_groups):
                if rng.random() < 0.4:
                    payload = f"SET k{g} v{seq}".encode()
                    seq += 1
                    for n in nodes:
                        n.propose_many(g, [payload])
            ti = None
            for (s, e, incs) in skew_windows:
                if s <= t < e:
                    ti = np.asarray(incs, np.int32)
            for n in nodes:
                n.timer_inc = ti
                n.tick()
            if t % 20 == 19 or t == ticks - 1:
                for n in nodes:
                    n.publish_flush()
                for other, what in ((fused, "fused"), (jmesh, "JAX mesh")):
                    for attr in ("_hard", "_hints", "_applied"):
                        np.testing.assert_array_equal(
                            getattr(meshn, attr), getattr(other, attr),
                            err_msg=f"{attr} vs {what} at tick {t}")
                for k, (n, ex) in enumerate(((fused, _expand_commit_item),
                                             (meshn, _expand_commit_item),
                                             (jmesh, j_expand))):
                    for g, rows in per_group(drain(n, ex)).items():
                        applied[k].setdefault(g, []).extend(rows)
                assert applied[1] == applied[0], f"vs fused at tick {t}"
                assert applied[1] == applied[2], f"vs JAX mesh at tick {t}"
        assert (fused._hard[:, :, 2] > 0).any(), "nothing ever committed"
        assert applied[1], "no applied KV to compare"
    finally:
        for n in nodes:
            n.stop()
    return [r for rows in applied[1].values() for r in rows]


def test_mesh_fused_equivalence_full_voters(tmp_path):
    assert len(_run_pair(tmp_path, ticks=100)) > 20


def test_mesh_fused_equivalence_peer_sharded(tmp_path):
    # The peers x groups mesh: the message exchange is the block-copy
    # route; the host contract must not notice.
    assert _run_pair(tmp_path, ticks=80, group_shards=4, peer_shards=2)


def test_mesh_fused_equivalence_masked_membership(tmp_path):
    # A 3-of-4 voter config: every quorum runs mask-weighted (K2 per
    # shard under commit_rule="pallas").
    assert _run_pair(tmp_path, ticks=100, membership=(0, 1, 2))


def test_mesh_fused_equivalence_under_skew(tmp_path):
    windows = ((20, 50, (2, 0, 1, 1)), (60, 80, (1, 3, 1, 0)))
    assert _run_pair(tmp_path, ticks=100, skew_windows=windows)


# -- acked writes over the product stack --------------------------------

def test_mesh_acked_writes_sharded_groups(tmp_path):
    """RaftDB + FusedPipe over the mesh node, G split over 2 shards:
    propose -> sharded step -> per-shard WAL fsync -> publish workers
    -> SQLite apply -> ack."""
    from raftsql_tpu_torch.models.sqlite_sm import SQLiteStateMachine
    from raftsql_tpu_torch.runtime.db import RaftDB
    from raftsql_tpu_torch.runtime.fused import FusedPipe

    cfg = cfg_for(num_peers=3, num_groups=4)
    mesh = MeshConfig(group_shards=2).build(device="cpu")
    assert mesh.shape["groups"] >= 2
    node = MeshClusterNode(cfg, str(tmp_path / "data"), mesh)
    node.start(interval_s=0.001)
    rdb = RaftDB(lambda g: SQLiteStateMachine(":memory:"),
                 FusedPipe(node), num_groups=4)
    try:
        futs = [rdb.propose("CREATE TABLE t (k TEXT, v TEXT)", group=g)
                for g in range(4)]
        errs = [f.wait(30) for f in futs]
        futs = [rdb.propose(f"INSERT INTO t VALUES ('k', 'g{g}')",
                            group=g) for g in range(4)]
        errs += [f.wait(30) for f in futs]
        assert all(e is None for e in errs), errs
        for g in range(4):
            assert rdb.query("SELECT v FROM t WHERE k='k'",
                             group=g) == f"|g{g}|\n"
    finally:
        rdb.close()


# -- skew on the mesh ---------------------------------------------------

def test_mesh_skew_changes_elections(tmp_path):
    """Lockstep vs per-peer skew on the MESH runtime, same seed: the
    outcomes differ, so the split timer vector reaches every peer
    block's clocks; the skew counters export through NodeMetrics."""
    import dataclasses as dc

    from raftsql_tpu_torch.chaos.scenarios import MeshChaosRunner
    from raftsql_tpu_torch.chaos.schedule import generate_skew

    sk = generate_skew(0, ticks=120)
    lock = dc.replace(sk, skews=())
    rep_a = MeshChaosRunner(lock, str(tmp_path / "lock"),
                            device="cpu").run()
    rb = MeshChaosRunner(sk, str(tmp_path / "skew"), device="cpu")
    rep_b = rb.run()
    assert rep_b["skew_ticks"] > 0 and rep_a["skew_ticks"] == 0
    assert rep_a["result_digest"] != rep_b["result_digest"]
    assert rb.final_metrics.faults_skew_ticks == rep_b["skew_ticks"]


def test_mesh_skew_chaos_reproduces(tmp_path, monkeypatch):
    """The mesh_skew family (chaos.run) at seed 0: twice, identical, its
    faults fired, and its digests the fused skew family's (the JAX
    package's pinned seed-0 digests); below 2 group shards the runner
    refuses."""
    from raftsql_tpu_torch.chaos import run as trun
    from raftsql_tpu_torch.chaos.scenarios import MeshChaosRunner
    from raftsql_tpu_torch.chaos.schedule import generate_skew

    sk = generate_skew(4, ticks=100)
    r1 = MeshChaosRunner(sk, str(tmp_path / "a"), device="cpu").run()
    r2 = MeshChaosRunner(sk, str(tmp_path / "b"), device="cpu").run()
    assert (r1["schedule_digest"], r1["result_digest"]) \
        == (r2["schedule_digest"], r2["result_digest"])
    assert r1["skew_ticks"] > 0 and r1["crashes"] >= 1
    assert trun.run_matrix(0, only=["mesh_skew"], device="cpu",
                           commit_rule="pallas") == 0
    monkeypatch.setenv("RAFTSQL_SHARD_SLOTS", "1")
    with pytest.raises(RuntimeError, match="2 group shards"):
        MeshChaosRunner(sk, str(tmp_path / "c"), device="cpu")


def test_mesh_skew_matches_fused_chaos(tmp_path):
    """The SAME skew schedule through the port's fused and mesh runners
    and the JAX package's mesh runner gives one result digest."""
    from raftsql_tpu.chaos.scenarios import MeshChaosRunner as JRunner
    from raftsql_tpu.chaos.schedule import generate_skew as jgen
    from raftsql_tpu_torch.chaos.scenarios import (FusedChaosRunner,
                                                   MeshChaosRunner)
    from raftsql_tpu_torch.chaos.schedule import generate_skew

    sk = generate_skew(2, ticks=100)
    rf = FusedChaosRunner(sk, str(tmp_path / "fused"), device="cpu").run()
    rm = MeshChaosRunner(sk, str(tmp_path / "mesh"), device="cpu",
                         commit_rule="pallas").run()
    rj = JRunner(jgen(2, ticks=100), str(tmp_path / "jax")).run()
    assert rf["result_digest"] == rm["result_digest"] \
        == rj["result_digest"], (rf, rm, rj)
    assert rm["schedule_digest"] == rj["schedule_digest"]


# -- the CLI's mesh and pod flags ---------------------------------------

@pytest.mark.parametrize("argv,msg", [
    (["--mesh", "--witness", "2"], "not supported with --mesh"),
    (["--pod", "--write-quorum", "2"], "not supported with --pod"),
    (["--pod", "--mesh"], "its own deployment"),
    (["--pod", "--placement"], "not supported with --pod"),
    (["--pod", "--overload-cap", "8"], "require --fused or --mesh"),
    (["--placement"], "requires --fused or --mesh")])
def test_cli_mesh_and_pod_flag_checks(argv, msg, capsys):
    """--placement and the overload flags take --fused or --mesh, as in
    the JAX package; the pod and the mesh refuse quorum geometry."""
    from raftsql_tpu_torch.server.main import main
    with pytest.raises(SystemExit) as e:
        main(argv + ["--device", "cpu"])
    assert e.value.code != 0
    assert msg in capsys.readouterr().err


def test_mesh_server_node_with_placement(tmp_path, monkeypatch):
    """build_mesh_node (the --mesh deployment) serves SQL per group over
    4 shard slots with its SQLite files laid out per group shard, and
    the placement controller attaches to its host plane."""
    from raftsql_tpu_torch.server.main import (attach_placement,
                                               build_mesh_node)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("RAFTSQL_SHARD_SLOTS", "4")
    rdb = build_mesh_node(groups=8, group_shards=4, tick=0.002,
                          device="cpu")
    pc = attach_placement(rdb, interval_s=0.05)
    try:
        for g in (0, 7):
            assert rdb.propose("CREATE TABLE t (v text)",
                               group=g).wait(30) is None
        assert (tmp_path / "raftsql-mesh-db" / "s3" / "g7.db").exists()
        assert (tmp_path / "raftsql-mesh" / "p1" / "s3").is_dir()
        assert rdb.pipe.node._group_shard_of(7) == 3
    finally:
        pc.stop()
        rdb.close()


@pytest.mark.parametrize("argv", [
    ["--mesh", "--groups", "8"],
    ["--mesh", "--groups", "8", "--group-shards", "4"],
    ["--pod", "--groups", "8", "--group-shards", "2"]])
def test_cli_mesh_and_pod_need_the_card_by_default(argv, tmp_path,
                                                    monkeypatch):
    """--mesh and --pod step on cuda unless --device says otherwise;
    without a card they raise instead of falling back to the CPU."""
    from raftsql_tpu_torch.server.main import main
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        main(argv)
