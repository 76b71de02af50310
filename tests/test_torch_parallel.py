"""The port's sharded step (raftsql_tpu_torch/parallel/sharded.py, K7)
beside the port's unsharded step and the JAX package's sharded step.

The JAX side runs on the 8 forced host devices of tests/conftest.py;
the port's mesh takes 8 shard slots of the CPU.  The same seeded
proposals (and fault masks) go through all three each tick, and every
leaf must be equal: consensus state is int32 and bool, so equality is
exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as PS

from raftsql_tpu.config import RaftConfig as JConfig
from raftsql_tpu.core import cluster as jcluster
from raftsql_tpu.parallel import (make_mesh as jmake_mesh,
                                  make_sharded_cluster_run as jrun_fn,
                                  make_sharded_cluster_step as jstep_fn,
                                  shard_cluster_arrays as jshard)
from raftsql_tpu_torch.config import LEADER, RaftConfig as TConfig
from raftsql_tpu_torch.convert import to_numpy
from raftsql_tpu_torch.core import cluster as tcluster
from raftsql_tpu_torch.parallel import (make_mesh, make_sharded_cluster_run,
                                        make_sharded_cluster_step,
                                        make_sharded_cluster_step_host,
                                        shard, shard_cluster_arrays)
from raftsql_tpu_torch.parallel.sharded import inbox_specs

torch.set_num_threads(1)
CPU8 = [torch.device("cpu")] * 8


def cfg_kw(num_peers, num_groups, seed=42):
    return dict(num_groups=num_groups, num_peers=num_peers, log_window=32,
                max_entries_per_msg=4, election_ticks=10,
                heartbeat_ticks=1, seed=seed, commit_rule="pallas")


def cfgs(num_peers, num_groups, seed=42):
    """(JAX config, port config).  The port steps commit_rule="pallas"
    (K1's plain version on the CPU); the JAX package's Pallas call does
    not lower inside its shard_map on the CPU, so its side runs the
    same rule as the windowed scan ("windowed", K1's reference)."""
    kw = cfg_kw(num_peers, num_groups, seed)
    return JConfig(**dict(kw, commit_rule="windowed")), TConfig(**kw)


def boot(tcfg):
    return (tcluster.init_cluster_state(tcfg, device="cpu"),
            tcluster.empty_cluster_inbox(tcfg, device="cpu"))


def jax_np(tree) -> dict:
    return {n: np.asarray(getattr(tree, n)) for n in tree._fields}


def assert_equal(a: dict, b: dict, msg):
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{msg}: {k}")


@pytest.mark.parametrize("pp,gg,P,G", [(1, 8, 3, 16), (2, 4, 4, 8)])
def test_sharded_step_matches_unsharded(pp, gg, P, G):
    jcfg, tcfg = cfgs(P, G)
    mesh = make_mesh(pp, gg, devices=CPU8)
    step = make_sharded_cluster_step(tcfg, mesh)
    jmesh = jmake_mesh(pp, gg)
    jstep = jstep_fn(jcfg, jmesh)
    rs, ri = boot(tcfg)
    ss, si = shard_cluster_arrays(mesh, *boot(tcfg))
    js, ji = jshard(jmesh, jcluster.init_cluster_state(jcfg),
                    jcluster.empty_cluster_inbox(jcfg))
    spec = NamedSharding(jmesh, PS("peers", "groups"))
    rng = np.random.default_rng(0)
    for t in range(60):
        props = rng.integers(0, 2, (P, G)).astype(np.int32)
        rs, ri, rinfo = tcluster.cluster_step(tcfg, rs, ri,
                                              torch.from_numpy(props))
        ss, si, sinfo = step(ss, si, torch.from_numpy(props))
        js, ji, jinfo = jstep(js, ji,
                              jax.device_put(jnp.asarray(props), spec))
        for name, ref, got, jref in (
                ("state", rs, ss, js), ("inbox", ri, si, ji),
                ("info", rinfo, sinfo, jinfo)):
            g = to_numpy(got.gather())
            assert_equal(to_numpy(ref), g, f"{name} vs unsharded @{t}")
            assert_equal(jax_np(jref), g, f"{name} vs JAX sharded @{t}")
    assert int((rs.role == LEADER).sum()) >= G


def test_sharded_run_commits_advance():
    P, G, ticks = 4, 8, 150
    jcfg, tcfg = cfgs(P, G, seed=5)
    mesh = make_mesh(2, 4, devices=CPU8)
    run = make_sharded_cluster_run(tcfg, mesh, ticks)
    # 1 entry per group per tick at every peer; non-leaders reject.
    props = np.ones((ticks, P, G), np.int32)
    st, ib, total = run(*shard_cluster_arrays(mesh, *boot(tcfg)), props)
    role = st.gather().role.numpy()
    assert (np.sum(role == LEADER, axis=0) >= 1).all()
    commit = st.gather().commit.numpy().max(axis=0)
    assert (commit >= 1).all(), commit
    assert int(total) == int(np.sum(commit))
    jmesh = jmake_mesh(2, 4)
    js, ji = jshard(jmesh, jcluster.init_cluster_state(jcfg),
                    jcluster.empty_cluster_inbox(jcfg))
    jprops = jax.device_put(jnp.asarray(props), NamedSharding(
        jmesh, PS(None, "peers", "groups")))
    js, ji, jtotal = jrun_fn(jcfg, jmesh, ticks)(js, ji, jprops)
    assert int(total) == int(jtotal)
    assert_equal(jax_np(js), to_numpy(st.gather()), "run vs JAX")


def test_sharded_soak_faults_matches_unsharded():
    """The 160-tick soak on the peers x groups mesh: 5 % random message
    loss plus a 40-tick isolation of peer 0, masked at the delivery
    boundary; the port's sharded run must equal its unsharded run and
    the JAX package's sharded run, elect, commit and recover."""
    P, G = 4, 8
    jcfg, tcfg = cfgs(P, G, seed=11)
    mesh = make_mesh(2, 4, devices=CPU8)
    step = make_sharded_cluster_step(tcfg, mesh)
    jmesh = jmake_mesh(2, 4)
    jstep = jstep_fn(jcfg, jmesh)
    spec3 = NamedSharding(jmesh, PS("peers", "groups", None))
    spec2 = NamedSharding(jmesh, PS("peers", "groups"))
    rs, ri = boot(tcfg)
    ss, si = shard_cluster_arrays(mesh, *boot(tcfg))
    js, ji = jshard(jmesh, jcluster.init_cluster_state(jcfg),
                    jcluster.empty_cluster_inbox(jcfg))
    rng = np.random.default_rng(7)
    ticks, part_from, part_to = 160, 60, 100
    commit_at_heal = None

    def masked(ib, keep):
        return ib._replace(v_type=ib.v_type * keep, a_type=ib.a_type * keep)

    for t in range(ticks):
        drop = rng.random((P, G, P)) < 0.05
        if part_from <= t < part_to:
            drop[0, :, :] = True
            drop[:, :, 0] = True
        keep = (~drop).astype(np.int32)
        props = rng.integers(0, 2, (P, G)).astype(np.int32)
        tk, tp = torch.from_numpy(keep), torch.from_numpy(props)
        rs, ri, _ = tcluster.cluster_step(tcfg, rs, masked(ri, tk), tp)
        si = shard(mesh, masked(si.gather(), tk), inbox_specs())
        ss, si, _ = step(ss, si, tp)
        js, ji, _ = jstep(js, masked(ji, jax.device_put(
            jnp.asarray(keep), spec3)), jax.device_put(jnp.asarray(props),
                                                        spec2))
        if t == part_to:
            commit_at_heal = rs.commit.numpy().max(axis=0)
        if t % 40 == 39:
            np.testing.assert_array_equal(
                ss.gather().commit.numpy(), rs.commit.numpy(),
                err_msg=f"commit diverged at tick {t}")
    final = to_numpy(ss.gather())
    assert_equal(to_numpy(rs), final, "final state vs unsharded")
    assert_equal(jax_np(js), final, "final state vs JAX sharded")
    commit = rs.commit.numpy().max(axis=0)
    assert (commit >= 1).all(), commit
    assert (commit > commit_at_heal).all(), (commit_at_heal, commit)


def test_mesh_divisibility_validation():
    mesh = make_mesh(2, 4, devices=CPU8)
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_cluster_step(TConfig(**cfg_kw(3, 8)), mesh)
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_cluster_step(TConfig(**cfg_kw(4, 6)), mesh)
    with pytest.raises(ValueError, match="devices"):
        make_mesh(2, 4, device="cpu")        # one shard slot by default


def test_shard_slots_count_each_device(monkeypatch):
    """RAFTSQL_SHARD_SLOTS counts each visible device as N slots (the
    JAX tests' forced host devices); the default is one; a CUDA mesh
    without a card raises."""
    from raftsql_tpu_torch.parallel import shard_slots
    assert shard_slots("cpu") == [torch.device("cpu")]
    monkeypatch.setenv("RAFTSQL_SHARD_SLOTS", "8")
    assert shard_slots("cpu") == CPU8
    assert make_mesh(2, 4, device="cpu").shape == {"peers": 2,
                                                   "groups": 4}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh(1, 1)


def _lockstep_host(mesh, tcfg, ticks=40):
    """`ticks` host-info steps with seeded proposals and skew; returns
    every packed info and the final gathered state."""
    step = make_sharded_cluster_step_host(tcfg, mesh)
    st, ib = shard_cluster_arrays(mesh, *boot(tcfg))
    rng = np.random.default_rng(3)
    infos = []
    for t in range(ticks):
        props = rng.integers(0, 2, (tcfg.num_peers, tcfg.num_groups))
        ti = rng.integers(0, 3, (tcfg.num_peers,))
        st, ib, pinfo, busy = step(st, ib, props.astype(np.int32),
                                   ti.astype(np.int32))
        infos.append((pinfo.numpy().copy(), bool(busy)))
    return infos, to_numpy(st.gather())


@pytest.mark.parametrize("layout", ["shared_device", "own_slots"])
def test_shard_layout_is_an_execution_detail(layout, monkeypatch):
    """Shards sharing one device (an explicit device list that repeats
    each device) and every shard on its own shard slot
    (RAFTSQL_SHARD_SLOTS) step bit-identically, and equal the fused
    host step on the concatenated state, packed info and busy bit
    included."""
    _, tcfg = cfgs(4, 8)
    if layout == "shared_device":
        devs = [torch.device("cpu")] * 4
        mesh = make_mesh(2, 4, devices=[devs[k // 2] for k in range(8)])
    else:
        monkeypatch.setenv("RAFTSQL_SHARD_SLOTS", "8")
        mesh = make_mesh(2, 4, device="cpu")
    infos, final = _lockstep_host(mesh, tcfg)
    rs, ri = boot(tcfg)
    rng = np.random.default_rng(3)
    for t, (pinfo, busy) in enumerate(infos):
        props = rng.integers(0, 2, (4, 8)).astype(np.int32)
        ti = rng.integers(0, 3, (4,)).astype(np.int32)
        rs, ri, rinfo, rbusy = tcluster.cluster_step_host(
            tcfg, rs, ri, torch.from_numpy(props), torch.from_numpy(ti))
        np.testing.assert_array_equal(pinfo, rinfo.numpy(), err_msg=str(t))
        assert busy == bool(rbusy), t
    assert_equal(to_numpy(rs), final, layout)


@pytest.mark.cuda
def test_shard_layout_on_the_card():
    """On the card: eight shards sharing it step bit-identically to the
    same ticks on the CPU's shard slots."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available())")
    _, tcfg = cfgs(4, 8)
    card = _lockstep_host(make_mesh(2, 4, devices=[torch.device("cuda")] * 8),
                          tcfg)
    cpu = _lockstep_host(make_mesh(2, 4, devices=CPU8), tcfg)
    for (a, ba), (b, bb) in zip(card[0], cpu[0]):
        np.testing.assert_array_equal(a, b)
        assert ba == bb
    assert_equal(card[1], cpu[1], "card vs CPU")


def test_mesh_cluster_node_durable(tmp_path):
    """MeshClusterNode: the sharded step under the full durable host
    plane (per-peer WAL split per group shard, mirroring, publish):
    commits flow, every shard dir of every peer holds WAL segments, and
    a restart replays them over the same mesh."""
    from raftsql_tpu_torch.runtime.db import _expand_commit_item
    from raftsql_tpu_torch.runtime.mesh import MeshClusterNode

    cfg = TConfig(num_groups=8, num_peers=4, log_window=32,
                  max_entries_per_msg=4, tick_interval_s=0.0)
    mesh = make_mesh(2, 4, devices=CPU8)

    def drain(node, peer=0):
        out = []
        q = node.commit_q(peer)
        while not q.empty():
            item = q.get_nowait()
            if isinstance(item, tuple):
                out.extend(_expand_commit_item(item))
        return out

    node = MeshClusterNode(cfg, str(tmp_path), mesh)
    for t in range(200):
        node.tick()
        if t > 10 and (node._hints >= 0).all():
            break
    assert (node._hints >= 0).all()
    for g in range(8):
        node.propose_many(g, [f"SET k{i} g{g}".encode() for i in range(5)])
    for _ in range(40):
        node.tick()
    node.publish_flush()
    live = drain(node)
    assert len(live) == 8 * 5
    assert all(w.is_native for w in node.wals)
    node.stop()
    for p in range(4):
        for j in range(4):
            segs = list((tmp_path / f"p{p + 1}" / f"s{j}").glob("wal-*"))
            assert segs, f"peer {p} shard {j} wrote no WAL"
    node2 = MeshClusterNode(cfg, str(tmp_path), mesh)
    rep = drain(node2)
    assert sorted(rep) == sorted(live)
    node2.stop()
