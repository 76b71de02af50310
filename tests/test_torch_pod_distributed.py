"""The pod's one program over hosts (raftsql_tpu_torch/pod/config.py
`PodConfig.init_distributed`, parallel/sharded.py
`make_distributed_cluster_step_host`) on the CPU, over gloo.

  * the process group: two processes form it through init_distributed;
    NCCL without a card raises; its rendezvous is not the address the
    pod transport binds;
  * the distributed step, two and three ranks, 48 ticks of seeded
    proposals and a skewed timer advance: every tick's packed info,
    busy bit, timer margin and ring counts, and the final owned blocks,
    equal the single-process sharded step, the fused step on the
    concatenated state and the JAX package's sharded step, leaf for
    leaf;
  * `pod.dryrun --mode equiv` under RAFTSQL_POD_JAX_DISTRIBUTED=1: its
    digest is the replicated pod's, the in-process procs == 1 run's and
    the JAX pod's;
  * the node under the opt-in: one rank equals the replicated pod (trace
    ring rows, roles, membership and transfer patches included); two
    ranks answer roles() and status() off the tick thread and complete
    a transfer; two `--pod` servers serve and read back every acked PUT.

Spawned processes run this file as a script (`_worker`); each has its
own timeout.  All consensus state is int32 or bool: equality is exact.
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SELF = os.path.abspath(__file__)
DIST_ENV = "RAFTSQL_POD_JAX_DISTRIBUTED"

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def eight_slots(monkeypatch):
    monkeypatch.setenv("RAFTSQL_SHARD_SLOTS", "8")
    monkeypatch.delenv(DIST_ENV, raising=False)


def _cfg_kw(P, G):
    return dict(num_groups=G, num_peers=P, log_window=32,
                max_entries_per_msg=4, election_ticks=10,
                heartbeat_ticks=1, seed=42, commit_rule="pallas")


def _coord() -> str:
    """A localhost coordinator address whose port and the port above it
    (the process group's rendezvous) are both free."""
    for _ in range(64):
        a = socket.socket()
        a.bind(("127.0.0.1", 0))
        port = a.getsockname()[1]
        b = socket.socket()
        try:
            b.bind(("127.0.0.1", port + 1))
        except OSError:
            continue
        finally:
            a.close()
            b.close()
        return f"127.0.0.1:{port}"
    raise RuntimeError("no free pair of ports")


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", RAFTSQL_SHARD_SLOTS="8")
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop(DIST_ENV, None)
    env.update(extra)
    return env


def _spawn_ranks(mode, procs, coord, out_dir, extra=(), timeout=120):
    """Run `procs` worker processes of this file; returns their logs."""
    ps = [subprocess.Popen(
        [sys.executable, SELF, mode, str(procs), str(r), coord,
         str(out_dir), *extra],
        env=_env(), cwd=REPO_ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(procs)]
    logs = []
    try:
        for p in ps:
            logs.append(p.communicate(timeout=timeout)[0].decode(
                errors="replace"))
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(ps):
        assert p.returncode == 0, f"rank {r}:\n{logs[r]}"
    return logs


# -- the process group --------------------------------------------------


def test_distributed_address_rule():
    """The rendezvous is a pure function of the config, one port above
    the coordinator's (which TcpPodTransport binds)."""
    from raftsql_tpu_torch.pod import PodConfig
    a = PodConfig(procs=3, proc_id=1, coordinator="10.0.0.5:7000")
    b = PodConfig(procs=3, proc_id=2, coordinator="10.0.0.5:7000")
    assert a.distributed_address() == b.distributed_address() \
        == "tcp://10.0.0.5:7001"
    assert a.distributed_address() != f"tcp://{a.coordinator}"
    with pytest.raises(ValueError, match="coordinator"):
        PodConfig().distributed_address()


def test_nccl_without_a_card_raises():
    """NCCL needs a card; nothing falls back to gloo or to the CPU."""
    import torch.distributed as dist

    from raftsql_tpu_torch.pod import PodConfig
    pod = PodConfig(procs=1, coordinator=_coord())
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="NCCL"):
        pod.init_distributed(device="cpu", backend="nccl")
    with pytest.raises(RuntimeError, match="NCCL"):
        pod.init_distributed(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        pod.init_distributed(device="cuda", backend="gloo")
    with pytest.raises(ValueError, match="backend"):
        pod.init_distributed(device="cpu", backend="mpi")
    assert not dist.is_initialized()


def test_two_processes_form_the_group(tmp_path):
    """Two processes join through init_distributed (gloo on the CPU),
    all-gather their ranks, and leave the group."""
    coord = _coord()
    _spawn_ranks("group", 2, coord, tmp_path, timeout=90)
    docs = [json.loads((tmp_path / f"group{r}.json").read_text())
            for r in range(2)]
    for r, d in enumerate(docs):
        assert d == {"backend": "gloo", "world": 2, "rank": r,
                     "gathered": [[0, 0], [1, 10]],
                     "address": "tcp://127.0.0.1:%d"
                                % (int(coord.rsplit(":", 1)[1]) + 1),
                     "left": True}


def test_rank_group_refuses_bad_owners(tmp_path):
    """A one-rank group in this process: owners must name its ranks;
    rank_group must match the pod's shape; the peer axis is refused."""
    import torch.distributed as dist

    from raftsql_tpu_torch.config import RaftConfig
    from raftsql_tpu_torch.parallel import (RankGroup, make_mesh,
                                            make_distributed_cluster_step_host)
    from raftsql_tpu_torch.pod import PodConfig
    from raftsql_tpu_torch.runtime.mesh import MeshClusterNode
    pod = PodConfig(procs=1, coordinator=_coord())
    assert pod.init_distributed(device="cpu") == "gloo"
    try:
        with pytest.raises(RuntimeError, match="already"):
            pod.init_distributed(device="cpu")
        with pytest.raises(ValueError, match="owners"):
            RankGroup([0, 1])
        with pytest.raises(ValueError, match="pod host"):
            PodConfig(procs=2, proc_id=1, coordinator="h:1").rank_group(2)
        ranks = pod.rank_group(2)
        assert ranks.owned == [0, 1] and ranks.procs == 1
        cfg = RaftConfig(**_cfg_kw(4, 8))
        mesh = make_mesh(2, 2, devices=[torch.device("cpu")] * 4)
        with pytest.raises(ValueError, match="peer shards"):
            make_distributed_cluster_step_host(cfg, mesh, ranks)
        with pytest.raises(ValueError, match="peer shards"):
            MeshClusterNode(cfg, str(tmp_path), mesh, ranks=ranks)
    finally:
        PodConfig.destroy_distributed()
    assert not dist.is_initialized()


# -- the distributed step against its three references ------------------


def _seeded_inputs(P, G, ticks):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(ticks):
        props = rng.integers(0, 2, (P, G)).astype(np.int32)
        ti = rng.integers(0, 3, (P,)).astype(np.int32)
        out.append((props, ti))
    return out


@pytest.mark.parametrize("procs,gg,G", [(2, 5, 20), (3, 6, 24)])
def test_distributed_step_matches_references(tmp_path, procs, gg, G):
    """Every rank's per-tick packed info, busy bit, timer margin and
    ring counts, and its final owned blocks, equal the single-process
    sharded host step, the fused host step on the concatenated state
    and the JAX package's sharded host step (two ranks own 3 and 2 of
    5 shards: the gather pads the short rank)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as PS

    from raftsql_tpu.config import RaftConfig as JConfig
    from raftsql_tpu.core import cluster as jcluster
    from raftsql_tpu.parallel import make_mesh as jmake_mesh
    from raftsql_tpu.parallel import shard_cluster_arrays as jshard
    from raftsql_tpu.parallel.sharded import (
        make_sharded_cluster_step_host as jstep_fn)
    from raftsql_tpu_torch.config import RaftConfig
    from raftsql_tpu_torch.convert import to_numpy
    from raftsql_tpu_torch.core import cluster as tcluster
    from raftsql_tpu_torch.parallel import (make_mesh,
                                            make_sharded_cluster_step_host,
                                            shard_cluster_arrays)
    from raftsql_tpu_torch.parallel.sharded import (make_sharded_step_fn,
                                                    ring_counts)
    P, ticks = 3, 48
    _spawn_ranks("step", procs, _coord(), tmp_path, extra=(str(gg), str(G),
                                                           str(ticks)))
    got = [np.load(tmp_path / f"step{r}.npz") for r in range(procs)]

    cfg = RaftConfig(**_cfg_kw(P, G))
    jcfg = JConfig(**dict(_cfg_kw(P, G), commit_rule="windowed"))
    mesh = make_mesh(1, gg, devices=[torch.device("cpu")] * gg)
    host = make_sharded_cluster_step_host(cfg, mesh)
    blocks_fn = make_sharded_step_fn(cfg, mesh)
    boot = (tcluster.init_cluster_state(cfg, device="cpu"),
            tcluster.empty_cluster_inbox(cfg, device="cpu"))
    ss, si = shard_cluster_arrays(mesh, *boot)
    bs, bi = shard_cluster_arrays(mesh, *boot)
    rs, ri = (tcluster.init_cluster_state(cfg, device="cpu"),
              tcluster.empty_cluster_inbox(cfg, device="cpu"))
    jmesh = jmake_mesh(1, gg)
    jstep = jstep_fn(jcfg, jmesh)
    js, ji = jshard(jmesh, jcluster.init_cluster_state(jcfg),
                    jcluster.empty_cluster_inbox(jcfg))
    spec2 = NamedSharding(jmesh, PS("peers", "groups"))
    spec1 = NamedSharding(jmesh, PS("peers"))
    for t, (props, ti) in enumerate(_seeded_inputs(P, G, ticks)):
        ss, si, pinfo, busy = host(ss, si, props, ti)
        blk = [[torch.from_numpy(props[:, j * (G // gg):(j + 1) * (G // gg)])
                for j in range(gg)]]
        bs_b, bi_b, binfo = blocks_fn(bs.blocks, bi.blocks, blk,
                                      [[torch.from_numpy(ti)] * gg])
        bs.blocks, bi.blocks = bs_b, bi_b
        rs, ri, rinfo, rbusy = tcluster.cluster_step_host(
            cfg, rs, ri, torch.from_numpy(props), torch.from_numpy(ti))
        js, ji, jinfo, jbusy = jstep(js, ji,
                                     jax.device_put(jnp.asarray(props),
                                                    spec2),
                                     jax.device_put(jnp.asarray(ti), spec1))
        want = pinfo.numpy()
        np.testing.assert_array_equal(want, rinfo.numpy(), err_msg=str(t))
        np.testing.assert_array_equal(want, np.asarray(jinfo),
                                      err_msg=str(t))
        assert bool(busy) == bool(rbusy) == bool(jbusy), t
        counts = ring_counts(si.gather(), ss.gather()).numpy()
        margin = binfo[0][0].timer_margin.numpy()
        for r in range(procs):
            np.testing.assert_array_equal(got[r]["info"][t], want,
                                          err_msg=f"rank {r} tick {t}")
            assert bool(got[r]["busy"][t]) == bool(busy), (r, t)
            np.testing.assert_array_equal(got[r]["margin"][t], margin)
            np.testing.assert_array_equal(got[r]["counts"][t], counts)
    final = {"st": to_numpy(ss.gather()), "ib": to_numpy(si.gather())}
    jfinal = {n: np.asarray(getattr(js, n)) for n in js._fields}
    rfinal = to_numpy(rs)
    gl = G // gg
    seen = set()
    for r in range(procs):
        owned = [int(j) for j in got[r]["owned"]]
        assert owned == [j for j in range(gg) if j % procs == r]
        seen.update(owned)
        for j in owned:
            for kind in ("st", "ib"):
                for name, leaf in final[kind].items():
                    # rng and tick split over peers only: whole on a rank
                    part = leaf[:, j * gl:(j + 1) * gl] \
                        if name not in ("rng", "tick") else leaf
                    np.testing.assert_array_equal(
                        got[r][f"{kind}_{j}_{name}"], part,
                        err_msg=f"rank {r} shard {j} {kind}.{name}")
                    if kind == "st" and name not in ("rng", "tick"):
                        np.testing.assert_array_equal(
                            rfinal[name][:, j * gl:(j + 1) * gl], part)
                        np.testing.assert_array_equal(
                            jfinal[name][:, j * gl:(j + 1) * gl], part)
                    elif kind == "st":
                        np.testing.assert_array_equal(rfinal[name], part)
                        np.testing.assert_array_equal(jfinal[name], part)
    assert seen == set(range(gg))
    assert int((rfinal["role"] == 2).sum()) >= G


# -- the dry-run rung under the opt-in ----------------------------------


def _dryrun_pair(tmp_path, tag, dist):
    coord = _coord()
    extra = {DIST_ENV: "1"} if dist else {}
    return [subprocess.Popen(
        [sys.executable, "-m", "raftsql_tpu_torch.pod.dryrun",
         "--procs", "2", "--proc-id", str(i), "--coord", coord,
         "--data-dir", str(tmp_path / f"{tag}{i}"), "--ticks", "60",
         "--seed", "0", "--device", "cpu",
         "--out", str(tmp_path / f"{tag}{i}.json")],
        env=_env(**extra), cwd=REPO_ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for i in range(2)]


def test_dryrun_equiv_under_the_opt_in(tmp_path):
    """Two dry-run processes with RAFTSQL_POD_JAX_DISTRIBUTED=1 (each
    steps 4 of the 8 group shards): their dumps' digest equals the
    replicated pair's, the in-process procs == 1 run's and the JAX
    package's procs == 1 pod's; each host wrote only its own shards."""
    from raftsql_tpu.pod.dryrun import build_pod_node as jbuild
    from raftsql_tpu.pod.dryrun import state_doc as jstate_doc
    from raftsql_tpu.runtime.db import _expand_commit_item as j_expand
    from raftsql_tpu_torch.pod.dryrun import (build_pod_node, drain_commits,
                                              seeded_workload, state_doc)
    procs = _dryrun_pair(tmp_path, "d", True) \
        + _dryrun_pair(tmp_path, "r", False)

    class _A:
        procs = 1
        proc_id = 0
        coord = ""
        groups = 8
        peers = 3
        group_shards = 0
        connect_timeout = 30.0
        device = "cpu"

    refs = []
    try:
        for build, state, tag in ((build_pod_node, state_doc, "ref"),
                                  (jbuild, jstate_doc, "jax")):
            _A.data_dir = str(tmp_path / tag)
            node, cfg = build(_A)
            applied = []
            try:
                wl = seeded_workload(0, 60, cfg.num_groups)
                for t in range(60):
                    for _i, g, payload in wl[t]:
                        node.pod_propose(g, [payload])
                    node.tick()
                    if tag == "jax":
                        import queue
                        q = node.commit_q(0)
                        while True:
                            try:
                                item = q.get_nowait()
                            except queue.Empty:
                                break
                            if isinstance(item, tuple):
                                applied.extend(j_expand(item))
                    else:
                        applied.extend(drain_commits(node))
                refs.append(state(node, applied))
            finally:
                node.stop()
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, p in enumerate(procs):
        assert p.returncode == 0, logs[i].decode(errors="replace")
    docs = {tag: [json.loads((tmp_path / f"{tag}{i}.json").read_text())
                  for i in range(2)] for tag in ("d", "r")}
    digests = [d["digest"] for tag in ("d", "r") for d in docs[tag]]
    assert digests == [refs[0]["digest"]] * 4
    assert refs[1]["digest"] == refs[0]["digest"]
    assert docs["d"][0]["kv_stream"] == refs[1]["kv_stream"]
    assert len(refs[0]["kv_stream"]) > 0
    owned = [sorted(x.name for x in (tmp_path / f"d{i}" / "p1").iterdir())
             for i in range(2)]
    assert owned == [["s0", "s2", "s4", "s6"], ["s1", "s3", "s5", "s7"]]


# -- the node under the opt-in ------------------------------------------


def _drive_pair(dist_node, ref, ticks, wl, act=None):
    from raftsql_tpu_torch.pod.dryrun import drain_commits
    applied = [[], []]
    for t in range(ticks):
        if act is not None:
            act(t)
        for _i, g, payload in wl[t]:
            dist_node.pod_propose(g, [payload])
            ref.pod_propose(g, [payload])
        for k, n in enumerate((dist_node, ref)):
            n.tick()
            applied[k].extend(drain_commits(n))
    return applied


def test_one_rank_program_equals_the_replicated_pod(tmp_path):
    """A one-rank process group (every shard owned) through the whole
    pod node equals the replicated pod: state dumps, trace ring rows
    (served from the gathered counts), roles(), and the membership and
    transfer patches written into the owned blocks."""
    from raftsql_tpu_torch.config import RaftConfig
    from raftsql_tpu_torch.pod import PodClusterNode, PodConfig
    from raftsql_tpu_torch.pod.dryrun import seeded_workload, state_doc
    from raftsql_tpu_torch.runtime.mesh import MeshConfig
    cfg = RaftConfig(num_groups=8, num_peers=3, log_window=32,
                     max_entries_per_msg=4, election_ticks=10,
                     heartbeat_ticks=1, tick_interval_s=0.0, seed=7,
                     commit_rule="pallas")
    pod = PodConfig(procs=1, coordinator=_coord())
    pod.init_distributed(device="cpu")
    mc = MeshConfig(group_shards=4)
    try:
        node = PodClusterNode(pod, cfg, str(tmp_path / "d"),
                              mc.build(device="cpu", owned=[0, 1, 2, 3]),
                              seed=3, distributed=True)
    except BaseException:
        PodConfig.destroy_distributed()
        raise
    ref = PodClusterNode(PodConfig(), cfg, str(tmp_path / "r"),
                         mc.build(device="cpu"), seed=3)
    try:
        for n in (node, ref):
            n.enable_tracing(ring_depth=8)
            n.enable_membership()
        with pytest.raises(RuntimeError, match="owned group shards"):
            node.states
        np.testing.assert_array_equal(node.roles(), ref.roles())
        wl = seeded_workload(0, 60, 8)

        def act(t):
            if t == 30:
                for n in (node, ref):
                    lead = int(n._hints[5])
                    n.transfer_leadership(5, (lead + 1) % 3)
            if t == 40:
                for n in (node, ref):
                    n.member_change(2, "remove", 2)

        applied = _drive_pair(node, ref, 60, wl, act)
        for n in (node, ref):
            n.publish_flush()
            n.ring.drain()
        a, b = state_doc(node, applied[0]), state_doc(ref, applied[1])
        assert a["digest"] == b["digest"]
        np.testing.assert_array_equal(node.roles(), ref.roles())
        assert node.ring.rows() == ref.ring.rows()
        assert node.metrics.transfers_completed \
            == ref.metrics.transfers_completed == 1
        assert node.members_doc() == ref.members_doc()
        assert node.members_doc()["groups"]["2"] \
            != node.members_doc()["groups"]["1"]
        doc = node.pod_doc()
        assert doc["distributed"] is True and doc["dist_backend"] == "gloo"
        assert doc["dist_gathers"] == 60
        assert "distributed" not in ref.pod_doc()
    finally:
        ref.stop()
        node.stop()
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_two_ranks_serve_host_readers_off_the_tick_thread(tmp_path):
    """Two ranks with their tick threads running: roles() and status()
    answer from the main thread while the pod ticks (no collective
    there), a transfer on an owned group completes (its owner patches
    its own block), and both ranks end with the same hard states."""
    _spawn_ranks("node", 2, _coord(), tmp_path, timeout=120)
    docs = [json.loads((tmp_path / f"node{r}.json").read_text())
            for r in range(2)]
    for d in docs:
        assert d["reads"] >= 20 and d["leaders_seen"]
        assert d["distributed"] is True
    assert docs[0]["hard"] == docs[1]["hard"]
    assert docs[0]["roles"] == docs[1]["roles"]
    assert docs[1]["transfer"] == "completed"


def test_pod_servers_under_the_opt_in(tmp_path):
    """Two `server.main --pod` processes with RAFTSQL_POD_JAX_DISTRIBUTED
    =1 (each steps its own group shard): /healthz answers while the pod
    ticks and names the process group, writes through host 0 follow the
    421 to the owner, every acked PUT reads back, and /metrics counts
    the collectives."""
    from raftsql_tpu_torch.api.client import RaftSQLClient
    from raftsql_tpu_torch.server.main import EXIT_CODE_FATAL
    deadline = 120.0
    s0, s1 = socket.socket(), socket.socket()
    s0.bind(("127.0.0.1", 0))
    s1.bind(("127.0.0.1", 0))
    p0, p1 = s0.getsockname()[1], s1.getsockname()[1]
    s0.close()
    s1.close()
    coord = _coord()
    hosts = f"127.0.0.1:{p0},127.0.0.1:{p1}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "raftsql_tpu_torch.server.main",
         "--pod", "--pod-id", str(i), "--pod-coord", coord,
         "--pod-hosts", hosts, "--port", str(p), "--groups", "4",
         "--group-shards", "2", "--peers", "3", "--tick", "0.02",
         "--device", "cpu"],
        env=_env(**{DIST_ENV: "1", "RAFTSQL_SHARD_SLOTS": "1"}),
        cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for i, p in enumerate((p0, p1))]
    cli = RaftSQLClient([f"127.0.0.1:{p0}"], timeout_s=15.0)
    try:
        cli.wait_healthy(0, deadline_s=deadline)
        doc = cli.health(0)
        assert doc["pod"]["distributed"] is True
        assert doc["pod"]["dist_backend"] == "gloo"
        assert doc["pod"]["owned_shards"] == [0]
        until = time.monotonic() + deadline
        while cli.refresh_hints(timeout_s=5.0) != 4:
            assert time.monotonic() < until, "pod hints"
            time.sleep(0.2)
        acked = []
        for g in range(4):
            cli.put("CREATE TABLE t (v text)", group=g, deadline_s=deadline)
            for k in range(3):
                cli.put(f"INSERT INTO t (v) VALUES ('g{g}k{k}')", group=g,
                        deadline_s=deadline)
                acked.append((g, f"g{g}k{k}"))
        for g in range(4):
            want = "".join(f"|{v}|\n" for gg, v in acked if gg == g)
            cli.get_until("SELECT v FROM t ORDER BY v", want, group=g,
                          deadline_s=deadline)
        status, hdrs, _ = cli.raw(
            0, "PUT", "/", "INSERT INTO t (v) VALUES ('y')",
            headers={"X-Raft-Group": "2"})
        assert (status, hdrs.get("X-Raft-Leader")) == (421, "2")
        for i in range(2):
            m = json.loads(cli.raw(i, "GET", "/metrics")[2])
            h = cli.health(i)
            assert h["pod"]["dist_gathers"] > 0
            assert m["pod"]["gathers"] > 0
    except BaseException:
        for p in procs:
            p.terminate()
        for i, p in enumerate(procs):
            print(f"--- pod host {i} ---\n"
                  + p.communicate(timeout=30)[0].decode(errors="replace"))
        raise
    finally:
        cli.close()
        for p in procs:
            if p.poll() is None:
                p.terminate()
    for p in procs:
        p.communicate(timeout=60)
        assert p.returncode in (0, EXIT_CODE_FATAL), p.returncode


# -- the spawned side -----------------------------------------------------


def _group_worker(procs, rank, coord, out):
    import torch.distributed as dist

    from raftsql_tpu_torch.pod import PodConfig
    pod = PodConfig(procs=procs, proc_id=rank, coordinator=coord)
    backend = pod.init_distributed(device="cpu", timeout_s=60)
    x = torch.tensor([rank, 10 * rank], dtype=torch.int32)
    outs = [torch.empty_like(x) for _ in range(procs)]
    dist.all_gather(outs, x)
    doc = {"backend": backend, "world": dist.get_world_size(),
           "rank": dist.get_rank(), "gathered": [o.tolist() for o in outs],
           "address": pod.distributed_address()}
    PodConfig.destroy_distributed()
    doc["left"] = not dist.is_initialized()
    with open(os.path.join(out, f"group{rank}.json"), "w") as f:
        json.dump(doc, f)


def _step_worker(procs, rank, coord, out, gg, G, ticks):
    from raftsql_tpu_torch.config import RaftConfig
    from raftsql_tpu_torch.convert import to_numpy
    from raftsql_tpu_torch.core import cluster as tcluster
    from raftsql_tpu_torch.parallel import (make_distributed_cluster_step_host,
                                            make_mesh, shard)
    from raftsql_tpu_torch.parallel.sharded import inbox_specs, state_specs
    from raftsql_tpu_torch.pod import PodConfig
    P = 3
    pod = PodConfig(procs=procs, proc_id=rank, coordinator=coord)
    pod.init_distributed(device="cpu", timeout_s=60)
    try:
        ranks = pod.rank_group(gg)
        cfg = RaftConfig(**_cfg_kw(P, G))
        mesh = make_mesh(1, gg, device="cpu", columns=ranks.owned)
        step = make_distributed_cluster_step_host(cfg, mesh, ranks)
        st = shard(mesh, tcluster.init_cluster_state(cfg, device="cpu"),
                   state_specs(), ranks.owned)
        ib = shard(mesh, tcluster.empty_cluster_inbox(cfg, device="cpu"),
                   inbox_specs(), ranks.owned)
        rec = {"info": [], "busy": [], "margin": [], "counts": []}
        for props, ti in _seeded_inputs(P, G, ticks):
            st, ib, pinfo, busy, aux = step(st, ib, props, ti)
            rec["info"].append(pinfo.numpy().copy())
            rec["busy"].append(bool(busy))
            rec["margin"].append(aux.timer_margin.numpy().copy())
            rec["counts"].append(aux.ring_counts.numpy().copy())
        arrays = {k: np.stack(v) for k, v in rec.items()}
        arrays["owned"] = np.asarray(ranks.owned)
        for j in ranks.owned:
            for kind, sh in (("st", st), ("ib", ib)):
                for name, leaf in to_numpy(sh.blocks[0][j]).items():
                    arrays[f"{kind}_{j}_{name}"] = leaf
        np.savez(os.path.join(out, f"step{rank}.npz"), **arrays)
    finally:
        PodConfig.destroy_distributed()


def _node_worker(procs, rank, coord, out, ticks=150):
    import argparse
    import threading

    from raftsql_tpu_torch.pod.dryrun import build_pod_node
    os.environ[DIST_ENV] = "1"
    args = argparse.Namespace(
        procs=procs, proc_id=rank, coord=coord,
        data_dir=os.path.join(out, f"n{rank}"), groups=8, peers=3,
        group_shards=4, connect_timeout=30.0, device="cpu",
        commit_rule="pallas", dist_backend="")
    node, cfg = build_pod_node(args)
    doc = {"reads": 0, "leaders_seen": False, "transfer": None}
    # Both ranks tick exactly `ticks` times on a thread of their own
    # (the collectives keep them in lockstep), while this thread reads.
    ticker = threading.Thread(
        target=lambda: [node.tick() for _ in range(ticks)])
    try:
        ticker.start()
        asked = False
        while ticker.is_alive():
            roles = node.roles()
            st = node.status()
            assert roles.shape == (3, 8) and len(st) == 8
            doc["reads"] += 1
            if ((roles == 2).sum(0) == 1).all() \
                    and all(v["role"] == "leader" for v in st.values()):
                doc["leaders_seen"] = True
            # Group 3 lies in shard 1, which rank 1 owns: its transfer
            # is armed in rank 1's own block.
            if rank == 1 and doc["leaders_seen"] and not asked:
                node.transfer_leadership(3, (int(node._hints[3]) + 1) % 3)
                asked = True
            time.sleep(0.005)
        ticker.join()
    finally:
        node.stop()
    assert node.error is None, node.error
    if rank == 1:
        doc["transfer"] = (node._xfer_events[0]["outcome"]
                           if node._xfer_events else None)
    doc["hard"] = node._hard.tolist()
    doc["roles"] = node.roles().tolist()
    doc["distributed"] = node.pod_doc()["distributed"]
    with open(os.path.join(out, f"node{rank}.json"), "w") as f:
        json.dump(doc, f)


def _worker(argv):
    mode, procs, rank, coord, out = argv[:5]
    procs, rank = int(procs), int(rank)
    if mode == "group":
        _group_worker(procs, rank, coord, out)
    elif mode == "step":
        gg, G, ticks = (int(x) for x in argv[5:8])
        _step_worker(procs, rank, coord, out, gg, G, ticks)
    elif mode == "node":
        _node_worker(procs, rank, coord, out)
    else:
        raise SystemExit(f"unknown worker mode {mode}")
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1:]))
