"""The port's pod runtime (raftsql_tpu_torch/pod/) beside the port's mesh
runtime and the JAX package's pod.

  * PodConfig, PODMETA and the TcpPodTransport collective, whose frames
    are byte for byte the JAX package's: a pod whose coordinator is one
    package's transport and whose member is the other's completes its
    gathers;
  * a procs == 1 pod (LocalPodTransport) equals the port's mesh node
    and the JAX package's procs == 1 pod, leaf for leaf, through the
    same seeded workload;
  * restart replays from disk, bad shapes are refused, and the client
    merges a pod's ownership hints;
  * (slow) two real dry-run processes and two `--pod` servers.
"""
import json
import os
import queue
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from tests.conftest import free_port

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def eight_slots(monkeypatch):
    monkeypatch.setenv("RAFTSQL_SHARD_SLOTS", "8")


def _child_env():
    env = dict(os.environ, RAFTSQL_SHARD_SLOTS="8", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


# -- PodConfig ----------------------------------------------------------


def test_pod_config_validation():
    from raftsql_tpu_torch.pod import PodConfig
    with pytest.raises(ValueError, match="process"):
        PodConfig(procs=0)
    with pytest.raises(ValueError, match="outside"):
        PodConfig(procs=2, proc_id=2, coordinator="h:1")
    with pytest.raises(ValueError, match="coordinator"):
        PodConfig(procs=2, proc_id=0)
    with pytest.raises(ValueError, match="hosts"):
        PodConfig(procs=2, proc_id=0, coordinator="h:1",
                  hosts=("http://a",))
    pod = PodConfig(procs=2, proc_id=1, coordinator="h:1")
    with pytest.raises(ValueError, match="shard"):
        pod.validate(group_shards=1)
    pod.validate(group_shards=4)
    assert pod.owned_shards(4) == [1, 3]
    assert PodConfig(procs=2, proc_id=0,
                     coordinator="h:1").owned_shards(4) == [0, 2]
    assert pod.seq_origin(3) == 1 and pod.seq_origin(4) == 0


def test_pod_meta_refuses_reassignment(tmp_path):
    from raftsql_tpu.pod import PodConfig as JPodConfig
    from raftsql_tpu_torch.pod import PodConfig
    d = str(tmp_path / "h0")
    PodConfig(procs=2, proc_id=0, coordinator="h:1").check_meta(d, 4)
    PodConfig(procs=2, proc_id=0, coordinator="h:1").check_meta(d, 4)
    for procs, pid, gg in ((3, 0, 4), (2, 1, 4), (2, 0, 8)):
        with pytest.raises(ValueError, match="shard assignment"):
            PodConfig(procs=procs, proc_id=pid,
                      coordinator="h:1").check_meta(d, gg)
    assert PodConfig.read_meta(d)["owned"] == [0, 2]
    assert PodConfig.read_meta(str(tmp_path / "none")) is None
    # The JAX package reads the port's PODMETA as its own.
    JPodConfig(procs=2, proc_id=0, coordinator="h:1").check_meta(d, 4)


# -- the collective -----------------------------------------------------


def _pod_threads(makers, tags=("a", "b")):
    """Run one transport per maker (proc ids in order) in threads over a
    fresh coordinator port; returns every proc's gathers."""
    procs = len(makers)
    coord = f"127.0.0.1:{free_port()}"
    results, errors = [None] * procs, []

    def run(pid):
        try:
            t = makers[pid](procs, pid, coord, connect_timeout_s=10.0)
            try:
                out = [t.gather(tag, f"{tag}{pid}".encode() * (pid + 1))
                       for tag in tags]
                t.barrier("end")
                results[pid] = out
            finally:
                t.close()
        except Exception as e:  # surfaced below
            errors.append((pid, e))

    threads = [threading.Thread(target=run, args=(p,))
               for p in range(procs)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not errors, errors
    return results


def test_tcp_pod_transport_gather():
    """Three threads form a pod over localhost: every process sees every
    contribution in proc-id order.  Then mixed pods: the JAX package's
    coordinator with a port member, and the reverse."""
    from raftsql_tpu.pod import TcpPodTransport as JTcp
    from raftsql_tpu_torch.pod import PodPeerLost, TcpPodTransport
    from raftsql_tpu_torch.pod.transport import make_transport
    want = [[b"a0", b"a1a1", b"a2a2a2"], [b"b0", b"b1b1", b"b2b2b2"]]
    assert _pod_threads([TcpPodTransport] * 3) == [want] * 3
    want2 = [[b"a0", b"a1a1"], [b"b0", b"b1b1"]]
    assert _pod_threads([JTcp, TcpPodTransport]) == [want2] * 2
    assert _pod_threads([TcpPodTransport, JTcp]) == [want2] * 2
    with pytest.raises(ValueError):
        TcpPodTransport(1, 0, "x:1")
    assert make_transport(1, 0, "").gather("x", b"p") == [b"p"]
    assert isinstance(PodPeerLost("x"), RuntimeError)


def test_tcp_pod_frames_match_jax_bytes():
    """The frames of one gather, written by each package's transport
    helpers, are the same bytes (JSON with base64 payloads)."""
    from raftsql_tpu.pod import transport as jt
    from raftsql_tpu_torch.pod import transport as tt
    docs = [{"tag": "!register", "proc": 1},
            {"tag": "tick:7", "proc": 1,
             "data": "eyJhIjpbXSwicCI6W119"},
            {"tag": "tick:7", "parts": ["", "AAEC/w=="]},
            {"tag": "!abort", "why": "peer lost"}]
    for doc in docs:
        blobs = []
        for mod in (jt, tt):
            a, b = socket.socketpair()
            try:
                n = mod._send_frame(a, doc)
                a.close()
                buf = b""
                while True:
                    chunk = b.recv(65536)
                    if not chunk:
                        break
                    buf += chunk
                assert n == len(buf)
                blobs.append(buf)
            finally:
                b.close()
        assert blobs[0] == blobs[1], doc


# -- equivalence (procs == 1 pod vs the mesh node and the JAX pod) ------


def _cfg_kw(**kw):
    base = dict(num_groups=8, num_peers=3, log_window=32,
                max_entries_per_msg=4, election_ticks=10,
                heartbeat_ticks=1, tick_interval_s=0.0, seed=7)
    base.update(kw)
    return base


def _drain(node, expand=None):
    from raftsql_tpu_torch.runtime.db import _expand_commit_item
    expand = expand or _expand_commit_item
    out = []
    q = node.commit_q(0)
    while True:
        try:
            item = q.get_nowait()
        except queue.Empty:
            break
        if isinstance(item, tuple):
            out.extend(expand(item))
    return out


def test_pod_single_proc_equivalence(tmp_path):
    """A procs == 1 pod is bit for bit the single controller (the port's
    mesh node) and the JAX package's procs == 1 pod: the same hard
    states, cursors, hints and applied stream (state_doc digest),
    through the full pod tick; then the ack plane."""
    from raftsql_tpu.config import RaftConfig as JConfig
    from raftsql_tpu.pod import PodClusterNode as JPod
    from raftsql_tpu.pod import PodConfig as JPodConfig
    from raftsql_tpu.pod.dryrun import state_doc as jstate_doc
    from raftsql_tpu.runtime.db import _expand_commit_item as j_expand
    from raftsql_tpu.runtime.mesh import MeshConfig as JMeshConfig
    from raftsql_tpu_torch.config import RaftConfig
    from raftsql_tpu_torch.pod import PodClusterNode, PodConfig
    from raftsql_tpu_torch.pod.dryrun import seeded_workload, state_doc
    from raftsql_tpu_torch.runtime.mesh import MeshClusterNode, MeshConfig
    cfg = RaftConfig(**_cfg_kw())
    mesh = MeshConfig(group_shards=4).build(device="cpu")
    pod = PodClusterNode(PodConfig(), cfg, str(tmp_path / "pod"), mesh,
                         seed=3)
    ref = MeshClusterNode(cfg, str(tmp_path / "ref"), mesh, seed=3)
    jpod = JPod(JPodConfig(), JConfig(**_cfg_kw()), str(tmp_path / "jax"),
                JMeshConfig(group_shards=4).build(), seed=3)
    applied = [[], [], []]
    try:
        wl = seeded_workload(0, 60, cfg.num_groups)
        for t in range(60):
            for _i, g, payload in wl[t]:
                assert len(pod.pod_propose(g, [payload])) == 1
                ref.propose_many(g, [payload])
                jpod.pod_propose(g, [payload])
            pod.tick()
            ref.tick()
            jpod.tick()
            ref.publish_flush()
            applied[0].extend(_drain(pod))
            applied[1].extend(_drain(ref))
            applied[2].extend(_drain(jpod, j_expand))
            if t % 20 == 19 or t == 59:
                docs = [state_doc(pod, applied[0]),
                        state_doc(ref, applied[1]),
                        jstate_doc(jpod, applied[2])]
                for other in (ref, jpod):
                    for attr in ("_hard", "_applied", "_hints"):
                        np.testing.assert_array_equal(
                            getattr(pod, attr), getattr(other, attr),
                            err_msg=f"{attr} at tick {t}")
                assert docs[0]["kv_stream"] == docs[1]["kv_stream"] \
                    == docs[2]["kv_stream"]
                assert docs[0]["digest"] == docs[1]["digest"] \
                    == docs[2]["digest"]
        assert len(applied[0]) > 0
        pod.pod_send_ack([5, 9])
        pod.tick()
        assert pod.pod_take_acked() == {5, 9}
        assert pod.pod_take_acked() == set()
        assert pod.metrics.pod_gathers >= 60
        assert all(w.is_native for w in pod.wals)
    finally:
        for n in (pod, ref, jpod):
            n.stop()


def test_pod_restart_replays_from_disk(tmp_path):
    """Stop a pod, reopen over the same dirs: the replay exchange
    rebuilds the same hard state and re-publishes the same stream."""
    import base64

    from raftsql_tpu_torch.config import RaftConfig
    from raftsql_tpu_torch.pod import PodClusterNode, PodConfig
    from raftsql_tpu_torch.pod.dryrun import seeded_workload, state_doc
    from raftsql_tpu_torch.runtime.mesh import MeshConfig
    cfg = RaftConfig(**_cfg_kw())
    mesh = MeshConfig(group_shards=4).build(device="cpu")
    d = str(tmp_path / "pod")
    node = PodClusterNode(PodConfig(), cfg, d, mesh, seed=3)
    applied = []
    try:
        wl = seeded_workload(0, 40, cfg.num_groups)
        for t in range(40):
            for _i, g, payload in wl[t]:
                node.pod_propose(g, [payload])
            node.tick()
            applied.extend(_drain(node))
        before = state_doc(node, applied)
        hard = node._hard.copy()
    finally:
        node.stop()
    np.testing.assert_array_equal(
        np.frombuffer(base64.b64decode(before["hard"]),
                      dtype=hard.dtype).reshape(hard.shape), hard)
    node2 = PodClusterNode(PodConfig(), cfg, d, mesh, seed=3)
    try:
        np.testing.assert_array_equal(node2._hard[:, :, :2],
                                      hard[:, :, :2])
        replayed = []
        for _ in range(3):
            node2.tick()
            replayed.extend(_drain(node2))
        rows = sorted([int(g), int(i),
                       d2.decode() if isinstance(d2, (bytes, bytearray))
                       else str(d2)] for (g, i, d2) in replayed)
        assert rows == before["kv_stream"]
    finally:
        node2.stop()


def test_pod_rejects_bad_shapes(tmp_path):
    from raftsql_tpu_torch.config import RaftConfig
    from raftsql_tpu_torch.pod import PodClusterNode, PodConfig
    from raftsql_tpu_torch.runtime.mesh import MeshConfig
    cfg = RaftConfig(num_groups=8, num_peers=3, log_window=32,
                     max_entries_per_msg=4, tick_interval_s=0.0)
    mesh = MeshConfig(group_shards=2).build(device="cpu")
    with pytest.raises(ValueError, match="shard"):
        PodClusterNode(PodConfig(procs=4, proc_id=0, coordinator="h:1"),
                       cfg, str(tmp_path / "x"), mesh)
    bad = RaftConfig(num_groups=6, num_peers=3, tick_interval_s=0.0)
    with pytest.raises(ValueError, match="divisible"):
        PodClusterNode(PodConfig(), bad, str(tmp_path / "y"),
                       MeshConfig(group_shards=4).build(device="cpu"))


# -- the dry-run rung: two real processes over TCP ----------------------


@pytest.mark.slow
def test_pod_dryrun_two_process_equivalence(tmp_path):
    """Two `raftsql_tpu_torch.pod.dryrun` processes form a pod over
    localhost and run the seeded workload: both dumps match each other
    and an in-process procs == 1 reference; each host materialized only
    its own shards' WAL dirs."""
    coord = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "raftsql_tpu_torch.pod.dryrun",
         "--procs", "2", "--proc-id", str(pid), "--coord", coord,
         "--data-dir", str(tmp_path / f"h{pid}"), "--ticks", "60",
         "--seed", "0", "--device", "cpu",
         "--out", str(tmp_path / f"h{pid}.json")],
        env=_child_env(), cwd=REPO_ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    logs = [p.communicate(timeout=280)[0] for p in procs]
    for pid, p in enumerate(procs):
        assert p.returncode == 0, logs[pid].decode(errors="replace")
    docs = [json.loads((tmp_path / f"h{i}.json").read_text())
            for i in range(2)]
    assert docs[0]["digest"] == docs[1]["digest"]
    assert docs[0]["kv_stream"] == docs[1]["kv_stream"]
    assert len(docs[0]["kv_stream"]) > 0
    from raftsql_tpu_torch.pod.dryrun import (build_pod_node, drain_commits,
                                              seeded_workload, state_doc)

    class _A:
        procs = 1
        proc_id = 0
        coord = ""
        data_dir = str(tmp_path / "ref")
        groups = 8
        peers = 3
        group_shards = 0
        connect_timeout = 30.0
        device = "cpu"

    node, cfg = build_pod_node(_A)
    applied = []
    try:
        wl = seeded_workload(0, 60, cfg.num_groups)
        for t in range(60):
            for _i, g, payload in wl[t]:
                node.pod_propose(g, [payload])
            node.tick()
            applied.extend(drain_commits(node))
        ref = state_doc(node, applied)
    finally:
        node.stop()
    assert docs[0]["digest"] == ref["digest"]
    owned = [sorted(x.name for x in (tmp_path / f"h{i}" / "p1").iterdir())
             for i in range(2)]
    assert not set(owned[0]) & set(owned[1])


# -- the serving plane: client routing + the --pod server ---------------


def test_client_pod_hint_merge(monkeypatch):
    """refresh_hints over a pod: the sweep adopts the /healthz hosts
    table and routes each group to its OWNER host (engine role is
    ignored on pod rows)."""
    from raftsql_tpu_torch.api.client import RaftSQLClient
    hosts = ["127.0.0.1:18000", "127.0.0.1:18001"]
    docs = {
        0: {"id": 0, "ready": True,
            "pod": {"procs": 2, "proc_id": 0, "hosts": hosts},
            "groups": {"0": {"role": "leader", "pod_owned": True},
                       "1": {"role": "leader", "pod_owned": False,
                             "lease_s": 9.0}}},
        1: {"id": 0, "ready": True,
            "pod": {"procs": 2, "proc_id": 1, "hosts": hosts},
            "groups": {"0": {"pod_owned": False},
                       "1": {"pod_owned": True, "lease_s": 5.0}}},
    }
    monkeypatch.setattr(RaftSQLClient, "health",
                        lambda self, idx, timeout_s=1.0: docs.get(idx))
    cli = RaftSQLClient([hosts[0]])
    try:
        assert cli.refresh_hints() == 2
        assert [p for (_h, p) in cli.nodes] == [18000, 18001]
        assert cli._leader == {0: 0, 1: 1}
        assert cli._lease_target(1) == 1
        assert cli.refresh_hints() == 2
        assert len(cli.nodes) == 2
    finally:
        cli.close()


@pytest.mark.slow
def test_pod_server_two_hosts(tmp_path):
    """Two `server.main --pod --device cpu` processes, a client pointed
    at host 0 only: the sweep adopts host 1 and routes by ownership; a
    misdirected write or read answers 421 naming the owner host."""
    from raftsql_tpu_torch.api.client import RaftSQLClient
    from raftsql_tpu_torch.server.main import EXIT_CODE_FATAL
    deadline = 120.0
    p0, p1 = free_port(), free_port()
    coord = f"127.0.0.1:{free_port()}"
    hosts = f"127.0.0.1:{p0},127.0.0.1:{p1}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "raftsql_tpu_torch.server.main",
         "--pod", "--pod-id", str(i), "--pod-coord", coord,
         "--pod-hosts", hosts, "--port", str(p), "--groups", "4",
         "--group-shards", "2", "--peers", "3", "--tick", "0.02",
         "--device", "cpu"],
        env=_child_env(), cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i, p in enumerate((p0, p1))]
    cli = RaftSQLClient([f"127.0.0.1:{p0}"], timeout_s=15.0)
    try:
        cli.wait_healthy(0, deadline_s=deadline)
        doc = cli.health(0)
        assert doc["pod"]["procs"] == 2
        assert doc["pod"]["owned_shards"] == [0]
        assert doc["groups"]["0"]["pod_owned"] is True
        assert doc["groups"]["2"]["pod_owned"] is False
        assert cli.refresh_hints(timeout_s=5.0) == 4
        assert len(cli.nodes) == 2
        assert cli._leader == {0: 0, 1: 0, 2: 1, 3: 1}
        cli.put("CREATE TABLE t (v text)", group=2, deadline_s=deadline)
        cli.put("INSERT INTO t (v) VALUES ('x')", group=2,
                deadline_s=deadline)
        cli.get_until("SELECT v FROM t", "|x|\n", group=2,
                      deadline_s=deadline)
        cli.put("CREATE TABLE s (v text)", group=0, deadline_s=deadline)
        status, hdrs, _ = cli.raw(
            0, "PUT", "/", "INSERT INTO t (v) VALUES ('y')",
            headers={"X-Raft-Group": "2"})
        assert status == 421
        assert hdrs.get("X-Raft-Leader") == "2"
        status, hdrs, _ = cli.raw(0, "GET", "/", "SELECT v FROM t",
                                  headers={"X-Raft-Group": "2"})
        assert status == 421
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
