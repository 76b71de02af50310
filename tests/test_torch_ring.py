"""The port's propose ring (raftsql_tpu_torch/runtime/ring.py) beside the
JAX package's.

Every test of tests/test_ring.py, on the port with device="cpu": SPSC
framing (wraparound, zero-copy pop windows, full-ring backpressure), the
request and completion codecs, an in-process RingServer <-> RingClient
round trip over the port's fused RaftDB, and the `--workers N`
deployment with real worker processes.  Plus the parity checks: the
records and the ring file after one push/pop script are byte-identical
between the two packages (the ring files are a format shared between
processes).
"""
import json
import os
import random
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch

from raftsql_tpu.runtime import ring as jring
from raftsql_tpu_torch.runtime.ring import (OP_GET, OP_PUT, ST_ERR,
                                            RingClient, RingServer,
                                            SpscRing, decode_completion,
                                            decode_request,
                                            encode_completion,
                                            encode_request)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- ring framing -----------------------------------------------------------


def test_ring_roundtrip_simple(tmp_path):
    r = SpscRing(str(tmp_path / "a.ring"), size=1 << 16, create=True)
    msgs = [b"hello", b"x" * 1000, b"tail"]
    for m in msgs:
        assert r.push(m)
    with pytest.raises(ValueError):
        r.push(b"")          # empty records are illegal (see push)
    got = []
    while True:
        v = r.pop()
        if v is None:
            break
        got.append(bytes(v))
        r.pop_commit()
    assert got == msgs
    assert r.depth_bytes() == 0


def test_ring_wraparound_many(tmp_path):
    """Thousands of variable-size records through a small ring: every
    byte survives arbitrary wrap positions."""
    rng = random.Random(7)
    r = SpscRing(str(tmp_path / "w.ring"), size=1 << 12, create=True)
    sent = recv = 0
    pending = []
    for i in range(5000):
        m = bytes([i % 256]) * rng.randrange(0, 200)
        rec = i.to_bytes(4, "little") + m
        while not r.push(rec):
            v = r.pop()
            assert v is not None
            pending.append(bytes(v))
            r.pop_commit()
            recv += 1
        sent += 1
    while True:
        v = r.pop()
        if v is None:
            break
        pending.append(bytes(v))
        r.pop_commit()
        recv += 1
    assert recv == sent == 5000
    for i, rec in enumerate(pending):
        assert int.from_bytes(rec[:4], "little") == i
        assert rec[4:] == bytes([i % 256]) * len(rec[4:])


def test_ring_full_backpressure(tmp_path):
    r = SpscRing(str(tmp_path / "f.ring"), size=1 << 12, create=True)
    big = b"z" * 1000
    pushed = 0
    while r.push(big):
        pushed += 1
    assert pushed >= 3
    assert not r.push(big)              # full reports, never tears
    v = r.pop()
    assert bytes(v) == big
    r.pop_commit()
    assert r.push(big)                  # space reclaimed after commit


def test_ring_attach_sees_producer(tmp_path):
    path = str(tmp_path / "x.ring")
    prod = SpscRing(path, size=1 << 14, create=True)
    cons = SpscRing(path)
    assert prod.push(b"one")
    assert prod.push(b"two")
    assert bytes(cons.pop()) == b"one"
    assert bytes(cons.pop()) == b"two"
    cons.pop_commit()
    assert cons.pop() is None
    assert prod.push(b"three")
    assert bytes(cons.pop()) == b"three"


def test_request_completion_codecs():
    rec = encode_request(OP_PUT, 42, 7, 1, 0xDEADBEEF, b"INSERT x")
    assert decode_request(memoryview(rec)) == (OP_PUT, 42, 7, 1,
                                               0xDEADBEEF, 0,
                                               b"INSERT x")
    rec = encode_request(OP_GET, 43, 0, 1, 0, b"SELECT 1",
                         deadline_mono_ms=123456)
    assert decode_request(memoryview(rec)) == (OP_GET, 43, 0, 1, 0,
                                               123456, b"SELECT 1")
    cpl = encode_completion(42, ST_ERR, 3, b"boom")
    assert decode_completion(memoryview(cpl)) == (42, ST_ERR, 3, b"boom")


# -- byte parity with the JAX package ---------------------------------------


def _records(seed):
    rng = random.Random(seed)
    reqs, cpls = [], []
    for i in range(200):
        op = rng.choice([1, 2, 3, 4, 5, 6])
        body = bytes(rng.randrange(256)
                     for _ in range(rng.randrange(0, 64)))
        args = (op, rng.randrange(1 << 64), rng.randrange(1 << 32),
                rng.randrange(256), rng.randrange(1 << 64), body)
        reqs.append((args, rng.randrange(1 << 64)))
        cpls.append((rng.randrange(1 << 64), rng.randrange(5),
                     rng.randrange(1 << 32), body))
    return reqs, cpls


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_records_byte_identical_to_jax(seed):
    reqs, cpls = _records(seed)
    for args, dl in reqs:
        t = encode_request(*args, deadline_mono_ms=dl)
        assert t == jring.encode_request(*args, deadline_mono_ms=dl)
        assert decode_request(memoryview(t)) \
            == jring.decode_request(memoryview(t))
    for args in cpls:
        t = encode_completion(*args)
        assert t == jring.encode_completion(*args)
        assert decode_completion(memoryview(t)) \
            == jring.decode_completion(memoryview(t))


def _ring_script(mod, path):
    """One push/pop script, wraps included: returns what was popped."""
    rng = random.Random(11)
    r = mod.SpscRing(path, size=1 << 12, create=True)
    got = []
    for i in range(600):
        rec = i.to_bytes(4, "little") + bytes([i % 251]) \
            * rng.randrange(0, 300)
        while not r.push(rec):
            v = r.pop()
            got.append(bytes(v))
            v.release()          # close() needs every view released
            r.pop_commit()
        if rng.random() < 0.4:
            v = r.pop()
            if v is not None:
                got.append(bytes(v))
                v.release()
                if rng.random() < 0.7:
                    r.pop_commit()
    r.pop_commit()
    r.close()
    return got


def test_ring_file_bytes_identical_to_jax(tmp_path):
    """The same script through both packages' rings leaves the same
    file, header and data region byte for byte; and each package's
    consumer reads the other's producer."""
    jp, tp = str(tmp_path / "j.ring"), str(tmp_path / "t.ring")
    import raftsql_tpu_torch.runtime.ring as tring
    assert _ring_script(jring, jp) == _ring_script(tring, tp)
    with open(jp, "rb") as f, open(tp, "rb") as g:
        assert f.read() == g.read()
    prod = jring.SpscRing(str(tmp_path / "x.ring"), size=1 << 12,
                          create=True)
    cons = SpscRing(str(tmp_path / "x.ring"))
    for m in (b"a" * 100, b"b" * 3000, b"c"):
        assert prod.push(m)
        assert bytes(cons.pop()) == m
        cons.pop_commit()


# -- in-process engine round trip -------------------------------------------


def _mk_rdb(tmp):
    from raftsql_tpu_torch.config import RaftConfig
    from raftsql_tpu_torch.models.sqlite_sm import SQLiteStateMachine
    from raftsql_tpu_torch.runtime.db import RaftDB
    from raftsql_tpu_torch.runtime.fused import FusedClusterNode, FusedPipe

    cfg = RaftConfig(num_groups=2, num_peers=3, log_window=32,
                     max_entries_per_msg=4, tick_interval_s=0.0)
    node = FusedClusterNode(cfg, os.path.join(tmp, "data"), device="cpu")
    node.start(interval_s=0.0005)
    pipe = FusedPipe(node)

    def smf(g):
        return SQLiteStateMachine(os.path.join(tmp, f"g{g}.db"))

    return RaftDB(smf, pipe, num_groups=2)


def test_ring_server_client_roundtrip(tmp_path):
    rdb = _mk_rdb(str(tmp_path))
    srv = RingServer(rdb, str(tmp_path / "rings"), workers=1)
    srv.start()
    rc = RingClient(str(tmp_path / "rings"), 0)
    try:
        assert rc.propose("CREATE TABLE t (v text)").wait(30) is None
        for i in range(8):
            assert rc.propose(f"INSERT INTO t (v) VALUES ('x{i}')") \
                .wait(30) is None
        assert rc.query("SELECT count(*) FROM t").strip() == "|8|"
        err = rc.propose("INSERT INTO missing VALUES (1)").wait(30)
        assert err is not None and "missing" in str(err)
        with pytest.raises(ValueError):
            rc.query("DELETE FROM t")
        m = json.loads(rc.render_metrics())
        assert m["ring_workers"] == 1
        assert m["ring_proposed"] >= 9
        assert "ring_depth" in m
        h = json.loads(rc.render_health())
        assert h["ready"] is True
    finally:
        rc.close()
        srv.stop()
        rdb.close()


def test_ring_retry_token_exactly_once(tmp_path):
    rdb = _mk_rdb(str(tmp_path))
    srv = RingServer(rdb, str(tmp_path / "rings"), workers=1)
    srv.start()
    rc = RingClient(str(tmp_path / "rings"), 0)
    try:
        assert rc.propose("CREATE TABLE t (v text)").wait(30) is None
        tok = 0x1234ABCD5678
        sql = "INSERT INTO t (v) VALUES ('once')"
        assert rc.propose(sql, token=tok).wait(30) is None
        assert rc.propose(sql, token=tok).wait(30) is None  # retry acks
        assert rc.query("SELECT count(*) FROM t").strip() == "|1|"
    finally:
        rc.close()
        srv.stop()
        rdb.close()


# -- the real multi-worker deployment ---------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _children(pid):
    """Live child pids of `pid` (from /proc)."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid and fields[0] != "Z":
            out.append(int(d))
    return out


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_workers_deployment_end_to_end(tmp_path):
    """server/main.py --fused --workers 2 --device cpu: two real worker
    processes over SO_REUSEPORT share one engine through the rings;
    writes and reads flow, /metrics shows the ring plane, the workers
    see no CUDA card, and SIGTERM exits 0 with no worker left."""
    from raftsql_tpu_torch.api.client import RaftSQLClient

    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "raftsql_tpu_torch.server.main", "--fused",
         "--workers", "2", "--groups", "2", "--port", str(port),
         "--tick", "0.004", "--device", "cpu"],
        cwd=str(tmp_path), env=_env(),
        stdout=open(tmp_path / "server.log", "wb"),
        stderr=subprocess.STDOUT)
    client = RaftSQLClient([port], timeout_s=10)
    workers = []
    try:
        client.wait_healthy(0, deadline_s=90)
        for g in range(2):
            client.put("CREATE TABLE t (v text)", group=g,
                       deadline_s=60)
        for i in range(20):
            client.put(f"INSERT INTO t (v) VALUES ('w{i}')",
                       group=i % 2, deadline_s=30)
        assert client.get("SELECT count(*) FROM t",
                          group=0).strip() == "|10|"
        assert client.get("SELECT count(*) FROM t",
                          group=1).strip() == "|10|"
        status, _, text = client.raw(0, "GET", "/metrics")
        assert status == 200
        m = json.loads(text)
        assert m["ring_workers"] == 2
        assert m["ring_proposed"] >= 22
        workers = _children(proc.pid)
        assert len(workers) == 2
        for w in workers:
            with open(f"/proc/{w}/environ", "rb") as f:
                env = f.read().split(b"\0")
            assert b"CUDA_VISIBLE_DEVICES=" in env
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        deadline = time.monotonic() + 10
        while any(_alive(w) for w in workers) \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not any(_alive(w) for w in workers)
    finally:
        client.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        for w in workers:
            if _alive(w):
                os.kill(w, signal.SIGKILL)


def test_ring_linear_get_421_redirect_workers_cluster(tmp_path):
    """Ring op 2 (GET) with flags bit 0 (linearizable) through a real
    --workers 2 deployment of a distributed 2-node cluster of the port:
    a linear read at the follower's workers crosses the ring, comes back
    ST_NOT_LEADER, surfaces as HTTP 421 + X-Raft-Leader, and the client
    chases the hint; plus the X-Raft-Session watermark echo."""
    from raftsql_tpu_torch.api.client import RaftSQLClient

    peer_ports = [_free_port(), _free_port()]
    http_ports = [_free_port(), _free_port()]
    cluster = ",".join(f"http://127.0.0.1:{p}" for p in peer_ports)
    # This test pins the RING read path: the worker shm fast path would
    # serve these reads before they cross the ring, so it stays off.
    env = _env(RAFTSQL_SHM_READS="0")
    procs = []
    for i in (0, 1):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "raftsql_tpu_torch.server.main",
             "--id", str(i + 1), "--cluster", cluster,
             "--port", str(http_ports[i]), "--workers", "2",
             "--tick", "0.01", "--lease-ticks", "30", "--device", "cpu"],
            cwd=str(tmp_path), env=env,
            stdout=open(tmp_path / f"node{i}.log", "wb"),
            stderr=subprocess.STDOUT))
    client = RaftSQLClient(http_ports, timeout_s=10)
    try:
        for i in (0, 1):
            client.wait_healthy(i, deadline_s=120)
        client.put("CREATE TABLE t (v text)", deadline_s=60)
        wm = client.put("INSERT INTO t (v) VALUES ('a')", deadline_s=30)
        assert wm is not None and wm >= 2     # session echo over the ring

        lead = None
        t0 = time.monotonic()
        while lead is None and time.monotonic() - t0 < 30:
            for i in (0, 1):
                doc = client.health(i, timeout_s=2.0)
                if doc and doc["groups"]["0"]["role"] == "leader":
                    lead = i
                    break
            time.sleep(0.1)
        assert lead is not None, "no leader reported via /healthz"
        follower = 1 - lead

        status, hdrs, _ = client.raw(
            follower, "GET", "/", "SELECT count(*) FROM t",
            headers={"X-Consistency": "linear"})
        assert status == 421
        assert hdrs.get("X-Raft-Leader") == str(lead + 1)

        got = client.get("SELECT count(*) FROM t", linear=True,
                         deadline_s=30)
        assert got == "|1|\n", got
        got = client.get("SELECT count(*) FROM t", node=follower,
                         consistency="session", session=wm,
                         deadline_s=30)
        assert got == "|1|\n", got

        _, _, text = client.raw(lead, "GET", "/metrics")
        m = json.loads(text)
        assert m["reads"]["lease"] + m["reads"]["read_index"] >= 1
        _, _, text = client.raw(follower, "GET", "/metrics")
        m = json.loads(text)
        assert m["reads"]["session"] >= 1
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for p in procs:
            assert p.wait(timeout=30) == 0
    finally:
        client.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
