"""The port's read-replica tier (raftsql_tpu_torch/replica/) beside the
JAX package's.

Every test of tests/test_replica.py on the port.  Plus: every frame kind
encodes to the JAX package's bytes, each package decodes the other's
frames, the port's ReplicaDB serves the same rows as the JAX package's
ReplicaDB from the same stream, and a parity-mode `--fused
--replica-listen` engine of the port boots and feeds a replica process
(the JAX package's engine dies at boot there:
tests/test_torch_shm.py::test_empty_group_snapshot).

The JAX file's coverage:

Covers, without ever booting the raft engine:
  - the frame codec: round trips for every frame kind, CRC corruption
    and impossible lengths surface as the typed StreamCorruptError
    (never an out-of-bounds slice), EOF as StreamClosed;
  - publisher tee -> stream server -> subscriber folding end to end
    over loopback TCP, against a real ShmSnapshotPublisher;
  - resume: a reconnecting subscriber presents its {group: applied}
    vector and the server replays only the tail;
  - log overflow -> stream RESYNC: once the mmap
    log is full the local shm plane dies, but the stream re-images
    subscribers with fresh KIND_BASE serializations — and the replica
    never serves a row count that goes backwards in between;
  - the ReplicaDB fail-closed ladder: every unprovable mode refuses
    with a 421-class ReplicaRefusal toward the write tier.
"""
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

from raftsql_tpu.replica import stream as jwire
from raftsql_tpu_torch.models.sqlite_sm import SQLiteStateMachine
from raftsql_tpu_torch.replica import stream as wire
from raftsql_tpu_torch.replica.node import (GATE_WAIT_S, ReplicaDB,
                                            ReplicaRefusal,
                                            ReplicaSubscriber)
from raftsql_tpu_torch.replica.publisher import ReplicaStreamServer
from raftsql_tpu_torch.runtime.db import NotLeaderError
from raftsql_tpu_torch.runtime.shm import KIND_DELTA, ShmSnapshotPublisher

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TIMEOUT = 30.0
SCHEMA = "CREATE TABLE t (k INTEGER PRIMARY KEY, v TEXT)"


# -- codec ------------------------------------------------------------------


def _pipe():
    a, b = socket.socketpair()
    a.settimeout(TIMEOUT)
    b.settimeout(TIMEOUT)
    return a, b


def test_codec_round_trips():
    a, b = _pipe()
    try:
        a.sendall(wire.encode_hello(7, 3, 2))
        kind, body = wire.read_frame(b)
        assert kind == wire.K_HELLO
        assert wire.decode_hello(body) == {"epoch": 7, "keymap_epoch": 3,
                                           "groups": 2}

        a.sendall(wire.encode_subscribe("h:1", {0: 5, 1: 0}))
        kind, body = wire.read_frame(b)
        assert kind == wire.K_SUB
        assert wire.decode_subscribe(body) == ("h:1", {0: 5, 1: 0})

        a.sendall(wire.encode_ack({1: 9}))
        kind, body = wire.read_frame(b)
        assert wire.decode_ack(body) == {1: 9}

        a.sendall(wire.encode_rec(KIND_DELTA, 1, 42, b"INSERT ..."))
        kind, body = wire.read_frame(b)
        assert kind == wire.K_REC
        assert wire.decode_rec(body) == (KIND_DELTA, 1, 42, b"INSERT ...")

        rows = [(5, 6, 1, 250_000, 2), (0, 0, 0, 0, 0)]
        a.sendall(wire.encode_table(7, 3, True, rows))
        kind, body = wire.read_frame(b)
        assert kind == wire.K_TABLE
        assert wire.decode_table(body) == (7, 3, True,
                                           [tuple(r) for r in rows])
    finally:
        a.close()
        b.close()


def test_codec_corruption_is_typed_never_a_wrong_row():
    # CRC mismatch: flip one payload byte.
    frame = bytearray(wire.encode_rec(KIND_DELTA, 0, 1, b"INSERT 1"))
    frame[-1] ^= 0x40
    a, b = _pipe()
    try:
        a.sendall(bytes(frame))
        with pytest.raises(wire.StreamCorruptError):
            wire.read_frame(b)
    finally:
        a.close()
        b.close()
    # Impossible declared length: bounds-checked before any slice.
    a, b = _pipe()
    try:
        a.sendall(wire._FRAME.pack(wire.MAX_FRAME + 1, 0))
        with pytest.raises(wire.StreamCorruptError):
            wire.read_frame(b)
    finally:
        a.close()
        b.close()
    # EOF mid-frame is a connection fault, not corruption.
    a, b = _pipe()
    try:
        a.sendall(wire.encode_hello(1, 0, 1)[:5])
        a.close()
        with pytest.raises(wire.StreamClosed):
            wire.read_frame(b)
    finally:
        b.close()


def test_short_rec_and_table_bodies_fail_closed():
    with pytest.raises(wire.StreamCorruptError):
        wire.decode_rec(b"\x01\x02")
    with pytest.raises(wire.StreamCorruptError):
        wire.decode_table(b"\x00" * 4)


# -- stream end to end ------------------------------------------------------


class _Upstream:
    """A stand-in engine: per-group authoritative state machines whose
    applies mirror into a real ShmSnapshotPublisher, exactly as
    runtime/db.py's apply thread does."""

    def __init__(self, tmp, groups=1, size=None):
        self.sms = [SQLiteStateMachine(":memory:", resume=True)
                    for _ in range(groups)]
        self.pub = ShmSnapshotPublisher(str(tmp), num_groups=groups,
                                        size=size)
        self.pub.start(self._serialize, self._applied)
        self.commit = [0] * groups

    def _serialize(self, g):
        idx, blob = self.sms[g].serialize_with_index()
        return (idx, blob) if idx > 0 else None

    def _applied(self, g):
        return self.sms[g].applied_index()

    def apply(self, g, sql, index):
        self.sms[g].apply(sql, index)
        self.pub.publish_deltas({g: [(sql, index)]})
        self.commit[g] = index

    def refresh(self, lease_s=0.0):
        self.pub.refresh(lambda g: self.commit[g], lambda g: 1,
                         lambda g: lease_s)

    def close(self):
        self.pub.close()
        for sm in self.sms:
            sm.close()


def _wait(pred, timeout=TIMEOUT):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True


def _applied_of(sub, group=0):
    with sub._cond:
        return sub.applied_locked(group)


def test_stream_folds_and_serves_the_ladder(tmp_path):
    up = _Upstream(tmp_path)
    srv = ReplicaStreamServer(up.pub, 0, host="127.0.0.1")
    srv.start()
    sub = ReplicaSubscriber(("127.0.0.1", srv.port), advertise="h:9")
    rdb = ReplicaDB(sub)
    try:
        up.apply(0, SCHEMA, 1)
        for k in range(5):
            up.apply(0, f"INSERT INTO t VALUES ({k}, 'v{k}')", k + 2)
        sub.start()
        assert _wait(lambda: _applied_of(sub) >= 6)

        assert rdb.query("SELECT count(*) FROM t").strip() == "|5|"
        assert rdb.query("SELECT count(*) FROM t", mode="session",
                         watermark=6).strip() == "|5|"
        # Uncovered watermark: refuse within the bounded gate wait.
        with pytest.raises(ReplicaRefusal) as e:
            rdb.query("SELECT 1", mode="session", watermark=7,
                      timeout=0.05)
        assert e.value.reason == "watermark-uncovered"

        # follower/linear need the TABLE heartbeat; keep it fresh from
        # a background refresher (the engine's 2ms thread, compressed).
        stop = threading.Event()

        def beat():
            while not stop.is_set():
                up.refresh(lease_s=time.monotonic() + 0.05)
                time.sleep(0.002)

        t = threading.Thread(target=beat, daemon=True)
        t.start()
        try:
            assert _wait(lambda: rdb.watermark(0) >= 6)
            assert rdb.query("SELECT count(*) FROM t",
                             mode="follower").strip() == "|5|"
            assert rdb.query("SELECT count(*) FROM t",
                             mode="linear").strip() == "|5|"
        finally:
            stop.set()
            t.join()

        # Writes refuse toward the write tier with the leader hint.
        with pytest.raises(NotLeaderError) as e:
            rdb.propose("INSERT INTO t VALUES (9, 'x')", 0)
        assert e.value.leader == 2          # leader_of()=1 -> 1-based 2
        # The refusal counters feed /metrics.
        m = rdb.metrics()
        assert m["replica_refusals"]["read-only-tier"] == 1
        assert m["replica_reads"]["linear"] == 1
        doc = rdb.health_doc()
        assert doc["replica"]["connected"]
        assert doc["groups"]["0"]["applied"] >= 6
    finally:
        rdb.close()
        srv.stop()
        up.close()


def test_resume_replays_only_the_tail(tmp_path):
    """Reconnect with a high-water vector: the server's log replay
    skips records at or below it (the wire's resume contract)."""
    up = _Upstream(tmp_path)
    srv = ReplicaStreamServer(up.pub, 0, host="127.0.0.1")
    srv.start()
    sub = ReplicaSubscriber(("127.0.0.1", srv.port))
    try:
        up.apply(0, SCHEMA, 1)
        up.apply(0, "INSERT INTO t VALUES (1, 'a')", 2)
        sub.start()
        assert _wait(lambda: _applied_of(sub) >= 2)

        # Sever the connection server-side; the subscriber reconnects
        # and presents applied=2 — the replay must skip 1 and 2.
        with srv._mu:
            conns = [s.conn for s in srv._subs]
        for c in conns:
            c.shutdown(socket.SHUT_RDWR)
        up.apply(0, "INSERT INTO t VALUES (2, 'b')", 3)
        assert _wait(lambda: _applied_of(sub) >= 3)
        with sub._cond:
            assert sub.connects >= 2
            got = sub._sms[0].query("SELECT count(*) FROM t")
        assert got.strip() == "|2|"
        # No resync happened: the log covered the reconnect.
        with sub._cond:
            assert sub.resyncs == 0
    finally:
        sub.stop()
        srv.stop()
        up.close()


def test_log_overflow_resyncs_the_stream_with_fresh_bases(tmp_path):
    """Overflow kills the local shm fast path, but
    the STREAM re-images subscribers from fresh serializations — and
    the replica's visible row count never goes backwards or serves a
    partial prefix in between."""
    up = _Upstream(tmp_path, size=1)       # min region: ~1 MiB log
    srv = ReplicaStreamServer(up.pub, 0, host="127.0.0.1")
    srv.start()
    sub = ReplicaSubscriber(("127.0.0.1", srv.port))
    counts = []
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            with sub._cond:
                sm = sub._sms.get(0)
                got = sm.query("SELECT count(*) FROM t") if sm else None
            if got is not None:
                counts.append(int(got.strip().strip("|")))
            time.sleep(0.002)

    t = threading.Thread(target=watch, daemon=True)
    try:
        up.apply(0, SCHEMA, 1)
        up.apply(0, "INSERT INTO t VALUES (0, 'seed')", 2)
        sub.start()
        assert _wait(lambda: _applied_of(sub) >= 2)
        t.start()

        big = "-- " + "x" * 600_000        # two of these overflow
        up.apply(0, "INSERT INTO t VALUES (1, 'a') " + big, 3)
        up.apply(0, "INSERT INTO t VALUES (2, 'b') " + big, 4)
        assert up.pub.log_full             # local shm plane is dead...
        up.apply(0, "INSERT INTO t VALUES (3, 'c')", 5)
        # ...but the stream keeps folding: the tee fires even after
        # overflow, so subscribers never notice.
        assert _wait(lambda: _applied_of(sub) >= 5)
        with sub._cond:
            got = sub._sms[0].query("SELECT count(*) FROM t")
        assert got.strip() == "|4|"

        # A LATE subscriber can't bootstrap from the full log: the
        # server re-images it with fresh KIND_BASE records instead.
        late = ReplicaSubscriber(("127.0.0.1", srv.port))
        late.start()
        try:
            assert _wait(lambda: _applied_of(late) >= 5)
            with late._cond:
                got = late._sms[0].query("SELECT count(*) FROM t")
                bases = late.bases_rx
            assert got.strip() == "|4|"
            assert bases >= 1              # bootstrapped via re-image
        finally:
            late.stop()
        assert srv.resyncs >= 1
    finally:
        stop.set()
        if t.is_alive():
            t.join()
        sub.stop()
        srv.stop()
        up.close()
    # The watcher never saw the count regress (no stale row served
    # between overflow and re-image).
    assert all(a <= b for a, b in zip(counts, counts[1:])), counts


def test_queue_lap_resyncs_instead_of_blocking_the_apply(tmp_path):
    """A subscriber whose tee queue laps is re-imaged, not blocked on:
    mark needs_resync directly (the deterministic equivalent of a full
    queue) and require the fresh-bases path to land."""
    up = _Upstream(tmp_path)
    srv = ReplicaStreamServer(up.pub, 0, host="127.0.0.1")
    srv.start()
    sub = ReplicaSubscriber(("127.0.0.1", srv.port))
    try:
        up.apply(0, SCHEMA, 1)
        up.apply(0, "INSERT INTO t VALUES (1, 'a')", 2)
        sub.start()
        assert _wait(lambda: _applied_of(sub) >= 2)
        with srv._mu:
            assert len(srv._subs) == 1
            srv._subs[0].needs_resync = True
        assert _wait(lambda: srv.resyncs >= 1)
        up.apply(0, "INSERT INTO t VALUES (2, 'b')", 3)
        assert _wait(lambda: _applied_of(sub) >= 3)
        with sub._cond:
            got = sub._sms[0].query("SELECT count(*) FROM t")
        assert got.strip() == "|2|"
    finally:
        sub.stop()
        srv.stop()
        up.close()


# -- the fail-closed ladder (no stream attached) ----------------------------


def _detached_rdb():
    sub = ReplicaSubscriber(("127.0.0.1", 1))   # never started
    return ReplicaDB(sub), sub


def test_ladder_refuses_everything_before_attach():
    rdb, _sub = _detached_rdb()
    for mode in ("local", "session", "follower", "linear"):
        with pytest.raises(ReplicaRefusal) as e:
            rdb.query("SELECT 1", mode=mode, timeout=0.01)
        assert e.value.reason == "no-stream"
    m = rdb.metrics()
    assert m["replica_refusals"]["no-stream"] == 4
    assert m["replica"]["refusals"] == 4


def test_ladder_gates_after_attach_without_heartbeat():
    rdb, sub = _detached_rdb()
    with sub._cond:
        sub.epoch = 99            # attached once...
        sub.num_groups = 1        # ...but no TABLE ever arrived
    assert rdb.query("SELECT 1").strip() == "|1|"   # local always serves
    with pytest.raises(ReplicaRefusal) as e:
        rdb.query("SELECT 1", mode="follower", timeout=0.01)
    assert e.value.reason == "heartbeat-stale"
    with pytest.raises(ReplicaRefusal) as e:
        rdb.query("SELECT 1", mode="linear", timeout=0.01)
    assert e.value.reason == "heartbeat-stale"
    with pytest.raises(ValueError):
        rdb.query("SELECT 1", group=5)
    with pytest.raises(ValueError):
        rdb.query("DELETE FROM t")         # read-only tier, 400-class


def test_linear_refuses_on_lapsed_lease():
    rdb, sub = _detached_rdb()
    now = time.monotonic_ns()
    with sub._cond:
        sub.epoch = 99
        sub.num_groups = 1
        sub._tbl = {"rx_ns": now + (1 << 40), "log_full": False,
                    "rows": [(0, 0, 0, now - 1, 3)]}   # lease in the past
    with pytest.raises(ReplicaRefusal) as e:
        rdb.query("SELECT 1", mode="linear", timeout=0.01)
    assert e.value.reason == "lease-lapsed"
    assert e.value.leader == 3             # hint points at the leader


def test_gate_wait_is_bounded():
    """A replica refuses FAST: the ladder's wait is capped at
    GATE_WAIT_S regardless of the client's request timeout."""
    rdb, sub = _detached_rdb()
    with sub._cond:
        sub.epoch = 99
        sub.num_groups = 1
    t0 = time.monotonic()
    with pytest.raises(ReplicaRefusal):
        rdb.query("SELECT 1", mode="session", watermark=10, timeout=30.0)
    assert time.monotonic() - t0 < GATE_WAIT_S + 1.0


def test_render_surfaces_are_json_lines():
    import json
    rdb, sub = _detached_rdb()
    for render in (rdb.render_health, rdb.render_metrics,
                   rdb.render_members, rdb.render_trace,
                   rdb.render_events):
        out = render()
        assert out.endswith("\n")
        json.loads(out)
    prom = rdb.render_metrics_prom()
    assert "raftsql_replica_refusals" in prom


# -- byte parity with the JAX package ---------------------------------------


def _frames(mod, seed):
    """Every frame kind from one seeded draw, encoded by `mod`."""
    rng = random.Random(seed)
    out = []
    for _ in range(40):
        g = rng.randrange(1, 6)
        vec = {i: rng.randrange(1 << 40) for i in range(g)}
        payload = bytes(rng.randrange(256)
                        for _ in range(rng.randrange(0, 300)))
        rows = [(rng.randrange(1 << 40), rng.randrange(1 << 40),
                 rng.randrange(1 << 40), rng.randrange(1 << 62),
                 rng.randrange(1 << 31)) for _ in range(g)]
        out += [mod.encode_hello(rng.randrange(1 << 63),
                                 rng.randrange(1 << 20), g),
                mod.encode_subscribe(f"h{rng.randrange(99)}:"
                                     f"{rng.randrange(65536)}", vec),
                mod.encode_ack(vec),
                mod.encode_rec(rng.choice([1, 2]), rng.randrange(g),
                               rng.randrange(1 << 50), payload),
                mod.encode_table(rng.randrange(1 << 63),
                                 rng.randrange(1 << 20),
                                 rng.random() < 0.5, rows)]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frames_byte_identical_to_jax(seed):
    t, j = _frames(wire, seed), _frames(jwire, seed)
    assert t == j
    # Each package reads the other's frames off a socket.
    for enc, dec in ((t, jwire), (j, wire)):
        a, b = _pipe()
        try:
            for frame in enc:
                a.sendall(frame)
                kind, body = dec.read_frame(b)
                assert dec.encode_frame(kind, body) == frame
        finally:
            a.close()
            b.close()


def _jax_upstream(tmp):
    """The stand-in engine of _Upstream on the JAX package's publisher
    and state machines."""
    from raftsql_tpu.models.sqlite_sm import SQLiteStateMachine as JSM
    from raftsql_tpu.runtime.shm import ShmSnapshotPublisher as JPub
    up = _Upstream.__new__(_Upstream)
    up.sms = [JSM(":memory:", resume=True)]
    up.pub = JPub(str(tmp), num_groups=1)
    up.pub.start(up._serialize, up._applied)
    up.commit = [0]
    return up


QUERIES = ("SELECT count(*) FROM t", "SELECT k, v FROM t ORDER BY k",
           "SELECT max(k), min(v) FROM t WHERE k % 3 = 1",
           "SELECT v FROM t WHERE k > 4 ORDER BY v DESC")


@pytest.mark.parametrize("upstream", ["port", "jax"])
def test_replicadb_serves_the_jax_rows_from_one_stream(tmp_path,
                                                       upstream):
    """A port subscriber and a JAX subscriber on one stream (from the
    port's stream server, then from the JAX package's): each
    package's ReplicaDB answers every query with the same rows, after a
    base image, deltas, a failed statement and a snapshot base."""
    from raftsql_tpu.replica.node import ReplicaDB as JReplicaDB
    from raftsql_tpu.replica.node import ReplicaSubscriber as JSub
    from raftsql_tpu.replica.publisher import \
        ReplicaStreamServer as JServer

    if upstream == "port":
        up, server_cls = _Upstream(tmp_path), ReplicaStreamServer
    else:
        up, server_cls = _jax_upstream(tmp_path), JServer
    up.apply(0, SCHEMA, 1)
    up.apply(0, "INSERT INTO t VALUES (1, 'before-subscribe')", 2)
    srv = server_cls(up.pub, 0, host="127.0.0.1")
    srv.start()
    subs = [ReplicaSubscriber(("127.0.0.1", srv.port)),
            JSub(("127.0.0.1", srv.port))]
    dbs = [ReplicaDB(subs[0]), JReplicaDB(subs[1])]
    try:
        for s in subs:
            s.start()
        n = 3
        for k in range(2, 12):
            up.apply(0, f"INSERT INTO t VALUES ({k}, 'v{k % 4}')", n)
            n += 1
        up.apply(0, "INSERT INTO missing VALUES (1)", n)     # fails
        n += 1
        up.apply(0, "UPDATE t SET v = 'u' WHERE k % 2 = 0", n)
        assert all(_wait(lambda s=s: _applied_of(s) >= n) for s in subs)
        for q in QUERIES:
            got = [db.query(q, mode="session", watermark=n) for db in dbs]
            assert got[0] == got[1], q
            assert got[0] == up.sms[0].query(q), q
    finally:
        for db in dbs:
            db.close()
        srv.stop()
        up.close()


# -- the engine's --replica-listen plane and a replica process ---------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _http(port, method, body="", headers=None, path="/"):
    import http.client
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        c.request(method, path, body=body.encode() or None,
                  headers=headers or {})
        r = c.getresponse()
        return r.status, dict(r.getheaders()), r.read().decode()
    finally:
        c.close()


def test_parity_mode_replica_listen_engine_boots(tmp_path):
    """`--fused --replica-listen` without --resume (parity mode, every
    group's database 0 pages at boot: the case the JAX package's engine
    dies on) boots on the port; a `python -m raftsql_tpu_torch.replica`
    process that never sees a card serves session reads at the acked
    watermark, and refuses a linear read (421) once the upstream is
    gone."""
    api, stream, rport = _free_port(), _free_port(), _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    eng = subprocess.Popen(
        [sys.executable, "-m", "raftsql_tpu_torch.server.main", "--fused",
         "--groups", "2", "--port", str(api), "--tick", "0.005",
         "--lease-ticks", "40", "--replica-listen", str(stream),
         "--device", "cpu"],
        cwd=str(tmp_path), env=env,
        stdout=open(tmp_path / "engine.log", "wb"),
        stderr=subprocess.STDOUT)
    rep = subprocess.Popen(
        [sys.executable, "-m", "raftsql_tpu_torch.replica",
         "--upstream", f"127.0.0.1:{stream}", "--port", str(rport)],
        cwd=str(tmp_path), env=dict(env, CUDA_VISIBLE_DEVICES=""),
        stdout=open(tmp_path / "replica.log", "wb"),
        stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 90
        for g in range(2):
            while True:
                assert eng.poll() is None, \
                    (tmp_path / "engine.log").read_text()[-2000:]
                assert time.monotonic() < deadline, "engine not ready"
                try:
                    st, _, _ = _http(api, "PUT", "CREATE TABLE t (k int)",
                                     {"X-Raft-Group": str(g)})
                    if st == 204:
                        break
                except OSError:
                    pass
                time.sleep(0.2)
        wm = 0
        for k in range(6):
            st, h, _ = _http(api, "PUT", f"INSERT INTO t VALUES ({k})",
                             {"X-Raft-Group": "1"})
            assert st == 204
            wm = max(wm, int(h["X-Raft-Session"]))
        hdr = {"X-Consistency": "session", "X-Raft-Session": str(wm),
               "X-Raft-Group": "1"}
        assert _wait(lambda: _try(rport, hdr) == (200, "|6|"), 60)
        st, _, body = _http(api, "GET", "", path="/healthz")
        assert st == 200 and json.loads(body)["replica"]["subscribers"]
        eng.send_signal(signal.SIGTERM)
        assert eng.wait(timeout=30) == 0
        lin = {"X-Consistency": "linear", "X-Raft-Group": "1"}
        assert _wait(lambda: _try(rport, lin)[0] == 421, 30)
    finally:
        for p in (rep, eng):
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


def _try(port, headers):
    try:
        st, _, body = _http(port, "GET", "SELECT count(*) FROM t",
                            headers)
        return st, body.strip()
    except OSError:
        return None, None
