"""The port's observability planes (raftsql_tpu_torch/obs/) against the
JAX package's, on the CPU.

The device event ring of a traced lockstep run must hold the JAX
package's rows tick for tick, with each side booted from its own seed
(the boot draws are the same threefry draws).  The span lifecycle, the
Chrome-trace export (checked by both packages' validators), the flight
recorder on a forced invariant failure, and GET /trace + GET /events on
the port's `--fused --trace` server follow the JAX package's obs tests.
The port's own additions are held here too: each PUT's span from the
HTTP parse to the reply, the finished-span ring, the apply and launch
sums, the `readback` tick phase, and the idle gaps of a device capture
named by tick phase (obs/timeline.py; its clock conversion is held on
the card by tests/test_torch_cuda.py).
"""
import http.client
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from raftsql_tpu.config import RaftConfig as JConfig
from raftsql_tpu.obs.export import validate_chrome_trace as j_validate
from raftsql_tpu.runtime.fused import FusedClusterNode as JNode
from raftsql_tpu_torch.api.aio import AioSQLServer
from raftsql_tpu_torch.api.http import SQLServer
from raftsql_tpu_torch.config import RaftConfig as TConfig
from raftsql_tpu_torch.obs import (EVENT_FIELDS, PROF_PHASES,
                                   DeviceEventRing, SpanTracer,
                                   TraceSegmentWriter, chrome_trace,
                                   collect_segments, validate_chrome_trace)
from raftsql_tpu_torch.obs import timeline
from raftsql_tpu_torch.obs.spans import (READ_STAMPS, STAMPS,
                                         read_stage_seconds, stage_seconds)
from raftsql_tpu_torch.runtime.fused import FusedClusterNode as TNode
from raftsql_tpu_torch.server import main as server_main
from raftsql_tpu_torch.server.main import build_fused_node

torch.set_num_threads(1)


def cfg_kw(**kw):
    args = dict(num_groups=4, num_peers=3, log_window=32,
                max_entries_per_msg=4, election_ticks=10,
                heartbeat_ticks=1, tick_interval_s=0.0)
    args.update(kw)
    return args


def elect(node, max_ticks=200):
    for t in range(max_ticks):
        node.tick()
        if t > 10 and (node._hints >= 0).all():
            return
    raise AssertionError("no full leadership within budget")


@pytest.fixture
def traced_node(tmp_path):
    node = TNode(TConfig(**cfg_kw()), str(tmp_path), device="cpu")
    node.enable_tracing(ring_depth=16)
    yield node
    node.stop()


# -- device plane ------------------------------------------------------

@pytest.mark.parametrize("rule", ["point", "pallas"])
def test_device_ring_rows_equal_jax(tmp_path, rule):
    """Both nodes boot from their own seed (no state carried across),
    trace every tick, and take the same proposals; the drained ring
    rows must be equal, field for field, tick for tick."""
    seed = 5
    jn = JNode(JConfig(**cfg_kw(commit_rule=rule)), str(tmp_path / "j"),
               seed=seed)
    tn = TNode(TConfig(**cfg_kw(commit_rule=rule)), str(tmp_path / "t"),
               seed=seed, device="cpu")
    try:
        for n in (jn, tn):
            n.enable_tracing(ring_depth=16)
        rng = np.random.default_rng(seed)
        for t in range(70):
            if t % 4 == 0:
                for g in range(4):
                    batch = [f"SET k{t}-{i} g{g}".encode()
                             for i in range(int(rng.integers(0, 5)))]
                    jn.propose_many(g, batch)
                    tn.propose_many(g, batch)
            for n in (jn, tn):
                n.tick()
                n.publish_flush()
        for n in (jn, tn):
            n.ring.drain()
        jrows, trows = jn.ring.rows(), tn.ring.rows()
        assert len(trows) == 70 and tn.ring.drains == 5
        assert [r["tick"] for r in trows] == list(range(70))
        assert trows == jrows
        # The run elected and committed: the rows say so.
        assert all(c >= 1 for row in trows[-1]["commit"] for c in row)
        assert any(v >= 2 for row in trows[-1]["votes"] for v in row)
    finally:
        jn.stop()
        tn.stop()


def test_ring_disabled_by_default(tmp_path):
    node = TNode(TConfig(**cfg_kw(num_groups=1)), str(tmp_path),
                 device="cpu")
    try:
        assert node.ring is None and node.tracer is None
        for _ in range(5):
            node.tick()     # no tracing machinery runs
    finally:
        node.stop()


def test_ring_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceEventRing(3, 4)


def _ring_inputs(G):
    """One fused step's packed info and post-step leaves at P = 3."""
    from raftsql_tpu_torch.core import cluster
    cfg = TConfig(**cfg_kw(num_groups=G))
    st = cluster.init_cluster_state(cfg, 3, device="cpu")
    ib = cluster.empty_cluster_inbox(cfg, device="cpu")
    st, ib, pinfo, _ = cluster.cluster_step_host(
        cfg, st, ib, torch.zeros((3, G), dtype=torch.int32))
    return pinfo, st.votes, ib.v_type, ib.a_type, np.zeros((3, G), np.int64)


def test_ring_history_is_bounded_in_bytes():
    """Where the byte budget binds, the history holds budget // row_bytes
    rows (the newest), under the budget, whatever the drains' sizes."""
    G = 100
    row_bytes = 3 * G * len(EVENT_FIELDS) * 4
    budget = 10 * row_bytes + row_bytes // 2
    ring = DeviceEventRing(3, G, depth=8, budget_bytes=budget,
                           device="cpu")
    assert ring.row_bytes == row_bytes and ring.capacity == 10
    args = _ring_inputs(G)
    for t in range(27):
        ring.record(t, *args)
        if t == 12:
            ring.drain()                  # a partial drain of 5 slots
        assert ring.history_bytes() <= budget
    ring.drain()
    assert ring.drains == 4 and len(ring) == 10
    assert ring.history_bytes() == 10 * row_bytes <= budget
    assert [r["tick"] for r in ring.rows()] == list(range(17, 27))
    assert [r["tick"] for r in ring.rows(last=3)] == [24, 25, 26]


def test_kept_rows_do_not_share_the_drained_block():
    """Each kept row owns its bytes: a view would hold the whole drained
    [slots, P, G, NEV] block alive past the budget."""
    ring = DeviceEventRing(3, 50, depth=16, budget_bytes=4 * 3 * 50 * 36,
                           device="cpu")
    args = _ring_inputs(50)
    for t in range(16):                   # one full drain of 16 slots
        ring.record(t, *args)
    kept = list(ring._events)
    assert len(kept) == 4 and ring.drains == 1
    for i, row in enumerate(kept):
        assert row.base is None and row.flags.owndata
        assert not np.shares_memory(row, ring._ring.numpy())
        for other in kept[i + 1:]:
            assert not np.shares_memory(row, other)


def test_server_shape_history_keeps_the_jax_packages_rows():
    """At 8 groups x 3 peers (864 B a row) the budget does not bind: the
    history keeps 4,096 rows, as the JAX package's ring does."""
    from raftsql_tpu.obs.device_ring import DeviceEventRing as JRing
    ring = DeviceEventRing(3, 8, device="cpu")
    assert ring.row_bytes == 864
    assert ring.capacity == 4096 == JRing(3, 8)._events.maxlen
    args = _ring_inputs(8)
    for t in range(4096 + 64):
        ring.record(t, *args)
    assert len(ring) == 4096 and ring.drains == 65
    assert ring.rows(last=1)[0]["tick"] == 4096 + 63
    assert ring.rows()[0]["tick"] == 64


def test_enable_tracing_keeps_the_ring_budget(tmp_path):
    """The node's ring takes the byte budget with `keep`: a small keep
    binds first, and the history holds that many rows."""
    from raftsql_tpu_torch.obs.device_ring import DEFAULT_BUDGET_BYTES
    node = TNode(TConfig(**cfg_kw(num_groups=100)), str(tmp_path),
                 device="cpu")
    try:
        node.enable_tracing(ring_depth=4, keep=3)
        assert node.ring.capacity == 3
        assert DEFAULT_BUDGET_BYTES // node.ring.row_bytes > 3
        for _ in range(10):
            node.tick()
        node.ring.drain()
        assert len(node.ring) == 3 and node.ring.drains == 3
        assert node.ring.history_bytes() == 3 * node.ring.row_bytes
    finally:
        node.stop()


# -- host plane (spans) ------------------------------------------------

def test_span_lifecycle_fused(traced_node):
    node = traced_node
    elect(node)
    node.propose_many(1, [b"SET k1 v1", b"SET k1 v2"])
    for _ in range(15):
        node.tick()
    node.publish_flush()
    snap = node.tracer.snapshot()
    spans = [s for s in snap["spans"] if s["group"] == 1
             and s["key"].startswith("SET k1")]
    assert len(spans) == 2
    for s in spans:
        ph = s["phases"]
        assert ph["propose"] <= ph["append"] <= ph["replicate"] \
            <= ph["commit"]
        assert s["index"] >= 1
    # WAL fsync events landed on the timeline ring.
    assert any(e["name"] == "wal.fsync" for e in snap["events"])


def test_span_tracer_bounded_and_skips_unknown_keys():
    tr = SpanTracer(max_pending=8, max_live=8, max_done=16)
    for i in range(100):
        tr.begin(0, f"q{i}")
    assert tr.dropped == 100 - 8
    tr.note_append(0, 1, [f"q{i}" for i in range(92, 100)])
    tr.note_commit(0, 8)
    for i in range(92, 100):
        tr.note_apply(0, i - 91)
        tr.note_ack(0, f"q{i}")
    snap = tr.snapshot()
    done = [s for s in snap["spans"] if "ack" in s["phases"]]
    assert len(done) == 8
    assert all(set(s["phases"]) == {"propose", "append", "replicate",
                                     "commit", "apply", "ack"}
               for s in done)
    fresh = SpanTracer()
    fresh.note_append(0, 5, ["never-proposed"])
    fresh.note_commit(0, 10)
    fresh.note_ack(0, "never-proposed")
    assert fresh.snapshot()["spans"] == []


# -- chrome trace export ----------------------------------------------

def test_chrome_trace_schema_from_live_run(traced_node, tmp_path):
    node = traced_node
    elect(node)
    node.propose_many(0, [b"SET k0 v0"])
    for _ in range(10):
        node.tick()
    node.publish_flush()
    node.ring.drain()
    seg = TraceSegmentWriter(str(tmp_path / "segs"), "worker-1", tag="w1")
    seg.note("request", node.tracer.t0 + 0.001, 0.0005, path="/")
    seg.flush()
    doc = chrome_trace(node.tracer.snapshot(), node.ring.rows(),
                       phase_events=node.prof.events(),
                       process_segments=[
                           dict(s, pid=os.getpid() + 10)
                           for s in collect_segments(
                               str(tmp_path / "segs"))],
                       base_monotonic=node.tracer.t0)
    for doc_ in (doc, json.loads(json.dumps(doc))):
        validate_chrome_trace(doc_)
        j_validate(doc_)
    evs = doc["traceEvents"]
    assert any(e["ph"] == "X" and "→" in e["name"] for e in evs)
    assert any(e["ph"] == "C" and e["pid"] == 3 for e in evs)
    assert any(e["ph"] == "X" and e["pid"] == 4 for e in evs)
    assert any(e.get("cat") == "proc" for e in evs)


def test_validate_rejects_malformed():
    validate_chrome_trace({"traceEvents": []})      # empty is valid
    for bad in ([{"ph": "X"}],
                [{"name": "x", "ph": "Z", "pid": 1, "ts": 0}],
                [{"name": "x", "ph": "X", "pid": 1, "ts": -1, "dur": 1}],
                [{"name": "x", "ph": "C", "pid": 1, "ts": 0,
                  "args": {"value": "not-a-number"}}]):
        with pytest.raises(ValueError):
            validate_chrome_trace({"traceEvents": bad})


# -- flight recorder ---------------------------------------------------

def test_flight_recorder_dumps_on_invariant_failure(tmp_path,
                                                    monkeypatch):
    """A chaos run that trips an invariant leaves a post-mortem artifact
    holding BOTH planes: device-plane tick events and host spans."""
    from raftsql_tpu_torch.chaos.invariants import InvariantViolation
    from raftsql_tpu_torch.chaos.scenarios import FusedChaosRunner
    from raftsql_tpu_torch.chaos.schedule import ChaosSchedule

    monkeypatch.setenv("RAFTSQL_FLIGHT_DIR", str(tmp_path / "flights"))
    sched = ChaosSchedule(seed=7, ticks=60)
    runner = FusedChaosRunner(sched, str(tmp_path / "data"), device="cpu")
    # Poison the commit-monotonicity matrix MID-run (after elections and
    # real traffic): the next observation reads as a regression.
    orig_observe = FusedChaosRunner._observe

    def poisoned(self, t):
        if t == 40:
            self.monotonic._hi[:, :] = 10 ** 6
        orig_observe(self, t)

    monkeypatch.setattr(FusedChaosRunner, "_observe", poisoned)
    with pytest.raises(InvariantViolation):
        runner.run()
    path = tmp_path / "flights" / "flight-fused-seed7.json"
    doc = json.loads(path.read_text())
    assert "commit regressed" in doc["reason"]
    assert doc["meta"]["schedule_digest"] == sched.digest()
    rows = doc["device_events"]
    assert rows and rows[-1]["tick"] == 40
    assert set(EVENT_FIELDS) - {"tick"} <= set(rows[-1])
    spans = doc["host_spans"]["spans"]
    assert any("commit" in s["phases"] for s in spans)
    assert doc["serving"]["overlap"]["enabled"] in (True, False)


# -- GET /trace and GET /events on the --fused --trace server ---------

@pytest.fixture(params=["threaded", "aio"])
def server(request, tmp_path):
    rdb = build_fused_node(groups=2, peers=3, tick=0.002,
                           data_prefix=str(tmp_path / "raftsql"),
                           commit_rule="pallas", trace=True, device="cpu")
    cls = SQLServer if request.param == "threaded" else AioSQLServer
    srv = cls(0, rdb, host="127.0.0.1", timeout_s=30.0)
    srv.start()
    yield srv
    srv.stop()
    rdb.close()


def _req(srv, method, path="/", body=b""):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def test_http_trace_and_events_endpoints(server):
    puts = [b"CREATE TABLE main.o (v text)",
            b'INSERT INTO main.o (v) VALUES ("a")',
            b'INSERT INTO main.o (v) VALUES ("b")']
    for body in puts:
        assert _req(server, "PUT", body=body)[0] == 204

    status, data = _req(server, "GET", "/trace")
    assert status == 200
    doc = json.loads(data)
    validate_chrome_trace(doc)
    j_validate(doc)
    assert any(e.get("ph") == "X" for e in doc["traceEvents"])

    status, data = _req(server, "GET", "/events")
    assert status == 200
    ev = json.loads(data)
    assert ev["tracing"] is True
    assert ev["device"] and set(EVENT_FIELDS) <= set(ev["device"][-1])
    full = [s for s in ev["host"]["spans"]
            if {"propose", "append", "replicate", "commit", "apply",
                "ack"} <= set(s["phases"])]
    # One full span from propose to ack per acked PUT.
    assert sorted(s["key"].encode() for s in full) == sorted(puts)
    for s in full:
        ph = s["phases"]
        assert ph["propose"] <= ph["append"] <= ph["commit"] \
            <= ph["apply"] <= ph["ack"]


def test_cli_trace_flag_reaches_the_node(monkeypatch):
    """`--fused --trace` builds the node with tracing on (the server's
    own serve loop is stubbed out)."""
    seen = {}

    class Stop(Exception):
        pass

    def fake_build(**kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(server_main, "build_fused_node", fake_build)
    with pytest.raises(Stop):
        server_main.main(["--fused", "--trace", "--device", "cpu"])
    assert seen["trace"] is True and seen["device"] == "cpu"


# -- request spans, apply and launch counters, the readback phase ------

def _served(tmp_path, **kw):
    """A one-group `--fused` server behind the asyncio HTTP plane."""
    rdb = build_fused_node(groups=1, peers=3, tick=0.002,
                           data_prefix=str(tmp_path / "raftsql"),
                           commit_rule="pallas", device="cpu", **kw)
    srv = AioSQLServer(0, rdb, host="127.0.0.1", timeout_s=30.0)
    srv.start()
    return rdb, srv


def _puts(n):
    return [b"CREATE TABLE main.s (v text)"] + [
        f'INSERT INTO main.s (v) VALUES ("{i}")'.encode()
        for i in range(n - 1)]


def _poll(fn, limit_s=10.0):
    t_end = time.monotonic() + limit_s
    while True:
        got = fn()
        if got is not None or time.monotonic() > t_end:
            return got
        time.sleep(0.01)


_ORDER = [STAMPS.index(s) for s in ("parsed", "propose", "append",
                                    "commit", "apply", "ack", "reply")]


@pytest.mark.parametrize("device_ring", [True, False])
def test_put_spans_run_from_parse_to_reply(tmp_path, device_ring):
    """Every PUT over HTTP finishes one span whose stamps never go back,
    and whose four stages sum exactly to reply - parsed.  `--trace`
    turns on both planes before the tick loop starts; the spans alone
    may be turned on while it runs, and then no device ring is made."""
    rdb, srv = _served(tmp_path, trace=device_ring)
    try:
        node = rdb.pipe.node
        if not device_ring:
            node.enable_tracing(device_ring=False, spans=64)
        assert (node.ring is not None) == device_ring
        puts = _puts(12)
        for body in puts:
            assert _req(srv, "PUT", body=body)[0] == 204

        def finished():
            t = node.tracer.finished()
            done = len(t) == len(puts) and not np.isnan(t[:, _ORDER]).any()
            return t if done else None

        t = _poll(finished)
        assert t is not None, node.tracer.finished()
        assert (np.diff(t[:, _ORDER], axis=1) >= 0).all()
        st = stage_seconds(t)
        assert list(st) == ["queue", "commit", "apply", "reply"]
        total = st["queue"] + st["commit"] + st["apply"] + st["reply"]
        span = t[:, STAMPS.index("reply")] - t[:, STAMPS.index("parsed")]
        assert len(total) == len(puts) and (total == span).all()
        m = node.metrics
        assert 0 < m.t_launch_cpu_ms and 0 < m.t_launch_ms
    finally:
        srv.stop()
        rdb.close()


def test_span_ring_keeps_the_newest_spans():
    tr = SpanTracer(max_done=4)
    folds = []
    for i in range(10):
        tr.begin(0, f"q{i}", t=float(i))
        tr.note_append(0, i + 1, [f"q{i}"])
        tr.note_commit(0, i + 1)
        folds.append(tr.note_ack(0, f"q{i}"))
    assert folds == list(range(10)) and tr.folded == 10
    t = tr.finished()
    assert t.shape == (4, len(STAMPS))
    assert t[:, STAMPS.index("parsed")].tolist() == [6.0, 7.0, 8.0, 9.0]
    assert [s["key"] for s in tr.snapshot()["spans"]] == [
        "q6", "q7", "q8", "q9"]
    tr.note_reply(folds[2], t=20.0)        # its row was overwritten
    tr.note_reply(folds[9], t=21.0)
    assert np.isnan(tr.finished()[:, STAMPS.index("reply")]).tolist() == [
        True, True, True, False]
    assert tr.finished()[3, STAMPS.index("reply")] == 21.0
    assert tr.note_ack(0, "never-proposed") is None
    # Past max_live the oldest live span spills into the ring unacked.
    tr = SpanTracer(max_live=2)
    for i in range(3):
        tr.begin(0, f"l{i}")
    tr.note_append(0, 1, ["l0", "l1", "l2"])
    assert tr.folded == 1
    assert np.isnan(tr.finished()[0, STAMPS.index("ack")])
    assert tr.note_ack(0, "l0") is None and tr.note_ack(0, "l2") == 1


def test_tracing_off_takes_no_span_or_cpu_read(tmp_path, monkeypatch):
    reads = []
    real = time.thread_time
    monkeypatch.setattr(time, "thread_time",
                        lambda: reads.append(1) or real())

    def refuse(*a, **k):
        raise AssertionError("a span hook ran with tracing off")

    for hook in ("begin", "note_append", "note_replicate", "note_commit",
                 "note_apply", "note_ack", "note_reply"):
        monkeypatch.setattr(SpanTracer, hook, refuse)
    rdb, srv = _served(tmp_path)
    try:
        node = rdb.pipe.node
        assert node.tracer is None and node.ring is None
        for body in _puts(6):
            assert _req(srv, "PUT", body=body)[0] == 204
        m = node.metrics
        assert m.ticks > 0 and m.t_launch_ms > 0
        assert m.t_launch_cpu_ms == 0.0 and reads == []
    finally:
        srv.stop()
        rdb.close()


def test_readback_is_a_phase_of_its_own(tmp_path):
    assert PROF_PHASES.index("readback") == PROF_PHASES.index(
        "dispatch") + 1
    rdb, srv = _served(tmp_path)
    try:
        assert _req(srv, "PUT", body=_puts(1)[0])[0] == 204
        status, data = _req(srv, "GET", "/metrics")
        assert status == 200
        pp = json.loads(data)["phase_profile"]
        assert "sample" not in pp
        assert pp["readback"]["n"] > 0
        # One dispatch record a tick now, as one readback.
        assert abs(pp["dispatch"]["n"] - pp["readback"]["n"]) <= 1
    finally:
        srv.stop()
        rdb.close()


def test_apply_time_grows_with_applied_entries(tmp_path):
    rdb, srv = _served(tmp_path)
    try:
        m = rdb.pipe.node.metrics
        puts = _puts(21)
        assert _req(srv, "PUT", body=puts[0])[0] == 204
        first = m.t_apply_ms
        assert first > 0
        for body in puts[1:]:
            assert _req(srv, "PUT", body=body)[0] == 204
        assert m.t_apply_ms > first
        assert json.loads(_req(srv, "GET", "/metrics")[1])[
            "phase_ms_per_tick"]["apply"] > 0
    finally:
        srv.stop()
        rdb.close()


def test_stage_seconds_keep_the_window_and_skip_the_capture():
    """Hand-computed stages (binary fractions, so exact): a span counts
    when its parse and reply lie in the window and clear of the
    capture."""
    nan = np.nan
    #     parsed propose append repl commit apply ack reply
    rows = np.array([
        [1.0, 1.0, 1.5, 1.75, 2.0, 2.125, 2.25, 2.5],     # counted
        [3.0, 3.0, 3.25, nan, 3.5, 3.625, 3.75, 4.0],     # counted
        [5.0, 5.0, 5.25, 5.5, 5.75, 5.8, 6.0, 6.25],      # in the capture
        [0.5, 0.5, 1.0, 1.0, 1.25, 1.3, 1.5, 1.75],       # before the open
        [9.0, 9.0, 9.25, 9.5, 9.75, 9.8, 10.0, 10.5],     # after the close
        [7.5, 7.5, 7.75, 8.0, 8.25, 8.3, 8.5, nan],       # no reply
        [8.0, 8.0, nan, nan, nan, nan, nan, nan],         # still queued
    ])
    st = stage_seconds(rows, t_open=0.75, t_close=10.25,
                       skip=(6.125, 7.0))
    assert {k: v.tolist() for k, v in st.items()} == {
        "queue": [0.5, 0.25], "commit": [0.5, 0.25],
        "apply": [0.25, 0.25], "reply": [0.25, 0.25]}
    assert all(len(v) == 5 for v in stage_seconds(rows).values())


# -- read spans and the read counters -----------------------------------

def _get_linear(srv, body, path="/"):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
    try:
        conn.request("GET", path, body=body,
                     headers={"X-Consistency": "linear"})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _held_read(rdb, srv):
    """One linear GET that must park: the apply is held back until a
    write has committed past it, then released.  Returns the GET's
    status."""
    gate = threading.Event()
    sm = rdb._sms[0]
    real = sm.apply_batch

    def held(items):
        gate.wait()
        return real(items)
    sm.apply_batch = held
    node = rdb.pipe.node
    put = threading.Thread(target=_req, args=(
        srv, "PUT", "/", b'INSERT INTO main.s (v) VALUES ("held")'))
    put.start()
    out = []
    try:
        assert _poll(lambda: node.commit_watermark(0) > rdb.watermark(0)
                     or None)
        get = threading.Thread(target=lambda: out.append(
            _get_linear(srv, b"SELECT * FROM main.s")))
        get.start()
        assert _poll(lambda: rdb._n_parked or None)
    finally:
        gate.set()
    get.join(30)
    put.join(30)
    sm.apply_batch = real
    return out[0][0]


def test_read_spans_run_from_parse_to_reply(tmp_path):
    """Every linear GET folds one read span whose stamps never go back
    and whose four stages sum exactly to reply - parsed; a GET that
    parked spends its time in `wait`."""
    rdb, srv = _served(tmp_path)
    try:
        node = rdb.pipe.node
        node.enable_tracing(device_ring=False, spans=64)
        for body in _puts(4):
            assert _req(srv, "PUT", body=body)[0] == 204
        for _ in range(6):
            assert _get_linear(srv, b"SELECT * FROM main.s")[0] == 200
        assert _held_read(rdb, srv) == 200
        t = node.tracer.finished_reads()
        assert t.shape == (7, len(READ_STAMPS))
        assert not np.isnan(t).any() and (np.diff(t, axis=1) >= 0).all()
        st = read_stage_seconds(t)
        assert list(st) == ["point", "wait", "query", "reply"]
        total = st["point"] + st["wait"] + st["query"] + st["reply"]
        assert (total == t[:, -1] - t[:, 0]).all()
        assert st["wait"][-1] > 0 and (st["wait"][:-1] == 0).all()
        assert node.tracer.folded == 4 + 1     # the writes' ring apart
    finally:
        srv.stop()
        rdb.close()


def test_read_span_ring_keeps_its_cap():
    tr = SpanTracer(max_done=4)
    nums = [tr.note_read(i % 2, [float(i + k) for k in range(5)])
            for i in range(10)]
    assert nums == list(range(10)) and tr.reads_folded == 10
    t = tr.finished_reads()
    assert t.shape == (4, len(READ_STAMPS))
    assert t[:, 0].tolist() == [6.0, 7.0, 8.0, 9.0]
    assert tr.folded == 0 and tr.finished().shape == (0, len(STAMPS))
    assert all(len(v) == 4 for v in read_stage_seconds(t).values())


def test_tracing_off_a_get_stamps_nothing(tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a read span was stamped with tracing off")

    monkeypatch.setattr(SpanTracer, "note_read", refuse)
    rdb, srv = _served(tmp_path)
    try:
        assert rdb.pipe.node.tracer is None
        for body in _puts(3):
            assert _req(srv, "PUT", body=body)[0] == 204
        for _ in range(4):
            assert _get_linear(srv, b"SELECT * FROM main.s")[0] == 200
        assert _held_read(rdb, srv) == 200
        assert _req(srv, "GET", body=b"SELECT * FROM main.s")[0] == 200
    finally:
        srv.stop()
        rdb.close()


def test_read_counters_on_get_metrics(tmp_path):
    rdb, srv = _served(tmp_path)
    try:
        for body in _puts(3):
            assert _req(srv, "PUT", body=body)[0] == 204
        assert _held_read(rdb, srv) == 200
        for _ in range(3):
            assert _get_linear(srv, b"SELECT * FROM main.s")[0] == 200
        status, body = _req(srv, "GET", "/metrics")
        assert status == 200
        reads = json.loads(body)["reads"]
        assert reads["reads_parked"] >= 1 and reads["read_wakes"] >= 1
        assert reads["read_wakes"] <= reads["reads_parked"]
        assert reads["t_read_wait_ms"] > 0
        assert reads["read_waiters_max"] >= 1
        assert reads["read_wait_timeouts"] == 0
    finally:
        srv.stop()
        rdb.close()


class _Activity:
    """What summarize and the timeline read of a kineto device event."""

    def __init__(self, s, e, name):
        self.s, self.e, self.n = s, e, name

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e

    def duration_ns(self):
        return self.e - self.s


def _phase_rings(records):
    """TickPhaseProfiler.raw()'s shape from (phase, t0, dur, tick, tid)."""
    raw = {}
    for p in PROF_PHASES:
        rs = [r for r in records if r[0] == p]
        raw[p] = tuple(np.array([r[k] for r in rs]) for k in (1, 2, 3, 4))
    return raw


def test_idle_gaps_are_named_by_the_tick_phase():
    """Profiler stamps 1 s behind time.monotonic(); three idle gaps, each
    labelled by the tick-thread phase over most of it (a publish worker,
    tid 1, does not count), timed and ordered as `summarize` does."""
    from portbench.device import summarize
    off = 10 ** 9
    acts = [_Activity(0, 1000, "k_a"), _Activity(5000, 5500, "k_b"),
            _Activity(5200, 6000, "k_c"), _Activity(20000, 21000, "k_d"),
            _Activity(22000, 22500, "k_e")]

    def mono(ns):
        return (ns + off) * 1e-9

    raw = _phase_rings([
        ("dispatch", mono(500), 4000e-9, 7, 0),
        ("readback", mono(4500), 1100e-9, 7, 0),
        ("wal_write", mono(6000), 3000e-9, 7, 0),
        ("fsync", mono(9000), 10000e-9, 7, 0),
        ("publish", mono(20500), 2000e-9, 7, 1)])
    phases = timeline.tick_phases(raw)
    assert [p[2] for p in phases] == ["dispatch", "readback", "wal_write",
                                      "fsync"]
    events = [(a.start_ns(), a.end_ns(), a.name()) for a in acts]
    gaps = timeline.idle_gaps(events, phases, off)
    cap = {"events": acts, "busy_s": 2.8e-6, "window_s": 23e-6}
    old = summarize(cap)
    assert [g[1] for g in gaps] == [g[1] for g in old["idle_gaps"]]
    assert (old["busy_s"], old["window_s"]) == (2.8e-6, 23e-6)
    assert [g[0] for g in gaps] == [
        "fsync tick 7: after k_c, before k_d",
        "dispatch tick 7: after k_a, before k_b",
        "between ticks after tick 7: after k_d, before k_e"]
    split = timeline.idle_split(events, phases, off, mono(0), mono(23000))
    want = {"dispatch": 3500e-9, "readback": 500e-9, "wal_write": 3000e-9,
            "fsync": 10000e-9, timeline.BETWEEN: 2500e-9}
    for p, v in split.items():
        assert v == pytest.approx(want.get(p, 0.0), abs=1e-12), p
    assert sum(split.values()) == pytest.approx(19500e-9, abs=1e-12)


def test_profiler_clock_is_told_apart():
    pairs = [(5_000, 1_700_000_000_000_000_000),
             (9_000, 1_700_000_000_000_004_002)]
    assert timeline.profiler_offset_ns(6_000, pairs) == 0
    assert timeline.profiler_offset_ns(1_700_000_000_000_001_000, pairs) \
        == (5_000 - 1_700_000_000_000_000_000
            + 9_000 - 1_700_000_000_000_004_002) // 2
    with pytest.raises(ValueError, match="neither"):
        timeline.profiler_offset_ns(10 ** 17, pairs)
