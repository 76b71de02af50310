"""The port's observability planes (raftsql_tpu_torch/obs/) against the
JAX package's, on the CPU.

The device event ring of a traced lockstep run must hold the JAX
package's rows tick for tick, with each side booted from its own seed
(the boot draws are the same threefry draws).  The span lifecycle, the
Chrome-trace export (checked by both packages' validators), the flight
recorder on a forced invariant failure, and GET /trace + GET /events on
the port's `--fused --trace` server follow the JAX package's obs tests.
"""
import http.client
import json
import os

import numpy as np
import pytest
import torch

from raftsql_tpu.config import RaftConfig as JConfig
from raftsql_tpu.obs.export import validate_chrome_trace as j_validate
from raftsql_tpu.runtime.fused import FusedClusterNode as JNode
from raftsql_tpu_torch.api.aio import AioSQLServer
from raftsql_tpu_torch.api.http import SQLServer
from raftsql_tpu_torch.config import RaftConfig as TConfig
from raftsql_tpu_torch.obs import (EVENT_FIELDS, DeviceEventRing,
                                   SpanTracer, TraceSegmentWriter,
                                   chrome_trace, collect_segments,
                                   validate_chrome_trace)
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
