"""The fused runtime's CUDA graph of its step (runtime/fused.py), on the
CPU: what runs without a card.

A CPU node steps eagerly every tick and says so in its counters; the
restage that copies a rebound state or inbox into the graph's buffers,
the copies that settle a step's results into them, and the launch
accounting that counts a capture's kernels on every replay are held
here; GET /metrics shows the four counters.  The graph itself, held to
the eager step leaf by leaf, is tests/test_torch_cuda.py's.
"""
import http.client
import json

import pytest
import torch

from raftsql_tpu_torch.api.aio import AioSQLServer
from raftsql_tpu_torch.config import RaftConfig
from raftsql_tpu_torch.core import cluster
from raftsql_tpu_torch.ops import pallas_quorum as pq
from raftsql_tpu_torch.runtime import fused
from raftsql_tpu_torch.server.main import build_fused_node
from raftsql_tpu_torch.transport.faults import drop_messages

torch.set_num_threads(1)

K1, K2 = "pallas_quorum_commit_index", "pallas_masked_quorum_commit_index"


def _cfg(**kw):
    args = dict(num_groups=4, num_peers=3, log_window=32,
                max_entries_per_msg=4, election_ticks=10,
                heartbeat_ticks=1, tick_interval_s=0.0,
                commit_rule="pallas")
    args.update(kw)
    return RaftConfig(**args)


@pytest.mark.parametrize("steps", [1, 2])
def test_cpu_node_steps_eagerly(tmp_path, monkeypatch, steps):
    monkeypatch.setenv("RAFTSQL_FUSED_STEPS", str(steps))
    node = fused.FusedClusterNode(_cfg(), str(tmp_path), device="cpu")
    try:
        for _ in range(30):
            node.tick()
        m = node.metrics
        assert (m.eager_steps, m.graph_captures, m.graph_replays,
                m.graph_restages) == (30, 0, 0, 0)
        assert node._graph is None
    finally:
        node.stop()


def _stepped(cfg, ticks=12):
    """A cluster state and inbox after `ticks` eager steps: live leaves,
    the inbox leaves strided views of the outbox."""
    st = cluster.init_cluster_state(cfg, seed=3, device="cpu")
    ib = cluster.empty_cluster_inbox(cfg, device="cpu")
    for _ in range(ticks):
        st, ib, _, _ = cluster.cluster_step_host(
            cfg, st, ib, torch.ones((3, cfg.num_groups), dtype=torch.int32))
    return st, ib


def _bufs(tup):
    return type(tup)(*[x.contiguous().clone() for x in tup])


class _Node:
    def __init__(self, states, inboxes):
        self.states, self.inboxes = states, inboxes


@pytest.mark.parametrize("which", ["states", "inboxes", "both"])
def test_restage_copies_a_rebound_state_into_the_buffers(which):
    cfg = _cfg()
    st, ib = _stepped(cfg)
    bs, bi = _bufs(st), _bufs(ib)
    ptrs = [x.data_ptr() for x in bs + bi]
    node = _Node(bs, bi)
    assert fused.restage(node, bs, bi) is False
    want_s, want_i = bs, bi
    if which in ("states", "both"):
        want_s = st._replace(term=st.term + 5, xfer_target=st.term * 0 + 1)
        node.states = want_s
    if which in ("inboxes", "both"):
        want_i = drop_messages(ib, torch.rand(ib.v_type.shape,
                                              generator=torch.Generator()
                                              .manual_seed(1)) < 0.5)
        node.inboxes = want_i
    assert fused.restage(node, bs, bi) is True
    assert node.states is bs and node.inboxes is bi
    assert [x.data_ptr() for x in bs + bi] == ptrs
    for got, want in zip(bs + bi, want_s + want_i):
        assert got.is_contiguous() and torch.equal(got, want)
    assert fused.restage(node, bs, bi) is False


def test_restage_refuses_another_shape():
    """A rebound state of another shape changes the step key, so the
    graph is dropped and nothing is restaged; one of the same shapes
    and dtypes keeps the key and is copied in."""
    cfg = _cfg()
    st, ib = _stepped(cfg)
    bs, bi = _bufs(st), _bufs(ib)
    pn = torch.zeros((3, cfg.num_groups), dtype=torch.int32)
    ti = torch.ones((3,), dtype=torch.int32)
    key = fused.step_key(cfg, 1, bs, bi, pn, ti)
    assert fused.step_key(cfg, 1, st, ib, pn, ti) == key
    other, _ = _stepped(_cfg(num_groups=5), ticks=1)
    assert fused.step_key(cfg, 1, other, bi, pn, ti) != key
    assert fused.step_key(cfg, 1, st._replace(term=st.term.long()), bi,
                          pn, ti) != key
    assert fused.step_key(_cfg(election_ticks=11), 1, bs, bi, pn, ti) != key
    assert fused.step_key(cfg, 2, bs, bi, pn, ti) != key
    assert fused.step_key(_cfg(), 1, bs, bi, pn, ti) == key


def test_settle_clones_results_that_alias_another_buffer():
    a, b, c = (torch.arange(4) + 10 * i for i in range(3))
    # The step's result for `a` is fresh, for `b` the old `a` (a view),
    # and `c` passes through: copying in order must not hand `b` the
    # `a` that the first copy has already overwritten.
    new = [b + 1, a[:], c]
    want = [x.clone() for x in new]
    copies = fused._settle([a, b, c], new)
    assert [dst is x for (dst, _), x in zip(copies, (a, b))] == [True, True]
    assert len(copies) == 2
    for dst, src in copies:
        dst.copy_(src)
    assert all(torch.equal(x, w) for x, w in zip((a, b, c), want))


def test_replays_count_the_kernels_a_capture_recorded():
    pq.reset_launches()
    pq._count(K1)
    with pq.counting_capture() as counts:
        pq._count(K1)
        pq._count(K2)
        pq._count(K2)
    assert pq.launches == {K1: 1, K2: 0}
    assert counts == {K1: 1, K2: 2}
    for _ in range(3):
        pq.count_replay(counts)
    assert pq.launches == {K1: 4, K2: 6}
    pq._count(K1)
    assert pq.launches[K1] == 5
    pq.reset_launches()


def test_metrics_show_the_graph_counters(tmp_path):
    rdb = build_fused_node(groups=2, peers=3, tick=0.002,
                           data_prefix=str(tmp_path / "raftsql"),
                           commit_rule="pallas", device="cpu")
    srv = AioSQLServer(0, rdb, host="127.0.0.1", timeout_s=30.0)
    srv.start()
    def req(method, path, body=b""):
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        try:
            conn.request(method, path, body=body)
            r = conn.getresponse()
            return r.status, r.read()
        finally:
            conn.close()

    try:
        # An acknowledged PUT: the node has stepped.
        assert req("PUT", "/", b"CREATE TABLE main.t (v text)")[0] == 204
        status, body = req("GET", "/metrics")
        assert status == 200
        doc = json.loads(body)
        ds = doc["device_step"]
        assert set(ds) == {"graph_captures", "graph_replays",
                           "graph_restages", "eager_steps"}
        assert ds["graph_captures"] == ds["graph_replays"] == 0
        assert ds["eager_steps"] > 0 and "phase_ms_per_tick" in doc
    finally:
        srv.stop()
        rdb.close()
