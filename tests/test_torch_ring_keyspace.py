"""The port's repairs of the worker plane (runtime/ring.py) for the
elastic keyspace and large documents, beside the JAX package's ring.

The JAX package's api/aio.py calls the reshard plane's methods on
`rdb.reshard`, which at a worker is `RingClient.reshard`, a method: a
POST /reshard or a /kv request at a JAX worker answers 400.  Its engine
answers a document larger than the completion ring with an error (a
worker's GET /trace dies once the trace outgrows 4 MiB).  The port
carries the keyed surface over ring ops 6 and 7 (`RingKeyspace`) and
hands a large document over as a file in the ring directory.
"""
import json
import os
import time

import pytest
import torch

from raftsql_tpu.runtime import ring as jring
from raftsql_tpu_torch.reshard.coordinator import ReshardRefused
from raftsql_tpu_torch.reshard.plane import (FrozenSlot, ReshardPlane,
                                             WrongEpoch)
from raftsql_tpu_torch.runtime import ring as tring

torch.set_num_threads(1)


class _DocDB:
    """The document surface RingServer renders (no shm plane)."""

    def __init__(self, trace: str):
        self.trace = trace

    def render_trace(self):
        return self.trace

    render_metrics = render_health = render_members = render_events = \
        render_trace


def _doc_round_trip(mod, tmp_path, trace):
    srv = mod.RingServer(_DocDB(trace), str(tmp_path), workers=1,
                         ring_bytes=1 << 16)
    srv.start()
    rc = mod.RingClient(str(tmp_path), 0)
    try:
        return rc.render_trace()
    finally:
        rc.close()
        srv.stop()


def test_large_document_crosses_the_ring(tmp_path):
    trace = json.dumps({"traceEvents": [{"name": f"e{i}", "ph": "i",
                                         "ts": i} for i in range(8000)]})
    assert len(trace) > 1 << 16
    assert _doc_round_trip(tring, tmp_path / "port", trace) == trace
    assert not [f for f in os.listdir(tmp_path / "port")
                if f.startswith("doc-")]
    small = json.dumps({"traceEvents": []})
    assert _doc_round_trip(tring, tmp_path / "small", small) == small
    with pytest.raises(RuntimeError, match="exceeds ring capacity"):
        _doc_round_trip(jring, tmp_path / "jax", trace)


def test_jax_ring_client_has_no_keyspace_surface():
    """The reference fault: what the HTTP planes call on `rdb.reshard`
    does not exist on a JAX worker's RingClient."""
    assert callable(jring.RingClient.reshard)
    assert not hasattr(jring.RingClient.reshard, "enqueue")
    assert not hasattr(jring.RingClient.reshard, "kv_put")


@pytest.fixture
def engine(tmp_path):
    from raftsql_tpu_torch.server.main import build_fused_node
    rdb = build_fused_node(groups=4, peers=3, tick=0.005,
                           data_prefix=str(tmp_path / "raftsql"),
                           device="cpu")
    plane = ReshardPlane(rdb, nslots=16, ship_dir=str(tmp_path / "ship"))
    plane.start()
    srv = tring.RingServer(rdb, str(tmp_path / "rings"), workers=1)
    srv.start()
    rc = tring.RingClient(str(tmp_path / "rings"), 0)
    yield rdb, plane, rc
    rc.close()
    srv.stop()
    plane.stop()
    rdb.close()


def test_keyspace_surface_over_the_ring(engine):
    rdb, plane, rc = engine
    ks = rc.reshard
    got = ks.kv("PUT", "alpha", value="1|one", token=0x55, timeout=30.0)
    assert got["epoch"] == 0 and got["group"] == plane.keymap.group_of(
        "alpha")
    assert rc.watermark(got["group"]) >= 1
    got = ks.kv("GET", "alpha", timeout=30.0)
    assert ReshardPlane.kv_value(got["rows"]) == "1|one"
    nope = next(f"nope{i}" for i in range(200)
                if plane.keymap.group_of(f"nope{i}") == got["group"])
    got_nope = ks.kv("GET", nope, timeout=30.0)
    assert ReshardPlane.kv_value(got_nope["rows"]) is None
    # A verb at the engine; a second one is refused (409 class).
    owned = plane.keymap.slots_of(plane.keymap.group_of("alpha"))
    src = plane.keymap.group_of("alpha")
    doc = ks.enqueue("split", src, (src + 1) % 4,
                     [plane.keymap.slot_of("alpha")])
    assert doc["verb"] in ("split", "merge") and len(owned) > 1
    with pytest.raises(ReshardRefused, match="in flight"):
        ks.enqueue("split", src, (src + 2) % 4, owned[:1])
    until = time.monotonic() + 30.0
    while plane.coord.busy:
        assert time.monotonic() < until, plane.doc()
        time.sleep(0.02)
    # A request pinned to the old epoch fails closed with the mapping.
    with pytest.raises(WrongEpoch):
        ks.kv("GET", "alpha", epoch=0, timeout=30.0)
    assert ks.keymap.epoch == 1
    assert ks.keymap.to_doc() == plane.keymap.to_doc()
    got = ks.kv("GET", "alpha", epoch=1, timeout=30.0)
    assert ReshardPlane.kv_value(got["rows"]) == "1|one"
    assert got["group"] == (src + 1) % 4
    # Frozen-slot intake is refused before anything is proposed.
    s = plane.keymap.slot_of("beta")
    plane.keymap.freeze([s])
    try:
        with pytest.raises(FrozenSlot) as e:
            ks.kv("PUT", "beta", value="2", timeout=30.0)
        assert e.value.slot == s
    finally:
        plane.keymap.unfreeze([s])
    with pytest.raises(ValueError, match="unknown verb"):
        try:
            ks.enqueue("rotate", 0, 1)
        except ReshardRefused as r:
            raise ValueError(str(r))
