"""The cases of tests/test_client.py, on the port's api/client.py.
The reference file's docstring follows.

api/client.py unit tests: leader-cache transitions on 421 hints.

Leadership transfers make leadership MOVE on purpose, so the
client's 421 handling is now on the hot path: a hint naming a node
other than the cached leader must invalidate the cache and rotate the
request to the new leader IMMEDIATELY — finishing the old rotation
first would spend a full round of timeouts on nodes known not to lead.
No sockets here: `raw` is monkeypatched, the cache logic is the unit.
"""
from raftsql_tpu_torch.api.client import RaftSQLClient


def _client():
    # Ports never dialled — raw() is replaced in every test that sends.
    return RaftSQLClient([10001, 10002, 10003], timeout_s=0.2,
                         backoff_s=0.001, backoff_cap_s=0.002)


def test_note_leader_change_detection():
    c = _client()
    # Empty cache: any valid hint is a change.
    assert c._note_leader(0, {"X-Raft-Leader": "2"}) is True
    assert c._leader[0] == 1
    # Same hint again: cache already right, no rotation needed.
    assert c._note_leader(0, {"X-Raft-Leader": "2"}) is False
    assert c._leader[0] == 1
    # Different hint (leadership transferred): change, cache follows.
    assert c._note_leader(0, {"X-Raft-Leader": "3"}) is True
    assert c._leader[0] == 2
    # Groups are independent.
    assert c._note_leader(5, {"X-Raft-Leader": "1"}) is True
    assert c._leader[0] == 2 and c._leader[5] == 0


def test_note_leader_hintless_421_invalidates():
    c = _client()
    assert c._note_leader(0, {"X-Raft-Leader": "1"}) is True
    # 421 with no (or junk) hint: the cached leader is demonstrably
    # wrong — drop it so the next rotation is unbiased.
    assert c._note_leader(0, {}) is False
    assert 0 not in c._leader
    c._leader[0] = 1
    assert c._note_leader(0, {"X-Raft-Leader": "zap"}) is False
    assert 0 not in c._leader


def test_put_chases_moved_leader_immediately():
    c = _client()
    c._leader[0] = 0                       # stale: node 0 used to lead
    calls = []

    def fake_raw(node, method, path="/", body="", headers=None,
                 timeout_s=None):
        calls.append(node)
        if node == 2:
            return 204, {"X-Raft-Session": "7"}, ""
        # Everyone else redirects to node 3 (idx 2): a transfer moved
        # leadership mid-flight.
        return 421, {"X-Raft-Leader": "3"}, "not leader"

    c.raw = fake_raw
    assert c.put("insert into kv values ('a','1')", deadline_s=5) == 7
    # The changed hint must ABANDON the rotation: exactly one miss at
    # the stale leader, then straight to the new one — the third node
    # is never dialled.
    assert calls == [0, 2]
    assert c._leader[0] == 2


def test_put_same_hint_keeps_rotating():
    c = _client()
    c._leader[0] = 2                       # cache already names idx 2
    calls = []

    def fake_raw(node, method, path="/", body="", headers=None,
                 timeout_s=None):
        calls.append(node)
        if len(calls) >= 4:
            return 204, {}, ""
        # idx 2 (the cached leader) answers 421 naming ITSELF — e.g.
        # it is mid-step-down; no rotation reset, just move on.
        return 421, {"X-Raft-Leader": "3"}, "not yet"

    c.raw = fake_raw
    assert c.put("insert into kv values ('b','2')", deadline_s=5) is None
    # Cached leader first, then the round-robin remainder — the
    # self-naming hint must NOT restart the order (that would hammer
    # one node in a tight loop).
    assert calls[0] == 2
    assert set(calls[:3]) == {0, 1, 2}


def test_get_rotates_on_changed_hint():
    c = _client()
    c._leader[0] = 0
    calls = []

    def fake_raw(node, method, path="/", body="", headers=None,
                 timeout_s=None):
        calls.append(node)
        if node == 1:
            return 200, {}, "42"
        return 421, {"X-Raft-Leader": "2"}, "moved"

    c.raw = fake_raw
    assert c.get("select v from kv", linear=True, deadline_s=5) == "42"
    assert calls == [0, 1]
    assert c._leader[0] == 1


# -- the read-replica tier: nearest-first routing + fallback -------------


def _with_replicas(c, n=2):
    c._adopt_replicas([f"127.0.0.1:{20001 + i}" for i in range(n)])
    return c


def test_adopt_replicas_is_idempotent_append_only():
    c = _client()
    assert c._adopt_replicas(["h:20001", "h:20002"]) == 2
    assert c._adopt_replicas(["h:20002", "h:20003", "junk"]) == 1
    assert c.replica_endpoints() == ["h:20001", "h:20002", "h:20003"]


def test_replica_order_is_rtt_ewma_nearest_first():
    c = _with_replicas(_client(), n=3)
    c._note_rtt(0, 12.0)
    c._note_rtt(1, 3.0)
    # replica 2 unmeasured: goes last until its first probe answers.
    assert c._replica_order() == [1, 0, 2]
    # EWMA: one slow sample must not instantly demote a near replica.
    c._note_rtt(1, 8.0)
    assert c._rtt[1] == 0.7 * 3.0 + 0.3 * 8.0
    assert c._replica_order() == [1, 0, 2]
    with c._mu:
        c._ralive[1] = False                 # dead endpoints drop out
    assert c._replica_order() == [0, 2]


def test_get_session_routes_to_replica_and_carries_watermark():
    """Satellite: the session watermark a PUT returned must reach the
    replica verbatim (X-Raft-Session), and a 200 there never touches
    the write tier."""
    c = _with_replicas(_client())
    seen = {}

    def fake_raw_replica(ridx, method, path="/", body="", headers=None,
                         timeout_s=None):
        seen.update(headers or {}, ridx=ridx, body=body)
        return 200, {"X-Raft-Session": "9"}, "|5|"

    c.raw_replica = fake_raw_replica
    c.raw = lambda *a, **k: (_ for _ in ()).throw(
        AssertionError("write tier dialled despite replica 200"))
    c._hints_at = __import__("time").monotonic()   # suppress the sweep
    rows, wm = c.get_session("SELECT count(*) FROM t",
                             consistency="session", session=7)
    assert rows == "|5|" and wm == 9
    assert seen["X-Raft-Session"] == "7"
    assert seen["X-Consistency"] == "session"


def test_get_session_falls_back_to_write_tier_on_421():
    """Satellite: any replica refusal (the fail-closed ladder answers
    421) must fall through to the authoritative tier — and adopt the
    leader hint the refusal carried."""
    c = _with_replicas(_client())
    order = []

    def fake_raw_replica(ridx, method, path="/", body="", headers=None,
                         timeout_s=None):
        order.append(("replica", ridx))
        return 421, {"X-Raft-Leader": "2"}, "replica refuses"

    def fake_raw(node, method, path="/", body="", headers=None,
                 timeout_s=None):
        order.append(("engine", node))
        return 200, {"X-Raft-Session": "4"}, "|1|"

    c.raw_replica = fake_raw_replica
    c.raw = fake_raw
    c._hints_at = __import__("time").monotonic()
    rows, wm = c.get_session("SELECT 1", consistency="session")
    assert rows == "|1|" and wm == 4
    # Both replicas refused, then the write tier answered — and the
    # hint from the refusal warmed the leader cache.
    assert order[:2] == [("replica", 0), ("replica", 1)]
    assert order[2][0] == "engine"
    assert c._leader[0] == 1
    assert c.replica_stats["127.0.0.1:20001"] == [0, 1]


def test_replica_conn_error_marks_dead_and_falls_back():
    c = _with_replicas(_client())

    def fake_raw_replica(ridx, method, path="/", body="", headers=None,
                         timeout_s=None):
        if ridx == 0:
            raise ConnectionRefusedError("down")
        return 200, {}, "|2|"

    c.raw_replica = fake_raw_replica
    c._hints_at = __import__("time").monotonic()
    assert c.get("SELECT 1") == "|2|"
    assert c._ralive[0] is False
    # Dead endpoint skipped on the next pass.
    assert c._replica_order() == [1]


def test_refresh_hints_adopts_replica_endpoints():
    c = _client()
    docs = {0: {"groups": {"0": {"role": "leader"}},
                "replica": {"endpoints": ["127.0.0.1:20007"]}}}
    c.health = lambda idx, timeout_s=1.0: docs.get(idx)
    probed = []
    c.raw_replica = lambda ridx, *a, **k: probed.append(ridx) \
        or (200, {}, "{}")
    assert c.refresh_hints() == 1
    assert c.replica_endpoints() == ["127.0.0.1:20007"]
    assert probed == [0]                    # the sweep seeds the EWMA
