"""The cases of tests/test_overload.py, on the port (its overload/ and
api/client.py), plus the overload chaos family against the JAX
package's.  The reference file's docstring follows.
Overload plane units (raftsql_tpu/overload/) + client backoff.

Two halves, matching the overload plane's contract:

* the controller itself — budgets refuse BEFORE the enqueue, deadline
  sheds attribute a phase, the brownout ladder never downgrades
  silently, and the advisory Retry-After stays inside its clamp; and

* the client side of the refusal (satellite c) — a 429's Retry-After
  holds exactly THAT node out of the rotation (no global stall, no
  retry storm), junk header values are ignored, and a request whose
  deadline already passed fails fast without a network round trip.

No sockets anywhere: the client's `raw` is monkeypatched, the
controller is driven directly.

The family: at seed 0 the JAX package's OverloadChaosRunner runs once
and the port's twice (the point rule, and the pallas rule, whose kernel
takes its plain version here); the reports — plan and result digests,
`group_commits` and every `overload_*` counter — must be equal key for
key, and the digests equal the constants chip_smoke.py holds the card
to.
"""
import time

import pytest
import torch

import chip_smoke
from raftsql_tpu.chaos import schedule as JS
from raftsql_tpu.chaos.scenarios import OverloadChaosRunner as JRunner
from raftsql_tpu_torch.api.client import RaftSQLClient, Unavailable
from raftsql_tpu_torch.chaos import run as trun
from raftsql_tpu_torch.chaos import schedule as TS
from raftsql_tpu_torch.overload import (
    BROWNOUT_LEASE_ONLY,
    BrownoutGovernor,
    DeadlineExceeded,
    Overloaded,
    OverloadController,
    deadline_steps,
    retry_after_header,
    retryable_refusal,
    zero_metrics_doc,
)

torch.set_num_threads(1)


# -- admission budgets -------------------------------------------------


def _ctl(**kw):
    kw.setdefault("groups", 4)
    kw.setdefault("seed", 0)
    return OverloadController(**kw)


def test_admit_refuses_before_enqueue_per_group():
    c = _ctl(group_cap=4)
    assert c.admit(0, 3) == 3
    # The 4th entry still fits; a batch of 2 would overflow and must
    # be refused WHOLE (budgets are checked before the enqueue, so the
    # real queue can never exceed the cap mid-batch).
    with pytest.raises(Overloaded) as ei:
        c.admit(0, 2)
    assert ei.value.scope == "group:0"
    assert c.rejected == 2 and c._depth[0] == 3
    # Other groups have their own budget.
    assert c.admit(1, 4) == 4
    assert c.depth_total == 7 and c.peak_depth == 7


def test_admit_engine_budget_spans_groups():
    c = _ctl(group_cap=0, total_cap=5)
    c.admit(0, 3)
    c.admit(1, 2)
    with pytest.raises(Overloaded) as ei:
        c.admit(2, 1)
    assert ei.value.scope == "engine"
    assert c.admitted == 5 and c.rejected == 1


def test_zero_caps_track_depth_but_never_refuse():
    c = _ctl()                              # both budgets disabled
    c.admit(0, 10_000)
    assert c.depth_total == 10_000 and c.rejected == 0


def test_drained_and_stage_shed_release_budget():
    c = _ctl(group_cap=4)
    c.admit(0, 4)
    with pytest.raises(Overloaded):
        c.admit(0, 1)
    c.drained(0, 3)
    c.stage_shed(0, 1)
    assert c.depth_total == 0 and c.shed_stage == 1
    assert c.admit(0, 4) == 4               # budget fully returned
    assert c.peak_depth == 4


def test_reset_depth_survives_counters():
    """Crash/restart: the queues died with the node, the cumulative
    counters must not (they feed the chaos report)."""
    c = _ctl(group_cap=4)
    c.admit(0, 4)
    with pytest.raises(Overloaded):
        c.admit(0, 1)
    c.reset_depth()
    assert c.depth_total == 0 and c._depth[0] == 0
    assert c.admitted == 4 and c.rejected == 1
    assert c.admit(0, 2) == 2


# -- deadline clocks ---------------------------------------------------


def test_deadline_steps_conversion_and_floor():
    # 10 ms at 1 ms/step = 10 steps from now.
    assert deadline_steps(100, 10.0, 0.001) == 110
    # Untimed engine (tick_interval_s=0): the 0.1 ms/step floor, the
    # same floor the lease clock uses.
    assert deadline_steps(0, 1.0, 0.0) == 10
    # A zero/negative budget never moves the deadline into the past.
    assert deadline_steps(7, 0.0, 0.001) == 7


def test_check_deadline_attributes_the_phase():
    c = _ctl()
    assert c.check_deadline(5, None, "stage") is True
    assert c.check_deadline(5, 5, "stage") is True   # inclusive
    with pytest.raises(DeadlineExceeded) as ei:
        c.check_deadline(6, 5, "stage")
    assert ei.value.phase == "stage" and c.shed_stage == 1
    with pytest.raises(DeadlineExceeded):
        c.check_deadline(6, 5, "ring")
    assert c.shed_ring == 1
    c.note_shed("edge")
    c.note_shed("commit_wait")
    assert c.shed_edge == 1 and c.shed_commit_wait == 1


# -- brownout ladder ---------------------------------------------------


def test_brownout_governor_hysteresis():
    g = BrownoutGovernor(hi=10.0, lo=3.0, alpha=1.0)  # alpha=1: no lag
    assert g.note_depth(9) == 0
    assert g.note_depth(11) == BROWNOUT_LEASE_ONLY
    # Between lo and hi: stays browned out (the hysteresis gap).
    assert g.note_depth(5) == BROWNOUT_LEASE_ONLY
    assert g.note_depth(2) == 0
    assert g.transitions == 2
    with pytest.raises(ValueError):
        BrownoutGovernor(hi=5.0, lo=5.0)


def test_brownout_read_path_never_silently_downgrades():
    c = _ctl(total_cap=100, brownout_hi=4.0, brownout_lo=1.0)
    assert c.brownout_read_path(opt_in=False) == "read_index"
    # Sustained depth pushes the EWMA over hi.
    c.admit(0, 50)
    for _ in range(8):
        c.note_tick()
    assert c.brownout_active()
    # Opted in: degraded to a session read, counted.
    assert c.brownout_read_path(opt_in=True) == "session"
    # Not opted in: typed refusal, never a silent stale answer.
    with pytest.raises(Overloaded) as ei:
        c.brownout_read_path(opt_in=False)
    assert ei.value.scope == "brownout"
    assert c.brownouts == 2


def test_no_total_cap_means_no_governor_by_default():
    assert _ctl().governor is None
    assert _ctl(total_cap=48).governor is not None
    # Explicit thresholds work without a total cap.
    assert _ctl(brownout_hi=8.0).governor is not None


# -- advisory Retry-After ----------------------------------------------


def test_retry_after_pessimistic_then_drain_tracking():
    c = _ctl(total_cap=100)
    # No drain observed yet: the pessimistic 5 s base, jittered into
    # [2.5, 7.5).
    for _ in range(32):
        assert 2.5 <= c.retry_after_s() < 7.5
    # Steady drain of 10 entries/tick at 1 ms/tick, backlog 20:
    # base = 20/10 * 0.001 = 2 ms -> clamped up to the 10 ms floor.
    c.admit(0, 20)
    for _ in range(64):
        c.drained(0, 10)
        c._depth[0] += 10          # hold the backlog constant
        c.depth_total += 10
        c.note_tick()
    for _ in range(32):
        assert 0.005 <= c.retry_after_s() < 0.015


def test_retry_after_header_floor_and_format():
    assert retry_after_header(0.0) == "0.010"
    assert retry_after_header(-3.0) == "0.010"
    assert retry_after_header(1.2345) == "1.234"
    assert float(retry_after_header(5.0)) == 5.0


def test_retryable_refusal_unified_mapping():
    st, ra = retryable_refusal(Overloaded("engine", 0.25))
    assert (st, ra) == (429, 0.25)
    st, ra = retryable_refusal(TimeoutError("apply"), default_retry_s=2.0)
    assert (st, ra) == (503, 2.0)


def test_metrics_doc_matches_zero_doc_shape():
    """Both HTTP planes flatten m["overload"] into raftsql_overload_*
    series; attached and detached engines must export the SAME keys or
    check_prom's required-series list breaks on one of them."""
    assert set(_ctl().metrics_doc()) == set(zero_metrics_doc())


# -- client: per-node Retry-After holdoff (satellite c) -----------------


def _client(**kw):
    kw.setdefault("timeout_s", 0.2)
    kw.setdefault("backoff_s", 0.001)
    kw.setdefault("backoff_cap_s", 0.002)
    return RaftSQLClient([10001, 10002, 10003], **kw)


def test_retry_after_parsing_and_clamp():
    c = _client()
    c._note_retry_after(0, {"Retry-After": "1.5"})
    assert c._holdoff[0] > time.monotonic() + 1.0
    # Clamped: a hostile/buggy server cannot park a node for an hour.
    c._note_retry_after(1, {"Retry-After": "3600"})
    assert c._holdoff[1] <= time.monotonic() + 30.0
    # Junk, absent, zero and negative values are all ignored.
    c._note_retry_after(2, {"Retry-After": "soon"})
    c._note_retry_after(2, {})
    c._note_retry_after(2, {"Retry-After": "0"})
    c._note_retry_after(2, {"Retry-After": "-2"})
    assert 2 not in c._holdoff
    # A shorter estimate never truncates a live longer holdoff.
    before = c._holdoff[1]
    c._note_retry_after(1, {"Retry-After": "0.01"})
    assert c._holdoff[1] == before


def test_holdoff_skips_node_but_never_empties_rotation():
    c = _client()
    c._holdoff[1] = time.monotonic() + 60.0
    for _ in range(8):
        assert 1 not in c._order(0, None)
    # Expired holdoffs rejoin.
    c._holdoff[1] = time.monotonic() - 0.001
    assert 1 in c._order(0, None)
    # All nodes held off: desperation wins over an empty rotation.
    now = time.monotonic()
    for i in range(3):
        c._holdoff[i] = now + 60.0
    assert len(c._order(0, None)) == 3


def test_put_429_holds_that_node_out():
    """One saturated engine answers 429+Retry-After; the write lands
    on a peer and the NEXT request never dials the saturated node."""
    c = _client()
    calls = []

    def fake_raw(node, method, path="/", body="", headers=None,
                 timeout_s=None):
        calls.append(node)
        if node == 0:
            return 429, {"Retry-After": "9.000"}, "overloaded (engine)"
        return 204, {}, ""

    c.raw = fake_raw
    c._rr = 0                               # rotation starts at node 0
    c._hints_at = time.monotonic()          # suppress the hint sweep
    assert c.put("insert into kv values ('a','1')",
                 deadline_s=5) is None
    assert calls == [0, 1]
    calls.clear()
    c.put("insert into kv values ('b','2')", deadline_s=5)
    assert 0 not in calls and len(calls) == 1


def test_cluster_wide_429_is_bounded_no_retry_storm():
    """Every node refusing must produce Unavailable after a BOUNDED
    number of attempts — backoff between rotations, not a tight loop
    hammering the cluster it just learned is saturated."""
    c = _client(backoff_s=0.01, backoff_cap_s=0.02)
    calls = []

    def fake_raw(node, method, path="/", body="", headers=None,
                 timeout_s=None):
        calls.append(node)
        return 429, {"Retry-After": "0.050"}, "overloaded (engine)"

    c.raw = fake_raw
    c._hints_at = time.monotonic()          # suppress the hint sweep
    with pytest.raises(Unavailable) as ei:
        c.put("insert into kv values ('c','3')", deadline_s=0.05)
    assert "429" in str(ei.value)
    # 50 ms of deadline with backoff between rotations: a handful of
    # rounds over 3 nodes, nowhere near a storm.
    assert len(calls) <= 30


def test_expired_deadline_fails_fast_without_round_trip():
    c = _client()

    def fake_raw(*a, **k):
        raise AssertionError("network dialled past the deadline")

    c.raw = fake_raw
    c.raw_replica = fake_raw
    c._hints_at = time.monotonic()          # suppress the hint sweep
    with pytest.raises(Unavailable):
        c.put("insert into kv values ('d','4')", deadline_s=0)
    with pytest.raises(Unavailable):
        c.get("select v from kv", deadline_s=0)


def test_requests_carry_remaining_deadline_header():
    """End-to-end propagation starts at the client: every attempt
    advertises its REMAINING budget so the server can shed before
    paying WAL cost."""
    c = _client()
    seen = []

    def fake_raw(node, method, path="/", body="", headers=None,
                 timeout_s=None):
        seen.append(dict(headers or {}))
        return (204, {}, "") if method == "PUT" else (200, {}, "|1|")

    c.raw = fake_raw
    c._hints_at = time.monotonic()          # suppress the hint sweep
    c.put("insert into kv values ('e','5')", deadline_s=2.0)
    c.get("select v from kv", linear=True, deadline_s=2.0)
    for h in seen:
        ms = int(h["X-Raft-Deadline-Ms"])
        assert 1 <= ms <= 2000


# -- the overload chaos family against the JAX package's ----------------


@pytest.fixture(scope="module")
def jax_overload(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax-overload")
    return JRunner(JS.generate_overload(0), str(d)).run()


@pytest.mark.parametrize("rule", ["point", "pallas"])
def test_overload_family_seed0_equals_jax(jax_overload, rule):
    plan = TS.generate_overload(0)
    assert plan.describe() == JS.generate_overload(0).describe()
    got = trun.run_fused(plan, device="cpu", commit_rule=rule)
    assert got == jax_overload
    assert (got["plan_digest"], got["result_digest"]) \
        == chip_smoke.CHAOS_DIGESTS["overload"]
    assert got["overload_rejected"] > 0 and got["overload_shed_stage"] > 0
    assert got["overload_depth_peak"] <= plan.total_cap


def test_overload_plans_equal_jax():
    for seed in (0, 1, 2, 3):
        assert TS.generate_overload(seed).digest() \
            == JS.generate_overload(seed).digest()
        for broken in (True, False):
            assert TS.falsification_overload_plan(seed, broken).digest() \
                == JS.falsification_overload_plan(seed, broken).digest()


def test_overload_gauntlet_cli(capsys):
    """`chaos.run --overload`: the family, its checks and the
    falsification pair (the missing admission bound caught as
    OVERLOAD-MEMORY, the bounded control passing and refusing)."""
    assert trun.main(["--overload", "--runs", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("chaos overload ok: seed=0 "
                              "plan=993c8f68e0b1ac1a")
    assert any('"falsification": "caught"' in line
               and "OVERLOAD-MEMORY" in line for line in out)
    assert any('"falsification_control": "passed"' in line
               for line in out)
