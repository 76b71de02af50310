"""The port's leadership-transfer and placement planes beside the JAX
package's, on the CPU.

  * The fused transfer cases of the JAX package's transfer tests
    (completion with its event log, the refusal taxonomy, the abort on
    deadline that re-opens the group) run on both packages' fused
    nodes, booted from seed 7: every tick's leader hints, latches,
    transfer docs, counters and hard states must be equal.
  * The TransferAvailability invariant's unit cases, on both packages.
  * The placement controller's decisions on the same traffic feeds,
    witnesses included, must be equal.
  * POST /transfer on the port's fused server, threaded and aio: 200
    and the leader moves; 400 on each refusal; 421 with the leader hint
    where the engine names another leader.
"""
import http.client
import json

import pytest
import torch

from raftsql_tpu.chaos import invariants as jinv
from raftsql_tpu.config import RaftConfig as JConfig
from raftsql_tpu.placement.controller import \
    PlacementController as JPlacement
from raftsql_tpu.runtime.fused import FusedClusterNode as JNode
from raftsql_tpu.runtime.node import TransferRefused as JRefused
from raftsql_tpu.transport import faults as jfaults
from raftsql_tpu.utils.metrics import GroupTraffic as JTraffic
from raftsql_tpu_torch.api.aio import AioSQLServer
from raftsql_tpu_torch.api.http import SQLServer
from raftsql_tpu_torch.chaos import invariants as tinv
from raftsql_tpu_torch.config import RaftConfig as TConfig
from raftsql_tpu_torch.membership import NotLeaderForChange
from raftsql_tpu_torch.placement.controller import \
    PlacementController as TPlacement
from raftsql_tpu_torch.runtime.fused import FusedClusterNode as TNode
from raftsql_tpu_torch.runtime.node import TransferRefused as TRefused
from raftsql_tpu_torch.server.main import build_fused_node
from raftsql_tpu_torch.transport import faults as tfaults
from raftsql_tpu_torch.utils.metrics import GroupTraffic as TTraffic

torch.set_num_threads(1)

JAX = dict(Node=JNode, Config=JConfig, faults=jfaults, Refused=JRefused,
           node_kw={})
PORT = dict(Node=TNode, Config=TConfig, faults=tfaults, Refused=TRefused,
            node_kw={"device": "cpu"})


def _node(pkg, path, rule):
    cfg = pkg["Config"](num_groups=2, num_peers=3, log_window=32,
                        max_entries_per_msg=4, election_ticks=10,
                        tick_interval_s=0.0, commit_rule=rule)
    return pkg["Node"](cfg, path, seed=7, **pkg["node_kw"])


def _obs(node):
    m = node.metrics
    return (node._tick_no, node._hints.tolist(), node._hard.tolist(),
            sorted(node.transferring_groups()), node.transfers_doc(),
            (m.transfers_initiated, m.transfers_completed,
             m.transfers_aborted, m.transfers_refused))


def _elect(node, rec):
    for t in range(200):
        node.tick()
        rec.append(_obs(node))
        if t > 10 and (node._hints >= 0).all():
            return
    raise AssertionError("no full leadership within budget")


def _refused(node, pkg, rec, *args, **kw):
    """A transfer request the engine must refuse: its refusal text."""
    try:
        node.transfer_leadership(*args, **kw)
    except pkg["Refused"] as e:
        rec.append(("refused", str(e)))
    except ValueError as e:
        rec.append(("range", str(e)))
    else:
        raise AssertionError(f"transfer {args} was not refused")


def _case_completes(pkg, path, rule):
    rec = []
    node = _node(pkg, path, rule)
    try:
        _elect(node, rec)
        old = int(node._hints[0])
        target = (old + 1) % 3
        node.propose_many(0, [b"SET k0 v0"])
        rec.append(("armed", node.transfer_leadership(0, target)))
        for _ in range(80):
            node.tick()
            rec.append(_obs(node))
            if int(node._hints[0]) == target \
                    and 0 not in node.transferring_groups():
                break
        before = int(node._hard[0, 0, 2])
        node.propose_many(0, [b"SET k0 v1"])
        for _ in range(20):
            node.tick()
            rec.append(_obs(node))
        rec.append(("served", int(node._hard[0, 0, 2]) > before,
                    dict(node.metrics.transfer_stall_hist)))
    finally:
        node.stop()
    return rec


def _case_refusals(pkg, path, rule):
    rec = []
    node = _node(pkg, path, rule)
    try:
        _refused(node, pkg, rec, 99, 0)
        _refused(node, pkg, rec, 0, 99)
        _refused(node, pkg, rec, 0, 0)              # no leader yet
        _elect(node, rec)
        lead = int(node._hints[0])
        _refused(node, pkg, rec, 0, lead)           # already leads
        node.transfer_leadership(0, (lead + 1) % 3)
        _refused(node, pkg, rec, 0, (lead + 2) % 3)  # in flight
        rec.append(_obs(node))
    finally:
        node.stop()
    return rec


def _case_abort(pkg, path, rule):
    rec = []
    node = _node(pkg, path, rule)
    try:
        _elect(node, rec)
        old = int(node._hints[0])
        target = (old + 1) % 3
        node.propose_many(0, [b"SET k0 v0", b"SET k0 v1"])
        node.transfer_leadership(0, target, deadline_ticks=12)
        for _ in range(40):
            node.inboxes = pkg["faults"].partition_peer(node.inboxes,
                                                        target)
            node.tick()
            rec.append(_obs(node))
            if 0 not in node.transferring_groups():
                break
        still_old = int(node._hints[0]) == old
        before = int(node._hard[0, 0, 2])
        node.propose_many(0, [b"SET k0 v2"])
        for _ in range(20):
            node.tick()
            rec.append(_obs(node))
        rec.append(("reopened", still_old,
                    int(node._hard[0, 0, 2]) > before))
    finally:
        node.stop()
    return rec


CASES = {"completes": _case_completes, "refusals": _case_refusals,
         "abort": _case_abort}


@pytest.mark.parametrize("rule", ["point", "pallas"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_transfer_case_equals_jax(tmp_path, case, rule):
    got = CASES[case](PORT, str(tmp_path / "port"), rule)
    assert got == CASES[case](JAX, str(tmp_path / "jax"), rule)
    last = got[-1]
    if case == "completes":
        ev = got[-22][4]["recent"][-1]
        assert ev["outcome"] == "completed" and ev["group"] == 0
        assert last[1] is True and sum(last[2].values()) == 1
    elif case == "refusals":
        kinds = [r[0] for r in got if isinstance(r[0], str)]
        assert kinds == ["range", "range", "refused", "refused", "refused"]
        assert "no leader" in got[2][1] and "in flight" in got[-2][1]
        assert last[5] == (1, 0, 0, 3)
    else:
        assert last == ("reopened", True, True)
        assert any(o[4]["recent"] and o[4]["recent"][-1]["outcome"]
                   == "aborted" for o in got[:-1]
                   if not isinstance(o[0], str))


# -- TransferAvailability (pure host logic) -----------------------------

@pytest.mark.parametrize("inv", [tinv, jinv], ids=["torch", "jax"])
def test_transfer_availability_cases(inv):
    def avail():
        return inv.TransferAvailability(election_ticks=10,
                                        deadline_ticks=40,
                                        max_stall_ticks=30, probe_ticks=20)

    a = avail()
    a.note_issued(5, 0, must_complete=True)
    with pytest.raises(inv.InvariantViolation,
                       match="TRANSFER-AVAILABILITY"):
        a.note_outcome(21, 0, "aborted", 16)
    a = avail()
    a.note_issued(5, 0, must_complete=True)
    with pytest.raises(inv.InvariantViolation, match="stalled"):
        a.note_outcome(50, 0, "completed", 45)
    a = avail()
    a.note_issued(5, 0, must_complete=False)
    a.note_outcome(21, 0, "aborted", 16)
    assert a.aborted == 1 and a.max_stall == 16
    a.check(200)
    a = avail()
    a.note_issued(5, 1, must_complete=False)
    a.check(5 + 40 + 2 * 10)
    with pytest.raises(inv.InvariantViolation, match="unresolved"):
        a.check(5 + 40 + 2 * 10 + 1)
    with pytest.raises(inv.InvariantViolation, match="never resolved"):
        a.final_check(199)
    a = avail()
    a.arm_probe(10, 0, "v7")
    a.probe_committed("v7")
    assert a.probes_confirmed == 1
    a.check(100)
    a.arm_probe(100, 1, "v8")
    with pytest.raises(inv.InvariantViolation, match="stopped serving"):
        a.check(121)
    a = avail()
    a.note_issued(5, 0, must_complete=True)
    a.arm_probe(5, 0, "v9")
    a.note_crash()
    a.check(500)
    a.final_check(500)


# -- placement ----------------------------------------------------------

class _Engine:
    """The engine surface PlacementController reads: a real GroupTraffic
    feed (of the package under test), scripted leaders, a recording
    transfer_leadership that can refuse."""

    def __init__(self, Config, Traffic, Refused, leaders, rates,
                 witnesses=None):
        self.cfg = Config(num_groups=len(leaders), num_peers=3,
                          tick_interval_s=0.0, witnesses=witnesses)
        self.traffic = Traffic(len(leaders), alpha=1.0)
        for g, n in enumerate(rates):
            self.traffic.add_propose(g, n)
        self.traffic._last_t -= 1.0       # one whole EWMA window
        self.leaders = list(leaders)
        self.transfers = []
        self.refuse = False
        self._refused = Refused

    def leader_of(self, g):
        return self.leaders[g]

    def transfer_leadership(self, g, target):
        if self.refuse:
            raise self._refused(g, "transfer already in flight")
        self.transfers.append((g, target))


FEEDS = [([0, 0, 1, 1], [60, 40, 8, 0], None, False),
         ([0, 0, 1, 2], [0, 0, 0, 0], None, False),
         ([0, 0], [50, 30], None, True),
         ([0, 0, 1, 1], [60, 40, 8, 0], (2,), False),
         ([0, 0], [50, 30], (1, 2), False)]


def _decisions(Placement, Config, Traffic, Refused, leaders, rates, wit,
               refuse):
    eng = _Engine(Config, Traffic, Refused, leaders, rates, wit)
    eng.refuse = refuse
    pc = Placement(eng, imbalance=2.0, min_rate=1.0)
    out = []
    for _ in range(2):
        d = pc.evaluate()
        if d is not None:
            d = {k: v for k, v in d.items() if k != "at"}
        out.append((d, list(eng.transfers), pc.metrics_doc()))
    return out


@pytest.mark.parametrize("feed", range(len(FEEDS)))
def test_placement_decisions_equal_jax(feed, monkeypatch):
    # The traffic EWMA divides by elapsed monotonic time: a frozen clock
    # makes each rate exactly the fed count over one window.
    import time
    monkeypatch.setattr(time, "monotonic", lambda: 1000.0)
    got = _decisions(TPlacement, TConfig, TTraffic, TRefused, *FEEDS[feed])
    assert got == _decisions(JPlacement, JConfig, JTraffic, JRefused,
                             *FEEDS[feed])
    first, transfers, m = got[0]
    if feed == 0:
        assert transfers == [(1, 2)] and first["to"] == 3
    if feed == 1:
        assert first is None and transfers == []
    if feed == 2:
        assert first["outcome"].startswith("refused")
        assert got[1][2]["backoff_groups"] >= 1
        assert m["refused"] == 1
    if feed == 3:
        assert transfers == [(1, 1)]         # never the witness, slot 2
    if feed == 4:
        assert first is None and transfers == []


# -- POST /transfer on the fused server ----------------------------------

def _post(srv, path, doc):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
    try:
        conn.request("POST", path, body=json.dumps(doc).encode())
        r = conn.getresponse()
        return r.status, r.read(), r.getheader("X-Raft-Leader")
    finally:
        conn.close()


def _wait(pred, node, what, ticks=2000):
    import time
    for _ in range(ticks):
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"{what}: {node.transfers_doc()}")


@pytest.mark.parametrize("engine", ["threaded", "aio"])
def test_post_transfer_on_fused_server(tmp_path, engine, monkeypatch):
    rdb = build_fused_node(groups=2, peers=3, tick=0.002,
                           data_prefix=str(tmp_path / "raftsql"),
                           commit_rule="pallas", device="cpu")
    cls = SQLServer if engine == "threaded" else AioSQLServer
    srv = cls(0, rdb, host="127.0.0.1", timeout_s=30.0)
    srv.start()
    node = rdb.pipe.node
    try:
        _wait(lambda: (node._hints >= 0).all(), node, "elections")
        lead = node.leader_of(0)
        target = (lead + 1) % 3
        st, body, _ = _post(srv, "/transfer", {"group": 0,
                                               "target": target})
        assert st == 200, body
        assert json.loads(body)["target"] == target + 1
        # A second request while the first is in flight: refused.
        st, body, _ = _post(srv, "/transfer",
                            {"group": 0, "target": (lead + 2) % 3})
        assert st == 400 and b"in flight" in body
        _wait(lambda: node.leader_of(0) == target
              and not node.transferring_groups(), node, "transfer")
        st, body, _ = _post(srv, "/transfer", {"group": 0,
                                               "target": target})
        assert st == 400 and b"already leads" in body
        st, body, _ = _post(srv, "/transfer", {"group": 9, "target": 0})
        assert st == 400 and b"out of range" in body
        # The fused engine leads every group in-process; an engine that
        # knows a leader elsewhere raises NotLeaderForChange, which both
        # HTTP planes answer with 421 and the hint.
        def elsewhere(group, target, deadline_ticks=None):
            raise NotLeaderForChange(group, 2)

        monkeypatch.setattr(node, "transfer_leadership", elsewhere)
        st, _, hint = _post(srv, "/transfer", {"group": 1, "target": 0})
        assert (st, hint) == (421, "2")
    finally:
        srv.stop()
        rdb.close()


def test_placement_moves_a_hot_leader_on_fused_server(tmp_path):
    """--placement on the fused server (server.main.attach_placement):
    acked writes on every group one peer leads make that peer hot, and
    the controller must complete a transfer away from it; every acked
    write is applied."""
    import time

    from raftsql_tpu_torch.server.main import attach_placement
    rdb = build_fused_node(groups=4, peers=3, tick=0.002,
                           data_prefix=str(tmp_path / "raftsql"),
                           commit_rule="pallas", device="cpu")
    node = rdb.pipe.node
    pc = None
    try:
        _wait(lambda: (node._hints >= 0).all(), node, "elections")
        for g in range(4):
            assert rdb.propose("CREATE TABLE t (v text)", g).wait(30) is None
        leads = [node.leader_of(g) for g in range(4)]
        hot = max(range(3), key=leads.count)
        on = [g for g in range(4) if leads[g] == hot]
        pc = attach_placement(rdb, interval_s=0.05)
        sent = 0
        deadline = time.monotonic() + 60
        while node.metrics.transfers_completed == 0:
            assert time.monotonic() < deadline, node.transfers_doc()
            futs = [rdb.propose(f"INSERT INTO t (v) VALUES ('{sent + i}')",
                                on[i % len(on)]) for i in range(8)]
            assert all(f.wait(30) is None for f in futs)
            sent += len(futs)
        assert pc.issued >= 1 and rdb.metrics()["placement"]["issued"] >= 1
        ev = [e for e in node.transfers_doc()["recent"]
              if e["outcome"] == "completed"]
        assert ev and ev[0]["from"] == hot + 1
        rows = sum(int(rdb.query("SELECT count(*) FROM t", g)
                       .strip().strip("|")) for g in on)
        assert rows == sent
    finally:
        if pc is not None:
            pc.stop()
        rdb.close()
