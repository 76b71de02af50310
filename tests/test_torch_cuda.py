"""The port's CUDA kernels on the card (skipped without one).

Run on a machine with an NVIDIA card (`--noconftest`: the suite's
conftest pins JAX, which that machine need not have):
    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
Each kernel wrapper is held to its plain PyTorch version on the same
CUDA tensors, exactly, and the fused tick on the card to the same ticks
on the CPU; torch.profiler's device stamps, put on time.monotonic() by
obs/timeline.py, fall inside the host's own stamps.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from raftsql_tpu_torch import convert
from raftsql_tpu_torch.config import RaftConfig
from raftsql_tpu_torch.core import cluster
from raftsql_tpu_torch.ops import pallas_quorum as pq

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _inputs(card, seed, R, P, W, lead="rand", offset=0):
    """Seeded K1/K2 inputs on the card; `lead` is "rand" (80 % lead),
    "none" or "all"; `offset` > 0 makes every tensor a contiguous view
    that starts `offset` elements into its storage (a base that is not
    16-byte aligned)."""
    rng = np.random.default_rng(seed)
    log_len = rng.integers(0, 3 * W, R).astype(np.int32)
    match = (rng.random((R, P)) * (log_len[:, None] + 1)).astype(np.int32)
    is_leader = {"rand": rng.random(R) < 0.8, "none": np.zeros(R, bool),
                 "all": np.ones(R, bool)}[lead]
    xs = [match, rng.integers(0, 4, (R, W)).astype(np.int32), log_len,
          (rng.random(R) * (log_len + 1)).astype(np.int32),
          rng.integers(0, 4, R).astype(np.int32), is_leader,
          rng.random((R, P)) < 0.6, rng.random((R, P)) < 0.6]
    out = []
    for x in xs:
        t = torch.from_numpy(x)
        out.append(_offset_view(t, offset, card) if offset else t.to(card))
    return out[:6], out[6], out[7]


def _offset_view(t, offset, card):
    flat = torch.zeros(t.numel() + offset, dtype=t.dtype, device=card)
    view = flat[offset:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


def _equal_plain(args, v, j, P, W):
    q = P // 2 + 1
    got = pq.pallas_quorum_commit_index(*args, quorum=q, window=W)
    want = pq.quorum_commit_index_plain(*args, quorum=q, window=W)
    assert torch.equal(got, want)
    for size in (None, P, max(P - 1, 1)):
        got = pq.pallas_masked_quorum_commit_index(
            *args, voters=v, voters_joint=j, window=W, size=size)
        want = pq.masked_quorum_commit_index_plain(
            *args, voters=v, voters_joint=j, window=W, size=size)
        assert torch.equal(got, want)
    full = torch.ones_like(v)
    got = pq.pallas_masked_quorum_commit_index(
        *args, voters=full, voters_joint=full, window=W)
    assert torch.equal(got, pq.masked_quorum_commit_index_plain(
        *args, voters=full, voters_joint=full, window=W))


@pytest.mark.parametrize("P", [1, 2, 3, 4, 5, 7, 15, 32, 33, 64, 255, 256,
                               257, 383, 384, 385])
def test_kernels_equal_plain(card, P):
    # 4099 rows: not a multiple of a block's rows.  The generic kernel
    # stages a warp's rows in the default 48 KB of shared memory up to
    # P = 383 (K1) and 255 (K2), and reads them from device memory past
    # that: both sides of both limits.
    args, v, j = _inputs(card, P, 4099, P, 64)
    _equal_plain(args, v, j, P, 64)


@pytest.mark.parametrize("lead", ["none", "all", "rand"])
@pytest.mark.parametrize("R", [1, 31, 257])
@pytest.mark.parametrize("P", [3, 33])
def test_kernels_edge_rows(card, P, R, lead):
    args, v, j = _inputs(card, 7 * R + P, R, P, 16, lead)
    _equal_plain(args, v, j, P, 16)


@pytest.mark.parametrize("P", [3, 5, 64])
def test_kernels_misaligned_base(card, P):
    """Views that start off a 16-byte boundary take the kernels' element
    loads instead of the 16-byte ones."""
    args, v, j = _inputs(card, P, 1000, P, 32, offset=1)
    _equal_plain(args, v, j, P, 32)


def test_wrapper_refuses_bad_inputs(card):
    args = [torch.zeros((8, 3), dtype=torch.int32, device=card),
            torch.zeros((8, 16), dtype=torch.int32, device=card)] + [
        torch.zeros(8, dtype=torch.int32, device=card)] * 3 + [
        torch.zeros(8, dtype=torch.bool, device=card)]
    with pytest.raises(TypeError):
        pq.pallas_quorum_commit_index(*args[:-1], args[-1].int(),
                                      quorum=2, window=16)
    with pytest.raises(ValueError):
        pq.pallas_quorum_commit_index(*args, quorum=2, window=32)
    with pytest.raises(ValueError):
        strided = torch.zeros((3, 8), dtype=torch.int32, device=card).t()
        pq.pallas_quorum_commit_index(strided, *args[1:], quorum=2,
                                      window=16)
    with pytest.raises(ValueError):
        pq.pallas_quorum_commit_index(*args[:2], args[2].cpu(), *args[3:],
                                      quorum=2, window=16)
    # 33 peers: more than one 32-bit mask word (the generic kernel).
    big, v, j = _inputs(card, 33, 8, 33, 16)
    _equal_plain(big, v, j, 33, 16)


def test_fused_tick_card_equals_cpu(card):
    cfg = RaftConfig(num_groups=512, num_peers=3, log_window=64,
                     max_entries_per_msg=8, commit_rule="pallas")
    cs = cluster.init_cluster_state(cfg, device="cpu")
    ci = cluster.empty_cluster_inbox(cfg, device="cpu")
    gs = convert.peer_state_from_numpy(convert.to_numpy(cs), card)
    gi = convert.inbox_from_numpy(convert.to_numpy(ci), card)
    rng = np.random.default_rng(0)
    pq.reset_launches()
    for t in range(64):
        prop = torch.from_numpy(rng.integers(0, 9, (3, 512)).astype(np.int32))
        cs, ci, cp, _ = cluster.cluster_step_host(cfg, cs, ci, prop)
        gs, gi, gp, _ = cluster.cluster_step_host(cfg, gs, gi,
                                                  prop.to(card))
        assert torch.equal(gp.cpu(), cp), t
    assert pq.launches["pallas_quorum_commit_index"] == 64


def _replace_and_transfer(device, path):
    """A durable 4-slot node on voters {0,1,2}: slot 0 replaced by slot 3
    on groups 0-7 (add_learner, promote, remove: joint consensus) while
    leadership moves on groups 8-15; returns what both devices must
    agree on, tick by tick."""
    from raftsql_tpu_torch.membership import MembershipError
    from raftsql_tpu_torch.runtime.fused import FusedClusterNode
    cfg = RaftConfig(num_groups=16, num_peers=4, log_window=32,
                     max_entries_per_msg=4, commit_rule="pallas",
                     initial_voters=(0, 1, 2), tick_interval_s=0.0)
    node = FusedClusterNode(cfg, path, seed=7, device=device)
    node.publish_peers = {0}
    node.enable_membership()
    rec, stage = [], dict.fromkeys(range(8), 0)
    ops = (("add_learner", 3), ("promote", 3), ("remove", 0))
    try:
        for t in range(200):
            node.tick()
            rec.append((node._hints.tolist(), node._hard.tolist(),
                        sorted(node.transferring_groups())))
            if t == 60:
                for g in range(8, 16):
                    node.transfer_leadership(
                        g, next(p for p in (0, 1, 2)
                                if p != node.leader_of(g)))
            for g in range(8) if t >= 60 else ():
                c = node.membership.config(g)
                if stage[g] < 3 and not c.is_joint and (
                        stage[g] == 0 or c.learners == 8 and stage[g] == 1
                        or c.voters == 15 and stage[g] == 2):
                    try:
                        node.member_change(g, *ops[stage[g]])
                        stage[g] += 1
                    except MembershipError:
                        pass
        rec.append(node.members_doc())
    finally:
        node.stop()
    return rec


def test_membership_and_transfer_card_equal_cpu(card, tmp_path):
    pq.reset_launches()
    got = _replace_and_transfer(card, str(tmp_path / "card"))
    assert pq.launches["pallas_masked_quorum_commit_index"] == 200
    assert pq.launches["pallas_quorum_commit_index"] == 0
    want = _replace_and_transfer("cpu", str(tmp_path / "cpu"))
    assert got == want
    doc = got[-1]["groups"]
    assert all(doc[str(g)]["voters"] == [1, 2, 3] for g in range(8))
    assert all(doc[str(g)]["voters"] == [0, 1, 2] for g in range(8, 16))


def _node_lockstep(device, path, cfg, ticks, change_at=None):
    """Three RaftNodes (the distributed runtime) over the loopback hub
    with its codec, ticked in lockstep with seeded proposals; at tick
    `change_at` group 0's leader removes slot 3 (the first conf entry:
    from then on every node's step takes the masked rule).  Returns
    every tick's (roles, hints, hard state, next_idx) and commits."""
    from raftsql_tpu_torch.runtime.db import _expand_commit_item
    from raftsql_tpu_torch.runtime.node import RaftNode
    from raftsql_tpu_torch.transport.loopback import (LoopbackHub,
                                                      LoopbackTransport)
    hub = LoopbackHub()
    P = cfg.num_peers
    nodes = [RaftNode(p + 1, P, cfg, LoopbackTransport(hub),
                      f"{path}/n{p}", device=device) for p in range(P)]
    rng = np.random.default_rng(3)
    rec = []
    try:
        for n in nodes:
            n.start(threaded=False)
        for t in range(ticks):
            if rng.random() < 0.7:
                nodes[int(rng.integers(0, P))].propose(
                    int(rng.integers(0, cfg.num_groups)),
                    f"SET k v{t}".encode())
            if t == change_at:
                lead = next(n for n in nodes if n._last_role[0] == 2)
                lead.member_change(0, "remove", 3)
            for n in nodes:
                n.tick()
            for n in nodes:
                got = []
                while not n.commit_q.empty():
                    item = n.commit_q.get_nowait()
                    if item is not None:
                        got.extend(_expand_commit_item(item, n))
                rec.append((n._last_role.tolist(), n._last_hint.tolist(),
                            n._hard_np.tolist(), n._next_idx.tolist(),
                            got))
    finally:
        for n in nodes:
            n.stop()
    return rec


def test_node_path_k1_card_equals_cpu(card, tmp_path):
    """The node path's K1: one launch per node tick, on that peer's G
    rows, and the cluster on the card equal to the same ticks on the
    CPU."""
    cfg = RaftConfig(num_groups=256, num_peers=3, log_window=32,
                     max_entries_per_msg=4, election_ticks=10,
                     heartbeat_ticks=1, tick_interval_s=0.0,
                     commit_rule="pallas")
    pq.reset_launches()
    got = _node_lockstep(card, str(tmp_path / "card"), cfg, 60)
    assert pq.launches["pallas_quorum_commit_index"] == 3 * 60
    assert pq.launches["pallas_masked_quorum_commit_index"] == 0
    assert got == _node_lockstep("cpu", str(tmp_path / "cpu"), cfg, 60)


def test_node_path_k2_after_member_change(card, tmp_path):
    """After the first conf entry applies, each node's next steps take
    the masked rule: K1 launches until then, K2 from then on, and the
    card equals the CPU tick for tick."""
    cfg = RaftConfig(num_groups=64, num_peers=4, log_window=32,
                     max_entries_per_msg=4, election_ticks=10,
                     heartbeat_ticks=1, tick_interval_s=0.0,
                     commit_rule="pallas")
    pq.reset_launches()
    got = _node_lockstep(card, str(tmp_path / "card"), cfg, 90,
                         change_at=40)
    k1 = pq.launches["pallas_quorum_commit_index"]
    k2 = pq.launches["pallas_masked_quorum_commit_index"]
    assert k1 >= 4 * 40 and k2 > 0 and k1 + k2 == 4 * 90, (k1, k2)
    assert got == _node_lockstep("cpu", str(tmp_path / "cpu"), cfg, 90,
                                 change_at=40)


def test_profiler_stamps_land_on_the_monotonic_clock(card):
    """A synchronised sleep kernel's device interval, put on
    time.monotonic() by obs/timeline.py, lies between the host's stamps
    taken before its launch and after its synchronize()."""
    from torch._C._autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from raftsql_tpu_torch.obs.timeline import clock_pair, profiler_offset_ns
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    for _ in range(3):          # the profiler may drop a launch
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pairs = [clock_pair()]
            t0 = time.monotonic_ns()
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
            t1 = time.monotonic_ns()
            pairs.append(clock_pair())
        acts = [e for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA
                and e.duration_ns() > 0]
        if acts:
            break
    assert len(acts) == 1, [e.name() for e in acts]
    off = profiler_offset_ns(acts[0].start_ns(), pairs)
    start, end = acts[0].start_ns() + off, acts[0].end_ns() + off
    assert t0 <= start < end <= t1, (t0, start, end, t1, off)


# -- the fused runtime's CUDA graph (runtime/fused.py) ------------------

K1_NAME = "pallas_quorum_commit_index"
K2_NAME = "pallas_masked_quorum_commit_index"


def _graph_vs_eager(card, path, cfg, steps, ticks=200):
    """Drive a FusedClusterNode's device step (graph replays after one
    eager tick) and the eager cluster_step_host chain on the same card
    from one boot, with seeded proposals, a skewed timer window, a
    membership and a transfer patch and a chaos inbox rewrite applied to
    both; every tick's packed info, busy bit, states and inboxes must be
    equal.  Returns the node's metrics, its graph's signature key and
    the signatures the step's entry point was called with."""
    from raftsql_tpu_torch.analysis.tripwire import SignatureTripwire
    from raftsql_tpu_torch.core.state import (set_group_config_stacked,
                                              set_transfer_target_stacked)
    from raftsql_tpu_torch.runtime.fused import FusedClusterNode
    from raftsql_tpu_torch.transport.faults import drop_messages
    node = FusedClusterNode(cfg, path, seed=5, device=card)
    node._steps = steps
    st = type(node.states)(*[x.clone() for x in node.states])
    ib = type(node.inboxes)(*[x.clone() for x in node.inboxes])
    rng = np.random.default_rng(cfg.num_groups * 10 + steps)
    P, G = cfg.num_peers, cfg.num_groups
    ones = torch.ones((P,), dtype=torch.int32, device=card)
    tw = SignatureTripwire()
    try:
        for t in range(ticks):
            shape = (steps, P, G) if steps > 1 else (P, G)
            pn = rng.integers(0, cfg.max_entries_per_msg + 1,
                              shape).astype(np.int32)
            skew = np.array([1, 2, 0], np.int32)[:P] \
                if 40 <= t < 70 else None
            if t == 90:
                vrow, jrow = np.array([1, 1, 0]), np.array([1, 1, 1])
                node._set_group_config(2, G - 1, vrow, jrow, False)
                st = set_group_config_stacked(st, 2, G - 1, vrow, jrow,
                                              False)
            if t == 100:
                node._set_transfer_target(0, 0, 1)
                st = set_transfer_target_stacked(st, 0, 0, 1)
            if t == 120:
                mask = rng.random(tuple(ib.v_type.shape)) < 0.5
                node.inboxes = drop_messages(node.inboxes, mask)
                ib = drop_messages(ib, mask)
            pd, bd = node._device_step(pn, skew)
            got, busy = node._readback(pd, bd)
            ti = ones if skew is None else torch.from_numpy(skew).to(card)
            if steps > 1:
                st, ib, want, wbusy = cluster.cluster_multistep_host(
                    cfg, st, ib, steps, torch.from_numpy(pn).to(card), ti)
            else:
                st, ib, want, wbusy = cluster.cluster_step_host(
                    cfg, st, ib, torch.from_numpy(pn).to(card), ti)
            assert np.array_equal(got, want.cpu().numpy()), t
            assert busy == bool(wbusy), t
            for name, a, b in zip(st._fields + ib._fields,
                                  node.states + node.inboxes, st + ib):
                assert torch.equal(a, b), (t, name)
        assert node.states is node._graph.states
        assert node.inboxes is node._graph.inboxes
        entry = "cluster_multistep_host" if steps > 1 else "cluster_step_host"
        return node.metrics, node._graph.key, tw.signatures(entry)
    finally:
        tw.disarm()
        node.stop()


@pytest.mark.parametrize("G,rule,steps,membership", [
    (1, "pallas", 1, False), (512, "pallas", 1, False),
    (512, "point", 1, False), (1, "pallas", 2, False),
    (512, "pallas", 2, False), (512, "pallas", 1, True)])
def test_graph_step_equals_eager_chain(card, tmp_path, G, rule, steps,
                                       membership):
    """The replayed graph against the eager chain, leaf by leaf, at the
    benchmark cell's shape (G = 1, P = 3, E = 8, pallas) and at G = 512,
    under both commit rules, one and two steps a dispatch, and the
    masked rule (K2): one capture, every tick after the first a replay,
    the one inbox rewrite a restage, and the quorum kernel counted once
    a step on each side; the eager steps and the capture called the
    entry point with one signature, the graph's key."""
    cfg = RaftConfig(num_groups=G, num_peers=3, log_window=64,
                     max_entries_per_msg=8, election_ticks=10,
                     heartbeat_ticks=1, tick_interval_s=0.0,
                     commit_rule=rule, dynamic_membership=membership)
    pq.reset_launches()
    m, key, seen = _graph_vs_eager(card, str(tmp_path), cfg, steps)
    assert seen == {key}
    assert (m.graph_captures, m.graph_replays, m.graph_restages,
            m.eager_steps) == (1, 199, 1, 1)
    want = {"pallas_quorum_commit_index": 0,
            "pallas_masked_quorum_commit_index": 0}
    if rule == "pallas":
        want[K2_NAME if membership else K1_NAME] = 2 * 200 * steps
    assert pq.launches == want


def test_profiler_sees_kernels_of_a_graph_captured_before_it(card,
                                                             tmp_path):
    """The benchmark starts torch.profiler after the node captured its
    graph: the replays' kernels, K1 among them, must still be recorded."""
    from torch.profiler import ProfilerActivity, profile

    from raftsql_tpu_torch.runtime.fused import FusedClusterNode
    cfg = RaftConfig(num_groups=1, num_peers=3, log_window=64,
                     max_entries_per_msg=8, tick_interval_s=0.0,
                     commit_rule="pallas")
    node = FusedClusterNode(cfg, str(tmp_path), seed=5, device=card)
    try:
        for _ in range(5):
            node.tick()
        assert node.metrics.graph_captures == 1
        k0 = pq.launches[K1_NAME]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                node.tick()
            torch.cuda.synchronize()
        k1 = pq.launches[K1_NAME] - k0
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.duration_ns() > 0]
        seen = sum(1 for n in names if "quorum_commit" in n)
        assert k1 == 20 and seen > 0, (k1, seen, len(names))
    finally:
        node.stop()


# A served node ticking its graph in its own thread under load, and four
# torch.profiler sessions started and stopped beside it in the main
# thread, as the benchmark's traced run does.
_PROFILE_BESIDE_TICKS = r"""
import tempfile, threading, time
from torch.profiler import ProfilerActivity, profile
from raftsql_tpu_torch.config import RaftConfig
from raftsql_tpu_torch.runtime.fused import FusedClusterNode
cfg = RaftConfig(num_groups=1, num_peers=3, log_window=64,
                 max_entries_per_msg=8, tick_interval_s=0.0,
                 commit_rule="pallas")
node = FusedClusterNode(cfg, tempfile.mkdtemp(), seed=1, device="cuda")
node.start(interval_s=0.002)
until = time.monotonic() + 60
while (node._hints < 0).any() and time.monotonic() < until:
    time.sleep(0.05)
stop = threading.Event()
def load():
    while not stop.is_set():
        node.propose_many(0, [b"x" * 64] * 8)
        time.sleep(0.001)
threading.Thread(target=load, daemon=True).start()
seen = 0
for _ in range(4):
    n0 = node.metrics.ticks
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        while node.metrics.ticks - n0 < 20:
            time.sleep(0.002)
    seen += sum(1 for e in prof.profiler.kineto_results.events()
                if "quorum_commit" in e.name())
stop.set()
node.stop()
print("seen", seen, "captures", node.metrics.graph_captures)
"""


def test_profiler_stops_beside_a_ticking_graph(card):
    """A profiler stop while another thread launches the graph must not
    hang (it did with CUDAGraph.replay, which drops the interpreter
    lock that the stop holds), and each session records K1."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    got = subprocess.run([sys.executable, "-c", _PROFILE_BESIDE_TICKS],
                         cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert got.returncode == 0, got.stderr[-3000:]
    words = got.stdout.split()
    assert words[-1] == "1" and int(words[1]) >= 4, got.stdout
