"""The port's CUDA kernels on the card (skipped without one).

Run on a machine with an NVIDIA card (`--noconftest`: the suite's
conftest pins JAX, which that machine need not have):
    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
Each kernel wrapper is held to its plain PyTorch version on the same
CUDA tensors, exactly, and the fused tick on the card to the same ticks
on the CPU; torch.profiler's device stamps, put on time.monotonic() by
obs/timeline.py, fall inside the host's own stamps.
"""
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
