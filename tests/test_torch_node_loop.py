"""The cases of tests/test_node_loop.py, on the port (raftsql_tpu_torch,
every RaftNode stepping on the CPU).  The reference file's docstring
follows.

The distributed runtime's event loop (runtime/node.py _run).

Covers step elision: interval-paced wakeups accumulate timer advance
without stepping while the device-reported timer_margin says no
election/heartbeat can fire, and the work event resumes full service
immediately — plus the replay/publish contract (committed prefix only).
"""
import queue
import time

import numpy as np

from raftsql_tpu_torch.config import NO_VOTE, RaftConfig
from raftsql_tpu_torch.runtime.node import CLOSED, RaftNode
from raftsql_tpu_torch.transport.loopback import LoopbackHub, LoopbackTransport

import torch

torch.set_num_threads(1)


def test_threaded_node_elides_idle_steps(tmp_path):
    """An idle threaded
    node with a coarse heartbeat runs far fewer steps than the tick
    interval allows — the device-reported timer_margin parks the loop —
    yet keeps serving when work arrives (the work event)."""
    cfg = RaftConfig(num_groups=1, num_peers=1, tick_interval_s=0.002,
                     election_ticks=60, heartbeat_ticks=25,
                     log_window=32, max_entries_per_msg=4)
    n = RaftNode(1, 1, cfg, LoopbackTransport(LoopbackHub()),
                 data_dir=str(tmp_path / "n1"), device="cpu")
    n.start(threaded=True)
    try:
        deadline = time.monotonic() + 5
        while n.leader_of(0) < 0:
            assert time.monotonic() < deadline, "no self-election"
            time.sleep(0.01)
        n.metrics.ticks = 0
        time.sleep(1.0)
        idle_ticks = n.metrics.ticks
        # 1s / 2ms = 500 loop slots; a leader's margin is the heartbeat
        # countdown (25), so ~20 steps expected.  Allow generous slack
        # for CI scheduling; the pre-elision loop would run ~400+.
        assert idle_ticks <= 120, idle_ticks
        # Snapshot first: the new leader's no-op already counts as a
        # commit, so waiting for >= 1 would pass vacuously.
        base = n.metrics.commits
        n.propose(0, b"SET k v")
        deadline = time.monotonic() + 5
        while n.metrics.commits <= base:
            assert time.monotonic() < deadline, "proposal never committed"
            time.sleep(0.01)
    finally:
        n.stop()


def test_replay_publishes_only_committed_prefix(tmp_path):
    """fail-before/pass-after (found by the process-plane chaos seed
    sweep): a restarted node must NOT publish its appended-but-
    UNCOMMITTED WAL tail to the state machine — a new leader may
    conflict-truncate it, and the phantom apply would diverge this
    replica's SQLite forever (survivors can then never converge).  The
    replaced entry must instead arrive exactly once through the
    ordinary commit path."""
    from raftsql_tpu_torch.runtime.db import _expand_commit_item
    from raftsql_tpu_torch.storage.wal import WAL

    # Hand-crafted WALs: a shared committed entry at index 1; node 1
    # additionally appended "lost-write" at index 2 in term 1 but never
    # committed it, while the term-2 majority (nodes 2, 3) committed a
    # DIFFERENT entry there.
    def make_wal(d, tail_term, tail_sql, term, commit):
        w = WAL(str(d))
        w.append_entry(0, 1, 1, b"SET shared")
        w.append_entry(0, 2, tail_term, tail_sql)
        w.set_hardstate(0, term, NO_VOTE, commit)
        w.sync()
        w.close()

    make_wal(tmp_path / "n1", 1, b"SET lost-write", 1, 1)
    make_wal(tmp_path / "n2", 2, b"SET won-write", 2, 2)
    make_wal(tmp_path / "n3", 2, b"SET won-write", 2, 2)

    # Tick 0.01 s where the reference's test takes 0.002 s: three
    # threaded nodes' CPU steps take ~21 ms a round in turn, past a
    # 20 ms (10-tick) election timeout, so 0.002 s never keeps a leader.
    cfg = RaftConfig(num_groups=1, num_peers=3, tick_interval_s=0.01,
                     log_window=32, max_entries_per_msg=4)
    hub = LoopbackHub()
    nodes = [RaftNode(i + 1, 3, cfg, LoopbackTransport(hub),
                      data_dir=str(tmp_path / f"n{i + 1}"), device="cpu")
             for i in range(3)]
    published = []
    try:
        for n in nodes:
            n.start(threaded=True)
        deadline = time.monotonic() + 15
        while not any(s == "SET won-write" for (_, _, s) in published):
            assert time.monotonic() < deadline, published
            try:
                item = nodes[0].commit_q.get(timeout=0.2)
            except queue.Empty:
                continue
            if item is None or item is CLOSED:
                continue
            published.extend(_expand_commit_item(item, nodes[0]))
    finally:
        for n in nodes:
            n.stop()
    sqls = [s for (_, _, s) in published]
    assert "SET lost-write" not in sqls, sqls
    assert sqls.count("SET won-write") == 1, sqls
    # The committed prefix itself did replay.
    assert sqls[0] == "SET shared", sqls


def test_forward_reclaimed_when_follower_becomes_leader(tmp_path):
    """A proposal forwarded to a leader that died in the same instant
    must NOT sit in forward-limbo until the retry deadline when the
    proposing follower itself wins the next election: the new leader
    reclaims its own in-flight forwards immediately (envelope dedup
    makes the requeue safe).  Found by the process-plane read nemesis:
    the entry node's PUT stalled for the whole deadline while it was
    the leader that could have committed it."""
    from raftsql_tpu_torch.config import LEADER
    from raftsql_tpu_torch.runtime.db import _expand_commit_item

    cfg = RaftConfig(num_groups=1, num_peers=3, log_window=64,
                     max_entries_per_msg=4, election_ticks=10,
                     heartbeat_ticks=1, tick_interval_s=0.0)
    hub = LoopbackHub()
    nodes = [RaftNode(i + 1, 3, cfg, LoopbackTransport(hub),
                      str(tmp_path / f"n{i + 1}"), device="cpu")
             for i in range(3)]
    dead = None
    try:
        for n in nodes:
            n.start(threaded=False)
        lead = None
        for _ in range(300):
            for n in nodes:
                n.tick()
            lead = next((i for i, n in enumerate(nodes)
                         if n._last_role[0] == LEADER), None)
            if lead is not None and all(
                    n.leader_of(0) == lead for n in nodes):
                break
        assert lead is not None
        fwd = (lead + 1) % 3         # the proposing follower
        other = (lead + 2) % 3
        # Propose at the follower, then kill the leader BEFORE the
        # follower's next tick delivers anywhere useful: the forward
        # targets a dead node and is lost.
        nodes[fwd].propose(0, b"SET k reclaimed")
        from raftsql_tpu_torch.chaos.scenarios import hard_crash_node
        hard_crash_node(nodes[lead])
        dead, nodes[lead] = nodes[lead], None
        # Bias the PROPOSING follower to win the next election (its
        # timers run 2x) — the reclaim-on-become-leader path.
        committed = {}
        for t in range(35):
            for i, n in enumerate(nodes):
                if n is None:
                    continue
                n.tick(timer_inc=2 if i == fwd else 1)
            while True:
                try:
                    item = nodes[fwd].commit_q.get_nowait()
                except queue.Empty:
                    break
                if item is None or item is CLOSED:
                    continue
                for (g, idx, sql) in _expand_commit_item(
                        item, nodes[fwd]):
                    committed[(g, idx)] = sql
            if "SET k reclaimed" in committed.values():
                break
        # Old behavior: the forward sat in limbo until the retry
        # deadline (4 * election_ticks = 40 ticks) — far beyond this
        # window.  With the reclaim, the new leader commits it right
        # after its election.
        assert "SET k reclaimed" in committed.values(), (
            f"forwarded proposal not reclaimed by the new leader "
            f"within 35 ticks (committed: {sorted(committed)})")
    finally:
        for n in nodes:
            if n is not None:
                n.stop()
        if dead is not None:
            dead.stop()


def test_replay_scrubs_duplicate_whose_first_copy_was_compacted(tmp_path):
    """fail-before/pass-after (found by the snapshot-family chaos seed
    sweep, seed 2): the dedup decision is a pure function of the
    committed log PREFIX — but compaction drops that prefix, so a
    restarted node replaying only the retained suffix used to re-apply
    a forward-retry duplicate whose first copy fell below the floor,
    while its live peers (in-memory windows intact) scrubbed it:
    permanent divergence.  The REC_DEDUP baseline persisted at the
    compaction boundary (storage/wal.py) must make replay scrub the
    same duplicates the live peers do."""
    from raftsql_tpu_torch.runtime.envelope import wrap
    from raftsql_tpu_torch.storage.wal import WAL

    DUP_PID = 42

    def make_wal(d, with_baseline):
        # Floor at 2: the duplicate's first copy (applied at index 1)
        # is gone.  The retained suffix holds its re-proposed copy at
        # index 3 plus an ordinary entry at 4; both are committed.
        w = WAL(str(d), native=False)
        w.mark_compact(0, 2, 1)
        if with_baseline:
            assert w.set_dedup(0, 2, [(1, DUP_PID)])
        w.append_entry(0, 3, 1, wrap(b"SET k stale-dup", pid=DUP_PID))
        w.append_entry(0, 4, 1, wrap(b"SET k fresh", pid=77))
        w.set_hardstate(0, 1, NO_VOTE, 4)
        w.sync()
        w.close()

    def replayed_sqls(d):
        cfg = RaftConfig(num_groups=1, num_peers=1,
                         tick_interval_s=0.002, log_window=32,
                         max_entries_per_msg=4)
        n = RaftNode(1, 1, cfg, LoopbackTransport(LoopbackHub()),
                     data_dir=str(d), device="cpu")
        sqls = []
        try:
            n.start(threaded=False)
            while True:                 # replay ends with the sentinel
                item = n.commit_q.get(timeout=5)
                if item is None:
                    break
                sqls.append(item[2])
        finally:
            n.stop()
        return sqls

    make_wal(tmp_path / "bare", with_baseline=False)
    make_wal(tmp_path / "pinned", with_baseline=True)
    # Control: without the baseline the duplicate IS re-published —
    # proving the assertion below bites.
    assert replayed_sqls(tmp_path / "bare") == [
        "SET k stale-dup", "SET k fresh"]
    assert replayed_sqls(tmp_path / "pinned") == ["SET k fresh"]


def test_status_reports_one_ticks_role_and_term(tmp_path):
    """GET /healthz (RaftNode.status) shows role and hard state of ONE
    tick.  Read mid-tick (from the send phase, after the WAL phase moved
    the hard state) it must still equal the previous tick's view: a
    leader deposed by a leadership transfer is never reported as the
    leader of the new term, which the process chaos runners'
    election-safety check would count as a second leader in that term."""
    from raftsql_tpu_torch.config import LEADER
    cfg = RaftConfig(num_groups=2, num_peers=3, log_window=32,
                     max_entries_per_msg=4, election_ticks=10,
                     heartbeat_ticks=1, tick_interval_s=0.0)
    hub = LoopbackHub()
    nodes = [RaftNode(i + 1, 3, cfg, LoopbackTransport(hub),
                      str(tmp_path / f"n{i + 1}"), device="cpu")
             for i in range(3)]
    mid = {}
    for i, n in enumerate(nodes):
        send = n._send_phase

        def spy(outbox, info, i=i, n=n, send=send):
            mid[i] = n.status()
            return send(outbox, info)

        n._send_phase = spy
    try:
        for n in nodes:
            n.start(threaded=False)
        end = [n.status() for n in nodes]
        deposed = 0
        for t in range(80):
            if t == 40:
                lead = nodes[0].leader_of(0)
                assert lead >= 0
                nodes[lead].transfer_leadership(0, (lead + 1) % 3)
            for i, n in enumerate(nodes):
                n.tick()
                assert mid[i] == end[i], (t, i, mid[i], end[i])
                now = n.status()
                deposed += (end[i]["0"]["role"] == "leader"
                            and now["0"]["role"] != "leader"
                            and now["0"]["term"] > end[i]["0"]["term"])
                end[i] = now
        assert deposed == 1
        assert (np.stack([n._last_role for n in nodes]) == LEADER).sum(0) \
            .tolist() == [1, 1]
    finally:
        for n in nodes:
            n.stop()
