"""The cases of tests/test_overlap_gc.py, on the port (every node on
the CPU).  The reference file's docstring follows.

Double-buffered dispatch + WAL group commit.

Covers the two durable-plane levers of the serving stack:

  * overlap pipeline (runtime/hostplane.py): crash mid-overlap loses
    exactly the un-externalized pipeline tail — everything published
    survives replay, the stashed tick vanishes atomically, and with
    multi-step dispatch the epoch-erase semantics still hold (an
    uncommitted dispatch whose records ARE durable is dropped on every
    peer);
  * chaos digest stability: the same seeded schedule produces
    bit-identical schedule+result digests with the overlap pipeline on
    and off, and with group commit layered on top;
  * GroupCommitWAL (storage/wal.py): one fsync per barrier round for
    all P peers, per-peer replay split, and bit-identical cluster
    behavior vs the per-peer-file layout.
"""
import queue
import tempfile

import numpy as np
import pytest
import torch

from raftsql_tpu_torch.config import RaftConfig
from raftsql_tpu_torch.runtime.fused import FusedClusterNode
from raftsql_tpu_torch.storage import fsio
from raftsql_tpu_torch.storage.wal import GroupCommitWAL

torch.set_num_threads(1)


def mkcfg(groups=2):
    return RaftConfig(num_groups=groups, num_peers=3, log_window=32,
                      max_entries_per_msg=4, tick_interval_s=0.0)


def elect(node, max_ticks=200):
    for t in range(max_ticks):
        node.tick()
        if t > 10 and (node._hints >= 0).all():
            return
    raise AssertionError("no full leadership within budget")


def _published(node):
    """Everything delivered to peer 0's commit stream so far, WITHOUT
    draining the double-buffer stash (only the async publish queues are
    joined) — the crash tests depend on the stash staying pending."""
    from raftsql_tpu_torch.runtime.db import _expand_commit_item
    for q in node._pub_qs:
        q.join()
    out = []
    q = node.commit_q(0)
    while True:
        try:
            item = q.get_nowait()
        except queue.Empty:
            break
        if item is None or not isinstance(item, tuple):
            continue
        out.extend(_expand_commit_item(item))
    return out


# -- crash mid-overlap -------------------------------------------------------


def test_crash_mid_overlap_keeps_published_drops_stash(tmp_path):
    """Crash with a stashed (never fsynced) tick in the pipeline: the
    stash vanishes atomically; every entry ever PUBLISHED before the
    crash replays."""
    from raftsql_tpu_torch.chaos.scenarios import hard_crash_fused

    inj = fsio.StorageFaultInjector()     # forces the Python backend:
    with fsio.installed(inj):             # buffered bytes die on crash
        cfg = mkcfg()
        node = FusedClusterNode(cfg, str(tmp_path), device="cpu")
        assert node._overlap
        elect(node)
        node.propose_many(0, [b"SET a 1", b"SET b 2"])
        for _ in range(12):
            node.tick()
        published = _published(node)
        keys_a = {(g, i) for (g, i, _q) in published}
        assert any(q == "SET a 1" for (_g, _i, q) in published)
        # Tick once more with a FRESH batch so it sits in the stash,
        # accepted by the device but never written to any WAL.
        node.propose_many(1, [b"SET z 9"])
        node.tick()
        assert node._stash is not None, "pipeline should be hot"
        published += _published(node)
        hard_crash_fused(node)

        node2 = FusedClusterNode(cfg, str(tmp_path), device="cpu")
        replayed = _published(node2)
        rkeys = {(g, i): q for (g, i, q) in replayed}
        # Durability: everything externalized before the crash is in
        # the replay, verbatim.
        for (g, i, q) in published:
            assert rkeys.get((g, i)) == q, (g, i, q)
        # Atomic loss: the stashed tick's write never happened.
        assert not any(q == "SET z 9" for q in rkeys.values())
        # The cluster continues: the lost write can be re-proposed.
        elect(node2, max_ticks=60)
        node2.propose_many(1, [b"SET z 9"])
        for _ in range(12):
            node2.tick()
        node2.publish_flush()
        assert any(q == "SET z 9"
                   for (_g, _i, q) in _published(node2))
        node2.stop()
        assert keys_a <= set(rkeys)


class _SimCrash(RuntimeError):
    pass


def test_crash_before_epoch_commit_erases_dispatch(tmp_path):
    """Multi-step dispatch + overlap: the stashed dispatch's WAL
    records land and FSYNC on every peer, but the crash hits before the
    cluster-atomic epoch commit — replay must ERASE the whole dispatch
    on every peer (repair_epochs), because within a multi-step dispatch
    peers observed each other's un-fsynced messages."""
    from raftsql_tpu_torch.chaos.scenarios import hard_crash_fused

    inj = fsio.StorageFaultInjector()
    with fsio.installed(inj):
        cfg = mkcfg()
        node = FusedClusterNode(cfg, str(tmp_path), device="cpu")
        node._steps = 2
        elect(node)
        node.propose_many(0, [b"SET a 1"])
        for _ in range(12):
            node.tick()
        node.publish_flush()
        _published(node)                  # drain
        lens_before = [node.plogs[0].length(g)
                       for g in range(cfg.num_groups)]

        node.propose_many(1, [b"SET doomed 1"])
        node.tick()                       # stash holds the dispatch
        assert node._stash is not None

        def boom(no):
            raise _SimCrash(f"crash before epoch {no} commit")

        node._commit_epoch = boom
        with pytest.raises(_SimCrash):
            node.tick()                   # retire writes+fsyncs, then dies
        hard_crash_fused(node)

        node2 = FusedClusterNode(cfg, str(tmp_path), device="cpu")
        # The doomed dispatch's records were DURABLE — only the epoch
        # machinery can (and must) drop them.
        replayed = _published(node2)
        assert not any(q == "SET doomed 1"
                       for (_g, _i, q) in replayed)
        for g in range(cfg.num_groups):
            assert node2.plogs[0].length(g) <= lens_before[g]
        node2.stop()


# -- chaos digests under the new pipeline ------------------------------------


def _chaos_digest(monkeypatch, overlap: str, gc: str, sched):
    from raftsql_tpu_torch.chaos.scenarios import FusedChaosRunner
    monkeypatch.setenv("RAFTSQL_OVERLAP_DISPATCH", overlap)
    monkeypatch.setenv("RAFTSQL_WAL_GROUP_COMMIT", gc)
    with tempfile.TemporaryDirectory(prefix="chaos-ovl-") as d:
        r = FusedChaosRunner(sched, d, device="cpu").run()
    return r["schedule_digest"], r["result_digest"]


def test_chaos_digest_stable_under_overlap(monkeypatch):
    """The same seeded fault schedule — partitions, crashes, storage
    faults, the full invariant suite — produces IDENTICAL digests with
    the double-buffered pipeline off and on: overlap moves work in
    time, never in content."""
    from raftsql_tpu_torch.chaos.schedule import generate
    sched = generate(5, ticks=120)
    base = _chaos_digest(monkeypatch, "0", "0", sched)
    ovl = _chaos_digest(monkeypatch, "1", "0", sched)
    assert base == ovl


def test_chaos_digest_stable_under_group_commit(monkeypatch):
    """Group commit is a WAL LAYOUT change: with the storage-fault
    windows stripped (they key on per-peer paths), the committed
    history digest must match the per-peer layout exactly — under the
    overlap pipeline too."""
    import dataclasses

    from raftsql_tpu_torch.chaos.schedule import generate
    sched = generate(11, ticks=100, min_fsync_faults=0,
                     min_torn_writes=0, min_crashes=0)
    sched = dataclasses.replace(sched, fsync_faults=(), torn_writes=(),
                                enospc_faults=(), fsync_stalls=())
    # Crash/restart events stay: replay must be layout-equivalent.
    base = _chaos_digest(monkeypatch, "1", "0", sched)
    gc = _chaos_digest(monkeypatch, "1", "1", sched)
    assert base == gc


# -- GroupCommitWAL units ----------------------------------------------------


def test_group_commit_one_fsync_per_round(tmp_path):
    gw = GroupCommitWAL(str(tmp_path / "gc"), num_peers=3, num_groups=2)
    views = [gw.view(p) for p in range(3)]
    for p, v in enumerate(views):
        v.append_ranges([0], [1], [1], [1], [f"p{p}".encode()])
        v.set_hardstates([0], [1], [p], [0])
    for v in views:                       # the barrier: P calls...
        v.sync()
    assert gw.group_commits == 1          # ...ONE fsync
    assert gw.batch_hist == {3: 1}
    views[1].append_ranges([1], [1], [1], [1], [b"solo"])
    for v in views:
        v.sync()
    assert gw.group_commits == 2
    assert gw.batch_hist == {3: 1, 1: 1}
    for v in views:
        v.sync()                          # idle round: no fsync
    assert gw.group_commits == 2
    for v in views:
        v.close()


def test_group_commit_replay_splits_per_peer(tmp_path):
    d = str(tmp_path / "gc")
    gw = GroupCommitWAL(d, num_peers=3, num_groups=2)
    views = [gw.view(p) for p in range(3)]
    for p, v in enumerate(views):
        v.append_ranges([0, 1], [1, 1], [2, 1], [1, 1],
                        [f"p{p}e1".encode(), f"p{p}e2".encode(),
                         f"p{p}g1".encode()])
        v.set_hardstates([0, 1], [1, 1], [-1, -1], [2, 1])
        v.sync()
        v.close()
    flat = GroupCommitWAL.replay_flat(d)
    for p in range(3):
        mine = GroupCommitWAL.split_replay(flat, p, 2)
        assert sorted(mine) == [0, 1]
        assert [e[1] for e in mine[0].entries] == [
            f"p{p}e1".encode(), f"p{p}e2".encode()]
        assert [e[1] for e in mine[1].entries] == [f"p{p}g1".encode()]
        assert mine[0].hard.commit == 2
        assert mine[1].hard.commit == 1


def test_group_commit_cluster_equivalent_to_per_peer(tmp_path):
    """The SAME seeded run on both WAL layouts: identical commit
    streams, identical hard states, identical post-restart replay."""
    results = []
    for label, gc in (("pp", False), ("gc", True)):
        d = str(tmp_path / label)
        cfg = mkcfg()
        node = FusedClusterNode(cfg, d, seed=3, group_commit=gc,
                                device="cpu")
        assert (node._gcwal is not None) == gc
        for _ in range(60):
            node.tick()
        for g in range(cfg.num_groups):
            node.propose_many(g, [f"SET k{i} g{g}".encode()
                                  for i in range(6)])
        for _ in range(30):
            node.tick()
        node.publish_flush()
        stream = sorted(_published(node))
        hard = node._hard.copy()
        node.stop()
        node2 = FusedClusterNode(cfg, d, seed=3, group_commit=gc,
                                 device="cpu")
        replay = sorted(_published(node2))
        hard2 = node2._hard.copy()
        node2.stop()
        results.append((stream, replay, hard, hard2))
    a, b = results
    assert a[0] == b[0]                   # live commit streams
    assert a[1] == b[1]                   # replayed streams
    assert np.array_equal(a[2], b[2])
    assert np.array_equal(a[3], b[3])
    assert len(a[0]) >= 12
