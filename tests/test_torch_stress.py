"""The case of tests/test_stress.py, on the port (three RaftNodes on
the CPU over LoopbackHub).  The reference file's docstring follows.

Concurrency stress: compact / InstallSnapshot / catch-up / publish
hammered concurrently on a live cluster (SURVEY.md §5.2; the reference
relies on Go's race detector being *available* but never enables it,
reference Makefile:14-15 — here the interleavings are driven on purpose).

Shape: a 3-node loopback cluster in snapshot-resume mode with a tiny log
window and aggressive WAL compaction, three concurrent proposer threads,
and a chaos thread that repeatedly partitions node 3 long enough for the
survivors to commit + compact PAST its position — so every heal forces
either host-mediated catch-up or a full InstallSnapshot — while publish
and the per-tick WAL phase run on the node threads throughout.
"""
import os
import threading
import time

import torch

from raftsql_tpu_torch.config import RaftConfig
from raftsql_tpu_torch.models.sqlite_sm import SQLiteStateMachine
from raftsql_tpu_torch.runtime.db import RaftDB
from raftsql_tpu_torch.runtime.pipe import RaftPipe
from raftsql_tpu_torch.transport.loopback import (FaultPlan, LoopbackHub,
                                            LoopbackTransport)

torch.set_num_threads(1)

TICK = 0.002
TIMEOUT = 60.0
N = 3
G = 4


def test_compact_install_catchup_publish_stress(tmp_path):
    faults = FaultPlan()
    hub = LoopbackHub(faults=faults)
    cfg = RaftConfig(num_groups=G, num_peers=N, tick_interval_s=TICK,
                     election_ticks=10, log_window=16,
                     max_entries_per_msg=4)
    dbs = []
    for i in range(N):
        pipe = RaftPipe.create(
            i + 1, N, cfg, LoopbackTransport(hub),
            data_dir=os.path.join(str(tmp_path), f"raftsql-{i + 1}"),
            device="cpu")
        dbs.append(RaftDB(
            lambda g, i=i: SQLiteStateMachine(
                os.path.join(str(tmp_path), f"db-{i}-{g}.db"), resume=True),
            pipe, num_groups=G, resume=True,
            compact_every=20, compact_keep=16))
    try:
        for g in range(G):
            assert dbs[0].propose("CREATE TABLE t (v text)",
                                  group=g).wait(TIMEOUT) is None

        stop = threading.Event()
        acked = [0] * N
        failed = []

        def proposer(i):
            k = 0
            while not stop.is_set():
                g = k % G
                fut = dbs[i].propose(
                    f"INSERT INTO t (v) VALUES ('n{i}k{k}')", group=g)
                try:
                    err = fut.wait(TIMEOUT)
                except TimeoutError as e:
                    # A hung ack is exactly what this test hunts — it
                    # must FAIL the test, not die in a daemon thread.
                    failed.append((i, k, e))
                    return
                if err is None:
                    acked[i] += 1
                elif "snapshot" not in str(err):
                    # "superseded by snapshot install" is the documented
                    # retriable outcome for proposals whose commit rode a
                    # state transfer; anything else is a real failure.
                    failed.append((i, k, err))
                k += 1

        threads = [threading.Thread(target=proposer, args=(i,), daemon=True)
                   for i in range(N)]
        for t in threads:
            t.start()

        # Chaos: partition node 3, let the survivors commit + compact far
        # past it, heal, repeat.  Each heal exercises catch-up and (once
        # the WAL floor passes node 3's log) InstallSnapshot, racing the
        # proposers' publish/WAL traffic the whole time.  The hold is
        # PROGRESS-based (survivors must out-run node 3 past the ring +
        # compaction keep), not wall-clock — a CPU-starved run otherwise
        # under-delivers the lag the hard paths need.
        def min_gap() -> int:
            a0 = dbs[0].pipe.node._applied
            a2 = dbs[2].pipe.node._applied
            return int((a0 - a2).min())

        for _ in range(3):
            faults.isolate(3, range(1, N + 1))
            t0 = time.monotonic()
            while min_gap() < 48 and time.monotonic() - t0 < 10.0:
                time.sleep(0.1)
            faults.heal()
            t0 = time.monotonic()
            while min_gap() > 4 and time.monotonic() - t0 < 6.0:
                time.sleep(0.1)

        stop.set()
        for t in threads:
            t.join(TIMEOUT)
        assert not failed, failed[:3]
        assert sum(acked) > 30, f"too few acks for a stress run: {acked}"

        # Quiesce, then require convergence: every node's replica of every
        # group reports the same row count (stale reads poll-retried, as
        # in reference raftsql_test.go:159-170).
        deadline = time.monotonic() + TIMEOUT
        for g in range(G):
            want = None
            while True:
                counts = [db.query("SELECT count(*) FROM t", group=g)
                          for db in dbs]
                if len(set(counts)) == 1:
                    want = counts[0]
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(
                        f"group {g} diverged after stress: {counts}")
                time.sleep(0.05)
            assert want.startswith("|") and int(want.strip("|\n")) >= 1
        installs = sum(db.pipe.node.metrics.snapshots_installed
                       for db in dbs if db.pipe is not None)
        catchups = sum(db.pipe.node.metrics.catchup_appends
                       for db in dbs if db.pipe is not None)
        compactions = sum(db.pipe.node.metrics.compactions
                          for db in dbs if db.pipe is not None)
        # The point of the chaos schedule: the hard paths actually ran.
        assert compactions > 0, "stress never compacted"
        assert installs + catchups > 0, \
            "stress never exercised catch-up or InstallSnapshot"
    finally:
        for db in dbs:
            try:
                db.close()
            except Exception:
                pass
