"""The cases of tests/test_snapshot.py, on the port (raftsql_tpu_torch,
every RaftNode stepping on the CPU).  The reference file's docstring
follows.

Snapshot-resume + WAL compaction (the checkpoint/resume subsystem
beyond the reference's delete-and-replay, SURVEY.md §5.4).

Key invariants:
  - resume mode applies each entry EXACTLY once across crashes (the
    applied_index is committed in the same SQLite transaction as the
    command, so double-apply would show up as duplicate rows);
  - WAL.rewrite drops snapshot-covered prefixes but restart still yields
    the same log positions/terms (boundary marker record);
  - a compacted node restarts correctly and keeps serving;
  - default mode stays reference-parity (file deleted, full replay).
"""
import os

import pytest

from raftsql_tpu_torch.config import RaftConfig
from raftsql_tpu_torch.models.sqlite_sm import SQLiteStateMachine
from raftsql_tpu_torch.runtime.db import RaftDB
from raftsql_tpu_torch.runtime.pipe import RaftPipe
from raftsql_tpu_torch.storage.wal import WAL, GroupLog, HardState
from raftsql_tpu_torch.transport.loopback import LoopbackHub, LoopbackTransport

import torch

torch.set_num_threads(1)

TICK = 0.005
TIMEOUT = 30.0


class TestSQLiteResume:
    def test_applied_index_atomic_with_apply(self, tmp_path):
        p = str(tmp_path / "a.db")
        sm = SQLiteStateMachine(p, resume=True)
        assert sm.applied_index() == 0
        assert sm.apply("CREATE TABLE t (v int)", index=1) is None
        assert sm.apply("INSERT INTO t VALUES (7)", index=2) is None
        assert sm.applied_index() == 2
        sm.close()
        sm2 = SQLiteStateMachine(p, resume=True)
        assert sm2.applied_index() == 2
        assert sm2.query("SELECT * FROM t") == "|7|\n"
        sm2.close()

    def test_failed_apply_still_advances_index(self, tmp_path):
        p = str(tmp_path / "b.db")
        sm = SQLiteStateMachine(p, resume=True)
        assert sm.apply("CREATE TABLE t (v int)", index=1) is None
        assert sm.apply("INSERT INTO nosuch VALUES (1)", index=2) \
            is not None
        assert sm.applied_index() == 2
        sm.close()

    def test_default_mode_deletes_file(self, tmp_path):
        p = str(tmp_path / "c.db")
        sm = SQLiteStateMachine(p)
        sm.apply("CREATE TABLE t (v int)", index=1)
        sm.apply("INSERT INTO t VALUES (1)", index=2)
        sm.close()
        sm2 = SQLiteStateMachine(p)           # reference parity: nuked
        with pytest.raises(Exception):
            sm2.query("SELECT * FROM t")
        sm2.close()


class TestWALRewrite:
    def test_rewrite_preserves_positions(self, tmp_path):
        d = str(tmp_path / "w")
        w = WAL(d)
        for i in range(1, 11):
            w.append_entry(0, i, 1, f"e{i}".encode())
        w.set_hardstate(0, 1, 0, 10)
        w.close()
        gl = WAL.replay(d)[0]
        # Compact away entries <= 6.
        image = {0: GroupLog(hard=HardState(1, 0, 10),
                             entries=gl.entries[6:], start=6,
                             start_term=gl.entries[5][0])}
        WAL.rewrite(d, image)
        gl2 = WAL.replay(d)[0]
        assert gl2.start == 6
        assert gl2.start_term == 1
        assert gl2.log_len == 10
        assert [e[1] for e in gl2.entries] == [b"e7", b"e8", b"e9", b"e10"]
        # Appends after the rewrite keep working at absolute positions.
        w2 = WAL(d)
        w2.append_entry(0, 11, 2, b"e11")
        w2.close()
        gl3 = WAL.replay(d)[0]
        assert gl3.log_len == 11
        assert gl3.entries[-1] == (2, b"e11")


def _boot(tmp_path, hub, cfg, i, resume, compact_every=0):
    pipe = RaftPipe.create(
        i + 1, cfg.num_peers, cfg, LoopbackTransport(hub),
        data_dir=str(tmp_path / f"raftsql-{i + 1}"), device="cpu")
    return RaftDB(
        lambda g, i=i: SQLiteStateMachine(
            str(tmp_path / f"snap-{i}.db"), resume=resume),
        pipe, resume=resume, compact_every=compact_every,
        compact_keep=0)


class TestClusterResume:
    def test_exactly_once_across_restart(self, tmp_path):
        """INSERTs without keys: a double-apply after restart would show
        as duplicate rows."""
        hub = LoopbackHub()
        cfg = RaftConfig(num_groups=1, num_peers=3, tick_interval_s=TICK,
                         log_window=32, max_entries_per_msg=4)
        dbs = [_boot(tmp_path, hub, cfg, i, resume=True) for i in range(3)]
        try:
            assert dbs[0].propose(
                "CREATE TABLE t (v int)").wait(TIMEOUT) is None
            for k in range(10):
                assert dbs[0].propose(
                    f"INSERT INTO t VALUES ({k})").wait(TIMEOUT) is None
            import time
            deadline = time.monotonic() + TIMEOUT
            while dbs[1].query("SELECT count(*) FROM t") != "|10|\n":
                assert time.monotonic() < deadline
                time.sleep(0.02)
            dbs[1].close()
            dbs[1] = _boot(tmp_path, hub, cfg, 1, resume=True)
            # After restart + replay the count must be exactly 10: the
            # replayed prefix was skipped, not re-applied.
            deadline = time.monotonic() + TIMEOUT
            while True:
                v = dbs[1].query("SELECT count(*) FROM t")
                if v == "|10|\n":
                    break
                assert v in ("|10|\n",) or int(v.strip("|\n")) <= 10, \
                    f"double apply: {v!r}"
                assert time.monotonic() < deadline
                time.sleep(0.02)
        finally:
            for db in dbs:
                db.close()

    def test_compaction_shrinks_wal_and_restarts(self, tmp_path):
        hub = LoopbackHub()
        # Tiny segments so the 81-entry run rotates several times and
        # compaction can drop whole pre-floor segments (VERDICT: no
        # stop-the-world rewrite of live data).
        cfg = RaftConfig(num_groups=1, num_peers=3, tick_interval_s=TICK,
                         log_window=16, max_entries_per_msg=4,
                         wal_segment_bytes=2048)
        dbs = [_boot(tmp_path, hub, cfg, i, resume=True, compact_every=20)
               for i in range(3)]
        try:
            assert dbs[0].propose(
                "CREATE TABLE t (v int)").wait(TIMEOUT) is None
            for k in range(80):
                assert dbs[0].propose(
                    f"INSERT INTO t VALUES ({k})").wait(TIMEOUT) is None
            # At least one node compacted (keep clamps to log_window=16,
            # applied ~81 >> 16).
            assert any(db.metrics()["compactions"] > 0 for db in dbs)
            segs = sorted((tmp_path / "raftsql-1").glob("wal-*.log"))
            walsz = sum(os.path.getsize(s) for s in segs)
            # Un-compacted the 81-insert log spans many 2 KiB segments;
            # compaction must have unlinked the pre-floor ones.
            assert walsz < 6144, (walsz, segs)
            assert segs[0].name != "wal-0.log", segs   # oldest seg dropped
            # Restart a compacted node; it must come back consistent.
            dbs[0].close()
            dbs[0] = _boot(tmp_path, hub, cfg, 0, resume=True)
            import time
            deadline = time.monotonic() + TIMEOUT
            while dbs[0].query("SELECT count(*) FROM t") != "|80|\n":
                assert time.monotonic() < deadline
                time.sleep(0.02)
        finally:
            for db in dbs:
                db.close()


class TestSnapshotTermCheck:
    """Receiver-side term rule for InstallSnapshot (raft: reject RPCs with
    term < currentTerm; adopt term > currentTerm)."""

    def _node(self, tmp_path):
        from raftsql_tpu_torch.runtime.node import RaftNode
        hub = LoopbackHub()
        cfg = RaftConfig(num_groups=1, num_peers=3, tick_interval_s=TICK,
                         log_window=16, max_entries_per_msg=4)
        node = RaftNode(1, 3, cfg, LoopbackTransport(hub),
                        str(tmp_path / "raftsql-1"), device="cpu")
        installs = []
        node.snapshot_installer = \
            lambda g, idx, blob: installs.append((g, idx, blob))
        return node, installs

    def test_stale_term_snapshot_rejected(self, tmp_path):
        from raftsql_tpu_torch.transport.base import SnapshotRec
        node, installs = self._node(tmp_path)
        node.state.term[0] = 5          # the port patches in place
        node._stage_snaps[0] = SnapshotRec(
            group=0, last_idx=50, last_term=3, term=3, blob=b"{}")
        node._install_snapshots()
        assert installs == []           # deposed leader's transfer dropped
        assert int(node.state.term[0]) == 5
        assert int(node.state.commit[0]) == 0

    def test_higher_term_duplicate_still_steps_down(self, tmp_path):
        """Term adoption fires on receipt of a valid higher-term RPC even
        when the transfer itself is a duplicate (raft §5.1)."""
        from raftsql_tpu_torch.config import FOLLOWER, LEADER
        from raftsql_tpu_torch.transport.base import SnapshotRec
        node, installs = self._node(tmp_path)
        node.state.term[0] = 5
        node.state.role[0] = LEADER
        node.state.commit[0] = 60
        node._stage_snaps[0] = SnapshotRec(
            group=0, last_idx=50, last_term=7, term=7, blob=b"{}")
        node._install_snapshots()
        assert installs == []           # last_idx <= commit: not installed
        assert int(node.state.term[0]) == 7
        assert int(node.state.role[0]) == FOLLOWER

    def test_higher_term_snapshot_adopts_term(self, tmp_path):
        from raftsql_tpu_torch.transport.base import SnapshotRec
        node, installs = self._node(tmp_path)
        node.state.term[0] = 5
        node.state.voted_for[0] = 2
        node._stage_snaps[0] = SnapshotRec(
            group=0, last_idx=50, last_term=7, term=7, blob=b"{}")
        node._install_snapshots()
        assert installs == [(0, 50, b"{}")]
        assert int(node.state.term[0]) == 7      # term catch-up
        assert int(node.state.commit[0]) == 50
        from raftsql_tpu_torch.config import NO_VOTE
        assert int(node.state.voted_for[0]) == NO_VOTE


class TestInstallSnapshot:
    def test_follower_beyond_floor_gets_full_transfer(self, tmp_path):
        """Kill a follower, write + compact far past its position, then
        restart it: the prefix it needs is gone from every log, so the
        leader must ship a full state-machine image (InstallSnapshot) and
        resume replication above it."""
        import time
        hub = LoopbackHub()
        cfg = RaftConfig(num_groups=1, num_peers=3, tick_interval_s=TICK,
                         log_window=16, max_entries_per_msg=4)
        dbs = [_boot(tmp_path, hub, cfg, i, resume=True, compact_every=10)
               for i in range(3)]
        try:
            assert dbs[0].propose(
                "CREATE TABLE t (v int)").wait(TIMEOUT) is None
            dbs[1].close()
            dbs[1] = None
            for k in range(120):    # >> log_window + compact keep
                assert dbs[0].propose(
                    f"INSERT INTO t VALUES ({k})").wait(TIMEOUT) is None
            assert any(db is not None and db.metrics()["compactions"] > 0
                       for db in dbs)
            dbs[1] = _boot(tmp_path, hub, cfg, 1, resume=True)
            deadline = time.monotonic() + TIMEOUT
            while True:
                # "no such table" is a legitimate transient on the
                # freshly restarted replica (stale local reads by
                # design): if it died before applying the CREATE, its
                # kept SQLite file has no `t` until the InstallSnapshot
                # lands — poll through it (test_cluster_sql.py's
                # catch-up loops tolerate the same transient).
                try:
                    got = dbs[1].query("SELECT count(*) FROM t")
                except Exception:
                    got = None
                if got == "|120|\n":
                    break
                assert time.monotonic() < deadline, (
                    got, [db.metrics() for db in dbs if db])
                time.sleep(0.02)
            assert sum(db.metrics()["snapshots_sent"]
                       for db in dbs if db) > 0
            assert dbs[1].metrics()["snapshots_installed"] > 0
            # And the installed follower keeps replicating live traffic.
            assert dbs[0].propose(
                "INSERT INTO t VALUES (999)").wait(TIMEOUT) is None
            deadline = time.monotonic() + TIMEOUT
            while "999" not in dbs[1].query("SELECT v FROM t"):
                assert time.monotonic() < deadline
                time.sleep(0.02)

            # Installed state must be ON DISK, not a connection-local
            # in-memory copy: restart the installed follower and require
            # its applied_index/data to come back from the FILE without
            # needing another transfer (sqlite3.deserialize detaches to
            # memory — install writes the image to the path instead).
            installed_applied = dbs[1]._sms[0].applied_index()
            assert installed_applied >= 120
            dbs[1].close()
            dbs[1] = _boot(tmp_path, hub, cfg, 1, resume=True)
            assert dbs[1]._sms[0].applied_index() >= installed_applied
            assert "999" in dbs[1].query("SELECT v FROM t")
        finally:
            for db in dbs:
                if db is not None:
                    db.close()
