"""The port's WAL, payload log and codec (the port's copy of
tests/test_storage.py), then the native storage plane held to the JAX
package's.

The copied tests run on both backends of the port's WAL where the JAX
package's test takes the default backend (`native` below: the C++ fast
path of native/wal.cc, or the Python writer), and pin a backend where it
pins one.  The parity tests that follow write the same records through
the port's native and Python backends and the JAX package's native and
Python backends and require the same bytes: every writer, the combined
payload-log calls on group-commit views, rotation and compaction at a
tiny segment size, and replay through the JAX package's reader.  The two
packages' builds of wal.cc are loaded side by side with ctypes' default
RTLD_LOCAL, so their identical C symbols never clash.
"""
import os

import numpy as np
import pytest

from raftsql_tpu.native.build import load_native_plog as j_load_plog
from raftsql_tpu.storage import log as jlog
from raftsql_tpu.storage import wal as jwal
from raftsql_tpu_torch.config import MSG_REQ, MSG_RESP
from raftsql_tpu_torch.native import build as tbuild
from raftsql_tpu_torch.storage import log as tlog
from raftsql_tpu_torch.storage import wal as twal
from raftsql_tpu_torch.storage.wal import WAL, wal_exists
from raftsql_tpu_torch.transport.base import (AppendRec, ProposalRec,
                                              TickBatch, VoteRec)
from raftsql_tpu_torch.transport.codec import decode_batch, encode_batch


@pytest.fixture(params=[True, False], ids=["native", "python"])
def native(request):
    """The port's WAL backend for a copied test that takes the default."""
    return request.param


class TestWAL:
    def test_roundtrip(self, native, tmp_path):
        d = str(tmp_path / "w")
        w = WAL(d, native=native)
        w.append_entry(0, 1, 1, b"CREATE TABLE t")
        w.append_entry(0, 2, 1, b"INSERT 1")
        w.append_entry(1, 1, 2, b"other group")
        w.set_hardstate(0, 1, 0, 2)
        w.sync()
        w.close()
        assert wal_exists(d)
        groups = WAL.replay(d)
        assert groups[0].log_len == 2
        assert groups[0].entries == [(1, b"CREATE TABLE t"), (1, b"INSERT 1")]
        assert groups[0].hard.term == 1
        assert groups[0].hard.commit == 2
        assert groups[1].entries == [(2, b"other group")]

    def test_conflict_truncation_on_replay(self, native, tmp_path):
        d = str(tmp_path / "w")
        w = WAL(d, native=native)
        w.append_entry(0, 1, 1, b"a")
        w.append_entry(0, 2, 1, b"b")
        w.append_entry(0, 3, 1, b"c")
        # Overwrite index 2 with a term-2 entry (leader change).
        w.append_entry(0, 2, 2, b"b2")
        w.close()
        groups = WAL.replay(d)
        assert groups[0].entries == [(1, b"a"), (2, b"b2")]

    def test_same_term_overlap_keeps_suffix(self, native, tmp_path):
        """A re-accepted duplicate append (same index+term, e.g. a stale
        retransmission) must NOT truncate durably-acked suffix entries —
        same index+term implies same entry (raft log matching)."""
        d = str(tmp_path / "w")
        w = WAL(d, native=native)
        for i in range(1, 6):
            w.append_entry(0, i, 1, f"e{i}".encode())
        w.append_entry(0, 3, 1, b"e3")      # stale duplicate of entry 3
        w.close()
        gl = WAL.replay(d)[0]
        assert gl.entries == [(1, f"e{i}".encode()) for i in range(1, 6)]

    def test_torn_tail_dropped(self, native, tmp_path):
        d = str(tmp_path / "w")
        w = WAL(d, native=native)
        w.append_entry(0, 1, 1, b"good")
        w.close()
        path = os.path.join(d, "wal-0.log")
        with open(path, "ab") as f:
            f.write(b"\x01\x02\x03garbage")
        groups = WAL.replay(d)
        assert groups[0].entries == [(1, b"good")]

    def test_append_after_reopen(self, native, tmp_path):
        d = str(tmp_path / "w")
        w = WAL(d, native=native)
        w.append_entry(0, 1, 1, b"one")
        w.close()
        w2 = WAL(d, native=native)
        w2.append_entry(0, 2, 1, b"two")
        w2.close()
        groups = WAL.replay(d)
        assert [e[1] for e in groups[0].entries] == [b"one", b"two"]

    def test_empty_replay(self, tmp_path):
        assert WAL.replay(str(tmp_path / "nope")) == {}


class TestSegmentation:
    """Segmented WAL: rotation at sync boundaries, replay concatenation,
    compaction by whole-segment deletion (etcd/wal's segment-dir shape,
    reference raft.go:99-117)."""

    def test_rotation_and_replay(self, native, tmp_path):
        d = str(tmp_path / "w")
        w = WAL(d, native=native, segment_bytes=256)
        for i in range(1, 41):
            w.append_entry(0, i, 1, f"entry-{i:03d}".encode())
            w.set_hardstate(0, 1, -1, i)
            w.sync()
        w.close()
        segs = sorted(p.name for p in (tmp_path / "w").glob("wal-*.log"))
        assert len(segs) > 2, segs           # actually rotated
        gl = WAL.replay(d)[0]
        assert gl.log_len == 40
        assert [e[1] for e in gl.entries] == [
            f"entry-{i:03d}".encode() for i in range(1, 41)]
        assert gl.hard.commit == 40          # last hardstate wins

    def test_reopen_appends_to_highest_segment(self, native, tmp_path):
        d = str(tmp_path / "w")
        w = WAL(d, native=native, segment_bytes=128)
        for i in range(1, 11):
            w.append_entry(0, i, 1, b"x" * 20)
            w.sync()
        w.close()
        n_before = len(list((tmp_path / "w").glob("wal-*.log")))
        w2 = WAL(d, native=native, segment_bytes=128)
        w2.append_entry(0, 11, 1, b"after-reopen")
        w2.sync()
        w2.close()
        assert len(list((tmp_path / "w").glob("wal-*.log"))) >= n_before
        gl = WAL.replay(d)[0]
        assert gl.log_len == 11
        assert gl.entries[-1] == (1, b"after-reopen")

    def test_compact_deletes_covered_segments(self, native, tmp_path):
        d = str(tmp_path / "w")
        w = WAL(d, native=native, segment_bytes=256)
        for i in range(1, 41):
            w.append_entry(0, i, 2, f"e{i}".encode())
            w.set_hardstate(0, 2, 0, i)
            w.sync()
        segs0 = sorted((tmp_path / "w").glob("wal-*.log"))
        assert len(segs0) > 3
        deleted = w.compact({0: (30, 2)}, {0: (2, 0, 40)})
        assert deleted > 0
        segs1 = sorted((tmp_path / "w").glob("wal-*.log"))
        assert len(segs1) < len(segs0)
        # Replay after dropping segments: floor honored, suffix intact.
        w.close()
        gl = WAL.replay(d)[0]
        assert gl.start == 30
        assert gl.start_term == 2
        assert gl.log_len == 40
        assert [e[1] for e in gl.entries] == [
            f"e{i}".encode() for i in range(31, 41)]
        assert gl.hard == type(gl.hard)(term=2, vote=0, commit=40)

    def test_compact_never_deletes_uncovered(self, native, tmp_path):
        """A segment holding entries above the floor must survive, and
        so must everything after it (contiguity)."""
        d = str(tmp_path / "w")
        w = WAL(d, native=native, segment_bytes=256)
        for i in range(1, 41):
            w.append_entry(0, i, 1, f"e{i}".encode())
            w.sync()
        deleted = w.compact({0: (5, 1)}, {0: (1, -1, 40)})
        w.close()
        gl = WAL.replay(d)[0]
        assert gl.start == 5
        assert gl.log_len == 40
        assert [e[1] for e in gl.entries] == [
            f"e{i}".encode() for i in range(6, 41)]

    def test_compact_multi_group_blocks_on_uncompacted_group(self, native,
                                                             tmp_path):
        """A segment is only deletable when EVERY group's records in it
        are covered; one lagging group pins it."""
        d = str(tmp_path / "w")
        w = WAL(d, native=native, segment_bytes=200)
        for i in range(1, 21):
            w.append_entry(0, i, 1, f"a{i}".encode())
            w.append_entry(1, i, 1, f"b{i}".encode())
            w.sync()
        # Only group 0 has a floor; group 1 pins every segment.
        assert w.compact({0: (15, 1)}, {0: (1, -1, 20),
                                        1: (1, -1, 20)}) == 0
        # Give group 1 a floor too: early segments can go.
        assert w.compact({0: (15, 1), 1: (15, 1)},
                         {0: (1, -1, 20), 1: (1, -1, 20)}) > 0
        w.close()
        groups = WAL.replay(d)
        assert groups[0].start == 15 and groups[1].start == 15
        assert groups[0].log_len == 20 and groups[1].log_len == 20

    def test_compact_marker_replay_keeps_suffix(self, native, tmp_path):
        """REC_COMPACT drops only the covered prefix (REC_SNAPSHOT also
        drops the suffix — different semantics, both replayed here)."""
        d = str(tmp_path / "w")
        w = WAL(d, native=native)
        for i in range(1, 11):
            w.append_entry(0, i, 1, f"e{i}".encode())
        w.mark_compact(0, 4, 1)
        w.append_entry(1, 1, 1, b"x1")
        w.set_snapshot(1, 7, 3)              # install: suffix must go too
        w.close()
        groups = WAL.replay(d)
        assert groups[0].start == 4
        assert [e[1] for e in groups[0].entries] == [
            f"e{i}".encode() for i in range(5, 11)]
        assert groups[1].start == 7
        assert groups[1].entries == []

    def test_dedup_baseline_replay_highest_floor_wins(self, tmp_path):
        """REC_DEDUP replay: the baseline comes back verbatim, and a
        later (higher-floor) record supersedes an earlier one."""
        d = str(tmp_path / "w")
        w = WAL(d, native=False)
        w.append_entry(0, 1, 1, b"e1")
        assert w.set_dedup(0, 1, [(1, 42)])
        w.append_entry(0, 2, 1, b"e2")
        w.append_entry(0, 3, 1, b"e3")
        assert w.set_dedup(0, 2, [(1, 42), (2, 77)])
        w.sync()
        w.close()
        gl = WAL.replay(d)[0]
        assert gl.dedup == (2, [(1, 42), (2, 77)])

    def test_dedup_baseline_survives_segment_unlink(self, tmp_path):
        """The dedup baseline obeys the hard-state survival contract:
        compaction re-asserts it into the active segment before
        unlinking the closed segment that held it — the doomed segment
        may hold the only record scrubbing a compacted-away
        forward-retry duplicate."""
        d = str(tmp_path / "w")
        w = WAL(d, native=False, segment_bytes=256)
        w.append_entry(0, 1, 1, b"first-copy")
        assert w.set_dedup(0, 1, [(1, 42)])
        for i in range(2, 41):
            w.append_entry(0, i, 1, f"e{i}".encode())
            w.set_hardstate(0, 1, -1, i)
            w.sync()
        assert w.compact({0: (30, 1)}, {0: (1, -1, 40)}) > 0
        w.close()
        gl = WAL.replay(d)[0]
        assert gl.start == 30
        assert gl.dedup == (1, [(1, 42)])

    def test_torn_mid_sequence_drops_later_segments(self, native, tmp_path):
        """A tear in a non-final segment is real corruption: replay keeps
        only the clean prefix, never skips over the damage."""
        d = str(tmp_path / "w")
        w = WAL(d, native=native, segment_bytes=64)
        for i in range(1, 9):
            w.append_entry(0, i, 1, b"y" * 30)
            w.sync()
        w.close()
        segs = sorted((tmp_path / "w").glob("wal-*.log"))
        assert len(segs) >= 3
        # Corrupt the middle segment's first record.
        mid = segs[len(segs) // 2]
        blob = bytearray(mid.read_bytes())
        blob[10] ^= 0xFF
        mid.write_bytes(bytes(blob))
        gl = WAL.replay(d)[0]
        assert 0 < gl.log_len < 8


class TestCodec:
    def test_roundtrip(self):
        batch = TickBatch(
            votes=[VoteRec(group=3, type=MSG_REQ, term=7, last_idx=9,
                           last_term=6),
                   VoteRec(group=0, type=MSG_RESP, term=7, granted=True)],
            appends=[
                AppendRec(group=2, type=MSG_REQ, term=5, prev_idx=10,
                          prev_term=4, ent_terms=[5, 5],
                          payloads=[b"INSERT a", b""], commit=9),
                AppendRec(group=2, type=MSG_RESP, term=5, success=True,
                          match=12),
            ],
            proposals=[ProposalRec(group=1, payload=b"CREATE TABLE x")])
        out = decode_batch(encode_batch(batch))
        assert out == batch

    def test_columnar_roundtrip(self):
        import numpy as np

        from raftsql_tpu_torch.transport.base import ColRecs

        def cols(nv, na):
            c = ColRecs()
            if nv:
                c.v_group = np.arange(nv, dtype=np.int32)
                c.v_type = np.full(nv, MSG_REQ, np.int32)
                c.v_term = np.arange(nv, dtype=np.int32) + 3
                c.v_last_idx = np.arange(nv, dtype=np.int32) * 2
                c.v_last_term = np.arange(nv, dtype=np.int32)
                c.v_granted = (np.arange(nv, dtype=np.int32) % 2)
            if na:
                c.a_group = np.arange(na, dtype=np.int32) + 1
                c.a_type = np.full(na, MSG_RESP, np.int32)
                c.a_term = np.arange(na, dtype=np.int32) + 9
                c.a_prev_idx = np.arange(na, dtype=np.int32)
                c.a_prev_term = np.arange(na, dtype=np.int32)
                c.a_commit = np.arange(na, dtype=np.int32) * 3
                c.a_success = (np.arange(na, dtype=np.int32) % 2)
                c.a_match = np.arange(na, dtype=np.int32) + 5
                c.a_seq = np.arange(na, dtype=np.int64) + (1 << 40)
            return c

        for nv, na in ((2, 3), (2, 0), (0, 3)):
            # Mixed with record sections: both must survive together.
            b = TickBatch(appends=[AppendRec(
                group=0, type=MSG_REQ, term=1, ent_terms=[1],
                payloads=[b"x"], seq=4)])
            b.cols = cols(nv, na)
            out = decode_batch(encode_batch(b))
            assert out.appends == b.appends
            assert (out.cols is not None) == bool(nv or na)
            for f in ("v_group", "v_type", "v_term", "v_last_idx",
                      "v_last_term", "v_granted"):
                want = getattr(b.cols, f)
                got = getattr(out.cols, f)
                if nv:
                    assert (np.asarray(got) == np.asarray(want)).all(), f
                else:
                    assert got is None or len(got) == 0
            for f in ("a_group", "a_type", "a_term", "a_prev_idx",
                      "a_prev_term", "a_commit", "a_success", "a_match",
                      "a_seq"):
                want = getattr(b.cols, f)
                got = getattr(out.cols, f)
                if na:
                    assert (np.asarray(got) == np.asarray(want)).all(), f
                    if f == "a_seq":
                        assert got.dtype == np.int64
                else:
                    assert got is None or len(got) == 0

    def test_empty(self):
        assert decode_batch(encode_batch(TickBatch())).empty()

    def test_payload_count_mismatch_asserts(self):
        bad = TickBatch(appends=[AppendRec(
            group=0, type=MSG_REQ, term=1, ent_terms=[1], payloads=[])])
        with pytest.raises(AssertionError):
            encode_batch(bad)

    def test_truncated_columnar_section_is_codec_error(self):
        """A truncated/corrupt trailing ColSection must fail as a codec
        error (struct.error, like the record sections), not a ValueError
        deep inside numpy frombuffer."""
        import struct

        import numpy as np

        from raftsql_tpu_torch.transport.base import ColRecs

        c = ColRecs()
        c.a_group = np.arange(4, dtype=np.int32)
        c.a_type = np.full(4, MSG_RESP, np.int32)
        c.a_term = np.ones(4, np.int32)
        c.a_prev_idx = np.zeros(4, np.int32)
        c.a_prev_term = np.zeros(4, np.int32)
        c.a_commit = np.zeros(4, np.int32)
        c.a_success = np.ones(4, np.int32)
        c.a_match = np.arange(4, dtype=np.int32)
        c.a_seq = np.arange(4, dtype=np.int64)
        blob = encode_batch(TickBatch(cols=c))
        # Drop tail bytes at several depths: mid-a_seq, mid-columns, and
        # right after the declared count.
        for cut in (8, len(blob) // 2, len(blob) - 4):
            with pytest.raises(struct.error):
                decode_batch(blob[:len(blob) - cut])
        # Corrupt count: a huge declared na over an empty remainder.
        head = encode_batch(TickBatch())
        with pytest.raises(struct.error):
            decode_batch(head + struct.pack("<I", 0)
                         + struct.pack("<I", 1 << 28))


class TestEnvelope:
    def test_wrap_unwrap(self):
        from raftsql_tpu_torch.runtime.envelope import unwrap, wrap
        data = wrap(b"INSERT INTO t VALUES (1)")
        pid, payload = unwrap(data)
        assert pid is not None
        assert payload == b"INSERT INTO t VALUES (1)"

    def test_bare_entries_pass_through(self):
        from raftsql_tpu_torch.runtime.envelope import unwrap
        assert unwrap(b"") == (None, b"")

    def test_distinct_ids(self):
        from raftsql_tpu_torch.runtime.envelope import unwrap, wrap
        a, b = wrap(b"x"), wrap(b"x")
        assert a != b
        assert unwrap(a)[1] == unwrap(b)[1] == b"x"

    def test_dedup_window(self):
        from raftsql_tpu_torch.runtime.envelope import DedupWindow
        w = DedupWindow(cap=3)
        assert not w.seen(1)
        assert w.seen(1)           # duplicate caught
        assert not w.seen(2)
        assert not w.seen(3)
        assert not w.seen(4)       # evicts 1
        assert not w.seen(1)       # 1 slid out of the window

    def test_dedup_pairs_upto_and_restore(self):
        """The window snapshots consistently at an applied index: a
        transfer at idx 20 must ship ids applied at or below 20 and NOT
        the live tail beyond it (runtime/node.py InstallSnapshot)."""
        from raftsql_tpu_torch.runtime.envelope import DedupWindow
        w = DedupWindow()
        for idx, pid in ((10, 100), (20, 200), (30, 300)):
            assert not w.seen(pid, idx)
        pairs = w.pairs_upto(20)
        assert pairs == [(10, 100), (20, 200)]
        r = DedupWindow()
        r.restore(pairs)
        assert r.seen(100) and r.seen(200)
        assert not r.seen(300)      # beyond the transfer: not skipped

    def test_snapshot_blob_framing(self):
        from raftsql_tpu_torch.runtime.envelope import (unwrap_snapshot,
                                                  wrap_snapshot)
        pairs = [(5, 111), (9, 2**63 + 7)]
        blob = wrap_snapshot(pairs, b"sm-state-bytes")
        got, sm = unwrap_snapshot(blob)
        assert got == pairs
        assert sm == b"sm-state-bytes"

    def test_snapshot_blob_bare_fallback(self):
        """Blobs without the framing magic are treated as bare SM state
        (back-compat with directly staged SnapshotRecs in tests)."""
        from raftsql_tpu_torch.runtime.envelope import unwrap_snapshot
        assert unwrap_snapshot(b"{}") == (None, b"{}")
        assert unwrap_snapshot(b"") == (None, b"")


class TestPayloadLog:
    def test_try_term_of(self):
        """Floor-safe term lookup for client-thread callers (ReadIndex):
        below-floor and beyond-log return None, never an assert/wrap."""
        from raftsql_tpu_torch.storage.log import PayloadLog
        pl = PayloadLog(1)
        pl.put(0, 1, [b"a", b"b", b"c", b"d"], [1, 1, 2, 2])
        assert pl.try_term_of(0, 0) == 0
        assert pl.try_term_of(0, 3) == 2
        assert pl.try_term_of(0, 5) is None       # beyond the log
        pl.compact(0, 2, 1)
        assert pl.try_term_of(0, 2) == 1          # boundary term kept
        assert pl.try_term_of(0, 1) is None       # below the floor

    def test_try_slice_floor_race_paths(self):
        """try_slice degrades to None when the requested range dips
        below a (concurrently advancing) compaction floor — the atomic
        check-then-slice the send path relies on."""
        from raftsql_tpu_torch.storage.log import PayloadLog
        pl = PayloadLog(1)
        pl.put(0, 1, [b"a", b"b", b"c", b"d", b"e"], [1] * 5)
        assert pl.try_slice(0, 2, 3) == [b"b", b"c", b"d"]
        pl.compact(0, 3, 1)
        assert pl.try_slice(0, 2, 3) is None      # starts below floor
        assert pl.try_slice(0, 4, 2) == [b"d", b"e"]
        # A short tail read returns what exists (caller length-checks),
        # never wraps to the list head.
        assert pl.try_slice(0, 5, 4) == [b"e"]

    def test_try_tail_with_terms_boundary(self):
        """Atomic (prev_term, entries) read for catch-up appends: the
        floor's retained boundary term serves prev_term exactly at the
        edge, and a compacted-away start returns None (InstallSnapshot
        territory)."""
        from raftsql_tpu_torch.storage.log import PayloadLog
        pl = PayloadLog(1)
        pl.put(0, 1, [b"a", b"b", b"c", b"d"], [1, 2, 2, 3])
        prev, ents = pl.try_tail_with_terms(0, 1, 2)
        assert prev == 0 and ents == [(1, b"a"), (2, b"b")]
        pl.compact(0, 2, 2)
        assert pl.try_tail_with_terms(0, 2, 2) is None   # at the floor
        prev, ents = pl.try_tail_with_terms(0, 3, 4)
        assert prev == 2                  # boundary term, not a wrap
        assert ents == [(2, b"c"), (3, b"d")]

    def test_try_accessors_race_live_compactor(self):
        """Hammer try_term_of/try_slice/try_tail_with_terms from a
        reader thread while the owner thread compacts: every result is
        either None or internally consistent (terms match what was
        written at those absolute positions) — no asserts, no wrapped
        negative indexes, no torn (start, lists) reads."""
        import threading
        from raftsql_tpu_torch.storage.log import PayloadLog
        pl = PayloadLog(1)
        N = 400
        pl.put(0, 1, [b"%d" % i for i in range(1, N + 1)],
               list(range(1, N + 1)))        # term i at index i
        stop = threading.Event()
        errors = []

        def reader():
            try:
                while not stop.is_set():
                    for idx in (1, N // 3, N // 2, N):
                        t = pl.try_term_of(0, idx)
                        assert t is None or t == idx, (idx, t)
                        got = pl.try_slice(0, idx, 3)
                        assert got is None \
                            or got == [b"%d" % i for i in
                                       range(idx, min(idx + 3, N + 1))]
                        tail = pl.try_tail_with_terms(0, idx, 2)
                        if tail is not None:
                            prev, ents = tail
                            assert prev == idx - 1
                            assert all(t == i for (t, _), i in
                                       zip(ents, range(idx, idx + 2)))
            except Exception as e:          # pragma: no cover - failure
                errors.append(e)

        th = threading.Thread(target=reader)
        th.start()
        try:
            for floor in range(2, N, 7):
                pl.compact(0, floor, floor)
        finally:
            stop.set()
            th.join(timeout=10)
        assert not errors, errors[0]


class TestNativeWAL:
    """The C++ write path (native/wal.cc) must be byte-identical to the
    Python writer and fully interoperable with Python replay."""

    @pytest.fixture()
    def lib(self):
        from raftsql_tpu_torch.native.build import load_native_wal
        lib = load_native_wal()
        assert lib is not None      # a failed build raises instead
        return lib

    @staticmethod
    def _write_all(w: WAL) -> None:
        w.append_entry(0, 1, 1, b"CREATE TABLE t")
        w.append_entry(0, 2, 1, b"")
        w.append_entry(7, 1, 3, b"x" * 1000)
        w.set_hardstate(0, 1, -1, 2)
        w.set_hardstate(7, 3, 2, 1)
        w.append_entries([1, 1], [1, 2], [2, 2], [b"batch-a", b"batch-b"])
        w.sync()
        w.close()

    def test_byte_identical_to_python(self, lib, tmp_path):
        dn, dp = str(tmp_path / "n"), str(tmp_path / "p")
        wn, wp = WAL(dn, native=True), WAL(dp, native=False)
        assert wn.is_native and not wp.is_native
        self._write_all(wn)
        self._write_all(wp)
        with open(wn.path, "rb") as f:
            n_bytes = f.read()
        with open(wp.path, "rb") as f:
            p_bytes = f.read()
        assert n_bytes == p_bytes
        assert len(n_bytes) > 0

    def test_native_write_python_replay(self, lib, tmp_path):
        d = str(tmp_path / "w")
        w = WAL(d, native=True)
        self._write_all(w)
        groups = WAL.replay(d)
        assert groups[0].entries == [(1, b"CREATE TABLE t"), (1, b"")]
        assert groups[0].hard.vote == -1
        assert groups[7].entries == [(3, b"x" * 1000)]
        assert groups[7].hard.vote == 2
        assert groups[1].entries == [(2, b"batch-a"), (2, b"batch-b")]

    def test_reopen_across_backends(self, lib, tmp_path):
        d = str(tmp_path / "w")
        w = WAL(d, native=True)
        w.append_entry(0, 1, 1, b"one")
        w.sync()
        w.close()
        w2 = WAL(d, native=False)
        w2.append_entry(0, 2, 1, b"two")
        w2.close()
        groups = WAL.replay(d)
        assert [e[1] for e in groups[0].entries] == [b"one", b"two"]


class TestBatchedHardstates:
    def test_batched_hardstates_replay(self, native, tmp_path):
        """set_hardstates (one native call per tick) must replay exactly
        like per-group set_hardstate, including NO_VOTE (-1) votes."""
        import numpy as np
        d = str(tmp_path / "hsb")
        w = WAL(d, native=native)
        w.append_entry(0, 1, 1, b"a")
        w.append_entry(2, 1, 1, b"b")
        w.set_hardstates(np.asarray([0, 2, 5]),
                         np.asarray([3, 4, 9]),
                         np.asarray([-1, 1, 0]),
                         np.asarray([1, 1, 0]))
        w.sync()
        w.close()
        groups = WAL.replay(d)
        h0, h2, h5 = groups[0].hard, groups[2].hard, groups[5].hard
        assert (h0.term, h0.vote, h0.commit) == (3, -1, 1)
        assert (h2.term, h2.vote, h2.commit) == (4, 1, 1)
        assert (h5.term, h5.vote, h5.commit) == (9, 0, 0)

    def test_batched_hardstates_python_fallback(self, tmp_path):
        import numpy as np
        d = str(tmp_path / "hsf")
        w = WAL(d, native=False)
        assert w._lib is None
        w.set_hardstates(np.asarray([1]), np.asarray([7]),
                         np.asarray([-1]), np.asarray([5]))
        w.sync()
        w.close()
        h = WAL.replay(d)[1].hard
        assert (h.term, h.vote, h.commit) == (7, -1, 5)


class TestRangeRecords:
    """Type-5 RANGE records: one framed record per same-term entry run
    (the fused tick's batched WAL form).  Replay must expand a RANGE to
    exactly the entry sequence its per-entry form would produce."""

    def test_roundtrip_equivalent_to_entries(self, tmp_path):
        dr, de = str(tmp_path / "r"), str(tmp_path / "e")
        wr, we = WAL(dr, native=False), WAL(de, native=False)
        datas = [b"a", b"", b"ccc", b"dd", b"e"]
        wr.append_ranges([0, 0, 3], [1, 4, 1], [3, 2, 0], [1, 1, 2],
                         datas)
        for i, d in enumerate(datas):
            we.append_entry(0, i + 1, 1, d)
        wr.close()
        we.close()
        gr, ge = WAL.replay(dr), WAL.replay(de)
        assert gr[0].entries == ge[0].entries
        assert 3 not in gr          # zero-count range writes nothing
        # ...including its segment stats: a phantom (group, start-1)
        # max-index entry would block compaction of the segment for a
        # group that may never earn a durable floor.
        assert 3 not in wr._active_stats.max_idx
        # And the range file is smaller: one header per run, not entry.
        assert os.path.getsize(wr.path) < os.path.getsize(we.path)

    def test_native_byte_identical(self, tmp_path):
        from raftsql_tpu_torch.native.build import load_native_wal
        assert load_native_wal() is not None
        dn, dp = str(tmp_path / "n"), str(tmp_path / "p")
        wn, wp = WAL(dn, native=True), WAL(dp, native=False)
        for w in (wn, wp):
            w.append_ranges([2, 5], [1, 11], [2, 3], [4, 9],
                            [b"x", b"yy", b"", b"zzz", b"w" * 300])
            w.sync()
            w.close()
        with open(wn.path, "rb") as f:
            nb = f.read()
        with open(wp.path, "rb") as f:
            pb = f.read()
        assert nb == pb and len(nb) > 0
        g = WAL.replay(dn)
        assert g[2].entries == [(4, b"x"), (4, b"yy")]
        assert g[5].entries == [(9, b""), (9, b"zzz"), (9, b"w" * 300)]

    def test_range_conflict_truncates(self, tmp_path):
        d = str(tmp_path / "w")
        w = WAL(d, native=False)
        w.append_ranges([0], [1], [4], [1], [b"a", b"b", b"c", b"d"])
        # New-term range overwriting 3.. truncates the old suffix.
        w.append_ranges([0], [3], [2], [2], [b"c2", b"d2"])
        w.close()
        gl = WAL.replay(d)[0]
        assert gl.entries == [(1, b"a"), (1, b"b"), (2, b"c2"), (2, b"d2")]

    def test_range_torn_tail(self, tmp_path):
        d = str(tmp_path / "w")
        w = WAL(d, native=False)
        w.append_ranges([0], [1], [2], [1], [b"good1", b"good2"])
        w.sync()
        w.append_ranges([0], [3], [2], [1], [b"lost1", b"lost2"])
        w.close()
        with open(w.path, "r+b") as f:
            f.truncate(os.path.getsize(w.path) - 3)   # tear mid-record
        gl = WAL.replay(d)[0]
        assert gl.entries == [(1, b"good1"), (1, b"good2")]

    def test_range_segment_stats_gate_compaction(self, tmp_path):
        """_stats_for must see RANGE max indexes: a closed segment whose
        ranges are NOT covered by the floor must survive compact()."""
        d = str(tmp_path / "w")
        w = WAL(d, native=False, segment_bytes=64)
        w.append_ranges([0], [1], [4], [1], [b"a" * 30] * 4)
        w.sync()                       # exceeds 64 bytes -> rotates
        w.append_ranges([0], [5], [2], [1], [b"b" * 30] * 2)
        w.sync()
        assert len(sorted((tmp_path / "w").glob("wal-*.log"))) >= 2
        # Drop the stats cache so compact() re-scans the closed segment
        # from bytes (the _stats_for parse under test).
        w._closed_stats.clear()
        # Floor at 2 does not cover the first segment's range 1-4.
        removed = w.compact({0: (2, 1)}, {0: (1, -1, 0)})
        assert removed == 0
        # Floor at 6 covers both closed ranges.
        removed = w.compact({0: (6, 1)}, {0: (1, -1, 0)})
        assert removed >= 1
        w.close()
        gl = WAL.replay(d)[0]
        assert gl.start == 6 and gl.log_len == 6 and gl.entries == []


# ---- the native storage plane against the JAX package's ------------------

PKGS = {"port": (twal, tlog, tbuild.load_native_plog),
        "jax": (jwal, jlog, j_load_plog)}
# Every (package, native) pair that writes a log: the port's native and
# Python backends and the JAX package's.
SIDES = [("port", True), ("port", False), ("jax", True), ("jax", False)]


def _side_id(side):
    return f"{side[0]}-{'native' if side[1] else 'python'}"


def _open(side, d, **kw):
    pkg, native = side
    w = PKGS[pkg][0].WAL(d, native=native, **kw)
    assert w.is_native == native
    return w


def _plog(side, G):
    """The payload log a writer pairs with: the native one beside a
    native WAL (the host plane's RAFTSQL_FUSED_NATIVE_PLOG layout)."""
    pkg, native = side
    _, logmod, load = PKGS[pkg]
    return logmod.NativePayloadLog(G, load()) if native \
        else logmod.PayloadLog(G)


def _dir_bytes(d):
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            out[f] = fh.read()
    return out


def _plog_rows(plog, G):
    """Every group's (start, terms, payloads) of a payload log."""
    rows = []
    for g in range(G):
        s, n = plog.start(g), plog.length(g)
        rows.append((s,) + tuple(plog.slice_columns(g, s + 1, n - s)))
    return rows


def _put_uniform(w, plog, groups, starts, counts, terms, datas):
    """The host plane's phase 2a: one combined native call, or the
    Python form (RANGE records, then the payload-log ranges)."""
    blob = b"".join(datas)
    lens = np.fromiter(map(len, datas), np.uint32, len(datas))
    if w.append_ranges_uniform(plog, groups, starts, counts, terms, blob,
                               lens):
        return
    w.append_ranges(groups, starts, counts, terms, datas)
    pos, puts = 0, []
    for g, s, c, t in zip(groups, starts, counts, terms):
        if c:
            puts.append((g, s, datas[pos: pos + c], [t] * c, None))
        pos += c
    plog.put_ranges(puts)


def _w_entry(w, plog):
    w.append_entry(0, 1, 1, b"CREATE TABLE t")
    w.append_entry(0, 2, 1, b"")
    w.append_entry(9, 1, 3, b"x" * 700)


def _w_entries(w, plog):
    w.append_entries([1, 1, 4, 1], [1, 2, 1, 3], [2, 2, 5, 2],
                     [b"a", b"", b"ccc", b"d"])


def _w_ranges(w, plog):
    w.append_ranges([2, 5, 5], [1, 11, 14], [2, 3, 1], [4, 9, 10],
                    [b"x", b"yy", b"", b"zzz", b"w" * 300, b"q"])


def _w_ranges_uniform(w, plog):
    _put_uniform(w, plog, [0, 3, 6, 0], [1, 5, 1, 3], [2, 0, 3, 1],
                 [1, 2, 2, 4], [b"u1", b"u2", b"v1", b"", b"v3", b"u3"])


def _w_hardstate(w, plog):
    w.set_hardstate(0, 1, -1, 2)
    w.set_hardstate(7, 3, 2, 1)


def _w_hardstates(w, plog):
    w.set_hardstates(np.asarray([0, 2, 5]), np.asarray([3, 4, 9]),
                     np.asarray([-1, 1, 0]), np.asarray([1, 1, 0]))


def _w_snapshot(w, plog):
    w.append_entry(1, 1, 1, b"x1")
    w.set_snapshot(1, 7, 3)


def _w_compact(w, plog):
    w.append_entries([0] * 4, [1, 2, 3, 4], [1] * 4, [b"a", b"b", b"c",
                                                      b"d"])
    w.mark_compact(0, 2, 1)


def _w_epoch(w, plog):
    w.epoch_mark(5, end=False)
    w.append_entry(0, 1, 1, b"in-epoch")
    w.epoch_mark(5, end=True)


WRITERS = {"append_entry": _w_entry, "append_entries": _w_entries,
           "append_ranges": _w_ranges,
           "append_ranges_uniform": _w_ranges_uniform,
           "set_hardstate": _w_hardstate, "set_hardstates": _w_hardstates,
           "set_snapshot": _w_snapshot, "mark_compact": _w_compact,
           "epoch_mark": _w_epoch}


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_every_writer_byte_identical_across_packages_and_backends(
        tmp_path, writer):
    """Each writer on the port's native and Python backends and the JAX
    package's: the same bytes, the same byte count in `_bytes` (which
    decides rotation), the same segment stats (which decide compaction)
    and, for the combined call, the same payload logs."""
    files, stats, plogs = {}, {}, {}
    for side in SIDES:
        d = str(tmp_path / _side_id(side))
        w = _open(side, d)
        plog = _plog(side, 10)
        WRITERS[writer](w, plog)
        w.sync()
        assert w._bytes == os.path.getsize(w.path), side
        stats[side] = (dict(w._active_stats.max_idx),
                       set(w._active_stats.hs))
        plogs[side] = _plog_rows(plog, 10)
        w.close()
        files[side] = _dir_bytes(d)
    want = files[("jax", True)]
    assert want and all(want.values())
    for side in SIDES:
        assert files[side] == want, side
        assert stats[side] == stats[("jax", True)], side
        assert plogs[side] == plogs[("jax", True)], side


def _gc_script(side, d, G=4):
    """Leader appends through group-commit views (peer p's records carry
    the bias p * G) and the followers' mirrors, as the host plane writes
    them; returns the shared log's bytes, every payload log and the
    base WAL's byte count."""
    pkg, native = side
    wmod = PKGS[pkg][0]
    gc = wmod.GroupCommitWAL(d, 3, G)
    views = [gc.view(p) for p in range(3)]
    assert all((v._lib is not None) == native for v in views)
    plogs = [_plog(side, G) for _ in range(3)]
    lead = {0: 0, 1: 0, 2: 1, 3: 2}
    # Phase 2a: peer 0 leads groups 0-1 (group 0 across a term change),
    # peer 1 group 2, peer 2 group 3.
    _put_uniform(views[0], plogs[0], [0, 0, 1], [1, 4, 1], [3, 2, 1],
                 [1, 2, 2], [b"a1", b"a2", b"", b"a4", b"a5", b"b1"])
    _put_uniform(views[1], plogs[1], [2], [1], [2], [3], [b"c1", b"c2"])
    _put_uniform(views[2], plogs[2], [3], [1], [4], [1],
                 [b"d1", b"d2", b"d3", b"d4" * 50])
    # A stale suffix on peer 1's copy of group 3, cut by new_len below.
    plogs[1].put(3, 1, [b"x1", b"x2", b"x3", b"x4", b"x5"], [1] * 5)
    # Phase 2b: every follower mirrors every group from its leader,
    # ordered by destination peer (the Python form writes peer by peer).
    mirrors = []
    for p in range(3):
        for g in range(G):
            if lead[g] != p:
                n = plogs[lead[g]].length(g)
                mirrors.append((p, lead[g], g, 1, n, n))
    cols = list(zip(*mirrors))
    if not wmod.wal_mirror_all(views, plogs, *cols):
        reads = [plogs[s].slice_columns(g, st, c)
                 for (_, s, g, st, c, _) in mirrors]
        for (p, _, g, st, c, nl), (terms, datas) in zip(mirrors, reads):
            plogs[p].put_ranges([(g, st, datas, terms, nl)])
            runs = wmod.split_uniform_runs(st, terms)
            views[p].append_ranges([g] * len(runs), [r[0] for r in runs],
                                   [r[1] for r in runs],
                                   [r[2] for r in runs], datas)
    for p, v in enumerate(views):
        v.set_hardstates(np.arange(G), np.full(G, 3), np.full(G, lead[0]),
                         np.full(G, 2))
        v.sync()
    nbytes = gc.base._bytes
    for v in views:
        v.close()
    return (_dir_bytes(d), [_plog_rows(pl, G) for pl in plogs], nbytes)


def test_uniform_and_mirror_on_group_commit_views(tmp_path, monkeypatch):
    """append_ranges_uniform and wal_mirror_all through group-commit
    views with nonzero group_bias: the port's native plane writes the
    JAX package's bytes and payload logs, and both equal the Python form
    of the same tick (the host plane's fallback)."""
    got = {}
    for side in SIDES:
        with monkeypatch.context() as m:
            if not side[1]:
                m.setenv("RAFTSQL_TPU_NATIVE", "0")
            got[side] = _gc_script(side, str(tmp_path / _side_id(side)))
    files, plogs, nbytes = got[("jax", True)]
    assert files and plogs[1][3][1] == [1, 1, 1, 1]   # stale suffix cut
    assert nbytes == sum(map(len, files.values()))
    for side in SIDES:
        assert got[side] == got[("jax", True)], side
    # The shared log replays into each peer's groups through the bias.
    flat = jwal.WAL.replay(str(tmp_path / "port-native"))
    assert sorted(flat) == list(range(12))
    assert [e[1] for e in flat[2 * 4 + 0].entries] == \
        [b"a1", b"a2", b"", b"a4", b"a5"]


def _rotating_script(side, d):
    w = _open(side, d, segment_bytes=96)
    plog = _plog(side, 3)
    for i in range(1, 25):
        _put_uniform(w, plog, [2], [i], [1], [1], [b"u%d" % i])
        w.append_ranges([0], [i], [1], [1], [b"r%d" % i])
        w.append_entry(1, i, 1, b"e")
        w.set_hardstates(np.asarray([0, 1]), np.asarray([1, 1]),
                         np.asarray([-1, -1]), np.asarray([i, 0]))
        w.sync()
        assert w._bytes == os.path.getsize(w.path)
    before = sorted(os.listdir(d))
    removed = w.compact({0: (20, 1), 1: (20, 1), 2: (20, 1)},
                        {0: (1, -1, 24), 1: (1, -1, 0)})
    w.append_entry(1, 25, 1, b"after")
    w.sync()
    w.close()
    return before, removed, _dir_bytes(d)


def test_rotation_and_compaction_identical_at_tiny_segments(tmp_path):
    """At a 96-byte segment size every sync rotates: the native
    backends' byte bookkeeping (from returned counts, not from _write)
    must roll the same segments as the Python writers, and compaction
    must unlink the same ones."""
    got = {side: _rotating_script(side, str(tmp_path / _side_id(side)))
           for side in SIDES}
    before, removed, files = got[("jax", True)]
    assert len(before) >= 20 and removed > 0
    assert len(files) < len(before)
    for side in SIDES:
        assert got[side] == got[("jax", True)], side


def test_port_native_files_replay_through_jax_reader(tmp_path):
    """Every writer's records from the port's native backend replay
    through the JAX package's reader exactly as through the port's."""
    d = str(tmp_path / "w")
    w = _open(("port", True), d)
    plog = _plog(("port", True), 10)
    for name in sorted(WRITERS):
        WRITERS[name](w, plog)
        w.sync()
    w.close()
    port, jax = twal.WAL.replay(d), jwal.WAL.replay(d)
    assert sorted(port) == sorted(jax) and len(port) >= 8
    for g in port:
        assert repr(port[g]) == repr(jax[g]), g
    assert jax[6].entries == [(2, b"v1"), (2, b""), (2, b"v3")]
    assert jax[1].start == 7 and jax[0].hard.commit == 1


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_conf_and_dedup_writers_absent_under_native(tmp_path, pkg):
    """The native backends have no REC_CONF or REC_DEDUP writer: set_conf
    and set_dedup return False and write nothing (the JAX package's
    documented gap, mirrored); the Python backends write them."""
    for native in (True, False):
        d = str(tmp_path / f"{pkg}-{native}")
        w = _open((pkg, native), d)
        assert w.set_conf(0, 5, 0, 0b111, 0b111, 0) is (not native)
        assert w.set_dedup(0, 2, [(1, 42)]) is (not native)
        w.sync()
        w.close()
        gl = PKGS[pkg][0].WAL.replay(d).get(0)
        if native:
            assert gl is None
        else:
            assert gl.conf is not None and gl.dedup == (2, [(1, 42)])


def test_failed_build_raises_and_never_falls_back(tmp_path, monkeypatch):
    """A source that does not compile: the default WAL (native outside a
    fault injector) and the payload-log loader raise with g++'s error;
    the Python writer runs only when asked for."""
    broken = tmp_path / "wal.cc"
    with open(tbuild.SOURCE) as f:
        broken.write_text(f.read() + "\nthis is not C++;\n")
    monkeypatch.setattr(tbuild, "SOURCE", str(broken))
    monkeypatch.setattr(tbuild, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match=r"g\+\+ failed[\s\S]*error"):
        WAL(str(tmp_path / "default"))
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        tbuild.load_native_plog()
    assert not [f for f in os.listdir(tmp_path / "build")
                if f.endswith(".so")]
    w = WAL(str(tmp_path / "python"), native=False)
    assert not w.is_native
    w.close()
    monkeypatch.setenv("RAFTSQL_TPU_NATIVE", "0")
    w = WAL(str(tmp_path / "switched-off"))
    assert not w.is_native
    w.close()
    with pytest.raises(RuntimeError, match="RAFTSQL_TPU_NATIVE=0"):
        WAL(str(tmp_path / "asked"), native=True)


def test_concurrent_builds_publish_one_whole_library(tmp_path):
    """Builds racing into one empty directory (test workers, Procfile
    children) each get the same whole library: g++ writes a temporary
    file that is renamed into place."""
    import ctypes
    import threading
    out, errs = [], []

    def one():
        try:
            out.append(tbuild.build(tbuild.SOURCE, str(tmp_path)))
        except Exception as e:          # pragma: no cover - failure
            errs.append(e)

    ths = [threading.Thread(target=one) for _ in range(3)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=300)
    assert not errs and len(out) == 3 and len(set(out)) == 1
    assert os.path.basename(out[0]).startswith("libwal_")
    assert os.listdir(tmp_path) == [os.path.basename(out[0])]
    assert ctypes.CDLL(out[0]).wal_open


def test_native_payload_log_every_method_equals_jax(tmp_path):
    """NativePayloadLog, method by method, against the JAX package's on
    the same operations, and against the port's Python PayloadLog where
    that class has the method."""
    logs = {"port": tlog.NativePayloadLog(3, tbuild.load_native_plog()),
            "jax": jlog.NativePayloadLog(3, j_load_plog())}
    py = tlog.PayloadLog(3)
    assert logs["port"].handle and logs["jax"].handle

    def run(pl):
        out = []
        pl.put(0, 1, [b"a", b"bb", b"", b"dddd"], [1, 1, 2, 2])
        pl.put_ranges([(1, 1, [b"x", b"y"], [3, 3], None),
                       (0, 3, [b"C", b"D", b"E"], [4, 4, 4], 5)])
        pl.set_start(2, 10, 6)
        pl.put(2, 11, [b"z"], [6])
        out.append([(pl.length(g), pl.start(g)) for g in range(3)])
        out.append([pl.term_of(0, i) for i in range(0, 6)])
        out.append([pl.try_term_of(0, i) for i in (0, 5, 6, 99)])
        out.append(pl.slice(0, 2, 3))
        out.append(pl.try_slice(0, 1, 5))
        out.append(pl.slice_columns(0, 1, 5))
        pl.compact(0, 2, 1)
        out.append((pl.start(0), pl.term_of(0, 2), pl.try_term_of(0, 1)))
        out.append(pl.try_slice(0, 1, 2))
        out.append(pl.slice(0, 3, 3))
        if hasattr(pl, "read_groups"):
            out.append(pl.read_groups([0, 1, 2], [3, 1, 11], [3, 2, 1]))
        return out

    got = {k: run(pl) for k, pl in logs.items()}
    assert got["port"] == got["jax"]
    assert got["port"][-1] == [[b"C", b"D", b"E"], [b"x", b"y"], [b"z"]]
    assert run(py) == got["port"][:-1]
    for pl in logs.values():
        with pytest.raises(RuntimeError):
            pl.slice(0, 1, 2)               # below the compaction floor
        with pytest.raises(RuntimeError):
            pl.read_groups([0], [1], [2])
        with pytest.raises(ValueError):
            pl.put(1, 9, [b"gap"], [3])     # past the tail
        pl.close()
        assert pl.handle is None


def test_native_sync_recounts_the_bytes_that_decide_rotation(tmp_path):
    """The native backend's running byte count is corrected from the file
    at each sync: a count that lost updates (the group-commit log's
    parallel workers add to it without a lock) still rotates the segment
    where the bytes on disk say, and compaction sees whole segments."""
    d = str(tmp_path / "w")
    w = _open(("port", True), d, segment_bytes=100)
    w.append_ranges([0], [1], [3], [1], [b"x" * 40] * 3)
    w._bytes = 0                       # as if every update had been lost
    w.sync()
    assert sorted(os.listdir(d)) == ["wal-0.log", "wal-1.log"]
    assert w._bytes == 0 and w.path.endswith("wal-1.log")
    w.append_entry(0, 4, 1, b"y")
    w.sync()
    assert w._bytes == os.path.getsize(w.path)
    w.close()
    assert [e[1] for e in twal.WAL.replay(d)[0].entries] == \
        [b"x" * 40] * 3 + [b"y"]
