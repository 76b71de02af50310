"""Durable write-ahead log, multi-group, host-side, segmented.

Replaces the reference's vendored `etcd/wal` (reference raft.go:33-34,
99-134): an append-only record log that persists raft entries and hard
state *before* peer messages are sent or commits published (the durability
ordering invariant, reference raft.go:227-235), and is fully replayed on
restart (reference raft.go:122-134).

Differences from etcd/wal, by design:
  - One WAL serves ALL raft groups of a node; records carry a group id, so
    a single fsync batches the tick's appends across every group — the
    group-commit analog of batching consensus math on device.
  - Records are fixed-layout little-endian structs (struct-of-arrays
    friendly, shared with the C++ fast path in native/wal.cc, built and
    loaded by native/build.py).

Segmentation (the same shape as etcd/wal's segment directory, which the
reference opens at raft.go:99-117): the log is a directory of bounded
files `wal-<seq>.log`; appends go to the highest sequence ("active")
segment, a segment that exceeds `segment_bytes` is closed at the next
sync boundary and a fresh one opened.  Compaction never rewrites live
data: it appends per-group COMPACT floor markers to the active segment,
then unlinks whole closed segments whose every record is superseded —
O(appended markers + unlink), not O(log).  Replay concatenates segments
in sequence order, so the byte format within each segment is exactly the
single-file format (the C++ fast path is unchanged per segment).

Record layout:  u32 crc32(body) | u32 body_len | body
  body := u8 type | fields
  type 1 ENTRY:     u32 group | u64 index | u64 term | bytes data
  type 2 HARDSTATE: u32 group | u64 term | i64 vote | u64 commit
  type 3 SNAPSHOT:  u32 group | u64 index | u64 term
  type 4 COMPACT:   u32 group | u64 index | u64 term
  type 5 RANGE:     u32 group | u64 start | u64 term | u32 count
                    | u32 lens[count] | bytes payloads (concatenated)

RANGE is the batched form the fused tick writes: one record per
(group, start, term) run of consecutive same-term entries at
start .. start+count-1, with the 8-byte frame + 21-byte entry header
amortized across the run (per-entry framing tripled the durable tick's
fsync bytes at G=10k).  Replay expands a RANGE to exactly the entry
sequence its per-entry form would have produced.

Replay semantics match raft's log-matching property: a later ENTRY record
at an index <= the current length with the SAME term is an idempotent
overwrite (a re-accepted duplicate append — same index+term implies same
entry), while a DIFFERENT term is a genuine conflict and truncates the
suffix from that index before appending (core/step.py Phase 4).  Truncating
on same-term overlap would silently drop durably-acked suffix entries when
a stale duplicate append covering only a prefix is re-accepted.  The last
HARDSTATE per group wins.  SNAPSHOT (an InstallSnapshot boundary) drops
the covered prefix AND the retained suffix — the installed state's
history may conflict with it; COMPACT (a local compaction floor) drops
only the covered prefix.  A torn record (bad CRC / short read) drops
everything from that point on — only the active segment's tail can
legitimately be torn.
"""
from __future__ import annotations

import os
import re
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

_HDR = struct.Struct("<II")          # crc, body_len
_ENTRY = struct.Struct("<BIQQ")      # type, group, index, term
_HARD = struct.Struct("<BIQqQ")      # type, group, term, vote, commit
_SNAP = struct.Struct("<BIQQ")       # type, group, index, term (also COMPACT)
_RANGE = struct.Struct("<BIQQI")     # type, group, start, term, count
_EPOCH = struct.Struct("<BBQ")       # type, kind (0 BEGIN / 1 END), no
_CONFREC = struct.Struct("<BIQBQQQ")  # type, group, index, kind,
#                                       voters, joint, learners (u64
#                                       slot bitmasks — membership/)
_DEDUPHDR = struct.Struct("<BIQI")   # type, group, floor_index, count
_DEDUPPAIR = struct.Struct("<QQ")    # applied index, proposal id

REC_ENTRY = 1
REC_HARDSTATE = 2
REC_SNAPSHOT = 3        # install boundary: entries <= index AND the
#                         retained suffix dropped (conflicting history)
REC_COMPACT = 4         # compaction floor: entries <= index dropped,
#                         retained suffix kept
REC_RANGE = 5           # batched same-term entry run (see module doc)
REC_EPOCH = 6           # multi-step dispatch frame marker (see
                        # runtime/fused.py steps_per_dispatch): kind 0 =
                        # BEGIN, 1 = END, + the dispatch's epoch number.
                        # Replay ignores these; repair_epochs() uses
                        # BEGIN markers to atomically drop an
                        # uncommitted dispatch after a crash.
REC_CONF = 7            # applied membership configuration baseline
                        # (raftsql_tpu/membership/): written when a
                        # committed conf-change entry APPLIES, carrying
                        # the entry's log index + the full config
                        # (kind, voter/joint/learner u64 bitmasks).
                        # Replay keeps the last one per group; restart
                        # recovery seeds the active config from it and
                        # re-applies any conf ENTRIES committed above
                        # it — so the active config survives even after
                        # compaction unlinks the entries that built it.
REC_DEDUP = 8           # forward-retry dedup baseline (set_dedup): the
                        # group's (applied_index, proposal_id) window
                        # pairs at or below a compaction/install floor.
                        # The dedup decision is a pure function of the
                        # committed log PREFIX (runtime/envelope.py) —
                        # compaction drops that prefix, so without this
                        # record a restarted node replays only the
                        # retained suffix and re-applies a forward-retry
                        # duplicate whose first copy fell below the
                        # floor while live peers scrub it (divergence).
                        # Replay keeps the highest-floor record per
                        # group; boot restores it into the DedupWindow
                        # BEFORE publishing the retained suffix.

_SEG_RE = re.compile(r"^wal-(\d+)\.log$")
# Single source of truth for the default lives in config (the CLI and
# RaftConfig share it).
from raftsql_tpu_torch.config import \
    WAL_SEGMENT_BYTES_DEFAULT as DEFAULT_SEGMENT_BYTES  # noqa: E402
from raftsql_tpu_torch.storage import fsio  # noqa: E402


def _segment_paths(dirname: str) -> List[Tuple[int, str]]:
    """[(seq, abspath)] of existing segments, sequence order."""
    out = []
    try:
        names = os.listdir(dirname)
    except FileNotFoundError:
        return []
    for n in names:
        m = _SEG_RE.match(n)
        if m:
            out.append((int(m.group(1)), os.path.join(dirname, n)))
    out.sort()
    return out


def _fsync_dir(dirname: str) -> None:
    fsio.fsync_dir(dirname)


@dataclass
class HardState:
    term: int = 0
    vote: int = -1
    commit: int = 0


@dataclass
class GroupLog:
    """Replayed per-group state: entries (start+1 ... start+len, 1-based)
    plus last hard state.  `start` > 0 after WAL compaction — the prefix
    up to `start` is covered by the state-machine snapshot; `start_term`
    is the boundary entry's term."""
    hard: HardState = field(default_factory=HardState)
    entries: List[Tuple[int, bytes]] = field(default_factory=list)  # (term, data)
    start: int = 0
    start_term: int = 0
    # Last applied-membership baseline (REC_CONF), or None:
    # (entry_index, kind, voters_mask, joint_mask, learners_mask).
    conf: Optional[Tuple[int, int, int, int, int]] = None
    # Highest-floor dedup baseline (REC_DEDUP), or None:
    # (floor_index, [(applied_index, proposal_id), ...] FIFO order).
    dedup: Optional[Tuple[int, List[Tuple[int, int]]]] = None

    @property
    def log_len(self) -> int:
        return self.start + len(self.entries)


@dataclass
class _SegStats:
    """What a closed segment contains, for deletability decisions:
    per-group max index referenced by ENTRY/SNAPSHOT/COMPACT records, and
    the set of groups with HARDSTATE records."""
    max_idx: Dict[int, int] = field(default_factory=dict)
    hs: Set[int] = field(default_factory=set)

    def bump(self, group: int, index: int) -> None:
        if index > self.max_idx.get(group, -1):
            self.max_idx[group] = index

    def groups(self) -> Set[int]:
        return set(self.max_idx) | self.hs


def split_uniform_runs(start: int, terms) -> List[Tuple[int, int, int]]:
    """(start, count, term) uniform-term runs covering positions
    start..start+len(terms)-1 — the shape RANGE records require.
    Mirrored batches cross terms only at elections, so the common case
    is ONE run; the boundary scan is vectorized, no per-entry Python."""
    import numpy as np
    n = len(terms)
    if n == 0:
        return []
    ta = np.asarray(terms)
    bnd = np.flatnonzero(np.diff(ta))
    if not bnd.size:
        return [(start, n, int(ta[0]))]
    edges = [0] + (bnd + 1).tolist() + [n]
    return [(start + a, b - a, int(ta[a]))
            for a, b in zip(edges[:-1], edges[1:])]


def wal_mirror_all(wals, plogs, peers, srcs, groups, starts, counts,
                   new_lens) -> bool:
    """Cluster-wide follower mirror in ONE native call
    (walplog_mirror_all): phase A stages every source range (the
    read-all-before-write-all contract that makes same-tick source
    truncation safe), phase B writes each destination peer's WAL ENTRY
    records + payload-log range + truncation.  Returns False when the
    native path is unavailable on any peer (caller falls back).

    Destination WALs may be group-commit views (GroupCommitWAL below):
    their `group_bias` flattens the record's group id into the shared
    multiplexed stream, applied on the WAL side only."""
    if not wals:
        return True
    lib = wals[0]._lib
    if lib is None or not hasattr(lib, "walplog_mirror_all"):
        return False
    if any(w._lib is None for w in wals) \
            or any(not hasattr(p, "handle") for p in plogs):
        return False
    import ctypes

    import numpy as np
    n = len(peers)
    if n == 0:
        return True
    P = len(wals)
    wh = (ctypes.c_void_p * P)(*[w._h for w in wals])
    ph = (ctypes.c_void_p * P)(*[p.handle for p in plogs])
    biases = np.asarray([getattr(w, "group_bias", 0) for w in wals],
                        np.uint32)
    pa = np.asarray(peers, np.uint32)
    sa = np.asarray(srcs, np.uint32)
    ga = np.asarray(groups, np.uint32)
    ia = np.asarray(starts, np.uint64)
    ca = np.asarray(counts, np.uint32)
    na = np.asarray(new_lens, np.int64)
    per_bytes = np.zeros(P, np.uint64)
    rc = lib.walplog_mirror_all(
        wh, ph, n,
        pa.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ga.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ia.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ca.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        na.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        per_bytes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        biases.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    if rc != 0:
        raise ValueError("walplog_mirror_all: source range unavailable")
    for i in range(n):
        c = int(ca[i])
        if c:
            w = wals[int(pa[i])]
            w._active_stats.bump(
                int(ga[i]) + int(biases[int(pa[i])]), int(ia[i]) + c - 1)
    for p in range(P):
        b = int(per_bytes[p])
        if b:
            wals[p]._pending = True
            wals[p]._bytes += b
    return True


def wal_exists(dirname: str) -> bool:
    return bool(_segment_paths(dirname))


class WAL:
    """Append-only segmented multi-group WAL with batched fsync.

    Usage per tick (the reference's Ready handling, raft.go:227-235):
        wal.append_entry(...); wal.set_hardstate(...)
        wal.sync()              # durable point — only now send/publish

    The write path is the C++ fast path (native/wal.cc — framing, CRC,
    buffered write, fdatasync behind one ctypes call) or the Python
    writer; both produce byte-identical files, and `replay` reads either.
    `native=None` takes the C++ path unless an fsio fault injector is
    active or RAFTSQL_TPU_NATIVE=0; True/False force.  A native path
    that was asked for and cannot be built, loaded or opened raises: it
    never falls back to Python (native/build.py).

    NOT thread-safe: callers serialize all writes, sync, and compact (the
    node holds its _wal_lock across every call).
    """

    def __init__(self, dirname: str, native: Optional[bool] = None,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES):
        os.makedirs(dirname, exist_ok=True)
        self.dirname = dirname
        self.segment_bytes = segment_bytes
        segs = _segment_paths(dirname)
        self._seq = segs[-1][0] if segs else 0
        self.path = os.path.join(dirname, f"wal-{self._seq}.log")
        self._native_pref = native
        self._lib = None
        self._h = None
        self._f = None
        self._pending = False
        self.last_sync_s = 0.0
        # Observability hook (raftsql_tpu/obs/spans.py SpanTracer, or
        # anything with note_event): wired by the owning runtime's
        # enable_tracing so every durable barrier lands on the host
        # trace timeline.  None (default) costs one attribute test.
        self.obs = None
        # A crash can tear the active segment's tail.  Appending AFTER
        # torn bytes would hide every later record from replay (it stops
        # at the first bad CRC) — durably-acked writes would vanish on the
        # next restart.  Truncate to the last whole record before opening
        # for append (etcd's repair path does the same).
        self._bytes = self._repair_tail(self.path)
        # Active-segment stats accumulate as we write; closed segments
        # written before this process are scanned lazily (compact()).
        self._active_stats = _SegStats()
        self._closed_stats: Dict[str, _SegStats] = {}
        self._marker_floor: Dict[int, int] = {}
        # Latest applied-membership baseline per group (set_conf),
        # re-asserted into the active segment when compaction unlinks
        # the segment that held it — same survival contract as hard
        # states.  Seeded by the owning runtime after replay (set_conf
        # is idempotent), not by this handle.
        self._conf_latest: Dict[int, Tuple[int, int, int, int, int]] = {}
        # Latest dedup baseline per group (set_dedup), kept as the
        # packed record body so compaction's re-assert is a plain
        # re-append — same survival contract as _conf_latest.
        self._dedup_latest: Dict[int, bytes] = {}
        self._open_active()

    @staticmethod
    def _repair_tail(path: str) -> int:
        """Truncate `path` to its longest valid record prefix; returns
        the resulting size (0 for a missing file)."""
        if not os.path.isfile(path):
            return 0
        with open(path, "rb") as f:
            blob = f.read()
        off = 0
        while off + _HDR.size <= len(blob):
            crc, blen = _HDR.unpack_from(blob, off)
            body = blob[off + _HDR.size: off + _HDR.size + blen]
            if len(body) != blen or zlib.crc32(body) != crc:
                break
            off += _HDR.size + blen
        if off < len(blob):
            with open(path, "r+b") as f:
                f.truncate(off)
                f.flush()
                os.fsync(f.fileno())
        return off

    def _open_active(self) -> None:
        # An active storage-fault injector (chaos scenarios) forces the
        # Python backend: the C++ fast path frames and fdatasyncs behind
        # one ctypes call, invisible to the fsio seam.  Both backends
        # write byte-identical files.
        if self._native_pref is not False and not fsio.active():
            from raftsql_tpu_torch.native.build import load_native_wal
            lib = load_native_wal()
            if lib is not None:
                h = lib.wal_open(self.path.encode())
                if not h:
                    raise OSError(f"native WAL: cannot open {self.path}")
                self._lib, self._h = lib, h
            elif self._native_pref is True:
                raise RuntimeError("native WAL requested but "
                                   "RAFTSQL_TPU_NATIVE=0")
        self._f = None if self._lib else open(self.path, "ab")

    @property
    def is_native(self) -> bool:
        return self._lib is not None

    # -- write path ------------------------------------------------------

    def _write(self, body: bytes) -> None:
        # One write per record (not header-then-body): the fsio seam
        # records it whole, so a simulated torn write tears a RECORD —
        # the shape a real power loss leaves.  A write failure (ENOSPC
        # through fsio.check_write) raises BEFORE any byte lands and
        # BEFORE _pending/_bytes advance, so the refused record leaves
        # the file tail at a clean record boundary and the in-memory
        # bookkeeping matched to it — the caller surfaces the error
        # (the runtimes treat it as fatal, like a failed fsync) and a
        # restart replays a consistent log.
        fsio.write(self._f, _HDR.pack(zlib.crc32(body), len(body)) + body)
        self._pending = True
        self._bytes += _HDR.size + len(body)

    def append_entry(self, group: int, index: int, term: int,
                     data: bytes) -> None:
        self._active_stats.bump(group, index)
        if self._lib is not None:
            self._lib.wal_append_entry(self._h, group, index, term,
                                       data, len(data))
            self._pending = True
            self._bytes += _HDR.size + _ENTRY.size + len(data)
            return
        self._write(_ENTRY.pack(REC_ENTRY, group, index, term) + data)

    def append_entries(self, groups, indexes, terms, datas) -> None:
        """Batched append — one native call for a whole tick's records.

        Callers (the tick's WAL phase) emit per-group ranges with
        ascending indexes, but the stats pass below does not rely on
        that — it computes each run's true max."""
        if self._lib is None:
            for g, i, t, d in zip(groups, indexes, terms, datas):
                self.append_entry(g, i, t, d)
            return
        import ctypes

        import numpy as np
        n = len(groups)
        if n == 0:
            return
        blob = b"".join(datas)
        # numpy list→array conversion marshals the parallel arrays ~5x
        # faster than ctypes (c_uint32 * n)(*list) star-unpacking.
        ga = np.asarray(groups, np.uint32)
        ia = np.asarray(indexes, np.uint64)
        ta = np.asarray(terms, np.uint64)
        # Segment stats (per-group max index) per contiguous RUN, not per
        # record: maximum.reduceat computes each run's true max whatever
        # the intra-run order (no reliance on the ascending-batch
        # contract), and bump()'s compare arbitrates across runs of the
        # same group.  The per-record dict pass this replaces was ~8% of
        # the WAL phase.
        ends = np.nonzero(np.diff(ga))[0]
        run_starts = np.concatenate(([0], ends + 1))
        run_max = np.maximum.reduceat(ia, run_starts)
        bump = self._active_stats.bump
        for s, m in zip(run_starts.tolist(), run_max.tolist()):
            bump(int(ga[s]), int(m))
        la = np.fromiter(map(len, datas), np.uint32, n)
        self._lib.wal_append_entries(
            self._h, n,
            ga.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ia.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ta.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            blob,
            la.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        self._pending = True
        self._bytes += n * (_HDR.size + _ENTRY.size) + len(blob)

    def append_ranges(self, groups, starts, counts, terms, datas) -> None:
        """Batched RANGE append: one type-5 record per (group, start,
        term, count) run of consecutive same-term entries.  `datas` is
        the flat per-entry payload list, ranges in order, `sum(counts)`
        entries total.  Equivalent on replay to appending each entry,
        at ~1/4 the framed bytes for small payloads (the durable tick's
        fsync is bandwidth-bound).
        """
        if any(c == 0 for c in counts):
            # Empty runs write nothing: a zero-count record would bump
            # segment stats at start-1 for a group that may have no
            # durable floor, permanently blocking segment deletion.
            keep = [i for i, c in enumerate(counts) if c]
            groups = [groups[i] for i in keep]
            starts = [starts[i] for i in keep]
            terms = [terms[i] for i in keep]
            counts = [c for c in counts if c]
        n = len(groups)
        if n == 0:
            return
        import numpy as np
        la = np.fromiter(map(len, datas), np.uint32, len(datas))
        bump = self._active_stats.bump
        for g, s, c in zip(groups, starts, counts):
            bump(int(g), int(s) + int(c) - 1)
        if self._lib is not None:
            import ctypes
            ga = np.asarray(groups, np.uint32)
            sa = np.asarray(starts, np.uint64)
            ta = np.asarray(terms, np.uint64)
            ca = np.asarray(counts, np.uint32)
            blob = b"".join(datas)
            self._lib.wal_append_ranges(
                self._h, n,
                ga.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                sa.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                ta.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                ca.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                blob,
                la.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
            self._pending = True
            self._bytes += (n * (_HDR.size + _RANGE.size)
                            + 4 * len(datas) + len(blob))
            return
        pos = 0
        lens = la.tobytes()      # little-endian u32, matches the format
        for g, s, c, t in zip(groups, starts, counts, terms):
            body = (_RANGE.pack(REC_RANGE, g, s, t, c)
                    + lens[4 * pos: 4 * (pos + c)]
                    + b"".join(datas[pos: pos + c]))
            pos += c
            self._write(body)

    def append_ranges_uniform(self, plog, groups, starts, counts, terms,
                              blob: bytes, lens,
                              group_bias: int = 0) -> bool:
        """Combined native write (walplog_put_uniform): for each range
        (group, start, count, term) write ONE WAL RANGE record AND the
        native payload-log range, all in one C call — zero per-entry
        Python.  `blob` concatenates every range's payload bytes in
        order; `lens` is per-entry.  Returns False when the native
        combined path is unavailable (caller falls back to
        append_entries + plog.put_ranges).  `group_bias` offsets the
        WAL records' group ids only (the group-commit multiplexed
        layout); the payload log is indexed by the raw group."""
        if self._lib is None or plog is None \
                or not hasattr(self._lib, "walplog_put_uniform"):
            return False
        import ctypes

        import numpy as np
        n_ranges = len(groups)
        if n_ranges == 0:
            return True
        ga = np.asarray(groups, np.uint32)
        sa = np.asarray(starts, np.uint64)
        ca = np.asarray(counts, np.uint32)
        ta = np.asarray(terms, np.uint64)
        la = np.asarray(lens, np.uint32)
        rc = self._lib.walplog_put_uniform(
            self._h, plog.handle, n_ranges,
            ga.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ca.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ta.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            blob,
            la.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            group_bias)
        if rc != 0:
            raise ValueError("walplog_put_uniform: payload gap")
        bump = self._active_stats.bump
        live = 0
        for g, s, c in zip(ga.tolist(), sa.tolist(), ca.tolist()):
            if c:             # native side skips empty runs entirely
                bump(g + group_bias, s + c - 1)
                live += 1
        self._pending = True
        # One RANGE record per non-empty run (native writes type-5 —
        # keep _bytes matched to the file so rotation fires where
        # segment_bytes intends).
        self._bytes += live * (_HDR.size + _RANGE.size) \
            + 4 * int(ca.sum()) + len(blob)
        return True

    def set_hardstate(self, group: int, term: int, vote: int,
                      commit: int) -> None:
        self._active_stats.hs.add(group)
        if self._lib is not None:
            self._lib.wal_set_hardstate(self._h, group, term, vote, commit)
            self._pending = True
            self._bytes += _HDR.size + _HARD.size
            return
        self._write(_HARD.pack(REC_HARDSTATE, group, term, vote, commit))

    def set_hardstates(self, groups, terms, votes, commits) -> None:
        """Batched hard-state records from parallel arrays — one native
        call for the whole tick (under saturation EVERY group's commit
        advances per tick, and a per-group ctypes round trip was ~40% of
        the durable WAL phase)."""
        n = len(groups)
        if n == 0:
            return
        if self._lib is None:
            for g, t, v, c in zip(groups, terms, votes, commits):
                self.set_hardstate(int(g), int(t), int(v), int(c))
            return
        import ctypes

        import numpy as np
        ga = np.ascontiguousarray(groups, np.uint32)
        self._active_stats.hs.update(ga.tolist())
        ta = np.ascontiguousarray(terms, np.uint64)
        va = np.ascontiguousarray(votes, np.int64)
        ca = np.ascontiguousarray(commits, np.uint64)
        self._lib.wal_set_hardstates(
            self._h, n,
            ga.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ta.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            va.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ca.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        self._pending = True
        self._bytes += n * (_HDR.size + _HARD.size)

    def set_snapshot(self, group: int, index: int, term: int) -> None:
        """InstallSnapshot boundary marker: on replay, entries of `group`
        at or below `index` AND the retained suffix are dropped — the
        installed state's history supersedes the whole local log."""
        self._active_stats.bump(group, index)
        if self._lib is not None:
            self._lib.wal_set_snapshot(self._h, group, index, term)
            self._pending = True
            self._bytes += _HDR.size + _SNAP.size
            return
        self._write(_SNAP.pack(REC_SNAPSHOT, group, index, term))

    def set_conf(self, group: int, index: int, kind: int, voters: int,
                 joint: int, learners: int) -> bool:
        """Applied-membership baseline record (REC_CONF): the conf
        entry at `index` has been APPLIED — replay's last-wins baseline
        seeds the active config even after compaction drops the entry.

        Durability ride-along: the record lands before the NEXT sync
        barrier; a crash before it replays the same conf from the still
        -committed log entry, so no extra fsync is needed here.  The
        native C fast path has no conf writer — returns False there
        (recovery then depends on the retained entries; the membership
        runtimes force the Python backend via their chaos/fsio posture,
        and document the native gap)."""
        if self._lib is not None:
            return False
        self._conf_latest[group] = (index, kind, voters, joint, learners)
        self._active_stats.hs.add(group)   # re-assert like a hard state
        self._write(_CONFREC.pack(REC_CONF, group, index, kind,
                                  voters, joint, learners))
        return True

    def set_dedup(self, group: int, floor: int,
                  pairs: List[Tuple[int, int]]) -> bool:
        """Dedup-window baseline record (REC_DEDUP): `pairs` is the
        group's forward-retry window at or below `floor` (the new
        compaction/install boundary), FIFO order.  Replay keeps the
        highest-floor record; node boot restores it into the in-memory
        window before publishing the retained suffix, so a restart
        scrubs the same forward-retry duplicates its live peers do.

        Durability ride-along like set_conf: the caller's compaction /
        install barrier syncs it.  The native C fast path has no dedup
        writer — returns False there (the chaos/fsio posture forces the
        Python backend wherever this invariant is exercised; native
        deployments keep the pre-record behavior and the documented
        gap)."""
        if self._lib is not None:
            return False
        body = b"".join(
            [_DEDUPHDR.pack(REC_DEDUP, group, floor, len(pairs))]
            + [_DEDUPPAIR.pack(i, p) for (i, p) in pairs])
        self._dedup_latest[group] = body
        self._active_stats.hs.add(group)   # re-assert like a hard state
        self._write(body)
        return True

    def epoch_mark(self, no: int, end: bool) -> None:
        """Multi-step dispatch frame marker (REC_EPOCH): BEGIN before
        the dispatch's first record, END after its last (including the
        hard states).  Replay ignores them; repair_epochs() drops a
        trailing dispatch whose epoch was never cluster-committed."""
        if self._lib is not None and hasattr(self._lib, "wal_epoch"):
            self._lib.wal_epoch(self._h, no, 1 if end else 0)
            self._pending = True
            self._bytes += _HDR.size + _EPOCH.size
            return
        self._write(_EPOCH.pack(REC_EPOCH, 1 if end else 0, no))

    @staticmethod
    def repair_epochs(dirname: str, committed: int) -> bool:
        """Atomically drop an UNCOMMITTED multi-step dispatch: truncate
        this WAL at the first EPOCH-BEGIN marker whose number exceeds
        `committed` (the cluster's epoch-commit fsync is the
        linearization point; see runtime/fused.py) and unlink any later
        segments.  Runs BEFORE replay/open.  Returns True if anything
        was dropped.

        Within one dispatch peers exchange messages that are not yet
        individually durable; the per-peer fsync barrier is not atomic,
        so a crash mid-barrier can leave peer A's WAL holding effects
        of a message peer B never persisted.  Dropping the whole
        uncommitted dispatch on EVERY peer restores the all-or-nothing
        view — nothing was published (publish follows the epoch-commit
        fsync), so no client observed it."""
        cut: Optional[Tuple[str, int]] = None
        paths = _segment_paths(dirname)
        for pi, (seq, path) in enumerate(paths):
            with open(path, "rb") as f:
                blob = f.read()
            off = 0
            while off + _HDR.size <= len(blob):
                crc, blen = _HDR.unpack_from(blob, off)
                body = blob[off + _HDR.size: off + _HDR.size + blen]
                if len(body) != blen or zlib.crc32(body) != crc:
                    break                    # torn — _repair_tail's job
                if body[0] == REC_EPOCH:
                    _, kind, no = _EPOCH.unpack_from(body)
                    if kind == 0 and no > committed:
                        cut = (pi, off)
                        break
                off += _HDR.size + blen
            if cut is not None:
                break
        if cut is None:
            return False
        pi, off = cut
        with open(paths[pi][1], "r+b") as f:
            f.truncate(off)
            f.flush()
            os.fsync(f.fileno())
        for _, path in paths[pi + 1:]:
            os.unlink(path)
        return True

    def _write_compact_rec(self, group: int, index: int, term: int) -> None:
        self._active_stats.bump(group, index)
        if self._lib is not None:
            self._lib.wal_set_compact(self._h, group, index, term)
            self._pending = True
            self._bytes += _HDR.size + _SNAP.size
            return
        self._write(_SNAP.pack(REC_COMPACT, group, index, term))

    def mark_compact(self, group: int, index: int, term: int) -> None:
        """Compaction floor marker: on replay, entries of `group` at or
        below `index` are dropped; the suffix survives.  Idempotent per
        floor (re-marking an already-marked floor is skipped)."""
        if index <= self._marker_floor.get(group, 0):
            return
        self._marker_floor[group] = index
        self._write_compact_rec(group, index, term)

    def sync(self) -> None:
        """Durable barrier.  May stall (slow disk — the fsio seam's
        stall rules model it): that is latency, never corruption — the
        caller's tick simply takes longer and every invariant must hold
        across it.  `last_sync_s` exposes the most recent barrier's
        wall time so a stalling disk is observable without a profiler."""
        if not self._pending:
            return
        import time as _t
        t0 = _t.monotonic()
        if self._lib is not None:
            if self._lib.wal_sync(self._h) != 0:
                raise OSError("native WAL sync failed")
            # The count that decides rotation, exact at the barrier: the
            # parallel workers of a group-commit log add to it from
            # several threads without a lock, and an update can be lost.
            self._bytes = os.path.getsize(self.path)
        else:
            fsio.fsync_file(self._f)
        self.last_sync_s = _t.monotonic() - t0
        if self.obs is not None:
            self.obs.note_event("wal.fsync", dur_s=self.last_sync_s,
                                dir=self.dirname)
        self._pending = False
        if self._bytes >= self.segment_bytes:
            self._rotate()

    def _rotate(self) -> None:
        """Close the active segment and start wal-<seq+1>.log.  Only ever
        called at a sync boundary, so every closed segment is a complete,
        durable record stream."""
        self._close_handle()
        self._closed_stats[self.path] = self._active_stats
        self._active_stats = _SegStats()
        self._seq += 1
        self.path = os.path.join(self.dirname, f"wal-{self._seq}.log")
        self._bytes = 0
        self._open_active()
        _fsync_dir(self.dirname)

    def _close_handle(self) -> None:
        if self._lib is not None:
            lib, self._lib = self._lib, None
            rc = lib.wal_close(self._h)
            self._h = None
            if rc != 0:
                raise OSError("native WAL close failed (unsynced records "
                              "may be lost)")
            return
        if self._f is not None:
            f, self._f = self._f, None
            fsio.fsync_file(f)
            f.close()

    def close(self) -> None:
        if self._lib is None and self._f is None:
            return
        self._close_handle()
        self._pending = False

    # -- compaction ------------------------------------------------------

    def _stats_for(self, path: str) -> _SegStats:
        """Stats of a closed (immutable) segment, scanned once."""
        st = self._closed_stats.get(path)
        if st is not None:
            return st
        st = _SegStats()
        with open(path, "rb") as f:
            blob = f.read()
        off = 0
        while off + _HDR.size <= len(blob):
            crc, blen = _HDR.unpack_from(blob, off)
            body = blob[off + _HDR.size: off + _HDR.size + blen]
            if len(body) != blen or zlib.crc32(body) != crc:
                break
            off += _HDR.size + blen
            rtype = body[0]
            if rtype == REC_ENTRY:
                _, group, index, _t = _ENTRY.unpack_from(body)
                st.bump(group, index)
            elif rtype == REC_RANGE:
                _, group, start, _t, count = _RANGE.unpack_from(body)
                st.bump(group, start + count - 1)
            elif rtype == REC_HARDSTATE:
                st.hs.add(_HARD.unpack_from(body)[1])
            elif rtype == REC_CONF:
                # Same survival contract as a hard state: the group's
                # baseline must be re-asserted before this segment may
                # be unlinked (compact()'s _conf_latest re-write).
                st.hs.add(_CONFREC.unpack_from(body)[1])
            elif rtype == REC_DEDUP:
                # Baseline survival contract, like REC_CONF above.
                st.hs.add(_DEDUPHDR.unpack_from(body)[1])
            elif rtype in (REC_SNAPSHOT, REC_COMPACT):
                _, group, index, _t = _SNAP.unpack_from(body)
                st.bump(group, index)
        self._closed_stats[path] = st
        return st

    def compact(self, floors: Dict[int, Tuple[int, int]],
                hard: Dict[int, Tuple[int, int, int]]) -> int:
        """Advance compaction floors and drop fully-superseded segments.

        floors: {group: (floor_index, floor_term)} — the durable
          snapshot-covered boundary per group (every group with a nonzero
          payload-log start, not just newly compacted ones).
        hard: {group: (term, vote, commit)} — current hard states, used
          to re-assert state for groups whose only hardstate records live
          in a segment being deleted.

        Appends COMPACT markers for advanced floors, then walks closed
        segments oldest-first and unlinks each whose every entry/marker
        is at or below its group's floor (hardstate-only groups are
        re-asserted into the active segment first).  Stops at the first
        non-deletable segment to keep the segment sequence contiguous.
        Never rewrites live data; cost is O(markers + unlinked files).

        Returns the number of deleted segments.
        """
        wrote = False
        for g, (idx, term) in sorted(floors.items()):
            if idx > self._marker_floor.get(g, 0):
                self.mark_compact(g, idx, term)
                wrote = True
        if wrote:
            self.sync()

        # Find the longest deletable prefix run first, then re-assert the
        # UNION of its groups once and fsync once — a long run of small
        # segments must not cost one fsync each (the caller holds the
        # node's WAL lock across this).
        run: List[str] = []
        affected: Set[int] = set()
        for seq, path in _segment_paths(self.dirname):
            if path == self.path:
                break                   # never delete the active segment
            st = self._stats_for(path)
            ok = all(
                g in floors and idx <= floors[g][0]
                for g, idx in st.max_idx.items()
            ) and all(g in hard for g in st.hs - set(st.max_idx))
            if not ok:
                break
            run.append(path)
            affected |= st.groups()
        if not run:
            return 0
        # Re-assert everything the doomed segments contributed, into the
        # active segment, durably, BEFORE the unlinks: hard states
        # (last-wins, and `hard` is current so appending it last is
        # correct) and floor markers (replay must re-learn start).
        for g in sorted(affected):
            if g in hard:
                self.set_hardstate(g, *hard[g])
            if g in floors:
                self._write_compact_rec(g, *floors[g])
            conf = self._conf_latest.get(g)
            if conf is not None and self._lib is None:
                # The membership baseline must survive the unlink too:
                # the conf ENTRY that built it may live only in the
                # doomed segments.
                self._write(_CONFREC.pack(REC_CONF, g, *conf))
            dd = self._dedup_latest.get(g)
            if dd is not None and self._lib is None:
                # Likewise the dedup baseline: the doomed segments may
                # hold the only record scrubbing a compacted-away
                # forward-retry duplicate.
                self._write(dd)
        self.sync()
        for path in run:
            os.unlink(path)
            self._closed_stats.pop(path, None)
        _fsync_dir(self.dirname)
        return len(run)

    @staticmethod
    def rewrite(dirname: str, groups: Dict[int, GroupLog]) -> None:
        """Atomically replace the WAL contents with a compacted image.

        Writes the image as a NEW top segment (seq = max + 1), fsyncs it
        into place, then unlinks all older segments.  A crash at any
        point leaves a correct replay: before the rename the old segments
        are intact; after it, replaying old segments then the image
        yields exactly the image (SNAPSHOT markers + full retained tails
        + final hard states supersede the prefix).  The caller must hold
        the WAL quiescent (no concurrent appends) and reopen its handle
        afterwards.

        The live engine compacts with `compact` (markers + segment
        drops); this full rewrite remains for offline tooling and tests.
        """
        segs = _segment_paths(dirname)
        new_seq = (segs[-1][0] + 1) if segs else 0
        path = os.path.join(dirname, f"wal-{new_seq}.log")
        tmp = path + ".rewrite"
        w = WAL.__new__(WAL)                      # bare python-backend WAL
        w._lib = w._h = None
        w.path = tmp
        w._f = open(tmp, "wb")
        w._pending = False
        w._bytes = 0
        w._active_stats = _SegStats()
        for g, gl in sorted(groups.items()):
            if gl.start:
                w.set_snapshot(g, gl.start, gl.start_term)
            for i, (term, data) in enumerate(gl.entries):
                w.append_entry(g, gl.start + 1 + i, term, data)
            w.set_hardstate(g, gl.hard.term, gl.hard.vote, gl.hard.commit)
        w._f.flush()
        os.fsync(w._f.fileno())
        w._f.close()
        os.replace(tmp, path)
        _fsync_dir(dirname)
        for seq, old in segs:
            os.unlink(old)
        if segs:
            _fsync_dir(dirname)

    # -- replay ----------------------------------------------------------

    @staticmethod
    def replay(dirname: str) -> Dict[int, GroupLog]:
        """Read all segments back into per-group logs, sequence order.

        A torn record drops everything after it — including later
        segments: only the active segment's tail can be torn by a crash,
        so a tear mid-sequence means real corruption and the safe replay
        is the longest clean prefix."""
        groups: Dict[int, GroupLog] = {}
        for seq, path in _segment_paths(dirname):
            with open(path, "rb") as f:
                blob = f.read()
            if not WAL._replay_blob(blob, groups):
                break
        return groups

    @staticmethod
    def _replay_entry(groups: Dict[int, GroupLog], group: int, index: int,
                      term: int, data: bytes) -> None:
        """Apply one replayed entry (ENTRY record, or one position of a
        RANGE record) under the log-matching semantics in the module
        doc: same-term overwrite is idempotent, different-term truncates
        the suffix, below-floor is skipped."""
        gl = groups.setdefault(group, GroupLog())
        pos = index - gl.start               # 1-based within entries
        if pos < 1:
            return                           # below compaction floor
        if pos <= len(gl.entries):
            if gl.entries[pos - 1][0] == term:
                gl.entries[pos - 1] = (term, data)
            else:                            # conflict truncation
                del gl.entries[pos - 1:]
                gl.entries.append((term, data))
        elif pos == len(gl.entries) + 1:
            gl.entries.append((term, data))
        else:
            # Forward gap: the missing prefix lived in segments
            # compaction unlinked (its COMPACT marker replays later,
            # from a retained segment — it will confirm this floor and
            # supply start_term).  Record-level corruption cannot
            # produce a gap: appends are sequential within a segment
            # and a torn record stops replay entirely.
            gl.entries.clear()
            gl.start, gl.start_term = index - 1, 0
            gl.entries.append((term, data))

    @staticmethod
    def _replay_blob(blob: bytes, groups: Dict[int, GroupLog]) -> bool:
        """Apply one segment's records; False on a torn record."""
        off = 0
        while off + _HDR.size <= len(blob):
            crc, blen = _HDR.unpack_from(blob, off)
            body = blob[off + _HDR.size: off + _HDR.size + blen]
            if len(body) != blen or zlib.crc32(body) != crc:
                return False        # torn — drop the rest
            off += _HDR.size + blen
            rtype = body[0]
            if rtype == REC_ENTRY:
                _, group, index, term = _ENTRY.unpack_from(body)
                WAL._replay_entry(groups, group, index, term,
                                  body[_ENTRY.size:])
            elif rtype == REC_RANGE:
                _, group, start, term, count = _RANGE.unpack_from(body)
                doff = _RANGE.size + 4 * count
                pos = doff
                for i in range(count):
                    (ln,) = struct.unpack_from(
                        "<I", body, _RANGE.size + 4 * i)
                    WAL._replay_entry(groups, group, start + i, term,
                                      body[pos: pos + ln])
                    pos += ln
            elif rtype == REC_HARDSTATE:
                _, group, term, vote, commit = _HARD.unpack_from(body)
                gl = groups.setdefault(group, GroupLog())
                gl.hard = HardState(term=term, vote=vote, commit=commit)
            elif rtype == REC_SNAPSHOT:
                _, group, index, term = _SNAP.unpack_from(body)
                gl = groups.setdefault(group, GroupLog())
                # Leads a rewritten WAL (no entries yet), or marks a live
                # InstallSnapshot mid-stream: drop the covered prefix —
                # AND any retained suffix, which predates the snapshot
                # and may conflict with the installed state's history.
                if index > gl.start:
                    gl.entries.clear()
                    gl.start, gl.start_term = index, term
            elif rtype == REC_COMPACT:
                _, group, index, term = _SNAP.unpack_from(body)
                gl = groups.setdefault(group, GroupLog())
                # Local compaction floor: the covered prefix goes, the
                # retained suffix SURVIVES (unlike REC_SNAPSHOT).
                if index > gl.start:
                    drop = min(index - gl.start, len(gl.entries))
                    del gl.entries[:drop]
                    gl.start, gl.start_term = index, term
                elif index == gl.start and gl.start_term == 0:
                    # Confirms an implicit floor inferred from a forward
                    # entry gap (see ENTRY handling above).
                    gl.start_term = term
            elif rtype == REC_CONF:
                _, group, index, kind, voters, joint, learners = \
                    _CONFREC.unpack_from(body)
                gl = groups.setdefault(group, GroupLog())
                # Last-wins applied-config baseline; conf entries
                # committed above it re-apply on top during restore
                # (runtime membership wiring).
                if gl.conf is None or index >= gl.conf[0]:
                    gl.conf = (index, kind, voters, joint, learners)
            elif rtype == REC_DEDUP:
                _, group, floor, count = _DEDUPHDR.unpack_from(body)
                gl = groups.setdefault(group, GroupLog())
                # Highest-floor-wins dedup baseline (a later compaction
                # supersedes an earlier one; pairs are FIFO-ordered).
                if gl.dedup is None or floor >= gl.dedup[0]:
                    off2 = _DEDUPHDR.size
                    gl.dedup = (floor, [
                        _DEDUPPAIR.unpack_from(
                            body, off2 + k * _DEDUPPAIR.size)
                        for k in range(count)])
        return True


# ---------------------------------------------------------------------------
# WAL group commit (PR 7): one physical log — one append stream, one
# fsync — for ALL P peers of a co-located cluster.


class GroupCommitWAL:
    """Multiplex P peers' logical WALs into ONE physical segmented log.

    The fused runtime's durable barrier was P fsyncs in flight (one per
    peer directory) per tick; on one data directory those target the
    same device, so the barrier pays P journal commits for one tick's
    worth of records.  This layout coalesces them: every peer's records
    land in one shared `WAL` (same record formats, same segmentation,
    same repair/compaction machinery) keyed by the FLAT group id
    `peer * G + g`, and the tick's barrier is ONE write+fsync covering
    every peer — a group commit whose batch is whatever the tick wrote.
    Durability semantics are unchanged: sync() returning still means
    every peer's records of the tick are on disk (they are in the same
    file, so trivially so), and the batch window is the tick itself —
    it adapts to load because a saturated tick simply carries more
    records into the same single commit.

    `view(peer)` returns the per-peer facade the host plane writes
    through (the WAL write surface with the peer's `group_bias` applied
    on the way in); `replay/exists/repair_epochs` are the matching
    whole-directory forms, with `split_replay` giving the per-peer
    slice the host plane's restore path consumes.

    Observability: `group_commits` counts actual fsyncs, `batch_hist`
    maps peers-per-commit → count (the bench's group-commit histogram),
    and the owning runtime exports both via /metrics
    (`wal_group_commits`).
    """

    def __init__(self, dirname: str, num_peers: int, num_groups: int,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES):
        import threading
        self.num_peers = num_peers
        self.num_groups = num_groups
        self.base = WAL(dirname, segment_bytes=segment_bytes)
        self._mu = threading.Lock()
        self._dirty: Set[int] = set()
        self._open_views = 0
        self._epoch_last: Optional[Tuple[int, bool]] = None
        self._floors: Dict[int, Tuple[int, int]] = {}
        self._hard: Dict[int, Tuple[int, int, int]] = {}
        self.group_commits = 0
        self.batch_hist: Dict[int, int] = {}
        self._views = [WALGroupView(self, p) for p in range(num_peers)]

    # -- per-peer facades ------------------------------------------------

    def view(self, peer: int) -> "WALGroupView":
        self._open_views += 1
        return self._views[peer]

    # -- whole-directory forms -------------------------------------------

    @staticmethod
    def exists(dirname: str) -> bool:
        return wal_exists(dirname)

    @staticmethod
    def replay_flat(dirname: str) -> Dict[int, GroupLog]:
        return WAL.replay(dirname)

    @staticmethod
    def split_replay(flat: Dict[int, GroupLog], peer: int,
                     num_groups: int) -> Dict[int, GroupLog]:
        lo, hi = peer * num_groups, (peer + 1) * num_groups
        return {fg - lo: gl for fg, gl in flat.items() if lo <= fg < hi}

    @staticmethod
    def repair_epochs(dirname: str, committed: int) -> bool:
        return WAL.repair_epochs(dirname, committed)

    # -- shared write machinery (called by the views) --------------------

    def note_write(self, peer: int) -> None:
        self._dirty.add(peer)

    def epoch_mark(self, no: int, end: bool) -> None:
        """One BEGIN/END frame per dispatch for the WHOLE shared stream
        (the host plane asks per peer; duplicates carry no information
        here because all peers' records share the file).  The dedupe
        check holds the lock across the write so a racing parallel
        worker can never slip a record ahead of the BEGIN it relies
        on."""
        with self._mu:
            key = (no, end)
            if self._epoch_last == key:
                return
            self._epoch_last = key
            self.base.epoch_mark(no, end)

    def sync(self) -> None:
        """The group commit: first caller flushes + fsyncs EVERYTHING
        every peer wrote since the last barrier; the other peers'
        sync() calls find nothing pending and return — P calls, one
        fsync."""
        with self._mu:
            if not self.base._pending:
                return
            batch = len(self._dirty) or 1
            self._dirty.clear()
            self.base.sync()
            self.group_commits += 1
            self.batch_hist[batch] = self.batch_hist.get(batch, 0) + 1

    def compact_view(self, bias: int, floors, hard) -> int:
        """Per-view compaction: floors/hard merge into the cluster-wide
        flat dicts (segment deletability needs EVERY peer's floors —
        one peer's view alone could never prove a shared segment
        fully superseded)."""
        with self._mu:
            self._floors.update(
                {g + bias: v for g, v in floors.items()})
            self._hard.update({g + bias: v for g, v in hard.items()})
            return self.base.compact(dict(self._floors),
                                     dict(self._hard))

    def close_view(self) -> None:
        with self._mu:
            self._open_views -= 1
            if self._open_views <= 0:
                self.base.close()


class WALGroupView:
    """One peer's write surface over a GroupCommitWAL: the WAL API the
    host plane uses, with `group_bias` flattening this peer's group ids
    into the shared stream.  NOT constructed directly — GroupCommitWAL
    hands them out."""

    def __init__(self, owner: GroupCommitWAL, peer: int):
        self._owner = owner
        self.peer = peer
        self.group_bias = peer * owner.num_groups

    # Shared-state delegation: the native mirror path (wal_mirror_all)
    # talks to `_lib`/`_h` and writes `_pending`/`_bytes`/stat bumps —
    # all live on the one shared base WAL.
    @property
    def _lib(self):
        return self._owner.base._lib

    @property
    def _h(self):
        return self._owner.base._h

    @property
    def is_native(self) -> bool:
        return self._owner.base.is_native

    @property
    def _f(self):
        return self._owner.base._f

    @property
    def _active_stats(self):
        return self._owner.base._active_stats

    @property
    def _pending(self):
        return self._owner.base._pending

    @_pending.setter
    def _pending(self, v) -> None:
        self._owner.base._pending = v
        if v:
            self._owner.note_write(self.peer)

    @property
    def _bytes(self):
        return self._owner.base._bytes

    @_bytes.setter
    def _bytes(self, v) -> None:
        self._owner.base._bytes = v

    @property
    def obs(self):
        return self._owner.base.obs

    @obs.setter
    def obs(self, tracer) -> None:
        self._owner.base.obs = tracer

    @property
    def last_sync_s(self) -> float:
        return self._owner.base.last_sync_s

    # -- biased write surface --------------------------------------------

    def _touch(self) -> None:
        self._owner.note_write(self.peer)

    def append_entry(self, group, index, term, data) -> None:
        self._touch()
        self._owner.base.append_entry(group + self.group_bias, index,
                                      term, data)

    def append_entries(self, groups, indexes, terms, datas) -> None:
        self._touch()
        self._owner.base.append_entries(
            [g + self.group_bias for g in groups], indexes, terms, datas)

    def append_ranges(self, groups, starts, counts, terms,
                      datas) -> None:
        self._touch()
        self._owner.base.append_ranges(
            [int(g) + self.group_bias for g in groups], starts, counts,
            terms, datas)

    def append_ranges_uniform(self, plog, groups, starts, counts, terms,
                              blob, lens) -> bool:
        self._touch()
        return self._owner.base.append_ranges_uniform(
            plog, groups, starts, counts, terms, blob, lens,
            group_bias=self.group_bias)

    def set_hardstate(self, group, term, vote, commit) -> None:
        self._touch()
        self._owner.base.set_hardstate(group + self.group_bias, term,
                                       vote, commit)

    def set_hardstates(self, groups, terms, votes, commits) -> None:
        import numpy as np
        self._touch()
        ga = np.asarray(groups, np.int64) + self.group_bias
        self._owner.base.set_hardstates(ga, terms, votes, commits)

    def set_snapshot(self, group, index, term) -> None:
        self._touch()
        self._owner.base.set_snapshot(group + self.group_bias, index,
                                      term)

    def set_conf(self, group, index, kind, voters, joint,
                 learners) -> bool:
        self._touch()
        return self._owner.base.set_conf(group + self.group_bias, index,
                                         kind, voters, joint, learners)

    def mark_compact(self, group, index, term) -> None:
        self._owner.base.mark_compact(group + self.group_bias, index,
                                      term)

    def epoch_mark(self, no: int, end: bool) -> None:
        self._owner.epoch_mark(no, end)

    def sync(self) -> None:
        self._owner.sync()

    def compact(self, floors, hard) -> int:
        return self._owner.compact_view(self.group_bias, floors, hard)

    def close(self) -> None:
        self._owner.close_view()
