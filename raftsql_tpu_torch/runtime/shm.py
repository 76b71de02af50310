"""Shared-memory snapshot plane: worker-mapped read fast path.

Port of raftsql_tpu/runtime/shm.py.  The region file (header, group
table, record log), the seqlock, the epoch and the log_full rules and
the RAFTSQL_SHM_READS / RAFTSQL_SHM_BYTES knobs are the JAX package's,
byte for byte: a region either package publishes reads the same.

The `--workers N` deployment (runtime/ring.py) moved HTTP parsing out
of the engine process, but every GET still paid a full mmap-ring round
trip INTO the engine: REQ slot, engine-side read pool, CPL slot.  Even
a `local` read, which touches no consensus state at all, crossed the
ring twice.

This module removes the round trip for the four read modes whose
freshness evidence is DATA, not a quorum round: the engine publishes
each group's applied SQL delta stream plus the `[G]` commit-watermark,
leader and lease columns into one mmap'd file in the ring directory;
workers map it READ-ONLY, feed per-group in-memory SQLite replicas
from the delta log, and serve

  * `local`    — replica catch-up to the published applied index;
  * `session`  — only once the published applied index covers the
    client's X-Raft-Session watermark (else fall back to the ring,
    where the engine blocks authoritatively);
  * `follower` — only once published applied covers published commit;
  * `linear`   — only while the published lease deadline (stamped by
    the engine from the SAME `now + max_clock_skew` bound its own
    lease reads enforce, runtime/node.py lease_deadline_s) covers the
    worker's CLOCK_MONOTONIC now (system-wide on Linux, so the
    deadline transfers across processes verbatim)

entirely inside the worker process.  Anything not provable from the
mapping — stale publisher heartbeat, watermark not yet covered, lease
lapsed, log overflow, epoch mismatch — FAILS CLOSED to the ring path:
the fast path may only ever skip work, never weaken a mode's contract.

Concurrency design
------------------

One writer (the engine's apply thread + a refresh thread, serialized
by a lock), many reader processes.  The header + per-group table are
guarded by a SEQLOCK: the writer bumps `seq` to odd, writes, bumps to
even; a reader snapshots seq, copies, re-checks (retry on odd/changed).
The delta log is APPEND-ONLY and never rewritten below `log_head`, so
readers copy log bytes WITHOUT the seqlock — a torn table read retries
in microseconds, while log consumption can never livelock behind a
fast writer.  When the log fills, the writer sets the `log_full` flag
and stops publishing deltas; readers treat the region as permanently
dead and every read falls back (the engine keeps serving via the
ring).  A restarted engine draws a fresh random `epoch`: a worker
whose mapping no longer matches its attached epoch marks the plane
dead — remapping a new region mid-flight could alias a rolled-back
applied index, so restart recovery is deliberately NOT transparent
(a stale-epoch remap must fail closed).

The memory-ordering assumption is declared machine-checked below
(`# raftlint: assumes=x86-tso`): raftlint's memory-model rule refuses
seqlock-annotated protocol code in any file that does not declare its
hardware store-order dependence.
"""
from __future__ import annotations

# raftlint: assumes=x86-tso -- the seqlock issues no explicit barriers:
# it relies on cross-process mmap stores becoming visible in program
# order, which x86-TSO guarantees (stores are not reordered with other
# stores, so the even-seq header rewrite publishes log_head only after
# the log/table bytes land).  On weakly-ordered architectures (ARM,
# POWER) a reader could observe the even seq before the data stores and
# take an undetected torn snapshot; this plane targets x86-64/Linux
# (the host of the engine and its card) and must grow fences or per-row
# checksums before being trusted elsewhere.

import mmap
import os
import secrets
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

# Header: magic, version, flags, num_groups, epoch, seq, log_head,
# log_cap, pub_ns, keymap_epoch.  64 bytes with padding to keep the
# group table aligned.  keymap_epoch (hdr[9]) is the elastic-keyspace
# mapping version (raftsql_tpu_torch/reshard/): a worker serving shm reads
# under a routing table older than the publisher's FAILS CLOSED to the
# ring path until it refreshes its mapping.
_MAGIC = 0x534E4150                      # "SNAP"
_VERSION = 1
_FLAG_LOG_FULL = 1
_HDR = struct.Struct("<IHHIQQQQQQ")      # 60 bytes used
_HDR_SIZE = 64
# Per-group row: applied, commit, base_index, lease_deadline_ns,
# leader (1-based, 0 unknown), pad.
_ROW = struct.Struct("<QQQQIi")
_ROW_SIZE = _ROW.size                    # 40 bytes
# Log record header: length of payload, kind, group, index.
_REC = struct.Struct("<IBIQ")
KIND_DELTA = 1                           # payload = one SQL statement
KIND_BASE = 2                            # payload = serialized image

SHM_FILE = "snap.shm"
DEFAULT_BYTES = 32 << 20

# A mapping whose publisher heartbeat is older than this is treated as
# dead for LEASE reads only: local/session/follower freshness is
# proven by the watermarks themselves, but a lease deadline published
# by a wedged engine must not outlive the engine's own refresh cadence
# by much more than the lease horizon.
PUB_STALE_NS = 250_000_000


def shm_path(ring_dir: str) -> str:
    return os.path.join(ring_dir, SHM_FILE)


class ShmSnapshotPublisher:
    """Engine side: owns the mapping read-write, publishes base images,
    applied deltas and the watermark/lease/leader table.

    publish_deltas runs on the apply thread (runtime/db.py _apply_run,
    before acks fire — a worker can then always reach an acked PUT's
    watermark); refresh() runs on a short-interval thread owned by the
    RingServer and restamps commit/leader/lease columns + the
    publisher heartbeat."""

    def __init__(self, ring_dir: str, num_groups: int,
                 size: Optional[int] = None):
        size = size or int(os.environ.get("RAFTSQL_SHM_BYTES",
                                          DEFAULT_BYTES))
        self.num_groups = num_groups
        self._table_off = _HDR_SIZE
        self._log_off = _HDR_SIZE + num_groups * _ROW_SIZE
        size = max(size, self._log_off + (1 << 20))
        self.path = shm_path(ring_dir)
        # No O_TRUNC, grow-only ftruncate: re-creating the region over
        # a predecessor's path (engine restart with the old refresh
        # thread still live) must never let the file size dip — a
        # store through the old mapping while the file is momentarily
        # short of the mapped range is SIGBUS, not an exception.  Old
        # readers die on the epoch flip exactly as before; stale log
        # bytes past the new head are unreachable (head moves only
        # after its bytes are written).
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o600)
        try:
            if os.fstat(fd).st_size < size:
                os.ftruncate(fd, size)
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self._size = size
        self._lock = threading.Lock()
        self._seq = 0
        self._log_head = 0
        self._log_cap = size - self._log_off
        self._full = False
        self.epoch = secrets.randbits(63) | 1    # never 0
        self.keymap_epoch = 0      # elastic-keyspace mapping version
        self._rows = [[0, 0, 0, 0, 0] for _ in range(num_groups)]
        #             applied, commit, base_index, lease_ns, leader
        # Stream tee (replica/publisher.py): called under _lock with
        # ("deltas", per_g) / ("base", group, index, blob) /
        # ("keymap", epoch) the instant a record lands — and, unlike
        # the mmap log, UNCONDITIONALLY: log overflow kills the local
        # fast path (readers can't trust a truncated log) but the
        # stream stays live, because subscribers are re-imaged from
        # fresh KIND_BASE serializations, not from this log.  None
        # (the default) keeps the publisher byte-for-byte inert.
        self.tee: Optional[Callable] = None
        self._serialize_of: Optional[Callable] = None
        # Deltas arriving before start() buffer here: the log must
        # open with each group's base image so a replica can never
        # replay a delta stream whose prefix it is missing.
        self._pending: Optional[List[Dict[int, list]]] = []
        self._write_header(pub_ns=time.monotonic_ns())
        self._write_table()

    # -- writer internals (callers hold _lock) --------------------------

    def _write_header(self, pub_ns: int) -> None:
        flags = _FLAG_LOG_FULL if self._full else 0
        self._mm[0:_HDR.size] = _HDR.pack(
            _MAGIC, _VERSION, flags, self.num_groups, self.epoch,
            self._seq, self._log_head, self._log_cap, pub_ns,
            self.keymap_epoch)

    def _write_table(self) -> None:
        off = self._table_off
        for row in self._rows:
            self._mm[off:off + _ROW_SIZE] = _ROW.pack(
                row[0], row[1], row[2], row[3], row[4], 0)
            off += _ROW_SIZE

    def _publish_locked(self, writes: Callable[[], None]) -> None:  # raftlint: seqlock
        """Seqlock write protocol: odd → mutate → even.  The log bytes
        appended by `writes` land BEFORE the header's log_head moves —
        readers never see a head past initialized bytes."""
        self._seq += 1                       # odd: writer in critical
        self._write_header(pub_ns=time.monotonic_ns())
        writes()
        self._seq += 1                       # even: consistent again
        self._write_header(pub_ns=time.monotonic_ns())

    def _append_locked(self, kind: int, group: int, index: int,
                       payload: bytes) -> bool:
        need = _REC.size + len(payload)
        if self._log_head + need > self._log_cap:
            self._full = True
            return False
        off = self._log_off + self._log_head
        self._mm[off:off + _REC.size] = _REC.pack(
            len(payload), kind, group, index)
        self._mm[off + _REC.size:off + need] = payload
        self._log_head += need
        return True

    def _run_locked(self, per_g: Dict[int, list]) -> None:
        """Append one applied run's deltas (caller holds _lock, inside
        the seqlock critical section)."""
        for group, items in per_g.items():
            row = self._rows[group]
            for (sql, index) in items:
                if index <= row[0]:
                    continue                 # covered by base/duplicate
                if not self._append_locked(KIND_DELTA, group, index,
                                           sql.encode("utf-8")):
                    return
                row[0] = index

    # -- engine-facing API ----------------------------------------------

    def start(self, serialize_of, applied_of) -> None:
        """Open the log: one base image per group (serialize_of(g) →
        (index, blob) or None), then every delta run buffered since
        the publisher was attached.  The attach-then-start ordering
        makes the stream complete: an apply finishing before its
        group's serialize is inside the base; one finishing after is a
        buffered delta ABOVE it (flushed here, in arrival order,
        before direct appends begin).  A group that HAS applied state
        (applied_of(g) > 0) but cannot produce an image would leave
        replicas with a truncated stream — the whole plane fails
        closed (log_full) rather than serve wrong prefixes."""
        self._serialize_of = serialize_of    # retained for stream resyncs
        bases = {}
        for g in range(self.num_groups):
            got = serialize_of(g)
            if got is not None and got[0] > 0:
                bases[g] = got
            elif int(applied_of(g)) > 0:
                with self._lock:
                    self._full = True
                    self._pending = None
                    self._publish_locked(lambda: None)
                return
        with self._lock:
            def writes():
                for g, (idx, blob) in bases.items():
                    if self._append_locked(KIND_BASE, g, idx, blob):
                        row = self._rows[g]
                        row[0] = max(row[0], idx)
                        row[2] = idx
                for per_g in (self._pending or ()):
                    self._run_locked(per_g)
                self._write_table()
            self._publish_locked(writes)
            self._pending = None

    def publish_base(self, group: int, blob: bytes, index: int) -> None:
        """Publish a group's full serialized image (snapshot install).
        Readers install the base when it passes their replica's applied
        index and replay deltas above it."""
        with self._lock:
            self._tee_locked("base", group, index, blob)
            if self._full:
                return

            def writes():
                if self._append_locked(KIND_BASE, group, index, blob):
                    row = self._rows[group]
                    row[0] = max(row[0], index)
                    row[2] = index
                    self._write_table()
            self._publish_locked(writes)

    def publish_deltas(self, per_g: Dict[int, List[Tuple[str, int]]]
                       ) -> None:
        """Publish one applied run: per group, the (sql, index) items
        just handed to the state machine, in apply order."""
        with self._lock:
            if self._pending is not None:
                self._pending.append(per_g)
                return               # pre-start: flushed into the log
                #                      (below any tee attach) by start()
            self._tee_locked("deltas", per_g)
            if self._full:
                return
            def writes():
                self._run_locked(per_g)
                self._write_table()
            self._publish_locked(writes)

    def refresh(self, commit_of, leader_of, lease_deadline_s) -> None:
        """Restamp the watermark/leader/lease columns + heartbeat from
        the engine's host caches (RingServer refresh thread).  Lease
        deadlines convert monotonic seconds → ns; 0.0 stays 0 (no
        lease)."""
        with self._lock:
            for g in range(self.num_groups):
                row = self._rows[g]
                try:
                    row[1] = max(row[1], int(commit_of(g)))
                    row[4] = int(leader_of(g)) + 1
                    d = lease_deadline_s(g)
                    row[3] = int(d * 1e9) if d > 0 else 0
                except Exception:            # noqa: BLE001
                    row[3] = 0               # fail closed, keep going
            self._publish_locked(self._write_table)

    def set_keymap_epoch(self, epoch: int) -> None:
        """Publish a new elastic-keyspace mapping version (reshard
        plane router flip).  Workers attached at an older value fail
        their shm reads closed until they refresh the mapping."""
        with self._lock:
            self._tee_locked("keymap", int(epoch))
            self.keymap_epoch = int(epoch)
            self._publish_locked(lambda: None)

    # -- stream-tee surface (replica/publisher.py) ----------------------

    def _tee_locked(self, *event) -> None:
        """Mirror one publish event to the stream tee (caller holds
        _lock).  The tee implementation only does non-blocking bounded
        queue puts; any failure is the stream plane's problem — it must
        never stall or fail the apply thread."""
        if self.tee is None:
            return
        try:
            self.tee(*event)
        except Exception:  # noqa: BLE001 -- tee must never stall applies
            pass

    def stream_register(self, fn: Callable[[], None]) -> Tuple[int, bool]:
        """Run a subscriber-registration callback under the publisher
        lock and return (log_head, log_full) from the same critical
        section: every record at or below the returned head is readable
        via read_log_records, and every event after it reaches the
        just-registered tee queue — no gap, and any overlap is absorbed
        by the replicas' resume-mode `index <= applied` dedup."""
        with self._lock:
            fn()
            return self._log_head, self._full

    def read_log_records(self, pos: int, head: int
                         ) -> List[Tuple[int, int, int, bytes]]:
        """Decode log records in [pos, head) as (kind, group, index,
        payload).  Bytes below a head returned by stream_register are
        append-only immutable, so this takes no lock and may run
        concurrently with the writer (same argument as the reader's
        _catch_up)."""
        out = []
        while pos + _REC.size <= head:
            off = self._log_off + pos
            ln, kind, group, index = _REC.unpack(
                self._mm[off:off + _REC.size])
            if pos + _REC.size + ln > head:
                break
            payload = bytes(self._mm[off + _REC.size:
                                     off + _REC.size + ln])
            pos += _REC.size + ln
            out.append((kind, group, index, payload))
        return out

    def fresh_base(self, group: int) -> Optional[Tuple[int, bytes]]:
        """A fresh (index, blob) image of one group for stream RESYNCs
        (overflowed log / lapped subscriber queue).  Calls the engine
        serializer retained by start(); that takes the state machine's
        own lock, NOT the publisher lock — never call this while
        holding _lock."""
        fn = self._serialize_of
        if fn is None:
            return None
        try:
            got = fn(group)
        except Exception:  # noqa: BLE001 -- resync just stays pending
            return None
        return got if got is not None and got[0] > 0 else None

    def table_snapshot(self):
        """(epoch, keymap_epoch, log_full, rows) with rows per group
        (applied, commit, base_index, lease_deadline_ns, leader) — the
        stream server's TABLE heartbeat source."""
        with self._lock:
            return (self.epoch, self.keymap_epoch, self._full,
                    [tuple(r) for r in self._rows])

    def close(self) -> None:
        with self._lock:
            try:
                self._mm.close()
            except (BufferError, ValueError):
                pass

    # test/diagnostic surface
    @property
    def log_full(self) -> bool:
        return self._full


class _GroupReplica:
    """One group's in-process SQLite replica, fed from the delta log.
    resume=True gives the state machine's own `index <= applied` skip,
    so re-feeding an overlapping window is harmless."""

    def __init__(self, group: int):
        from raftsql_tpu_torch.models.sqlite_sm import SQLiteStateMachine
        self.sm = SQLiteStateMachine(":memory:", resume=True)
        self.group = group
        self.consumed = 0        # log bytes already fed


class ShmSnapshotReader:
    """Worker side: maps the snapshot region read-only and serves
    reads from per-group replicas.  Every public method FAILS CLOSED —
    returns None — whenever the mapping cannot PROVE the mode's
    freshness contract; the caller (runtime/ring.py RingClient) then
    takes the ordinary ring round trip."""

    def __init__(self, ring_dir: str):
        self.path = shm_path(ring_dir)
        fd = os.open(self.path, os.O_RDONLY)
        try:
            self._mm = mmap.mmap(fd, 0, prot=mmap.PROT_READ)
        finally:
            os.close(fd)
        self._lock = threading.Lock()
        self._dead = False
        hdr = self._read_header_raw()
        if hdr is None or hdr[0] != _MAGIC or hdr[1] != _VERSION:
            self.close()         # don't leak the mapping on a failed
            #                      attach — the caller never sees us
            raise RuntimeError(f"{self.path}: bad snapshot header")
        self.epoch = hdr[4]
        self.num_groups = hdr[3]
        # Elastic-keyspace mapping version this worker routes by.
        # try_read fails closed while the publisher's header reports a
        # different value; note_keymap_epoch revalidates after the
        # worker refreshed its key->group mapping.
        self._kmap_epoch = hdr[9]
        self._table_off = _HDR_SIZE
        self._log_off = _HDR_SIZE + self.num_groups * _ROW_SIZE
        self._replicas: Dict[int, _GroupReplica] = {}

    # -- mapping access -------------------------------------------------

    def _read_header_raw(self):
        try:
            return _HDR.unpack(self._mm[0:_HDR.size])
        except (ValueError, struct.error):
            return None

    def _snapshot_table(self):  # raftlint: seqlock fail-closed
        """Seqlock read of header + group table: (header, rows) or
        None after bounded retries / on any fail-closed condition.
        The epoch check pins the attachment: a restarted engine's
        fresh region (new epoch) permanently kills this reader."""
        if self._dead:
            return None
        for _ in range(64):
            h1 = self._read_header_raw()
            if h1 is None:
                return None
            if h1[0] != _MAGIC or h1[1] != _VERSION \
                    or h1[4] != self.epoch:
                self._dead = True            # stale epoch: fail closed
                return None
            if h1[5] & 1:                    # writer mid-update
                time.sleep(0)
                continue
            raw = bytes(self._mm[self._table_off:self._log_off])
            h2 = self._read_header_raw()
            if h2 is None or h2[5] != h1[5] or h2[4] != self.epoch:
                time.sleep(0)
                continue                     # torn: retry
            rows = [_ROW.unpack_from(raw, i * _ROW_SIZE)
                    for i in range(self.num_groups)]
            return h1, rows
        return None

    # raftlint: fail-closed
    def _catch_up(self, rep: _GroupReplica, target: int,
                  log_head: int) -> bool:
        """Feed the replica from the append-only log until its applied
        index reaches `target`.  Log bytes below log_head are immutable
        — no seqlock needed here.  False when the log ran out before
        the target (publisher hasn't written it yet — fall back)."""
        g = rep.group
        while rep.sm.applied_index() < target:
            if rep.consumed + _REC.size > log_head:
                return False
            off = self._log_off + rep.consumed
            ln, kind, group, index = _REC.unpack(
                self._mm[off:off + _REC.size])
            if rep.consumed + _REC.size + ln > log_head:
                return False
            payload = bytes(self._mm[off + _REC.size:
                                     off + _REC.size + ln])
            rep.consumed += _REC.size + ln
            if group != g:
                continue
            if kind == KIND_BASE:
                if index > rep.sm.applied_index():
                    rep.sm.install(payload, index)
            elif kind == KIND_DELTA:
                # resume-mode state machine skips index <= applied.
                rep.sm.apply(payload.decode("utf-8"), index)
        return True

    # -- read API --------------------------------------------------------

    # raftlint: fail-closed
    def try_read(self, mode: str, group: int, query: str,
                 watermark: int = 0
                 ) -> Optional[Tuple[str, int]]:
        """Serve one read entirely from the mapping: (rows, session
        watermark echo) — or None to fall back to the ring.  `mode` is
        local/session/follower/linear with the contracts documented in
        the module docstring."""
        from raftsql_tpu_torch.models.sqlite_sm import is_select
        if not is_select(query):
            return None          # engine's 400 class — and NEVER let a
            #                      write mutate the worker-side replica
        snap = self._snapshot_table()
        if snap is None:
            return None
        hdr, rows = snap
        if hdr[2] & _FLAG_LOG_FULL:
            self._dead = True                # overflow: permanently out
            return None
        if hdr[9] != self._kmap_epoch:
            # The router moved the keyspace (reshard flip) under this
            # worker's cached mapping: fail closed to the ring path —
            # the engine routes by the CURRENT mapping — until the
            # worker refreshes and calls note_keymap_epoch.
            return None
        if not 0 <= group < self.num_groups:
            return None
        applied, commit, _base, lease_ns, _leader, _pad = rows[group]
        if mode == "local":
            target = applied
        elif mode == "session":
            if applied < watermark:
                return None                  # engine blocks, we don't
            target = max(applied, watermark)
        elif mode == "follower":
            if applied < commit:
                return None
            target = commit
        elif mode == "linear":
            if lease_ns <= 0 or time.monotonic_ns() >= lease_ns:
                return None                  # no provable lease
            if applied < commit:
                return None
            if time.monotonic_ns() - hdr[8] > PUB_STALE_NS:
                return None                  # publisher heartbeat stale
            # Serve at `applied`, NOT the published commit column: the
            # apply thread publishes applied before acks fire, so it
            # covers every acked write, while commit is only restamped
            # by the ~2ms refresh thread — targeting commit inside that
            # window could miss a just-acked PUT.  applied never runs
            # ahead of true commit (entries apply only after commit),
            # and the applied >= commit guard above keeps the lease
            # evidence sound.
            target = applied
        else:
            return None
        with self._lock:
            rep = self._replicas.get(group)
            if rep is None:
                rep = _GroupReplica(group)
                self._replicas[group] = rep
            if not self._catch_up(rep, target, hdr[6]):
                return None
            try:
                out = rep.sm.query(query)
            except Exception:                # noqa: BLE001
                return None                  # surface SQL errors via ring
            return out, int(rep.sm.applied_index())

    def leader_of(self, group: int) -> int:  # raftlint: fail-closed
        """Published 1-based leader hint (0 unknown), for worker-side
        421 redirects without a ring trip; -0 fail-open to 0."""
        snap = self._snapshot_table()
        if snap is None or not 0 <= group < self.num_groups:
            return 0
        return int(snap[1][group][4])

    def keymap_epoch(self) -> int:
        """The publisher's CURRENT elastic-keyspace mapping version
        (0 when no reshard plane ever published)."""
        hdr = self._read_header_raw()
        return int(hdr[9]) if hdr is not None else 0

    def note_keymap_epoch(self, epoch: int) -> None:
        """The worker refreshed its key->group mapping to `epoch`
        (from /healthz): shm reads revalidate against it."""
        self._kmap_epoch = int(epoch)

    def close(self) -> None:
        try:
            self._mm.close()
        except (BufferError, ValueError):
            pass
