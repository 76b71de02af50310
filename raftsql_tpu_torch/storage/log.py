"""Host-side payload log: entry (term, bytes) per (group, index).

The device log (core/state.py) stores only the last-W entry *terms* in a
ring; the bytes of each proposal (SQL text) — and the full term history,
which the device ring forgets once an index slides out of the window —
live here, mirroring device log positions 1:1.  This splits the
reference's `raft.MemoryStorage` (reference raft.go:129, 229) into its two
real roles: ordering metadata (device) and bytes (host).

The full term history is what lets the leader's HOST build catch-up
AppendEntries for followers that have fallen more than W entries behind —
positions the device can no longer describe (runtime/node.py catch-up
path; the reference gets the same from MemoryStorage.Term, which etcd's
sendAppend consults before falling back to a snapshot).

Storage layout is COLUMNAR: parallel per-group term and payload lists,
not a list of (term, bytes) tuples.  The hot paths — publish slicing
payloads for every committed range, and the durable tick appending a
batch per active group — then cost one C-level list slice/extend each,
with no per-entry tuple construction (measured: the tuple layout's
put/slice pair was a double-digit share of the fused durable tick).

Like MemoryStorage, growth is unbounded unless compacted (`compact`, fed
by state-machine snapshots — runtime/db.py / runtime/fused.py); parity
deployments never compact, same documented limitation as the reference
(db.go:27-29).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


class PayloadLog:
    """1-based, truncate-on-conflict (term, bytes) log for G groups.

    After `compact(g, upto, term)`, entries at or below `upto` are
    dropped; `start(g)` reports the floor and `term_of(g, start)` still
    resolves (the boundary term is retained) so AppendEntries prev-term
    checks at the compaction edge work."""

    def __init__(self, num_groups: int):
        self._terms: List[List[int]] = [[] for _ in range(num_groups)]
        self._datas: List[List[bytes]] = [[] for _ in range(num_groups)]
        self._start: List[int] = [0] * num_groups
        self._start_term: List[int] = [0] * num_groups
        # One lock: readers (publish, catch-up, send) race the compactor,
        # and a torn (_start, lists) read would mis-align indexes.
        self._mu = __import__("threading").RLock()

    def length(self, group: int) -> int:
        with self._mu:
            return self._start[group] + len(self._datas[group])

    def start(self, group: int) -> int:
        with self._mu:
            return self._start[group]

    def set_start(self, group: int, start: int, start_term: int) -> None:
        """Initialize the compaction floor on restart (from a WAL
        snapshot marker).  Only valid on an empty group log."""
        with self._mu:
            assert not self._datas[group]
            self._start[group] = start
            self._start_term[group] = start_term

    def reset(self, group: int, start: int, start_term: int) -> None:
        """Discard the group's entire log and restart it at `start` (the
        receiver side of InstallSnapshot: history before the snapshot is
        gone, and any suffix predating it may conflict)."""
        with self._mu:
            self._terms[group].clear()
            self._datas[group].clear()
            self._start[group] = start
            self._start_term[group] = start_term

    def compact(self, group: int, upto: int, boundary_term: int) -> None:
        """Drop entries <= upto (must be <= length)."""
        with self._mu:
            s = self._start[group]
            if upto <= s:
                return
            del self._terms[group][: upto - s]
            del self._datas[group][: upto - s]
            self._start[group] = upto
            self._start_term[group] = boundary_term

    def get(self, group: int, index: int) -> bytes:
        with self._mu:
            return self._datas[group][index - 1 - self._start[group]]

    def term_of(self, group: int, index: int) -> int:
        """Term of entry `index`; term_of(0) == 0 (the log-start
        sentinel), term_of(start) == the retained boundary term."""
        with self._mu:
            if index == 0:
                return 0
            s = self._start[group]
            if index == s:
                return self._start_term[group]
            # A negative list index would silently wrap to the tail.
            assert index > s, f"term_of below compaction floor ({index})"
            return self._terms[group][index - 1 - s]

    def try_term_of(self, group: int, index: int) -> Optional[int]:
        """term_of with a floor check instead of an assert: None when
        `index` sits at/below a concurrently advancing compaction floor
        or beyond the log — for client-thread callers (ReadIndex) that
        race the compactor and must degrade to a retry, not an
        AssertionError (or a wrapped negative index under python -O)."""
        with self._mu:
            if index == 0:
                return 0
            s = self._start[group]
            if index == s:
                return self._start_term[group]
            if index < s or index > s + len(self._terms[group]):
                return None
            return self._terms[group][index - 1 - s]

    def try_tail_with_terms(self, group: int, start: int, n: int):
        """Atomic (prev_term, [(term, payload)...]) for entries
        [start, start+n) — None if `start` has been compacted away.
        The single lock hold makes check + boundary-term + slice one
        consistent read against the concurrent compactor."""
        with self._mu:
            s0 = self._start[group]
            if start <= s0:
                return None
            if start - 1 == 0:
                prev_term = 0
            elif start - 1 == s0:
                prev_term = self._start_term[group]
            else:
                prev_term = self._terms[group][start - 2 - s0]
            rel = start - 1 - s0
            return prev_term, list(zip(self._terms[group][rel: rel + n],
                                       self._datas[group][rel: rel + n]))

    def slice(self, group: int, start: int, n: int) -> List[bytes]:
        """Entry payloads [start, start+n), 1-based — one C-level list
        slice, the publish hot path."""
        with self._mu:
            s = start - 1 - self._start[group]
            assert s >= 0, "slice below compaction floor"
            return self._datas[group][s: s + n]

    def try_slice(self, group: int, start: int, n: int
                  ) -> Optional[List[bytes]]:
        """Like slice, but None when [start, start+n) dips below the
        compaction floor — the floor moves concurrently (compactor
        thread), so check-then-slice must be one atomic operation."""
        with self._mu:
            s = start - 1 - self._start[group]
            if s < 0:
                return None
            return self._datas[group][s: s + n]

    def slice_columns(self, group: int, start: int, n: int
                      ) -> Tuple[List[int], List[bytes]]:
        """(terms, payloads) for [start, start+n) as two C-level list
        slices — the mirror hot path (runtime/fused.py); a tuple-zipping
        variant of this accessor was the second-largest per-entry cost
        of the durable tick."""
        with self._mu:
            s = start - 1 - self._start[group]
            assert s >= 0, "slice below compaction floor"
            return (self._terms[group][s: s + n],
                    self._datas[group][s: s + n])

    def put(self, group: int, start: int, payloads: Sequence[bytes],
            terms: Sequence[int], new_len: Optional[int] = None) -> None:
        """Write (term, payload) at [start, start+len), extending or
        overwriting; then truncate to new_len if given (the
        conflict-truncation mirror of the device-side append in
        core/step.py Phase 4)."""
        with self._mu:
            self._put_locked(group, start, payloads, terms, new_len)

    def put_ranges(self, items) -> None:
        """Batched `put`: one lock acquisition for an iterable of
        (group, start, payloads, terms, new_len) tuples — the fused
        runtime writes O(groups) ranges per tick and the per-call lock
        round trip was a measurable slice of its WAL phase."""
        with self._mu:
            for (group, start, payloads, terms, new_len) in items:
                self._put_locked(group, start, payloads, terms, new_len)

    def _put_locked(self, group: int, start: int, payloads, terms,
                    new_len: Optional[int]) -> None:
        tl, dl = self._terms[group], self._datas[group]
        off = self._start[group]
        rel = start - 1 - off
        # The parallel lists corrupt silently if they ever diverge (the
        # old tuple layout couldn't): refuse mismatched inputs here.
        assert len(terms) == len(payloads), (len(terms), len(payloads))
        if rel == len(dl):
            # Pure tail append — the leader/follower hot path: two
            # C-level extends, zero per-entry Python.
            tl.extend(terms)
            dl.extend(payloads)
        else:
            n = len(payloads)
            if rel >= 0 and rel + n <= len(dl):
                # In-place overwrite (conflict suffix replacement).
                tl[rel: rel + n] = terms
                dl[rel: rel + n] = payloads
            else:
                for i in range(n):
                    pos = rel + i
                    if pos < 0:
                        continue   # below the compaction floor: immutable
                    if pos < len(dl):
                        tl[pos] = terms[i]
                        dl[pos] = payloads[i]
                    elif pos == len(dl):
                        tl.append(terms[i])
                        dl.append(payloads[i])
                    else:
                        raise ValueError(
                            f"payload gap: group {group} idx "
                            f"{pos + 1 + off} > len {len(dl) + off}")
        if new_len is not None and new_len - off < len(dl):
            del tl[max(new_len - off, 0):]
            del dl[max(new_len - off, 0):]


class NativePayloadLog:
    """ctypes-backed PayloadLog (native/wal.cc `Plog`): same surface,
    entry bytes live in C++.  Paired with WAL.append_ranges_uniform and
    storage.wal.wal_mirror_all, the fused runtime's payload plane does
    no per-entry Python at all on the write side; reads (publish,
    replay, catch-up) come back as one blob + lens and split into bytes
    objects only where a consumer needs them."""

    def __init__(self, num_groups: int, lib):
        import ctypes
        self._c = ctypes
        self._lib = lib
        self._h = lib.plog_new(num_groups)
        self._G = num_groups

    @property
    def handle(self):
        return self._h

    def close(self) -> None:
        if self._h:
            self._lib.plog_free(self._h)
            self._h = None

    def length(self, group: int) -> int:
        return int(self._lib.plog_length(self._h, group))

    def start(self, group: int) -> int:
        return int(self._lib.plog_start(self._h, group))

    def set_start(self, group: int, start: int, start_term: int) -> None:
        rc = self._lib.plog_set_start(self._h, group, start, start_term)
        if rc != 0:
            raise RuntimeError("set_start on non-empty group")

    def term_of(self, group: int, index: int) -> int:
        t = int(self._lib.plog_term_of(self._h, group, index))
        if t == (1 << 64) - 1:      # explicit: survives python -O
            raise IndexError(f"term_of out of range (g{group} "
                             f"idx {index})")
        return t

    def try_term_of(self, group: int, index: int) -> Optional[int]:
        t = int(self._lib.plog_term_of(self._h, group, index))
        return None if t == (1 << 64) - 1 else t

    def compact(self, group: int, upto: int, boundary_term: int) -> None:
        rc = self._lib.plog_compact(self._h, group, upto, boundary_term)
        if rc != 0:
            raise RuntimeError(f"compact past tail (g{group} "
                               f"upto {upto})")

    def put(self, group: int, start: int, payloads: Sequence[bytes],
            terms: Sequence[int], new_len: Optional[int] = None) -> None:
        import numpy as np
        c = self._c
        n = len(payloads)
        blob = b"".join(payloads)
        lens = np.fromiter(map(len, payloads), np.uint32, n)
        ta = np.asarray(terms, np.uint64)
        rc = self._lib.plog_put_range(
            self._h, group, start, n,
            ta.ctypes.data_as(c.POINTER(c.c_uint64)), blob,
            lens.ctypes.data_as(c.POINTER(c.c_uint32)),
            -1 if new_len is None else new_len)
        if rc != 0:
            raise ValueError(f"payload gap: group {group} at {start}")

    def put_ranges(self, items) -> None:
        for (group, start, payloads, terms, new_len) in items:
            self.put(group, start, payloads, terms, new_len)

    def _read(self, group: int, start: int, n: int, want_terms: bool):
        import numpy as np
        c = self._c
        total = int(self._lib.plog_range_bytes(self._h, group, start, n))
        if total == (1 << 64) - 1:
            return None
        blob = c.create_string_buffer(total)
        lens = np.zeros(n, np.uint32)
        terms = np.zeros(n, np.uint64) if want_terms else None
        rc = self._lib.plog_read_range(
            self._h, group, start, n,
            c.cast(blob, c.POINTER(c.c_uint8)),
            lens.ctypes.data_as(c.POINTER(c.c_uint32)),
            terms.ctypes.data_as(c.POINTER(c.c_uint64))
            if want_terms else None)
        if rc != 0:
            return None
        raw = blob.raw
        out, off = [], 0
        for ln in lens.tolist():
            out.append(raw[off: off + ln])
            off += ln
        return (out, terms.tolist()) if want_terms else out

    def slice(self, group: int, start: int, n: int) -> List[bytes]:
        got = self._read(group, start, n, want_terms=False)
        if got is None:             # explicit: survives python -O
            raise RuntimeError("slice below compaction floor")
        return got

    def try_slice(self, group: int, start: int, n: int
                  ) -> Optional[List[bytes]]:
        return self._read(group, start, n, want_terms=False)

    def read_groups(self, groups, starts, counts):
        """Batched multi-range read: [(payloads...)] per range, in TWO
        ctypes calls total — the publish hot path reads every ready
        group of a tick at once (per-range ctypes calls cost more than
        the payloads themselves)."""
        import numpy as np
        c = self._c
        n_ranges = len(groups)
        ga = np.asarray(groups, np.uint32)
        sa = np.asarray(starts, np.uint64)
        ca = np.asarray(counts, np.uint32)
        gp = ga.ctypes.data_as(c.POINTER(c.c_uint32))
        sp = sa.ctypes.data_as(c.POINTER(c.c_uint64))
        cp = ca.ctypes.data_as(c.POINTER(c.c_uint32))
        total = int(self._lib.plog_ranges_bytes(self._h, n_ranges,
                                                gp, sp, cp))
        if total == (1 << 64) - 1:  # explicit: survives python -O
            raise RuntimeError("read_groups: range below compaction "
                               "floor or past tail")
        blob = c.create_string_buffer(total)
        n_entries = int(ca.sum())
        lens = np.zeros(n_entries, np.uint32)
        rc = self._lib.plog_read_groups(
            self._h, n_ranges, gp, sp, cp,
            c.cast(blob, c.POINTER(c.c_uint8)),
            lens.ctypes.data_as(c.POINTER(c.c_uint32)))
        if rc != 0:                 # explicit: survives python -O
            raise RuntimeError("read_groups raced a truncation")
        raw = blob.raw
        out, off, li = [], 0, 0
        lens_l = lens.tolist()
        for cnt in ca.tolist():
            datas = []
            for _ in range(cnt):
                ln = lens_l[li]
                datas.append(raw[off: off + ln])
                off += ln
                li += 1
            out.append(datas)
        return out

    def slice_columns(self, group: int, start: int, n: int
                      ) -> Tuple[List[int], List[bytes]]:
        got = self._read(group, start, n, want_terms=True)
        if got is None:             # explicit: survives python -O
            raise RuntimeError("slice below compaction floor")
        datas, terms = got
        return terms, datas
