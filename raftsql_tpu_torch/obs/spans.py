"""Host-plane span tracer: per-request lifecycle with monotonic stamps.

A span follows one client write from the HTTP plane to its reply, one
`time.monotonic()` stamp per step (STAMPS):

    parsed     the HTTP plane decoded the request (api/aio.py)
    propose    the proposal entered the host plane's queue (`begin`)
    append     the leader accepted it into a device step: its log index
               is bound here
    replicate  a follower's log holds it
    commit     the committed, fsynced entry was handed to the apply
               plane (peer 0's publish; the quorum point lies before)
    apply      the state machine applied it
    ack        the writer's future resolved
    reply      the event loop wrote the response

The stages (STAGES) partition a finished span: queue = append - parsed,
commit = commit - append, apply = ack - commit, reply = reply - ack, so
they sum to reply - parsed.  `parsed` and `reply` are taken only by an
HTTP plane that passes them (`begin(..., t=)`, `note_reply`).

A read has a span of its own, stamped by api/aio.py alone (READ_STAMPS):

    parsed     the HTTP plane decoded the GET
    point      its read point was taken (runtime/db.py read_point)
    applied    the apply released it (RaftDB.park; = point when the
               apply was there already)
    queried    its SQLite query returned
    reply      the event loop wrote the response

Its stages (READ_STAGES) point, wait, query and reply sum to reply -
parsed likewise.  The HTTP plane holds a read's stamps itself and folds
them with one `note_read` call into a ring of their own, of the same
cap and layout as the finished writes'.

Stamps come from the planes that own each transition (api/aio.py,
runtime/db.py, runtime/hostplane.py, runtime/node.py); the tracer only
correlates them.  Correlation is two-stage, mirroring the engine's own
identity scheme: before an index is assigned, spans wait in a per-group
FIFO keyed by payload content (the same content-FIFO identity the ack
router uses, SURVEY.md §2d.3); the leader-append hook then binds each
accepted payload to its log index, and every later phase stamps by
(group, index).  Forwarded/replayed entries with no local span are
skipped — tracing is an observer, never a participant.

A span is a Python object only while it is live.  At its ack (or when
it is evicted as the oldest live span) it folds into a preallocated
ring of `max_done` rows: its stamps (NaN where none was taken), group,
index, the first 128 bytes of its key and its fold number.  `note_ack`
returns the fold number; `note_reply` stamps that row unless the ring
has overwritten it since.  The ring drops oldest first; `finished()`
copies its stamps for analysis and `snapshot()` renders JSON.  Pending
and live spans are capped too (oldest spill), and timeline events live
in a bounded deque, so a tracer left on forever holds a constant
footprint.  All methods take one small lock; callers gate on
`tracer is not None`, so the disabled cost is one attribute test.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

STAMPS = ("parsed", "propose", "append", "replicate", "commit", "apply",
          "ack", "reply")
_COL = {s: k for k, s in enumerate(STAMPS)}
# (stage, from stamp, to stamp): contiguous, parsed to reply.
STAGES = (("queue", "parsed", "append"), ("commit", "append", "commit"),
          ("apply", "commit", "ack"), ("reply", "ack", "reply"))
_STAGE_COLS = [_COL["parsed"]] + [_COL[b] for _, _, b in STAGES]
READ_STAMPS = ("parsed", "point", "applied", "queried", "reply")
READ_STAGES = (("point", "parsed", "point"), ("wait", "point", "applied"),
               ("query", "applied", "queried"),
               ("reply", "queried", "reply"))
_KEY_BYTES = 128

# Bounded watermark walk per note_replicate/note_commit call: commit can
# jump arbitrarily far after a catch-up; spans beyond the cap simply
# miss the stamp (observability degrades, never the tick).
_WALK_CAP = 4096


class Span:
    __slots__ = ("group", "key", "index", "t")

    def __init__(self, group: int, key: str, t_propose: float):
        self.group = group
        self.key = key
        self.index = -1
        self.t: Dict[str, float] = {"propose": t_propose}


def _phases_us(stamps: Dict[str, float], t0: float) -> dict:
    return {k: round((v - t0) * 1e6, 1) for k, v in stamps.items()}


class SpanTracer:
    def __init__(self, max_pending: int = 4096, max_live: int = 8192,
                 max_done: int = 4096, max_events: int = 8192):
        self.t0 = time.monotonic()
        self._mu = threading.Lock()
        self._pending: Dict[int, deque] = {}       # group -> [Span]
        # Live spans by (group, index), in the order they were bound.
        self._by_index: Dict[Tuple[int, int], Span] = {}
        self._by_key: Dict[Tuple[int, str], deque] = {}
        self._events: deque = deque(maxlen=max_events)
        self._marks: Dict[Tuple[str, int], int] = {}   # (phase, g) -> idx
        self._max_pending = max_pending
        self._max_live = max_live
        self.dropped = 0
        # The finished-span ring (module docstring): row n % cap holds
        # fold number n.
        self.cap = max(1, max_done)
        self._t = np.full((self.cap, len(STAMPS)), np.nan)
        self._group = np.zeros(self.cap, np.int64)
        self._index = np.full(self.cap, -1, np.int64)
        self._key = np.zeros(self.cap, f"S{_KEY_BYTES}")
        self._seq = np.full(self.cap, -1, np.int64)
        self.folded = 0
        # The finished reads' ring, row n % cap holding read number n.
        self._rt = np.full((self.cap, len(READ_STAMPS)), np.nan)
        self._rgroup = np.zeros(self.cap, np.int64)
        self.reads_folded = 0

    # -- lifecycle hooks ------------------------------------------------

    def begin(self, group: int, key: str,
              t: Optional[float] = None) -> None:
        """A client proposal entered the pipeline (pre-index); `t` is
        its `parsed` stamp when the HTTP plane took one."""
        now = time.monotonic()
        sp = Span(group, key, now)
        if t is not None:
            sp.t["parsed"] = t
        with self._mu:
            q = self._pending.setdefault(group, deque())
            if len(q) >= self._max_pending:
                q.popleft()
                self.dropped += 1
            q.append(sp)

    def note_append(self, group: int, start: int, keys: List[str]) -> None:
        """The leader accepted `keys` into its log at start..start+n-1:
        bind indexes, stamp `append`.  Payloads with no pending span
        (forwarded from a peer, replays) are skipped."""
        now = time.monotonic()
        with self._mu:
            q = self._pending.get(group)
            if not q:
                return
            for off, key in enumerate(keys):
                sp = None
                for cand in q:
                    if cand.key == key:
                        sp = cand
                        break
                if sp is None:
                    continue
                q.remove(sp)
                sp.index = start + off
                sp.t["append"] = now
                self._by_index[(group, sp.index)] = sp
                self._by_key.setdefault((group, key), deque()).append(sp)
            while len(self._by_index) > self._max_live:
                self._evict_oldest_locked()

    def _evict_oldest_locked(self) -> None:
        self._finish_locked(self._by_index.pop(next(iter(self._by_index))))

    def _stamp_upto(self, phase: str, group: int, upto: int,
                    also: Optional[str] = None) -> None:
        now = time.monotonic()
        with self._mu:
            mark = self._marks.get((phase, group), 0)
            if upto <= mark:
                return
            lo = max(mark + 1, upto - _WALK_CAP + 1)
            for idx in range(lo, upto + 1):
                sp = self._by_index.get((group, idx))
                if sp is None:
                    continue
                sp.t.setdefault(phase, now)
                if also is not None:
                    sp.t.setdefault(also, now)
            self._marks[(phase, group)] = upto

    def note_replicate(self, group: int, upto: int) -> None:
        """Entries up to `upto` were handed to a follower (fused: the
        mirror landed in the follower's log; distributed: the append
        left on the wire)."""
        self._stamp_upto("replicate", group, upto)

    def note_commit(self, group: int, upto: int) -> None:
        """Entries up to `upto` were handed to the apply plane: the
        fused host plane calls this from peer 0's publish, after the
        tick's fsync barrier; the distributed node when its commit index
        moves.  Implies replication, so a missing replicate stamp is
        filled."""
        self._stamp_upto("commit", group, upto, also="replicate")

    def note_apply(self, group: int, index: int) -> None:
        now = time.monotonic()
        with self._mu:
            sp = self._by_index.get((group, index))
            if sp is not None:
                sp.t.setdefault("apply", now)

    def note_ack(self, group: int, key: str) -> Optional[int]:
        """The client ack fired (content-FIFO identity, matching the
        ack router): fold the oldest live span with this key into the
        ring.  Returns its fold number for `note_reply`, or None."""
        now = time.monotonic()
        with self._mu:
            q = self._by_key.get((group, key))
            if not q:
                return None
            sp = q.popleft()
            if not q:
                del self._by_key[(group, key)]
            sp.t["ack"] = now
            self._by_index.pop((group, sp.index), None)
            return self._finish_locked(sp)

    def note_reply(self, n: int, t: Optional[float] = None) -> None:
        """The response of the span folded as number `n` was written."""
        now = time.monotonic() if t is None else t
        with self._mu:
            j = n % self.cap
            if self._seq[j] == n:
                self._t[j, _COL["reply"]] = now

    def note_read(self, group: int, stamps) -> int:
        """Fold one answered read: its READ_STAMPS, in order.  Returns
        its read number."""
        with self._mu:
            n = self.reads_folded
            j = n % self.cap
            self._rt[j] = stamps
            self._rgroup[j] = group
            self.reads_folded = n + 1
            return n

    def _finish_locked(self, sp: Span) -> int:
        q = self._by_key.get((sp.group, sp.key))
        if q is not None:
            try:
                q.remove(sp)
            except ValueError:
                pass
            if not q:
                self._by_key.pop((sp.group, sp.key), None)
        n = self.folded
        j = n % self.cap
        row = self._t[j]
        row[:] = np.nan
        for k, v in sp.t.items():
            row[_COL[k]] = v
        self._group[j] = sp.group
        self._index[j] = sp.index
        self._key[j] = sp.key.encode("utf-8", "replace")[:_KEY_BYTES]
        self._seq[j] = n
        self.folded = n + 1
        return n

    def _rows_locked(self, last: int, folded: Optional[int] = None
                     ) -> np.ndarray:
        """Ring rows of the newest `last` folded spans (of `folded`
        folded, by default the writes'), oldest first."""
        folded = self.folded if folded is None else folded
        take = min(folded, self.cap, last)
        return np.arange(folded - take, folded) % self.cap

    # -- generic timeline events ---------------------------------------

    def note_event(self, name: str, dur_s: float = 0.0,
                   t_start: Optional[float] = None, **args) -> None:
        """A point or duration event on the host timeline (WAL fsync,
        TCP frame, tick phase, ...)."""
        t = time.monotonic() - dur_s if t_start is None else t_start
        with self._mu:      # snapshot() iterates this deque
            self._events.append((name, t, dur_s, args))

    # -- export ---------------------------------------------------------

    def finished(self) -> np.ndarray:
        """A copy of the ring's stamps, one row per folded span (oldest
        first), one column per STAMPS entry, NaN where none was taken."""
        with self._mu:
            return self._t[self._rows_locked(self.cap)]

    def finished_reads(self) -> np.ndarray:
        """A copy of the read ring's stamps, as `finished()` gives the
        writes', one column per READ_STAMPS entry."""
        with self._mu:
            return self._rt[self._rows_locked(self.cap, self.reads_folded)]

    def snapshot(self, max_spans: int = 4096) -> dict:
        """JSON-ready view: the newest folded and still-live spans
        (us-since-epoch stamps) and the timeline-event ring."""
        with self._mu:
            rows = self._rows_locked(max_spans)
            t, grp = self._t[rows], self._group[rows]
            idx, keys = self._index[rows], self._key[rows]
            live = [(sp.group, sp.key, sp.index, dict(sp.t))
                    for sp in self._by_index.values()]
            events = list(self._events)
        spans = [{"group": int(g), "key": k.decode("utf-8", "replace"),
                  "index": int(i),
                  "phases": _phases_us({STAMPS[c]: float(v)
                                        for c, v in enumerate(row)
                                        if v == v}, self.t0)}
                 for row, g, i, k in zip(t, grp, idx, keys)]
        spans += [{"group": g, "key": k[:_KEY_BYTES], "index": i,
                   "phases": _phases_us(st, self.t0)}
                  for g, k, i, st in live]
        evs = [{"name": n, "ts": round((t - self.t0) * 1e6, 1),
                "dur": round(d * 1e6, 1), "args": a}
               for (n, t, d, a) in events]
        return {"epoch_monotonic": self.t0, "spans": spans[-max_spans:],
                "events": evs, "dropped": self.dropped}


def stage_seconds(stamps: np.ndarray, t_open: float = -np.inf,
                  t_close: float = np.inf, skip=None) -> dict:
    """Each stage's seconds (STAGES) over the rows of `stamps` (as
    `finished()` gives them) that carry all five of the stages' stamps,
    whose `parsed` and `reply` both lie in [t_open, t_close], and which
    do not overlap the interval `skip` = (start, end), if given."""
    return _stage_seconds(stamps[:, _STAGE_COLS], STAGES, t_open,
                          t_close, skip)


def read_stage_seconds(stamps: np.ndarray, t_open: float = -np.inf,
                       t_close: float = np.inf, skip=None) -> dict:
    """`stage_seconds` of the reads' READ_STAGES, over the rows of
    `finished_reads()`."""
    return _stage_seconds(stamps, READ_STAGES, t_open, t_close, skip)


def _stage_seconds(s: np.ndarray, stages, t_open, t_close, skip) -> dict:
    ok = ~np.isnan(s).any(axis=1)
    ok &= (s[:, 0] >= t_open) & (s[:, -1] <= t_close)
    if skip is not None:
        ok &= (s[:, -1] < skip[0]) | (s[:, 0] > skip[1])
    d = np.diff(s[ok], axis=1)
    return {name: d[:, k] for k, (name, _, _) in enumerate(stages)}
