"""Host-plane span tracer: per-proposal lifecycle with monotonic stamps.

A span follows one client proposal through the pipeline the engine
actually runs:

    propose -> append (leader WAL) -> replicate (follower mirror/send)
            -> commit (quorum; the two coincide at the leader)
            -> apply -> ack

Stamps come from the planes that own each transition (runtime/db.py,
runtime/node.py, runtime/fused.py); the tracer only correlates them.
Correlation is two-stage, mirroring the engine's own identity scheme:
before an index is assigned, spans wait in a per-group FIFO keyed by
payload content (the same content-FIFO identity the ack router uses,
SURVEY.md §2d.3); the leader-append hook then binds each accepted
payload to its log index, and every later phase stamps by
(group, index).  Forwarded/replayed entries with no local span are
skipped — tracing is an observer, never a participant.

Everything is bounded: pending and live spans are capped (oldest spill
to the completed ring), completed spans and timeline events live in
`deque(maxlen=...)` rings — a tracer left on forever holds a constant
footprint.  All methods take one small lock; callers gate on
`tracer is not None`, so the disabled cost is one attribute test.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

PHASES = ("propose", "append", "replicate", "commit", "apply", "ack")

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

    def as_dict(self, t0: float) -> dict:
        return {"group": self.group, "key": self.key[:128],
                "index": self.index,
                "phases": {k: round((v - t0) * 1e6, 1)   # us since epoch
                           for k, v in self.t.items()}}


class SpanTracer:
    def __init__(self, max_pending: int = 4096, max_live: int = 8192,
                 max_done: int = 4096, max_events: int = 8192):
        self.t0 = time.monotonic()
        self._mu = threading.Lock()
        self._pending: Dict[int, deque] = {}       # group -> [Span]
        self._by_index: Dict[Tuple[int, int], Span] = {}
        self._live_fifo: deque = deque()           # (g, idx) insertion order
        self._by_key: Dict[Tuple[int, str], deque] = {}
        self._done: deque = deque(maxlen=max_done)
        self._events: deque = deque(maxlen=max_events)
        self._marks: Dict[Tuple[str, int], int] = {}   # (phase, g) -> idx
        self._max_pending = max_pending
        self._max_live = max_live
        self.dropped = 0

    # -- lifecycle hooks ------------------------------------------------

    def begin(self, group: int, key: str) -> None:
        """A client proposal entered the pipeline (pre-index)."""
        now = time.monotonic()
        with self._mu:
            q = self._pending.setdefault(group, deque())
            if len(q) >= self._max_pending:
                q.popleft()
                self.dropped += 1
            q.append(Span(group, key, now))

    def note_append(self, group: int, start: int, keys: List[str]) -> None:
        """The leader accepted `keys` into its log at start..start+n-1
        and wrote them to the WAL: bind indexes, stamp `append`.
        Payloads with no pending span (forwarded from a peer, replays)
        are skipped."""
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
                self._live_fifo.append((group, sp.index))
                self._by_key.setdefault((group, key), deque()).append(sp)
            while len(self._by_index) > self._max_live:
                self._evict_oldest_locked()

    def _evict_oldest_locked(self) -> None:
        while self._live_fifo:
            k = self._live_fifo.popleft()
            sp = self._by_index.pop(k, None)
            if sp is not None:
                self._finish_locked(sp)
                return

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
        """The group's commit index reached `upto` — the quorum point.
        Implies replication, so a missing replicate stamp is filled."""
        self._stamp_upto("commit", group, upto, also="replicate")

    def note_apply(self, group: int, index: int) -> None:
        now = time.monotonic()
        with self._mu:
            sp = self._by_index.get((group, index))
            if sp is not None:
                sp.t.setdefault("apply", now)

    def note_ack(self, group: int, key: str) -> None:
        """The client ack fired (content-FIFO identity, matching the
        ack router): finalize the oldest live span with this key."""
        now = time.monotonic()
        with self._mu:
            q = self._by_key.get((group, key))
            if not q:
                return
            sp = q.popleft()
            if not q:
                del self._by_key[(group, key)]
            sp.t["ack"] = now
            self._by_index.pop((group, sp.index), None)
            self._finish_locked(sp)

    def _finish_locked(self, sp: Span) -> None:
        q = self._by_key.get((sp.group, sp.key))
        if q is not None:
            try:
                q.remove(sp)
            except ValueError:
                pass
            if not q:
                self._by_key.pop((sp.group, sp.key), None)
        self._done.append(sp)

    # -- generic timeline events ---------------------------------------

    def note_event(self, name: str, dur_s: float = 0.0,
                   t_start: Optional[float] = None, **args) -> None:
        """A point or duration event on the host timeline (WAL fsync,
        TCP frame, tick phase, ...)."""
        t = time.monotonic() - dur_s if t_start is None else t_start
        with self._mu:      # snapshot() iterates this deque
            self._events.append((name, t, dur_s, args))

    # -- export ---------------------------------------------------------

    def snapshot(self, max_spans: int = 4096) -> dict:
        """JSON-ready view: completed + still-live spans (us-since-epoch
        stamps) and the timeline-event ring."""
        with self._mu:
            done = list(self._done)
            live = list(self._by_index.values())
            events = list(self._events)
        spans = [sp.as_dict(self.t0) for sp in (done + live)[-max_spans:]]
        evs = [{"name": n, "ts": round((t - self.t0) * 1e6, 1),
                "dur": round(d * 1e6, 1), "args": a}
               for (n, t, d, a) in events]
        return {"epoch_monotonic": self.t0, "spans": spans,
                "events": evs, "dropped": self.dropped}
