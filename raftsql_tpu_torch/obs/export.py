"""Chrome trace-event export — the JSON object format Perfetto and
chrome://tracing load directly.

One document, three track families:

  * pid 1 "spans": per-group tracks of complete ("X") slices, one per
    adjacent recorded phase pair of every span
    (propose→append→replicate→commit→apply→ack), on the host monotonic
    axis (us since the tracer epoch);
  * pid 2 "host io": the tracer's timeline-event ring (WAL fsyncs, TCP
    frames, ...) as duration slices or instants;
  * pid 3 "device": counter ("C") tracks built from the device event
    ring — commit / inbox depth / vote tally per (peer, group) — on a
    SYNTHETIC tick axis (1 tick = `tick_us` microseconds), since device
    ticks carry no wall clock.  Separate pid, so the axes never mix;
  * pid 4 "tick phases": the tick-phase profiler's per-phase duration
    tracks (obs/prof.py — pop / dispatch / wal_write / fsync / publish
    / ring_drain, one thread per (phase, worker id));
  * real-pid process tracks: per-process trace SEGMENTS merged in from
    the serving plane's worker processes (TraceSegmentWriter /
    collect_segments below) — a `--workers N` deployment's /trace is
    ONE multi-process Perfetto timeline, workers named and keyed by
    their real OS pid.

Cross-process timestamps work because Linux CLOCK_MONOTONIC is one
boot-relative clock shared by every process on the host: segments
store RAW monotonic stamps and chrome_trace rebases everything to one
`base_monotonic` epoch (the engine tracer's, falling back to the
profiler's).

`validate_chrome_trace` is the schema check the tests (and `make
trace`) run over every emitted document, so "Perfetto accepts it" is an
asserted property, not a hope.
"""
from __future__ import annotations

import glob
import json
import os
import threading
import time
from collections import deque
from typing import List, Optional

from raftsql_tpu_torch.obs.spans import STAMPS

_ALLOWED_PH = {"X", "B", "E", "i", "I", "C", "M"}


def _meta(pid: int, name: str, tid: Optional[int] = None,
          tname: Optional[str] = None) -> List[dict]:
    out = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": name}}]
    if tid is not None:
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": tname or str(tid)}})
    return out


def chrome_trace(span_snapshot: Optional[dict] = None,
                 device_rows: Optional[List[dict]] = None,
                 tick_us: float = 1000.0, max_groups: int = 8,
                 phase_events: Optional[List[dict]] = None,
                 process_segments: Optional[List[dict]] = None,
                 base_monotonic: Optional[float] = None) -> dict:
    """Build the trace document from `SpanTracer.snapshot()` and/or
    `DeviceEventRing.rows()`, plus the tick-phase profiler's
    `events()` (`phase_events`) and per-process worker segments
    (`process_segments`, see collect_segments).  Any input may be
    None/empty — the document is always valid (an empty trace loads
    fine).  `base_monotonic` is the raw-monotonic epoch phase/segment
    stamps are rebased to (pass the span tracer's `t0` so every track
    family shares one time axis)."""
    events: List[dict] = []
    events += _meta(1, "raftsql spans")
    seen_groups = set()

    for sp in (span_snapshot or {}).get("spans", ()):
        g = sp["group"]
        if g not in seen_groups and len(seen_groups) < max_groups:
            seen_groups.add(g)
            events += _meta(1, "raftsql spans", tid=g,
                            tname=f"group {g}")[1:]
        ph = sp["phases"]
        stamps = [(name, ph[name]) for name in STAMPS if name in ph]
        for (a, ta), (b, tb) in zip(stamps, stamps[1:]):
            events.append({
                "name": f"{a}→{b}", "cat": "span", "ph": "X",
                "ts": ta, "dur": max(tb - ta, 0.0), "pid": 1, "tid": g,
                "args": {"index": sp["index"], "key": sp["key"]}})

    host_events = (span_snapshot or {}).get("events", ())
    if host_events:
        events += _meta(2, "raftsql host io", tid=0, tname="io")
        for ev in host_events:
            rec = {"name": ev["name"], "cat": "io", "ts": ev["ts"],
                   "pid": 2, "tid": 0, "args": ev.get("args", {})}
            if ev.get("dur", 0) > 0:
                rec.update(ph="X", dur=ev["dur"])
            else:
                rec.update(ph="i", s="t")
            events.append(rec)

    if device_rows:
        events += _meta(3, "raftsql device (tick axis)")
        P = len(device_rows[0]["commit"])
        G = min(len(device_rows[0]["commit"][0]), max_groups)
        for row in device_rows:
            ts = row["tick"] * tick_us
            for p in range(P):
                for g in range(G):
                    for field in ("commit", "inbox_depth", "votes"):
                        events.append({
                            "name": f"p{p}/g{g} {field}", "ph": "C",
                            "ts": ts, "pid": 3, "tid": 0,
                            "args": {"value": row[field][p][g]}})

    base = base_monotonic or 0.0

    def _rel_us(raw_s: float) -> float:
        return round(max((raw_s - base) * 1e6, 0.0), 1)

    if phase_events:
        events += _meta(4, "raftsql tick phases")
        tids: dict = {}
        for ev in phase_events:
            key = (ev["phase"], ev.get("tid", 0))
            tid = tids.get(key)
            if tid is None:
                tid = tids[key] = len(tids)
                tname = ev["phase"] if not ev.get("tid") \
                    else f"{ev['phase']} w{ev['tid']}"
                events += _meta(4, "raftsql tick phases", tid=tid,
                                tname=tname)[1:]
            events.append({
                "name": ev["phase"], "cat": "phase", "ph": "X",
                "ts": _rel_us(ev["t0"]),
                "dur": round(max(ev["dur"], 0.0) * 1e6, 1),
                "pid": 4, "tid": tid, "args": {"tick": ev["tick"]}})

    for seg in process_segments or ():
        pid = int(seg.get("pid", 0))
        if pid <= 4:        # never collide with the synthetic tracks
            continue
        events += _meta(pid, seg.get("name", f"pid {pid}"), tid=0,
                        tname="requests")
        for ev in seg.get("events", ()):
            rec = {"name": ev["name"], "cat": "proc",
                   "ts": _rel_us(ev["ts"]), "pid": pid,
                   "tid": int(ev.get("tid", 0)),
                   "args": ev.get("args", {})}
            dur = ev.get("dur", 0.0)
            if dur and dur > 0:
                rec.update(ph="X", dur=round(dur * 1e6, 1))
            else:
                rec.update(ph="i", s="t")
            events.append(rec)

    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# Cross-process trace segments (the --workers serving plane).


class TraceSegmentWriter:
    """Per-process trace segment: a bounded event ring a worker process
    stamps (pid/worker-id tagged) and flushes ATOMICALLY (tmp + rename)
    into the engine's ring directory, where the engine's /trace picks
    it up (collect_segments) and merges it into the single Perfetto
    timeline.  Timestamps are RAW monotonic seconds — one clock per
    host, so the engine can rebase them onto its own trace epoch.

    Bounded and crash-friendly: the ring caps memory, the atomic
    rename means a reader never sees a torn file, and the last flushed
    segment of a SIGKILLed worker stays on disk — its final moments
    remain on the merged timeline."""

    def __init__(self, dirname: str, name: str, tag: Optional[str] = None,
                 cap: int = 4096, flush_s: float = 0.5):
        os.makedirs(dirname, exist_ok=True)
        self.name = name
        self.pid = os.getpid()
        self.path = os.path.join(dirname,
                                 f"trace-seg-{tag or self.pid}.json")
        self.flush_s = flush_s
        self._events: deque = deque(maxlen=cap)
        self._mu = threading.Lock()
        self._dirty = False
        self._last_flush = 0.0

    def note(self, name: str, t_start: float, dur_s: float,
             tid: int = 0, **args) -> None:
        with self._mu:
            self._events.append({"name": name, "ts": t_start,
                                 "dur": dur_s, "tid": tid,
                                 "args": args})
            self._dirty = True

    def maybe_flush(self) -> None:
        """Flush when dirty and at least `flush_s` elapsed — cheap to
        call after every completion batch."""
        if self._dirty and time.monotonic() - self._last_flush \
                >= self.flush_s:
            self.flush()

    def flush(self) -> None:
        with self._mu:
            doc = {"pid": self.pid, "name": self.name,
                   "events": list(self._events)}
            self._dirty = False
        self._last_flush = time.monotonic()
        tmp = self.path + f".tmp{self.pid}"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f)
            os.replace(tmp, self.path)
        except OSError:       # diagnostics only — never fail the worker
            try:
                os.unlink(tmp)
            except OSError:
                pass


def collect_segments(dirname: str) -> List[dict]:
    """Every flushed per-process trace segment under `dirname`
    (unreadable/corrupt files skipped — a scrape must always render)."""
    out: List[dict] = []
    for path in sorted(glob.glob(os.path.join(dirname,
                                              "trace-seg-*.json"))):
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict) and isinstance(doc.get("events"), list):
            out.append(doc)
    return out


def validate_chrome_trace(doc: dict) -> None:
    """Raise ValueError unless `doc` is a well-formed Chrome trace-event
    JSON object: serializable, traceEvents a list, every event carrying
    a name, a known phase, a pid, and (for non-metadata phases) a
    non-negative numeric ts; complete events need a non-negative dur,
    counters a numeric value."""
    try:
        json.dumps(doc)
    except (TypeError, ValueError) as e:
        raise ValueError(f"trace not JSON-serializable: {e}") from e
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise ValueError("trace must be an object with a traceEvents list")
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise ValueError(f"event {i}: missing name")
        ph = ev.get("ph")
        if ph not in _ALLOWED_PH:
            raise ValueError(f"event {i}: bad phase {ph!r}")
        if "pid" not in ev:
            raise ValueError(f"event {i}: missing pid")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                raise ValueError(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: bad dur {dur!r}")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                raise ValueError(f"event {i}: counter needs numeric args")
