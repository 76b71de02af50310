"""Tick-phase profiler: where does a tick's wall time actually go?

`NodeMetrics.phase_ms_per_tick` is a running AVERAGE — it can say "wal
is 40% of the tick" but not "fsync p99 spiked 20x for 50 ticks while
p50 held", which is exactly the shape a serving regression takes.  This
module is the per-phase distribution layer between that average and the
full span tracer: monotonic-clock stamps around each phase of the host
plane's tick —

    pop        proposal pop/stage (_build_prop_n + _stage_ranges)
    dispatch   the enqueue of the device step
    readback   the wait for the step and its packed-info readback
    wal_write  WAL entry/hardstate writes (the durable phase minus fsync)
    fsync      the per-peer fsync barrier
    publish    commit delivery to the apply plane
    ring_drain the serving plane's propose-ring drain batches

— ring-buffered per phase (pre-allocated numpy arrays, no allocation
on the hot path, one small lock per record) and exported as p50/p95/p99
phase histograms in `GET /metrics` (`phase_profile`, and as a
Prometheus summary `raftsql_tick_phase_ms{phase=...}` under
`?format=prom`) plus per-phase Perfetto tracks in `GET /trace`.

OVERLAP-AWARE ATTRIBUTION: under double-buffered dispatch
(runtime/hostplane.py, default on) tick t's stashed durable phase
retires inside tick t+1's device window.  Every sample carries the
tick that OWNS the work — the stash remembers its originating tick and
the publish queue items carry theirs — so a phase histogram keyed by
tick is identical whether the pipeline overlaps or not (pinned by
tests/test_obs.py's attribution test).

Default **on** (the per-tick cost is ~10 monotonic reads and ~8 ring
writes, whatever the number of groups): RAFTSQL_PROF=0 disables it.
`raw()` copies the rings as they stand (cheap enough inside a measured
window); obs/timeline.py reads them against a device capture.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np

# Phases that partition the tick thread's wall time; ring_drain runs on
# the serving plane's drain threads and is reported but excluded from
# the tick-share denominators.
PROF_PHASES = ("pop", "dispatch", "readback", "wal_write", "fsync",
               "publish", "ring_drain")
TICK_PHASES = PROF_PHASES[:-1]


class TickPhaseProfiler:
    """Per-phase duration rings + totals (see module docstring).

    record() is safe from any thread (tick thread, publish workers,
    ring drains); everything is pre-allocated at construction."""

    def __init__(self, cap: int = 4096):
        n = len(PROF_PHASES)
        self.cap = cap
        self.epoch = time.monotonic()
        self._i: Dict[str, int] = {p: k for k, p in enumerate(PROF_PHASES)}
        self._dur = np.zeros((n, cap), np.float64)      # seconds
        self._t0 = np.zeros((n, cap), np.float64)       # raw monotonic s
        self._tick = np.full((n, cap), -1, np.int64)    # owning tick
        self._tid = np.zeros((n, cap), np.int32)        # worker/shard id
        self._pos = [0] * n
        self._count = [0] * n
        self._total = [0.0] * n
        self._mu = threading.Lock()

    @classmethod
    def from_env(cls) -> Optional["TickPhaseProfiler"]:
        """The default-on constructor the host plane uses; RAFTSQL_PROF=0
        turns the profiler off."""
        if os.environ.get("RAFTSQL_PROF", "1") == "0":
            return None
        return cls()

    def record(self, phase: str, tick_no: int, t_start: float,
               dur_s: float, tid: int = 0) -> None:
        k = self._i[phase]
        with self._mu:
            j = self._pos[k]
            self._dur[k, j] = dur_s
            self._t0[k, j] = t_start
            self._tick[k, j] = tick_no
            self._tid[k, j] = tid
            self._pos[k] = (j + 1) % self.cap
            self._count[k] += 1
            self._total[k] += dur_s

    # -- export ---------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-ready per-phase histograms over the ring window:
        {phase: {p50_ms, p95_ms, p99_ms, max_ms, n, total_ms}}.  Sorting
        happens OUTSIDE the lock (the scrape must never stall the tick
        thread's record)."""
        with self._mu:
            durs = self._dur.copy()
            ticks = self._tick.copy()
            counts = list(self._count)
            totals = list(self._total)
        out: dict = {}
        for p, k in self._i.items():
            if not counts[k]:
                continue
            valid = durs[k][ticks[k] >= 0]
            valid.sort()
            n = valid.size

            def q(f):
                return round(float(valid[min(int(f * n), n - 1)]) * 1e3,
                             4)

            out[p] = {"p50_ms": q(0.5), "p95_ms": q(0.95),
                      "p99_ms": q(0.99),
                      "max_ms": round(float(valid[-1]) * 1e3, 4),
                      "n": counts[k],
                      "total_ms": round(totals[k] * 1e3, 3)}
        return out

    def shares(self) -> dict:
        """Each tick phase's share of the total profiled tick time —
        the one-line "why did this rung move" summary the durable bench
        records (fsync-share vs dispatch-share vs publish-share)."""
        with self._mu:
            totals = {p: self._total[self._i[p]] for p in TICK_PHASES}
        denom = sum(totals.values())
        if denom <= 0:
            return {f"{p}_share": 0.0 for p in TICK_PHASES}
        return {f"{p}_share": round(v / denom, 4)
                for p, v in totals.items()}

    def phase_ticks(self, phase: str) -> List[int]:
        """Sorted distinct tick ids holding samples of `phase` (the
        attribution test's probe)."""
        k = self._i[phase]
        with self._mu:
            t = self._tick[k].copy()
        return sorted(set(int(x) for x in t[t >= 0]))

    def raw(self) -> Dict[str, tuple]:
        """Copies of the rings: {phase: (t0, dur, tick, tid)} arrays of
        the recorded samples in ring order (RAW monotonic seconds)."""
        with self._mu:
            durs = self._dur.copy()
            t0s = self._t0.copy()
            ticks = self._tick.copy()
            tids = self._tid.copy()
        out = {}
        for p, k in self._i.items():
            m = ticks[k] >= 0
            out[p] = (t0s[k][m], durs[k][m], ticks[k][m], tids[k][m])
        return out

    def events(self, last: int = 2048) -> List[dict]:
        """The ring window as Perfetto-ready phase events (newest-last,
        RAW monotonic start seconds — the caller rebases to its trace
        epoch): {"phase", "tick", "t0", "dur", "tid"}."""
        evs: List[dict] = []
        for p, (t0s, durs, ticks, tids) in self.raw().items():
            for t0, d, tk, td in zip(t0s, durs, ticks, tids):
                evs.append({"phase": p, "tick": int(tk),
                            "t0": float(t0), "dur": float(d),
                            "tid": int(td)})
        evs.sort(key=lambda e: e["t0"])
        return evs[-last:]
