"""The card's activities and the tick thread's phases on one clock.

torch.profiler stamps a capture's device activities (kineto's
`start_ns()`/`end_ns()`) on a host clock of its own: CLOCK_REALTIME on
the torch builds the port runs, CLOCK_MONOTONIC on others.  The
tick-phase profiler (obs/prof.py) and the span tracer (obs/spans.py)
stamp `time.monotonic()`.  This module puts the device activities on
`time.monotonic()` and reads them against the tick thread's phases:

- `clock_pair()`, read at a capture's open and close, and
  `profiler_offset_ns(stamp, pairs)`: what to add to a profiler stamp to
  put it on `time.monotonic_ns()`, the clock told apart by which of the
  two a stamp of the capture lies near.
- `tick_phases(prof.raw())`: the tick thread's phases as disjoint
  intervals (tid 0; publish workers and ring drains run elsewhere).
- `idle_gaps(...)`: the longest stretches with no device activity, found
  and timed exactly as before, each named by the phase that covered
  most of it ("between ticks" where none did), then its tick, then the
  device ops on either side.
- `idle_split(...)`: a window's idle seconds by covering phase;
  `IN_STEP` are the phases of the device step itself.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Sequence, Tuple

from raftsql_tpu_torch.obs.prof import TICK_PHASES

BETWEEN = "between ticks"
IN_STEP = ("dispatch", "readback")
_FAR_NS = 3600 * 10 ** 9        # a stamp this far from both clocks: neither


def clock_pair() -> Tuple[int, int]:
    """(time.monotonic_ns(), time.time_ns()): the realtime read taken
    between two monotonic reads, whose mean it is paired with."""
    m0 = time.monotonic_ns()
    r = time.time_ns()
    m1 = time.monotonic_ns()
    return (m0 + m1) // 2, r


def profiler_offset_ns(stamp_ns: int, pairs: Sequence[tuple]) -> int:
    """Nanoseconds to add to a profiler stamp of the capture that
    `pairs` (clock_pair() reads at its open and close) bracket, to put
    it on time.monotonic_ns().  Raises when `stamp_ns` lies near
    neither clock."""
    m, r = pairs[0]
    if abs(stamp_ns - m) <= _FAR_NS:
        return 0
    if abs(stamp_ns - r) <= _FAR_NS:
        return sum(m - r for m, r in pairs) // len(pairs)
    raise ValueError(f"profiler stamp {stamp_ns} lies near neither "
                     f"CLOCK_MONOTONIC ({m}) nor CLOCK_REALTIME ({r})")


def tick_phases(raw: Dict[str, tuple]) -> List[tuple]:
    """The tick thread's phase samples of `TickPhaseProfiler.raw()` as
    disjoint (start_s, end_s, phase, tick) intervals, sorted: a sample
    starting inside an earlier one is cut to start at its end."""
    out = []
    for p in TICK_PHASES:
        t0s, durs, ticks, tids = raw.get(p, ((), (), (), ()))
        for t0, d, tk, td in zip(t0s, durs, ticks, tids):
            if td == 0 and d > 0:
                out.append((float(t0), float(t0 + d), p, int(tk)))
    out.sort()
    cut, end = [], float("-inf")
    for s, e, p, tk in out:
        s = max(s, end)
        if e > s:
            cut.append((s, e, p, tk))
            end = e
    return cut


def _cover(a: float, b: float, phases: List[tuple],
           starts: List[float]) -> Tuple[Dict[str, float], dict]:
    """Seconds of [a, b] under each phase of the disjoint `phases`
    (BETWEEN for the rest), and per phase the tick of its interval
    covering most of it."""
    got: Dict[str, float] = {}
    tick: Dict[str, tuple] = {}
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    while i < len(phases) and phases[i][0] < b:
        s, e, p, tk = phases[i]
        o = min(b, e) - max(a, s)
        if o > 0:
            got[p] = got.get(p, 0.0) + o
            if o > tick.get(p, (0.0,))[0]:
                tick[p] = (o, tk)
        i += 1
    got[BETWEEN] = max((b - a) - sum(got.values()), 0.0)
    return got, {p: tk for p, (_, tk) in tick.items()}


def _label(a: float, b: float, phases: List[tuple], starts: List[float],
           text: str) -> str:
    got, tick = _cover(a, b, phases, starts)
    phase = max(got, key=got.get)
    if phase != BETWEEN:
        return f"{phase} tick {tick[phase]}: {text}"
    i = bisect.bisect_right(starts, a) - 1
    if i < 0:
        return f"{BETWEEN}: {text}"
    return f"{BETWEEN} after tick {phases[i][3]}: {text}"


def idle_gaps(events: Sequence[tuple], phases: List[tuple],
              offset_ns: int, top: int = 10) -> List[list]:
    """The `top` longest stretches with no device activity among
    `events` ((start_ns, end_ns, name) on the profiler's clock), longest
    first, as [label, seconds]: the gaps and their seconds are those
    `portbench/device.py` `summarize` finds; the label leads with the
    tick phase (`phases`, from `tick_phases`) that covered most of the
    gap once `offset_ns` puts it on time.monotonic()."""
    starts = [iv[0] for iv in phases]
    spans = sorted(events)
    gaps, end, prev = [], None, None
    for s, t, name in spans:
        if end is not None and s > end:
            gaps.append((s - end, end, s, prev, name))
        if end is None or t > end:
            end, prev = t, name
    gaps.sort(key=lambda g: -g[0])
    return [[_label((a + offset_ns) * 1e-9, (b + offset_ns) * 1e-9,
                    phases, starts,
                    f"after {before[:40]}, before {after[:40]}"),
             dur * 1e-9]
            for dur, a, b, before, after in gaps[:top]]


def idle_split(events: Sequence[tuple], phases: List[tuple],
               offset_ns: int, w0: float, w1: float) -> Dict[str, float]:
    """Seconds of [w0, w1] (time.monotonic()) with no device activity,
    by the tick phase covering them (BETWEEN where none did); the values
    sum to the window's idle seconds."""
    starts = [iv[0] for iv in phases]
    busy = sorted(((s + offset_ns) * 1e-9, (t + offset_ns) * 1e-9)
                  for s, t, _ in events)
    out: Dict[str, float] = {p: 0.0 for p in TICK_PHASES}
    out[BETWEEN] = 0.0
    at = w0
    for s, t in busy + [(w1, w1)]:
        s, t = min(max(s, w0), w1), min(t, w1)
        if s > at:
            got, _ = _cover(at, s, phases, starts)
            for p, v in got.items():
                out[p] += v
        at = max(at, t)
        if at >= w1:
            break
    return out
