"""Arithmetic the metric readers share: window deltas of the program's
NodeMetrics counters, the client's latencies and the nearest-rank
percentile.  In a traced run
the ticks under torch.profiler are left out: `snap["capture"]` holds the
counters at the capture's edges and its seconds."""
from __future__ import annotations

import math


def delta(snap: dict, name: str) -> float:
    """A counter's growth over the window (its value at the window's
    close less its value at the open), less its growth under the
    profiler."""
    d = snap["node_close"][name] - snap["node_open"][name]
    cap = snap.get("capture")
    if cap:
        d -= cap["close"][name] - cap["open"][name]
    return d


def seconds(snap: dict) -> float:
    """The window's length less the capture's."""
    cap = snap.get("capture")
    return snap["window_s"] - (cap["s"] if cap else 0.0)


def per_tick(snap: dict, name: str):
    """A counter's window delta per tick of the window, None without a
    tick."""
    ticks = delta(snap, "ticks")
    return delta(snap, name) / ticks if ticks > 0 else None


def latencies_ms(snap: dict, ops, status: int) -> list:
    """The client's send-to-reply milliseconds of the window's requests
    of the kinds `ops` (portbench.reference.check's OP_*) answered
    `status`."""
    return [(r.t1 - r.t0) * 1e-6 for r in snap["requests"]
            if r.op in ops and r.status == status]


def p95(values):
    """The nearest-rank 95th percentile, None without a value."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]
