"""The window's length over its ticks (NodeMetrics.ticks), both less
the profiled ticks'."""
from portbench.metrics._common import delta, seconds


def read(snap: dict):
    ticks = delta(snap, "ticks")
    return seconds(snap) * 1e3 / ticks if ticks > 0 else None
