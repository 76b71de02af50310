"""The host plane's durable phase (WAL writes + fsync, NodeMetrics.
t_wal_ms) per tick over the window."""
from portbench.metrics._common import per_tick


def read(snap: dict):
    return per_tick(snap, "t_wal_ms")
