"""Entries committed (peer 0's publish count, NodeMetrics.commits) per
tick over the window: the propose/ack plane's batch."""
from portbench.metrics._common import per_tick


def read(snap: dict):
    return per_tick(snap, "commits")
