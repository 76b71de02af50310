"""The device step's host-clock time (dispatch + readback,
NodeMetrics.t_device_ms) per tick over the window."""
from portbench.metrics._common import per_tick


def read(snap: dict):
    return per_tick(snap, "t_device_ms")
