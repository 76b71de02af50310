"""Traffic-aware leadership placement (ROADMAP: placement item).

The PyTorch port's copy of the JAX package's module of the same path.

The telemetry plane measures per-group traffic (utils/metrics.py
GroupTraffic EWMA rates); the transfer plane can MOVE leadership
(thesis §3.10 TimeoutNow, runtime/hostplane.py / runtime/node.py
transfer_leadership).  This package closes the loop: a controller
thread that watches the traffic feed and issues graceful transfers to
balance hot groups across peers — and, on the mesh runtime, within
each group shard — with per-group retry/backoff and a recent-decision
log that flight bundles attach for attribution (obs/flight.py).
"""
from raftsql_tpu_torch.placement.controller import PlacementController

__all__ = ["PlacementController"]
