"""FusedClusterNode — the durable co-located deployment, on a GPU.

Port of raftsql_tpu/runtime/fused.py.  All P peers x G groups advance in
one fused cluster step per tick (core/cluster.py), messages delivered by
an on-device transpose, and the host crosses the boundary once per tick
with a packed StepInfo.  The durable host phase — propose queues, WAL +
payload-log writes, the fsync barrier, publish — is the shared
ClusterHostPlane (runtime/hostplane.py); this class only dispatches the
device step.

Durability keeps the reference's per-batch contract (raft.go:227-235:
wal.Save -> transport.Send -> publish) with the dispatch itself as the
send barrier: messages composed at tick t are observed by their
receivers only inside step t+1, and the host does not dispatch step t+1
until every peer's tick-t appends and hard states are fsynced.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from raftsql_tpu_torch.core.cluster import (cluster_multistep_host,
                                            cluster_step_host)
from raftsql_tpu_torch.runtime.hostplane import ClusterHostPlane

__all__ = ["FusedClusterNode", "FusedPipe", "ClusterHostPlane"]


class FusedClusterNode(ClusterHostPlane):
    """The single-device durable runtime: ClusterHostPlane with the fused
    cluster step as its device program, including the multi-step
    dispatch (RAFTSQL_FUSED_STEPS) and the busy bit that drives idle
    parking."""

    # Steady-state [P] int32 lockstep advance, built once on the device,
    # so the None and the skew branch hand the step the same dtype and
    # shape (a CUDA-graph capture of the step would need that too).
    _ti_ones = None

    def _device_step(self, prop_n: np.ndarray,
                     timer_inc: Optional[np.ndarray] = None):
        """Dispatch one cluster step; returns (packed-info device tensor,
        device busy bit).  `timer_inc` is the per-peer [P] timer advance
        (None = lockstep 1s)."""
        dev = self.device
        if self._ti_ones is None:
            self._ti_ones = torch.ones((self.cfg.num_peers,),
                                       dtype=torch.int32, device=dev)
        ti = self._ti_ones if timer_inc is None \
            else torch.as_tensor(np.asarray(timer_inc, np.int32),
                                 device=dev)
        pn = torch.as_tensor(prop_n, device=dev)
        if self._steps > 1:
            self.states, self.inboxes, pinfos_dev, busy = \
                cluster_multistep_host(self.cfg, self.states,
                                       self.inboxes, self._steps, pn, ti)
            return pinfos_dev, busy
        self.states, self.inboxes, pinfo_dev, busy = cluster_step_host(
            self.cfg, self.states, self.inboxes, pn, ti)
        return pinfo_dev, busy


class FusedPipe:
    """The propose/commit/error facade (reference raftpipe.go:3-17) over
    a ClusterHostPlane runtime, so the whole SQL stack above consensus —
    RaftDB ack routing, HTTP API, CLI — serves from the co-located
    runtime unchanged.  Peer 0's commit stream is the apply plane."""

    def __init__(self, node: ClusterHostPlane):
        self.node = node
        # This facade is the only consumer and it reads peer 0's
        # stream; skip materializing the other peers' publishes.
        node.publish_peers = {0}
        self.commit_q = node.commit_q(0)

    def propose(self, group: int, payload: bytes,
                pid: Optional[int] = None,
                deadline_step: Optional[int] = None,
                t_parsed: Optional[float] = None) -> None:
        # `pid` (client retry token) is accepted for facade parity and
        # dropped: fused proposals are routed on the host and never
        # forward-retried, so payloads travel plain.  `deadline_step`
        # (overload plane, device-step units) rides to the hostplane so
        # expired work is shed before staging; `t_parsed` to its span
        # tracer.
        self.node.propose_many(group, [payload],
                               deadline_step=deadline_step,
                               t_parsed=t_parsed)

    @property
    def error(self) -> Optional[Exception]:
        return self.node.error

    def close(self) -> Optional[Exception]:
        self.node.stop()
        return self.node.error
