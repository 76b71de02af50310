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

import ctypes
from typing import Optional

import numpy as np
import torch

from raftsql_tpu_torch.core import signature
from raftsql_tpu_torch.core.cluster import (cluster_multistep_host,
                                            cluster_step_host)
from raftsql_tpu_torch.ops import pallas_quorum
from raftsql_tpu_torch.runtime.hostplane import ClusterHostPlane

__all__ = ["FusedClusterNode", "FusedPipe", "ClusterHostPlane"]


_driver: Optional[ctypes.PyDLL] = None


def _launch(graph_exec: int, stream: int) -> None:
    """Launch a graph with the CUDA driver's cuGraphLaunch while holding
    the interpreter lock (a ctypes.PyDLL call keeps it; CUDAGraph.replay
    releases it).  torch.profiler's stop holds the lock too, and a graph
    launched by another thread while it disables CUPTI's activity hangs
    both threads (shown on an H100 under torch 2.11.0+cu128): the lock
    keeps the two apart.  tests/test_torch_cuda.py
    test_profiler_stops_beside_a_ticking_graph runs the two threads; a
    torch release whose profiler stop drops the lock fails it.  Once
    that test passes with `graph.replay()` in place of this call, this
    launch path can go."""
    global _driver
    if _driver is None:
        lib = ctypes.PyDLL("libcuda.so.1")
        lib.cuGraphLaunch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.cuGraphLaunch.restype = ctypes.c_int
        _driver = lib
    rc = _driver.cuGraphLaunch(graph_exec, stream)
    if rc:
        raise RuntimeError(f"cuGraphLaunch failed: CUresult {rc}")


def _settle(bufs, new) -> list:
    """The copies that write step results `new` into the graph's buffers
    `bufs` (leaf for leaf), with every result that shares memory with a
    buffer other than its own cloned first, so no copy reads a buffer an
    earlier copy has already overwritten."""
    ptrs = {b.untyped_storage().data_ptr() for b in bufs}
    out = []
    for b, x in zip(bufs, new):
        if x is b:
            continue
        if x.untyped_storage().data_ptr() in ptrs:
            x = x.clone()
        out.append((b, x))
    return out


def step_key(cfg, steps: int, states, inboxes, prop_n, ti) -> tuple:
    """The step's call signature as its entry point records it
    (core/signature.py): a graph of the step is captured under it and
    replayed while the node's call keeps it."""
    return signature.signature_key((cfg,) if steps == 1 else (cfg, steps),
                                   (states, inboxes, prop_n, ti))


def restage(node, states, inboxes) -> bool:
    """Copy a state or inbox that host code rebound on `node` into the
    buffers `states` and `inboxes` (the same shapes and dtypes: the step
    key says so), and bind the buffers again.  Returns whether anything
    was rebound."""
    rebound = [(new, bufs) for new, bufs in ((node.states, states),
                                             (node.inboxes, inboxes))
               if new is not bufs]
    for new, bufs in rebound:
        for b, x in _settle(list(bufs), list(new)):
            b.copy_(x)
    node.states, node.inboxes = states, inboxes
    return bool(rebound)


class _StepGraph:
    """One capture of a node's step: the CUDA graph and the buffers it
    reads and writes.  `states` and `inboxes` hold the cluster state
    between ticks (every leaf contiguous, inbox leaves [dst, G, src,
    ...]); `prop_n` and `ti` are the step's inputs; `out` is the packed
    info flattened with the busy bit as its last word, and `pinfo` and
    `busy` its views.  `key` is the step key it was captured under
    (`step_key`); `launches` the quorum kernels
    the capture recorded, added to pallas_quorum.launches on every
    replay."""

    def __init__(self, node: "FusedClusterNode", prop_n: np.ndarray):
        self.cfg, self.steps = node.cfg, node._steps
        self.states = type(node.states)(
            *[x.contiguous().clone() for x in node.states])
        self.inboxes = type(node.inboxes)(
            *[x.contiguous().clone() for x in node.inboxes])
        dev = self.states.term.device
        self.prop_n = torch.zeros(prop_n.shape,
                                  dtype=torch.as_tensor(prop_n).dtype,
                                  device=dev)
        self.ti = torch.ones((self.cfg.num_peers,), dtype=torch.int32,
                             device=dev)
        self.ti_ones = True
        self.key = step_key(self.cfg, self.steps, self.states,
                            self.inboxes, self.prop_n, self.ti)
        bufs = list(self.states) + list(self.inboxes)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the server's other threads (event loop, apply,
        # publish workers) may call into CUDA while this one captures.
        with pallas_quorum.counting_capture() as counts, \
                torch.cuda.graph(self.graph, stream=torch.cuda.Stream(dev),
                                 capture_error_mode="thread_local"):
            st, ib, pinfo, busy = node._run(self.states, self.inboxes,
                                            self.prop_n, self.ti)
            for b, x in _settle(bufs, list(st) + list(ib)):
                b.copy_(x)
            self.out = torch.empty(pinfo.numel() + 1, dtype=torch.int32,
                                   device=dev)
            torch.cat([pinfo.reshape(-1), busy.reshape(1).to(torch.int32)],
                      out=self.out)
        self.launches = counts
        self.exec = self.graph.raw_cuda_graph_exec()
        self.device = dev
        self.n = pinfo.numel()
        self.pinfo = self.out[:self.n].view(pinfo.shape)
        self.busy = self.out[self.n:]


class FusedClusterNode(ClusterHostPlane):
    """The single-device durable runtime: ClusterHostPlane with the fused
    cluster step as its device program, including the multi-step
    dispatch (RAFTSQL_FUSED_STEPS) and the busy bit that drives idle
    parking.

    On a CUDA card the step is replayed as one CUDA graph.  The first
    tick, and the first after the config or the step count changed, runs
    eagerly: it loads the kernels and makes the allocator's first
    allocations.  The next captures the step (`_StepGraph`) and replays
    it, and every tick after copies its inputs in and replays.  From the
    capture on `self.states` and `self.inboxes` are the graph's buffers,
    so readers between ticks see the current state and in-place patches
    (membership, transfer) write the buffers.  A state, inbox or config
    that host code rebinds (chaos inbox rewrites, enable_membership) is
    noticed by identity before the next replay: while the step key stays
    the graph's, the leaves are copied into the buffers (`restage`), and
    otherwise the graph is dropped and the step warmed up and captured
    anew.  A CPU node steps eagerly."""

    # Steady-state [P] int32 lockstep advance of the eager step, built
    # once on the device, so the None and the skew branch hand the step
    # the same dtype and shape.
    _ti_ones = None
    _graph: Optional[_StepGraph] = None
    # (cfg, steps) of the last eager step on a card: the warm-up the
    # capture of that step follows.
    _warmed = None

    def _run(self, states, inboxes, pn, ti):
        if self._steps > 1:
            return cluster_multistep_host(self.cfg, states, inboxes,
                                          self._steps, pn, ti)
        return cluster_step_host(self.cfg, states, inboxes, pn, ti)

    def _eager_step(self, prop_n: np.ndarray,
                    timer_inc: Optional[np.ndarray]):
        dev = self.device
        if self._ti_ones is None:
            self._ti_ones = torch.ones((self.cfg.num_peers,),
                                       dtype=torch.int32, device=dev)
        ti = self._ti_ones if timer_inc is None \
            else torch.as_tensor(np.asarray(timer_inc, np.int32),
                                 device=dev)
        pn = torch.as_tensor(prop_n, device=dev)
        self.states, self.inboxes, pinfo_dev, busy = self._run(
            self.states, self.inboxes, pn, ti)
        self.metrics.eager_steps += 1
        return pinfo_dev, busy

    def _device_step(self, prop_n: np.ndarray,
                     timer_inc: Optional[np.ndarray] = None):
        """Dispatch one cluster step; returns (packed-info device tensor,
        device busy bit).  `timer_inc` is the per-peer [P] timer advance
        (None = lockstep 1s)."""
        if self.device.type != "cuda":
            return self._eager_step(prop_n, timer_inc)
        g = self._graph
        if g is not None and not (
                self.states is g.states and self.inboxes is g.inboxes
                and self.cfg is g.cfg and self._steps == g.steps):
            if step_key(self.cfg, self._steps, self.states, self.inboxes,
                        g.prop_n, g.ti) != g.key:
                g = self._graph = None
            else:
                g.cfg = self.cfg
                if restage(self, g.states, g.inboxes):
                    self.metrics.graph_restages += 1
        if g is None:
            if self._warmed != (self.cfg, self._steps):
                self._warmed = (self.cfg, self._steps)
                return self._eager_step(prop_n, timer_inc)
            g = self._graph = _StepGraph(self, prop_n)
            self.states, self.inboxes = g.states, g.inboxes
            self.metrics.graph_captures += 1
        g.prop_n.copy_(torch.from_numpy(prop_n))
        if timer_inc is not None:
            g.ti.copy_(torch.from_numpy(np.asarray(timer_inc, np.int32)))
            g.ti_ones = False
        elif not g.ti_ones:
            g.ti.fill_(1)
            g.ti_ones = True
        _launch(g.exec, torch.cuda.current_stream(g.device).cuda_stream)
        pallas_quorum.count_replay(g.launches)
        self.metrics.graph_replays += 1
        return g.pinfo, g.busy

    def _readback(self, pinfo_dev: torch.Tensor,
                  busy_dev: Optional[torch.Tensor]):
        """A replay's packed info and busy bit are one buffer, read back
        whole by ClusterHostPlane._readback: one device-to-host copy a
        dispatch, as for an eager step."""
        g = self._graph
        if g is None or pinfo_dev is not g.pinfo:
            return ClusterHostPlane._readback(pinfo_dev, busy_dev)
        flat, _ = ClusterHostPlane._readback(g.out, None)
        return flat[:g.n].reshape(g.pinfo.shape), bool(flat[g.n])


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
