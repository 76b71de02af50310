"""Fused whole-cluster stepping: P peers x G groups in one tick, in PyTorch.

Port of raftsql_tpu/core/cluster.py.  All P peers' states are stacked on
a leading axis and stepped together by the batched `peer_step` (where the
JAX package vmapped it); messages are delivered by transposing the
outbox, src->dst becoming dst->src with one `transpose(0, 2)`.  The
multi-step dispatch and `cluster_run` are Python loops over the steps
(the JAX package's `lax.scan`).  No jit and no donation: each step
returns fresh tensors.  The entry points (`cluster_step_host`,
`cluster_multistep_host`, `cluster_run`) report their call signature
to core/signature.py while a tripwire is armed.
"""
from __future__ import annotations

from typing import Tuple

import torch

from raftsql_tpu_torch.config import MSG_REQ, MSG_RESP, RaftConfig
from raftsql_tpu_torch.core import signature
from raftsql_tpu_torch.core.state import (I32, Inbox, Outbox, PeerState,
                                          StepInfo, empty_inbox,
                                          init_peer_state)
from raftsql_tpu_torch.core.step import pack_info, peer_step


def _stack(tuples):
    return type(tuples[0])(*[torch.stack(xs) for xs in zip(*tuples)])


def init_cluster_state(cfg: RaftConfig, seed: int | None = None,
                       device="cuda") -> PeerState:
    """Stacked PeerState with a leading peers axis: every leaf [P, ...]."""
    return _stack([init_peer_state(cfg, p, seed, device)
                   for p in range(cfg.num_peers)])


def empty_cluster_inbox(cfg: RaftConfig, device="cuda") -> Inbox:
    return _stack([empty_inbox(cfg, device) for _ in range(cfg.num_peers)])


def deliver(outbox: Outbox) -> Inbox:
    """In-device message delivery: [src, G, dst, ...] -> [dst, G, src, ...]
    (views; the next step reads them strided)."""
    return Inbox(*[x.transpose(0, 2) for x in outbox])


def cluster_step(cfg: RaftConfig, states: PeerState, inboxes: Inbox,
                 prop_n: torch.Tensor, timer_inc: torch.Tensor | int = 1
                 ) -> Tuple[PeerState, Inbox, StepInfo]:
    """One tick for the whole co-located cluster.  prop_n [P, G];
    timer_inc a scalar or a per-peer [P] vector.  Returns (new_states,
    delivered inboxes for the next tick, stacked infos)."""
    dev = states.term.device
    P = cfg.num_peers
    self_ids = torch.arange(P, dtype=I32, device=dev)
    ti = torch.as_tensor(timer_inc, dtype=I32, device=dev).expand(P)
    new_states, outboxes, infos = peer_step(cfg, states, inboxes, prop_n,
                                            self_ids, timer_inc=ti)
    return new_states, deliver(outboxes), infos


def _busy(ib: Inbox) -> torch.Tensor:
    """Device-only protocol work the packed info cannot show: vote
    traffic, entry-carrying appends, rejected append responses."""
    return ((ib.v_type != 0).any()
            | ((ib.a_type == MSG_REQ) & (ib.a_n > 0)).any()
            | ((ib.a_type == MSG_RESP) & ~ib.a_success).any())


def cluster_step_host(cfg: RaftConfig, states: PeerState, inboxes: Inbox,
                      prop_n: torch.Tensor, timer_inc: torch.Tensor | int = 1):
    """Fused step for the durable co-located runtime (runtime/fused.py):
    returns (states, inboxes, packed [P, G, INFO_NCOLS] info, busy), with
    `busy` a 0-dim bool tensor on the device."""
    if signature.ARMED:
        signature.note("cluster_step_host", (cfg,),
                       (states, inboxes, prop_n, timer_inc))
    st, ib, infos = cluster_step(cfg, states, inboxes, prop_n, timer_inc)
    return st, ib, pack_info(infos), _busy(ib)


def cluster_multistep_host(cfg: RaftConfig, states: PeerState,
                           inboxes: Inbox, steps: int, prop_n: torch.Tensor,
                           timer_inc: torch.Tensor | int = 1):
    """`steps` fused steps in one dispatch: prop_n [S, P, G]; returns the
    packed infos stacked [S, P, G, INFO_NCOLS] and busy OR-reduced over
    the steps."""
    if signature.ARMED:
        signature.note("cluster_multistep_host", (cfg, steps),
                       (states, inboxes, prop_n, timer_inc))
    pinfos, busy = [], None
    for s in range(steps):
        states, inboxes, info = cluster_step(cfg, states, inboxes,
                                             prop_n[s], timer_inc)
        pinfos.append(pack_info(info))
        b = _busy(inboxes)
        busy = b if busy is None else busy | b
    return states, inboxes, torch.stack(pinfos), busy


def cluster_run(cfg: RaftConfig, states: PeerState, inboxes: Inbox,
                num_ticks: int, prop_n: torch.Tensor
                ) -> Tuple[PeerState, Inbox, StepInfo]:
    """`num_ticks` fused steps in lockstep; prop_n is [T, P, G].

    Returns the final states and inboxes and the per-tick infos, every
    leaf stacked [T, P, G, ...] as the JAX package's scan stacks them:
    the bench reduces those on the device (ops/commit_scan.py) so that
    only scalars cross to the host.  Under commit_rule="pallas" each
    tick launches K1 once (K2 once voter masks are live)."""
    if signature.ARMED:
        signature.note("cluster_run", (cfg, num_ticks),
                       (states, inboxes, prop_n))
    infos = []
    for t in range(num_ticks):
        states, inboxes, info = cluster_step(cfg, states, inboxes,
                                             prop_n[t])
        infos.append(info)
    return states, inboxes, _stack(infos)
