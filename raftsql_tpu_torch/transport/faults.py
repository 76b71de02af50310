"""Fault injection for the batched message plane, as tensor masks.

Port of raftsql_tpu/transport/faults.py.  Messages here are dense
tensors, so faults are *masks*: dropping a message zeroes its slot in
every Inbox leaf; partitioning a peer zeroes every slot to and from it.
Each function is a `torch.where` per leaf on the inbox's own device.
Masks may be given as numpy arrays or tensors; they are moved to the
inbox's device.  `random_drop` draws with the JAX package's threefry
(core/threefry.py), so a JAX key gives the same drops on both sides.
"""
from __future__ import annotations

import numpy as np
import torch

from raftsql_tpu_torch.core import threefry
from raftsql_tpu_torch.core.state import Inbox


def _mask(inbox: Inbox, m) -> torch.Tensor:
    return torch.as_tensor(m, dtype=torch.bool, device=inbox.v_type.device)


def drop_messages(inbox: Inbox, drop) -> Inbox:
    """Drop messages by mask.

    Args:
      inbox: stacked cluster inbox, leaves [P_dst, G, P_src, ...] (or a
        single peer's inbox [G, P_src, ...]).
      drop: bool mask broadcastable to [P_dst, G, P_src] (resp. [G, P_src]);
        True = the message in that slot is lost.
    """
    keep = ~_mask(inbox, drop)

    def mask(x: torch.Tensor) -> torch.Tensor:
        m = keep
        while m.dim() < x.dim():
            m = m[..., None]
        return torch.where(m, x, torch.zeros((), dtype=x.dtype,
                                             device=x.device))

    return Inbox(*[mask(x) for x in inbox])


def random_drop(inbox: Inbox, key, p_drop: float) -> Inbox:
    """Drop each message slot independently with probability p_drop.
    `key` is a JAX PRNG key's two uint32 words; the mask is
    `jax.random.bernoulli(key, p_drop, shape)`, drawn on the host."""
    shape = tuple(inbox.v_type.shape)  # [..., G, P_src]
    key = np.asarray(key).astype(np.uint32)
    return drop_messages(inbox, threefry.bernoulli(key, p_drop, shape))


def hold_messages(inbox: Inbox, hold) -> tuple[Inbox, Inbox]:
    """Split an inbox for DELAY injection: (delivered, held).

    `delivered` is the inbox with the held slots zeroed (they do not
    arrive this tick); `held` contains ONLY the held slots (everything
    else zeroed), to be re-injected into a later tick's inbox with
    `release_messages`.  Mask semantics match `drop_messages` (True =
    this slot is delayed).
    """
    hold = _mask(inbox, hold)
    return drop_messages(inbox, hold), drop_messages(inbox, ~hold)


def release_messages(inbox: Inbox, held: Inbox) -> Inbox:
    """Overlay previously-held message slots into a live inbox.

    A held slot wins where it actually carries a message (nonzero type
    code); per-slot the vote plane and the append plane overlay
    independently, mirroring the dense Inbox's two-slot schema.  Any
    same-slot message composed this tick is overwritten (raft tolerates
    both loss and reordering, so this is a legal adversarial schedule).
    """
    v_m = held.v_type != 0          # [.., G, P_src]
    a_m = held.a_type != 0

    def overlay(name: str, live: torch.Tensor,
                hld: torch.Tensor) -> torch.Tensor:
        m = v_m if name.startswith("v_") else a_m
        while m.dim() < live.dim():
            m = m[..., None]
        return torch.where(m, hld, live)

    return Inbox(*[overlay(n, getattr(inbox, n), getattr(held, n))
                   for n in Inbox._fields])


def asym_partition(inbox: Inbox, src: int, dst: int) -> Inbox:
    """One-directional partition of a stacked cluster inbox: `dst` stops
    hearing `src`, while `src` still hears `dst`.  inbox leaves are
    [P_dst, G, P_src, ...]; only row dst == `dst`, column src == `src`
    is zeroed."""
    P = inbox.v_type.shape[0]
    ar = torch.arange(P, device=inbox.v_type.device)
    drop = (ar == dst)[:, None, None] & (ar == src)[None, None, :]
    return drop_messages(inbox, drop.expand(inbox.v_type.shape))


def partition_peer(inbox: Inbox, peer: int) -> Inbox:
    """Isolate one peer of a stacked cluster inbox: nothing in, nothing
    out.  inbox leaves are [P_dst, G, P_src, ...]; row dst == peer and
    column src == peer are zeroed (a network partition of that peer in
    the reference's rafthttp topology, raft.go:180-184)."""
    P = inbox.v_type.shape[0]
    hit = torch.arange(P, device=inbox.v_type.device) == peer
    drop = hit[:, None, None] | hit[None, None, :]   # [P, 1, P]
    return drop_messages(inbox, drop.expand(inbox.v_type.shape))
