"""Carry device state between the JAX package and the port as numpy.

Boot states need no conversion (the port draws the JAX package's
threefry draws from the same seed); this carries any other state across
leaf by leaf: a JAX state mid-run into the port, or a port state between
devices.  Dicts are keyed by the JAX field names; `rng` crosses as its
two uint32 key words (held as int32 bit patterns in the port).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raftsql_tpu_torch.core.state import Inbox, PeerState, resolve_device


def _leaf(name: str, arr, dev: torch.device) -> torch.Tensor:
    a = np.asarray(arr)
    if name == "rng":
        a = a.astype(np.uint32).view(np.int32)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def peer_state_from_numpy(d: dict, device="cuda") -> PeerState:
    dev = resolve_device(device)
    return PeerState(**{n: _leaf(n, d[n], dev) for n in PeerState._fields})


def inbox_from_numpy(d: dict, device="cuda") -> Inbox:
    dev = resolve_device(device)
    return Inbox(**{n: _leaf(n, d[n], dev) for n in Inbox._fields})


def to_numpy(tup: NamedTuple) -> dict:
    """NamedTuple of tensors -> {field: numpy array}; rng back to uint32."""
    out = {}
    for n, v in tup._asdict().items():
        a = v.detach().cpu().numpy()
        out[n] = a.view(np.uint32) if n == "rng" else a
    return out
