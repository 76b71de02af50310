"""Call signatures of the port's step entry points.

The JAX package's jit cache gives every distinct trace signature of an
entry point its own compiled program; a second signature reaching a
steady-state entry point mid-run is a recompile under the leader's
election timer (raftsql_tpu/analysis/tripwire.py).  The port runs eager
and has no such cache, so its ground truth is the signatures the entry
points are called with: the key a CUDA graph of the step is captured
under, and what analysis/tripwire.py `SignatureTripwire` counts.

A key holds, per argument, `(shape, dtype, device)` of every tensor leaf
(NamedTuple states and inboxes are walked leaf by leaf), the type of
every Python scalar, `None` for None, and the value itself of each
static argument (a new `cfg` or step count is a new program in JAX
too).  Recording runs only while a tripwire is armed: otherwise an entry
point pays one check of `ARMED`.
"""
from __future__ import annotations

from typing import Dict, List, Set

import torch

# The four entry points; each passes its static arguments (the JAX
# package's static_argnums of the same function) to `note` by value.
ENTRY_POINTS = ("cluster_step_host", "cluster_multistep_host",
                "cluster_run", "peer_step_packed")

# The armed recorders: each is a dict entry name -> set of keys.
ARMED: List[Dict[str, Set[tuple]]] = []


def leaf_key(x):
    """The signature of one argument."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype), str(x.device))
    if isinstance(x, (tuple, list)):
        return (type(x).__name__,) + tuple(leaf_key(v) for v in x)
    return type(x).__name__


def signature_key(static: tuple, args: tuple) -> tuple:
    """The key of one call: the static arguments by value, every other
    argument by `leaf_key`."""
    return (static, tuple(leaf_key(a) for a in args))


def note(entry: str, static: tuple, args: tuple) -> None:
    """Add one call's key to every armed recorder (the caller checks
    ARMED first)."""
    key = signature_key(static, args)
    for seen in ARMED:
        seen.setdefault(entry, set()).add(key)
