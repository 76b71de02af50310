"""Windowed commit-index advance and commit trajectories, in PyTorch.

Port of raftsql_tpu/ops/commit_scan.py:

  * `windowed_commit_index` and `masked_windowed_commit_index`: the full
    raft §5.3/§5.4.2 rule, which advances to the LARGEST ring-resident
    position n with commit < n <= quorum-match whose entry term equals
    the leader's current term, as one masked max over the W ring slots;

  * `running_commit` and `commit_latency_ticks` (ROADMAP K8): a prefix
    max of per-tick commit candidates over the tick axis, then the first
    tick at which each group reaches its target.  The bench reduces
    `core/cluster.py` `cluster_run`'s stacked infos with them on the
    device, so that only scalars cross to the host.  They are XLA in the
    JAX package, not Pallas: `torch.cummax` and a first-hit `argmax`.
"""
from __future__ import annotations

import torch

from raftsql_tpu_torch.ops.quorum import (masked_quorum_match_index,
                                          quorum_match_index)

I32 = torch.int32


def windowed_commit_index(match, log_term, log_len, commit, term,
                          is_leader, *, quorum: int, window: int):
    """[..., P] match + [..., W] term ring -> [...] advanced commit."""
    qmatch = quorum_match_index(match, quorum)
    return _windowed_from_qmatch(qmatch, log_term, log_len, commit, term,
                                 is_leader)


def masked_windowed_commit_index(match, log_term, log_len, commit, term,
                                 is_leader, *, voters, voters_joint,
                                 window: int, size=None):
    """The windowed rule with the joint-consensus ceiling: the min of the
    two masks' quorum indexes."""
    qmatch = torch.minimum(
        masked_quorum_match_index(match, voters, size),
        masked_quorum_match_index(match, voters_joint, size))
    return _windowed_from_qmatch(qmatch, log_term, log_len, commit, term,
                                 is_leader)


def _windowed_from_qmatch(qmatch, log_term, log_len, commit, term,
                          is_leader):
    W = log_term.shape[-1]
    slot = torch.arange(W, dtype=I32, device=log_term.device)
    # Log index resident in each slot: the unique n in (log_len - W,
    # log_len] with (n - 1) mod W == slot (floored mod, as in jnp).
    base = log_len[..., None] - 1
    n = base - torch.remainder(base - slot, W) + 1
    committable = (n > commit[..., None]) & (n <= qmatch[..., None]) \
        & (n >= 1) & (log_term == term[..., None])
    best = torch.where(committable, n, 0).amax(-1)
    ok = is_leader & (best > commit)
    return torch.where(ok, best, commit)


def running_commit(candidates: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Monotone prefix max over the tick axis: [T, ...] -> [T, ...]."""
    return torch.cummax(candidates, dim=axis).values


def commit_latency_ticks(traj: torch.Tensor,
                         targets: torch.Tensor) -> torch.Tensor:
    """First tick at which each group's commit reaches its target.

    traj: [T, G] monotone commit trajectory (from `running_commit`);
    targets: [G] log index per group.  Returns [G] int32: the first t
    with traj[t] >= target, or T where no tick reaches it."""
    T = traj.shape[0]
    hit = traj >= targets[None, :]                              # [T, G]
    # argmax takes no bool; like jnp.argmax it returns the first maximum.
    first = hit.to(I32).argmax(dim=0).to(I32)
    return torch.where(hit.any(dim=0), first, T)
