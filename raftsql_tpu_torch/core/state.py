"""Struct-of-arrays raft state for one peer across all groups, as tensors.

Port of raftsql_tpu/core/state.py.  The leaves, their order and their
dtypes are the JAX package's (int32 and bool), with one exception of
representation: `rng` holds the two uint32 key words as int32 bit
patterns (torch has no full uint32 arithmetic; ops/dense.py
election_jitter widens them to int64).  Every function here accepts
leaves with any leading batch shape: the fused cluster stacks P peers
on a leading axis ([P, G, ...]) where the JAX package used vmap.

All log positions are 1-based: index 0 is the sentinel "before the log"
position with term 0.  The on-device log keeps only entry terms in a
ring of capacity W; payloads live host-side in storage/log.py.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raftsql_tpu_torch.config import (FOLLOWER, NO_LEADER, NO_VOTE, NO_XFER,
                                      RaftConfig)
from raftsql_tpu_torch.core import threefry

I32 = torch.int32
B = torch.bool
INT32_MAX = 2 ** 31 - 1


def resolve_device(device="cuda") -> torch.device:
    """The explicit device of an entry point.  A CUDA device that is not
    there raises: the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


def host_copy(flat: torch.Tensor) -> np.ndarray:
    """A 1-D device tensor as numpy in ONE device-to-host copy: into
    freshly allocated pinned memory on CUDA (PyTorch's caching host
    allocator takes the block back once every numpy view of it is
    gone), the tensor itself on the CPU (`flat` must then be a fresh
    tensor nothing else writes)."""
    if flat.device.type == "cuda":
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        torch.cuda.current_stream(flat.device).synchronize()
        return host.numpy()
    return flat.numpy()


class PeerState(NamedTuple):
    """Raft state of ONE peer, batched over G groups (see the JAX
    package's PeerState for each field's meaning).  Shapes [G] unless
    noted; a stacked cluster prefixes every leaf with [P]."""

    term: torch.Tensor          # [G] i32
    voted_for: torch.Tensor     # [G] i32
    role: torch.Tensor          # [G] i32
    leader_hint: torch.Tensor   # [G] i32
    commit: torch.Tensor        # [G] i32
    log_len: torch.Tensor       # [G] i32
    log_term: torch.Tensor      # [G, W] i32 ring (or [G, 1] stub)
    tbl_pos: torch.Tensor       # [G, K] i32
    tbl_term: torch.Tensor      # [G, K] i32
    elapsed: torch.Tensor       # [G] i32
    timeout: torch.Tensor       # [G] i32
    hb_elapsed: torch.Tensor    # [G] i32
    votes: torch.Tensor         # [G, P] bool
    match: torch.Tensor         # [G, P] i32
    next_idx: torch.Tensor      # [G, P] i32
    voters: torch.Tensor        # [G, P] bool
    voters_joint: torch.Tensor  # [G, P] bool
    resp_tick: torch.Tensor     # [G, P] i32
    xfer_target: torch.Tensor   # [G] i32
    rng: torch.Tensor           # [2] i32: the uint32 key words, bit for bit
    tick: torch.Tensor          # [] i32


class Inbox(NamedTuple):
    """Dense per-source message slots delivered to one peer: a vote slot
    and an append slot per (group, source), [G, P] (+ [G, P, E])."""

    v_type: torch.Tensor
    v_term: torch.Tensor
    v_last_idx: torch.Tensor
    v_last_term: torch.Tensor
    v_granted: torch.Tensor     # bool
    a_type: torch.Tensor
    a_term: torch.Tensor
    a_prev_idx: torch.Tensor
    a_prev_term: torch.Tensor
    a_n: torch.Tensor
    a_ents: torch.Tensor        # [G, P, E]
    a_commit: torch.Tensor
    a_success: torch.Tensor     # bool
    a_match: torch.Tensor


# The outbox has the same schema, indexed [G, dst] instead of [G, src].
Outbox = Inbox


class StepInfo(NamedTuple):
    """Host-facing observations from one step (all [G] unless noted)."""

    commit: torch.Tensor
    role: torch.Tensor
    term: torch.Tensor
    voted_for: torch.Tensor
    leader_hint: torch.Tensor
    prop_base: torch.Tensor
    prop_accepted: torch.Tensor
    noop: torch.Tensor          # bool
    app_from: torch.Tensor
    app_start: torch.Tensor
    app_n: torch.Tensor
    app_conflict: torch.Tensor  # bool
    new_log_len: torch.Tensor
    lease: torch.Tensor
    xfer: torch.Tensor
    next_idx: torch.Tensor      # [G, P]
    floor: torch.Tensor
    timer_margin: torch.Tensor  # []


def init_peer_state(cfg: RaftConfig, self_id: int, seed: int | None = None,
                    device="cuda") -> PeerState:
    """Fresh boot state (empty log, term 0, follower everywhere), with
    election timeouts drawn per group in [election_ticks,
    2*election_ticks) and two key words for the jitter hash.  The draws
    are the JAX package's threefry draws (core/threefry.py), made on
    the host: fold_in(PRNGKey(seed), self_id), split, randint — so a
    node booted with `seed` here equals the JAX package's node booted
    with `seed`, on any device."""
    dev = resolve_device(device)
    g, p, w = cfg.num_groups, cfg.num_peers, cfg.log_window
    seed = cfg.seed if seed is None else seed
    key = threefry.fold_in(threefry.prng_key(seed), self_id)
    key, sub = threefry.split(key)
    timeout = torch.from_numpy(threefry.randint(
        sub, (g,), cfg.election_ticks, 2 * cfg.election_ticks))
    rng = torch.from_numpy(key.view(np.int32).copy())
    voters = torch.as_tensor(initial_voter_row(cfg)).expand(g, p)
    z = lambda *s: torch.zeros(s, dtype=I32, device=dev)  # noqa: E731
    full = lambda s, v: torch.full(s, v, dtype=I32, device=dev)  # noqa: E731
    return PeerState(
        term=z(g),
        voted_for=full((g,), NO_VOTE),
        role=full((g,), FOLLOWER),
        leader_hint=full((g,), NO_LEADER),
        commit=z(g),
        log_len=z(g),
        log_term=z(g, w if cfg.keep_ring else 1),
        tbl_pos=z(g, cfg.term_table_slots),
        tbl_term=z(g, cfg.term_table_slots),
        elapsed=z(g),
        timeout=timeout.to(dev),
        hb_elapsed=z(g),
        votes=torch.zeros((g, p), dtype=B, device=dev),
        match=z(g, p),
        next_idx=torch.ones((g, p), dtype=I32, device=dev),
        voters=voters.to(dev).clone(),
        voters_joint=voters.to(dev).clone(),
        resp_tick=z(g, p),
        xfer_target=full((g,), NO_XFER),
        rng=rng.to(dev),
        tick=torch.zeros((), dtype=I32, device=dev),
    )


def initial_voter_row(cfg: RaftConfig) -> np.ndarray:
    """[P] bool numpy row of cfg's boot-time voter set (all True when
    cfg.initial_voters is None)."""
    p = cfg.num_peers
    if cfg.initial_voters is None:
        return np.ones((p,), bool)
    row = np.zeros((p,), bool)
    row[list(cfg.initial_voters)] = True
    return row


def witness_row(cfg: RaftConfig) -> np.ndarray:
    """[P] bool numpy row of cfg's witness slots (all False by default)."""
    row = np.zeros((cfg.num_peers,), bool)
    if cfg.witnesses:
        row[list(cfg.witnesses)] = True
    return row


def _set_config(states: PeerState, at: tuple, voters_row, joint_row,
                self_is_voter: bool) -> PeerState:
    """Write one (peer row, group)'s masks in place; `at` indexes the
    leading axes ((g,) or (p, g)).  A row the new config leaves without
    a vote drops to follower if it led or campaigned: the condition is
    evaluated on the device (torch.where), so a patch never syncs."""
    dev = states.voters.device
    states.voters[at] = torch.as_tensor(np.asarray(voters_row, bool),
                                        device=dev)
    states.voters_joint[at] = torch.as_tensor(np.asarray(joint_row, bool),
                                              device=dev)
    if not self_is_voter:
        demote = states.role[at] != FOLLOWER
        states.role[at] = torch.where(demote, FOLLOWER, states.role[at])
        states.leader_hint[at] = torch.where(demote, NO_LEADER,
                                             states.leader_hint[at])
        states.votes[at] = states.votes[at] & ~demote
    return states


def set_group_config(state: PeerState, g: int, voters_row, joint_row,
                     self_is_voter: bool) -> PeerState:
    """Patch group `g`'s active configuration into one peer's masks, in
    place (the JAX package's set_group_config, which donates its input).

    Called by the host membership plane when a conf-change log entry
    applies at commit (two-phase joint style: C_old,new sets voters=new
    and voters_joint=old; C_new sets both to new).  A leader or
    candidate that `self_is_voter` says has no vote in the new config
    steps down to follower with its tally cleared (raft §6: it led long
    enough to commit its own removal); core/step.py gates election
    timeouts on the mask, so it never campaigns again.  Returns
    `state`, whose leaves were written in place."""
    return _set_config(state, (int(g),), voters_row, joint_row,
                       bool(self_is_voter))


def set_group_config_stacked(states: PeerState, p: int, g: int,
                             voters_row, joint_row,
                             self_is_voter: bool) -> PeerState:
    """`set_group_config` over a stacked cluster state (leaves
    [P, G, ...]): patch peer row `p`'s view of group `g`.  Each peer row
    applies a conf entry when its own commit passes the entry."""
    return _set_config(states, (int(p), int(g)), voters_row, joint_row,
                       bool(self_is_voter))


def set_transfer_target(state: PeerState, g: int, target: int) -> PeerState:
    """Arm (target >= 0) or clear (NO_XFER) group `g`'s leadership
    transfer on one peer's row, in place.  The step only reads
    xfer_target: arming a non-leader row is harmless (the step clears
    it next tick), and the abort path clears it to re-open the group
    for proposals."""
    state.xfer_target[int(g)] = int(target)
    return state


def set_transfer_target_stacked(states: PeerState, p: int, g: int,
                                target: int) -> PeerState:
    """`set_transfer_target` over a stacked cluster state: arm or clear
    peer row `p`'s transfer latch for group `g`, in place."""
    states.xfer_target[int(p), int(g)] = int(target)
    return states


def install_snapshot_state(state: PeerState, g: int, last_idx: int,
                           last_term: int, sender_term: int) -> PeerState:
    """Reset group `g`'s row of one peer's state to a snapshot boundary,
    in place (the JAX package's install_snapshot_state, which donates).

    The follower installed a state-machine image at log position
    `last_idx` (entry term `last_term`): its log becomes exactly that
    prefix (length and commit jump to last_idx), the term ring and the
    transition table keep only the boundary, and the row drops to
    follower so replication resumes from last_idx + 1 (raft §7).  A
    higher `sender_term` is adopted with the vote cleared; the caller
    has already rejected a lower one.  The row is written by index from
    host values, so the install never syncs with the device."""
    g, last_idx, last_term = int(g), int(last_idx), int(last_term)
    sender_term = int(sender_term)
    rw = state.log_term.shape[-1]      # W, or 1 for the keep_ring stub
    state.log_term[g] = 0
    state.log_term[g, (last_idx - 1) % rw] = last_term
    K = state.tbl_pos.shape[-1]
    state.tbl_pos[g] = 0
    state.tbl_pos[g, K - 1] = last_idx
    state.tbl_term[g] = 0
    state.tbl_term[g, K - 1] = last_term
    newer = sender_term > state.term[g]
    state.voted_for[g] = torch.where(newer, NO_VOTE, state.voted_for[g])
    state.term[g] = torch.clamp(state.term[g], min=sender_term)
    state.log_len[g] = last_idx
    state.commit[g] = last_idx
    state.role[g] = FOLLOWER
    state.votes[g] = False
    state.match[g] = 0
    state.next_idx[g] = last_idx + 1
    state.elapsed[g] = 0
    state.resp_tick[g] = 0
    state.xfer_target[g] = NO_XFER
    return state


def set_peer_progress(state: PeerState, g: int, d: int,
                      next_idx: int) -> PeerState:
    """Leader-side optimistic advance after shipping a snapshot to peer
    `d`: replication resumes at next_idx = last_idx + 1, written in
    place.  `match` is not touched (the step clamps next_idx to match+1
    from below, so an unacknowledged match would block reject-walkback
    for good); a lost transfer walks next_idx back and retriggers it."""
    state.next_idx[int(g), int(d)] = int(next_idx)
    return state


def restore_peer_state(cfg: RaftConfig, self_id: int,
                       log_terms: dict, hard: dict,
                       seed: int | None = None,
                       starts: dict | None = None,
                       device="cuda") -> PeerState:
    """Rebuild boot state from a replayed WAL (the reference's
    RestartNode path, raft.go:122-134).  Same contract as the JAX
    package's restore_peer_state: log_terms {group: [terms after
    start]}, hard {group: (term, voted_for, commit)}, starts {group:
    (start, start_term)} compaction floors."""
    st = init_peer_state(cfg, self_id, seed, device)
    g_, k_ = cfg.num_groups, cfg.term_table_slots
    w = cfg.log_window if cfg.keep_ring else 1
    starts = starts or {}
    term = np.zeros((g_,), np.int32)
    voted = np.full((g_,), NO_VOTE, np.int32)
    commit = np.zeros((g_,), np.int32)
    log_len = np.zeros((g_,), np.int32)
    window = np.zeros((g_, w), np.int32)
    tbl_pos = np.zeros((g_, k_), np.int32)
    tbl_term = np.zeros((g_, k_), np.int32)
    for g in range(g_):
        t, v, c = hard.get(g, (0, NO_VOTE, 0))
        term[g], voted[g], commit[g] = t, v, c
        start, start_term = starts.get(g, (0, 0))
        terms = log_terms.get(g, [])
        log_len[g] = start + len(terms)
        lo = max(start + 1, log_len[g] - w + 1)
        for idx in range(lo, log_len[g] + 1):
            window[g, (idx - 1) % w] = terms[idx - 1 - start]
        if start >= 1 and start > log_len[g] - w:
            window[g, (start - 1) % w] = start_term
        trans = []
        if start >= 1:
            trans.append((start, start_term))
        last = start_term if start >= 1 else 0
        for idx in range(start + 1, log_len[g] + 1):
            tt = terms[idx - 1 - start]
            if tt != last:
                trans.append((idx, tt))
                last = tt
        trans = trans[-k_:]
        for j, (pos_, term_) in enumerate(trans):
            tbl_pos[g, k_ - len(trans) + j] = pos_
            tbl_term[g, k_ - len(trans) + j] = term_
        commit[g] = min(max(commit[g], start), log_len[g])
    dev = st.term.device
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return st._replace(
        term=t(term), voted_for=t(voted), commit=t(commit),
        log_len=t(log_len), log_term=t(window),
        tbl_pos=t(tbl_pos), tbl_term=t(tbl_term))


def empty_inbox(cfg: RaftConfig, device="cuda") -> Inbox:
    dev = resolve_device(device)
    g, p, e = cfg.num_groups, cfg.num_peers, cfg.max_entries_per_msg
    z = lambda: torch.zeros((g, p), dtype=I32, device=dev)  # noqa: E731
    zb = lambda: torch.zeros((g, p), dtype=B, device=dev)  # noqa: E731
    return Inbox(
        v_type=z(), v_term=z(), v_last_idx=z(), v_last_term=z(),
        v_granted=zb(), a_type=z(), a_term=z(), a_prev_idx=z(),
        a_prev_term=z(), a_n=z(),
        a_ents=torch.zeros((g, p, e), dtype=I32, device=dev),
        a_commit=z(), a_success=zb(), a_match=z(),
    )


def term_at_tbl(tbl_pos: torch.Tensor, tbl_term: torch.Tensor,
                log_len: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Term of entry `idx` from the transition table; term_at(0) == 0.

    `idx` may be [...] or [..., X] against tables [..., K].  Terms are
    nondecreasing in position, so the term at idx is the max term over
    valid transitions starting at or before idx.  Out of range (idx < 1,
    idx > log_len, or below the table floor) returns 0."""
    squeeze = idx.dim() == tbl_pos.dim() - 1
    idx2 = idx[..., None] if squeeze else idx
    hit = (tbl_pos[..., None, :] > 0) \
        & (tbl_pos[..., None, :] <= idx2[..., None])    # [..., X, K]
    got = torch.where(hit, tbl_term[..., None, :], 0).amax(-1)
    if squeeze:
        got = got[..., 0]
    else:
        log_len = log_len[..., None]
    valid = (idx >= 1) & (idx <= log_len)
    return torch.where(valid, got, 0)


def tbl_floor(tbl_pos: torch.Tensor, log_len: torch.Tensor) -> torch.Tensor:
    """Lowest position whose term the table still knows; log_len + 1 for
    an empty table.  The fill value is the int32 maximum, kept int32."""
    valid = tbl_pos > 0
    f = torch.where(valid, tbl_pos, INT32_MAX).amin(-1)
    return torch.where(valid.any(-1), f, log_len + 1)


def term_at(log_term: torch.Tensor, log_len: torch.Tensor, idx: torch.Tensor,
            window: int) -> torch.Tensor:
    """Term of entry `idx` from the ring, with term_at(0) == 0; out of
    range (idx < 1 or idx > log_len) returns 0.  The slot is the floored
    (idx - 1) mod window, as jnp's `%` computes it."""
    from raftsql_tpu_torch.ops.dense import take_last

    squeeze = idx.dim() == log_term.dim() - 1
    idx2 = idx[..., None] if squeeze else idx
    got = take_last(log_term, torch.remainder(idx2 - 1, window))
    if squeeze:
        got = got[..., 0]
    else:
        log_len = log_len[..., None]
    valid = (idx >= 1) & (idx <= log_len)
    return torch.where(valid, got, 0)
