"""The batched raft peer transition — one tick for G groups, in PyTorch.

Port of raftsql_tpu/core/step.py.  Every phase is kept, in the same order
and with the same masked dense arithmetic (each branch a `torch.where`
over all groups); see the JAX package for the protocol reasoning behind
each line.  What changes is the batching: the JAX package vmaps one
peer's step over the P peers of a fused cluster, while here `peer_step`
takes state leaves with ANY leading batch shape `bs` ([] for one peer,
[P] for a stacked cluster) and a `self_id` of that shape.  Row-local math
broadcasts over `bs` unchanged; the Phase-7 quorum kernels of
commit_rule="pallas" see the batch folded into their row axis, so one
launch covers all P x G rows.

int32 stays int32 throughout: integer reductions pass `dtype=I32`, and
`%` is `torch.remainder` (floored, as in jnp).
"""
from __future__ import annotations

from typing import Tuple

import torch

from raftsql_tpu_torch.config import (CANDIDATE, FLOOR_HINT_BIAS, FOLLOWER,
                                      LEADER, MSG_NONE, MSG_PREREQ,
                                      MSG_PRERESP, MSG_REQ, MSG_RESP,
                                      MSG_TIMEONOW, NO_LEADER, NO_VOTE,
                                      NO_XFER, PRECANDIDATE, RaftConfig)
from raftsql_tpu_torch.core import signature
from raftsql_tpu_torch.core.state import (I32, Inbox, Outbox, PeerState,
                                          StepInfo, tbl_floor, term_at_tbl,
                                          witness_row)
from raftsql_tpu_torch.ops import dense
from raftsql_tpu_torch.ops.quorum import (masked_quorum_commit_index,
                                          masked_quorum_match_index,
                                          masked_vote_win,
                                          quorum_commit_index,
                                          quorum_match_index, vote_count)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """jnp.argmax over a bool last axis: the first True index, 0 if none."""
    n = mask.shape[-1]
    lanes = torch.arange(n, dtype=I32, device=mask.device)
    idx = torch.where(mask, lanes, n).amin(-1)
    return torch.where(idx == n, 0, idx)


def _rows(x: torch.Tensor, nb: int) -> torch.Tensor:
    """Fold the batch axes and the group axis into one row axis."""
    return x.reshape((-1,) + tuple(x.shape[nb + 1:])).contiguous()


def peer_step(cfg: RaftConfig, state: PeerState, inbox: Inbox,
              prop_n: torch.Tensor, self_id: torch.Tensor,
              group_offset: int = 0,
              timer_inc: torch.Tensor | int = 1,
              force_bcast: torch.Tensor | bool = False
              ) -> Tuple[PeerState, Outbox, StepInfo]:
    """Advance each batched peer's view of all G groups by one tick.

    Args mirror the JAX package's peer_step; `self_id` and a tensor
    `timer_inc` have the batch shape of the state (for a stacked cluster
    [P]), `prop_n` is [..., G], `force_bcast` a bool or a [G] mask.

    Returns (new_state, outbox, info), batched like the state.
    """
    G, P, W, E = cfg.num_groups, cfg.num_peers, cfg.log_window, \
        cfg.max_entries_per_msg
    dev = state.term.device
    bs = tuple(state.term.shape[:-1])
    nb = len(bs)
    src_ids = torch.arange(P, dtype=I32, device=dev)             # [P]
    sid = self_id.to(I32).reshape(bs + (1,))                     # ~[.., G]
    self_onehot = src_ids == sid[..., None]                      # [.., 1, P]
    if isinstance(timer_inc, torch.Tensor):
        timer_inc = timer_inc.to(I32).reshape(bs + (1,))

    voters, jvoters = state.voters, state.voters_joint
    if cfg.static_full_voters:
        voter_src = True
        self_voter = True

        def _vote_win(votes):
            return vote_count(votes) >= cfg.election_size
    else:
        voter_src = voters | jvoters                             # [.., G, P]
        self_voter = (voter_src & self_onehot).sum(-1, dtype=I32) > 0

        def _vote_win(votes):
            return masked_vote_win(votes, voters, jvoters,
                                   cfg.election_quorum)

    if cfg.witnesses:
        wrow = torch.as_tensor(witness_row(cfg), device=dev)
        self_witness = wrow[sid.long()]                          # ~[.., G]
    else:
        self_witness = False

    log_term, log_len = state.log_term, state.log_len
    tbl_pos, tbl_term = state.tbl_pos, state.tbl_term
    commit0 = state.commit
    floor0 = tbl_floor(tbl_pos, log_len)

    def term_of0(idx):  # reads against the PRE-append log
        return term_at_tbl(tbl_pos, tbl_term, log_len, idx)

    # ---- Phase 1: term catch-up (prevote probes never bump).
    v_bump = (inbox.v_type == MSG_REQ) | (inbox.v_type == MSG_RESP) \
        | ((inbox.v_type == MSG_PRERESP) & ~inbox.v_granted)
    a_has = inbox.a_type != MSG_NONE
    msg_term = torch.maximum(
        torch.where(v_bump, inbox.v_term, 0).amax(-1),
        torch.where(a_has, inbox.a_term, 0).amax(-1))
    bumped = msg_term > state.term
    term = torch.maximum(state.term, msg_term)
    role = torch.where(bumped, FOLLOWER, state.role)
    voted = torch.where(bumped, NO_VOTE, state.voted_for)
    votes = torch.where(bumped[..., None], False, state.votes)
    leader_hint = torch.where(bumped, NO_LEADER, state.leader_hint)

    my_last_term = term_of0(log_len)

    # ---- Phase 1b: TimeoutNow receipt (leadership transfer).
    tnow_fire = ((inbox.v_type == MSG_TIMEONOW)
                 & (inbox.v_term == term[..., None])).any(-1) \
        & (role != LEADER) & self_voter
    if cfg.witnesses:
        tnow_fire = tnow_fire & ~self_witness
    term = torch.where(tnow_fire, term + 1, term)
    role = torch.where(tnow_fire, CANDIDATE, role)
    voted = torch.where(tnow_fire, sid, voted)
    votes = torch.where(tnow_fire[..., None], self_onehot, votes)
    leader_hint = torch.where(tnow_fire, NO_LEADER, leader_hint)

    # ---- Phase 2: RequestVote requests (one grant per group per tick).
    vreq = inbox.v_type == MSG_REQ
    vreq_cur = vreq & (inbox.v_term == term[..., None])
    up2date = (inbox.v_last_term > my_last_term[..., None]) | (
        (inbox.v_last_term == my_last_term[..., None])
        & (inbox.v_last_idx >= log_len[..., None]))
    eligible = vreq_cur & up2date & voter_src & (
        (voted == NO_VOTE)[..., None] | (voted[..., None] == src_ids))
    any_grant = eligible.any(-1)
    grant_to = _first_true(eligible)
    grant = eligible & (src_ids == grant_to[..., None])
    voted = torch.where(any_grant, grant_to, voted)

    # ---- Phase 2b: PreVote requests.
    preq = inbox.v_type == MSG_PREREQ
    if cfg.prevote:
        in_lease = (leader_hint != NO_LEADER) & \
            (state.elapsed < cfg.election_ticks)
        lease_ok = ~in_lease[..., None]
        if cfg.unsafe_witness_lease and cfg.witnesses:
            lease_ok = lease_ok | self_witness[..., None]
        pre_grant = preq & (inbox.v_term > term[..., None]) & up2date \
            & voter_src & lease_ok
    else:
        pre_grant = torch.zeros_like(preq)

    vterm_resp = term

    # ---- Phase 3: vote tallies (prevote first, then real votes).
    if cfg.prevote:
        got_pre = (inbox.v_type == MSG_PRERESP) & inbox.v_granted \
            & (inbox.v_term == term[..., None] + 1) \
            & (role == PRECANDIDATE)[..., None]
        votes = votes | got_pre
        become_cand = (role == PRECANDIDATE) & _vote_win(votes)
        term = torch.where(become_cand, term + 1, term)
        role = torch.where(become_cand, CANDIDATE, role)
        voted = torch.where(become_cand, sid, voted)
        votes = torch.where(become_cand[..., None], self_onehot, votes)

    got_vote = (inbox.v_type == MSG_RESP) \
        & (inbox.v_term == term[..., None]) \
        & inbox.v_granted & (role == CANDIDATE)[..., None]
    votes = votes | got_vote
    become_leader = (role == CANDIDATE) & _vote_win(votes)
    role = torch.where(become_leader, LEADER, role)
    leader_hint = torch.where(become_leader, sid, leader_hint)
    next_idx = torch.where(become_leader[..., None], log_len[..., None] + 1,
                           state.next_idx)
    match = torch.where(become_leader[..., None], 0, state.match)

    # ---- Phase 4: AppendEntries requests (one current-term append per
    # group).
    areq = inbox.a_type == MSG_REQ
    areq_cur = areq & (inbox.a_term == term[..., None])
    any_app = areq_cur.any(-1)
    asrc = _first_true(areq_cur)
    role = torch.where(
        any_app & ((role == CANDIDATE) | (role == PRECANDIDATE)),
        FOLLOWER, role)
    leader_hint = torch.where(any_app, asrc, leader_hint)

    def pick(x):
        return dense.pick_peer(x, asrc)

    prev = pick(inbox.a_prev_idx)
    prev_t = pick(inbox.a_prev_term)
    a_n = pick(inbox.a_n)
    a_ents = pick(inbox.a_ents)                                  # [.., G, E]
    a_commit = pick(inbox.a_commit)

    ov_n = torch.clamp(torch.minimum(prev + a_n, log_len) - prev, 0, E)
    ov_term = term_of0(prev + ov_n)
    batch_ov = dense.pick_batch(a_ents, torch.clamp(ov_n - 1, min=0))
    anchor_ok = (ov_n > 0) & (prev + ov_n >= floor0) \
        & (ov_term == batch_ov)
    prev_ok = ((prev == 0) & (floor0 <= 1)) \
        | ((prev <= log_len) & (prev >= floor0)
           & (term_of0(prev) == prev_t)) \
        | ((prev <= log_len) & anchor_ok)
    accept = any_app & prev_ok & (role != LEADER)

    conflict = accept & (ov_n > 0) & (ov_term != batch_ov)
    a_n_w = torch.clamp(a_n, 0, E)
    wpos = torch.arange(W, dtype=I32, device=dev)
    if cfg.keep_ring:
        rel4 = torch.remainder(wpos - prev[..., None], W)        # [.., G, W]
        len_after = torch.where(conflict, prev + a_n,
                                torch.maximum(log_len, prev + a_n))
        pos4 = prev[..., None] + 1 + rel4
        hit4 = accept[..., None] & (rel4 < a_n_w[..., None]) \
            & (pos4 > len_after[..., None] - W)
        vals4 = dense.ring_gather_values(a_ents, rel4, a_n_w)
        log_term = torch.where(hit4, vals4, log_term)
    app_end = prev + a_n
    follower_len0 = log_len
    log_len = torch.where(
        accept,
        torch.where(conflict, app_end, torch.maximum(log_len, app_end)),
        log_len)

    # Transition-table merge for the accepted batch (keep the newest K,
    # right-aligned, by a reversed prefix count — no sort).
    new_from = torch.where(conflict, prev, follower_len0)
    old_keep = (tbl_pos > 0) & (
        ~(accept & conflict)[..., None] | (tbl_pos <= prev[..., None]))
    erange = torch.arange(E, dtype=I32, device=dev)
    pos_e = prev[..., None] + 1 + erange                         # [.., G, E]
    prev_term_known = term_of0(prev)
    ents_shift = torch.cat([prev_term_known[..., None], a_ents[..., :-1]],
                           dim=-1)
    bnd = a_ents != ents_shift
    new_add = accept[..., None] & (erange < a_n_w[..., None]) \
        & (pos_e > new_from[..., None]) & bnd
    K = tbl_pos.shape[-1]
    cand_pos = torch.cat([torch.where(old_keep, tbl_pos, 0),
                          torch.where(new_add, pos_e, 0)], dim=-1)
    cand_term = torch.cat([torch.where(old_keep, tbl_term, 0),
                           torch.where(new_add, a_ents, 0)], dim=-1)
    cvalid = (cand_pos > 0).to(I32)
    r = torch.flip(torch.cumsum(torch.flip(cvalid, [-1]), -1, dtype=I32),
                   [-1]) - cvalid
    keep = (cvalid > 0) & (r < K)
    slot = torch.where(keep, K - 1 - r, K)
    krange = torch.arange(K, dtype=I32, device=dev)
    hit_k = slot[..., None] == krange                            # [.,K+E,K]
    merged_pos = torch.where(hit_k, cand_pos[..., None], 0).sum(
        -2, dtype=I32)
    merged_term = torch.where(hit_k, cand_term[..., None], 0).sum(
        -2, dtype=I32)
    tbl_pos = torch.where(accept[..., None], merged_pos, tbl_pos)
    tbl_term = torch.where(accept[..., None], merged_term, tbl_term)
    commit = torch.where(
        accept, torch.maximum(commit0, torch.minimum(a_commit, app_end)),
        commit0)

    # ---- Phase 5: AppendEntries responses -> match/next bookkeeping.
    rs = (inbox.a_type == MSG_RESP) & (inbox.a_term == term[..., None]) \
        & (role == LEADER)[..., None]
    rs_ok = rs & inbox.a_success
    rs_fail = rs & ~inbox.a_success
    match = torch.where(rs_ok, torch.maximum(match, inbox.a_match), match)
    next_idx = torch.where(rs_ok,
                           torch.maximum(next_idx, inbox.a_match + 1),
                           next_idx)
    is_floor_hint = inbox.a_match >= FLOOR_HINT_BIAS
    hint = torch.where(is_floor_hint, inbox.a_match - FLOOR_HINT_BIAS,
                       inbox.a_match)
    walked = torch.clamp(torch.minimum(next_idx - 1, hint + 1), min=1)
    next_idx = torch.where(
        rs_fail, torch.where(is_floor_hint, hint + 1, walked), next_idx)
    next_idx = torch.maximum(next_idx, match + 1)

    # ---- Phase 6: proposals (+ the new-leader no-op entry).
    is_leader = role == LEADER
    transferring = is_leader & (state.xfer_target != NO_XFER)
    n_acc = torch.where(transferring, 0, prop_n.to(I32))
    space = torch.clamp(W - 2 * E - (log_len - commit), min=0)
    noop_n = (become_leader & (space >= 1)).to(I32)
    n_acc = torch.where(
        is_leader, torch.minimum(torch.clamp(n_acc, max=E), space - noop_n),
        0)
    total_app = noop_n + n_acc
    prop_base = log_len + noop_n
    if cfg.keep_ring:
        rel6 = torch.remainder(wpos - log_len[..., None], W)
        log_term = torch.where(rel6 < total_app[..., None], term[..., None],
                               log_term)
    push = (total_app > 0) & (tbl_term[..., K - 1] != term)
    shifted_pos = torch.cat([tbl_pos[..., 1:], (log_len + 1)[..., None]],
                            dim=-1)
    shifted_term = torch.cat([tbl_term[..., 1:], term[..., None]], dim=-1)
    tbl_pos = torch.where(push[..., None], shifted_pos, tbl_pos)
    tbl_term = torch.where(push[..., None], shifted_term, tbl_term)
    log_len = log_len + total_app

    def term_of1(idx):  # reads against the POST-append log
        return term_at_tbl(tbl_pos, tbl_term, log_len, idx)

    floor1 = tbl_floor(tbl_pos, log_len)
    match = torch.where(is_leader[..., None] & self_onehot,
                        log_len[..., None], match)

    # ---- Phase 7: leader commit advance (cfg.commit_rule), all with the
    # WRITE quorum.  "pallas" folds the batch into the kernels' row axis.
    if cfg.commit_rule == "windowed":
        if cfg.static_full_voters:
            from raftsql_tpu_torch.ops.commit_scan import \
                windowed_commit_index
            commit = windowed_commit_index(
                match, log_term, log_len, commit, term, is_leader,
                quorum=cfg.write_size, window=W)
        else:
            from raftsql_tpu_torch.ops.commit_scan import \
                masked_windowed_commit_index
            commit = masked_windowed_commit_index(
                match, log_term, log_len, commit, term, is_leader,
                voters=voters, voters_joint=jvoters, window=W,
                size=cfg.write_quorum)
    elif cfg.commit_rule == "pallas":
        from raftsql_tpu_torch.ops import pallas_quorum as pq
        rows = (_rows(match, nb), _rows(log_term, nb), _rows(log_len, nb),
                _rows(commit, nb), _rows(term, nb), _rows(is_leader, nb))
        if cfg.static_full_voters:
            flat = pq.pallas_quorum_commit_index(
                *rows, quorum=cfg.write_size, window=W)
        else:
            flat = pq.pallas_masked_quorum_commit_index(
                *rows, voters=_rows(voters, nb),
                voters_joint=_rows(jvoters, nb), window=W,
                size=cfg.write_quorum)
        commit = flat.reshape(bs + (G,))
    elif cfg.static_full_voters:
        commit = quorum_commit_index(
            match, log_term, log_len, commit, term, is_leader,
            quorum=cfg.write_size, window=W, term_of=term_of1)
    else:
        commit = masked_quorum_commit_index(
            match, log_term, log_len, commit, term, is_leader,
            voters=voters, voters_joint=jvoters, window=W,
            term_of=term_of1, size=cfg.write_quorum)

    # ---- Phase 8: timers and election start.
    reset = any_grant | any_app | tnow_fire
    elapsed = torch.where(is_leader | reset, 0, state.elapsed + timer_inc)
    fire = (role != LEADER) & (elapsed >= state.timeout) & self_voter
    if cfg.witnesses:
        fire = fire & ~self_witness
    term_resp = term
    if cfg.prevote:
        role = torch.where(fire, PRECANDIDATE, role)
        votes = torch.where(fire[..., None], self_onehot, votes)
    else:
        term = torch.where(fire, term + 1, term)
        role = torch.where(fire, CANDIDATE, role)
        voted = torch.where(fire, sid, voted)
        votes = torch.where(fire[..., None], self_onehot, votes)
    leader_hint = torch.where(fire, NO_LEADER, leader_hint)
    elapsed = torch.where(fire, 0, elapsed)
    gids = int(group_offset) + torch.arange(G, dtype=I32, device=dev)
    new_timeout = dense.election_jitter(
        dense.key_data_of(state.rng), state.tick, gids,
        cfg.election_ticks, 2 * cfg.election_ticks)
    timeout = torch.where(fire, new_timeout, state.timeout)

    hb = torch.where(is_leader, state.hb_elapsed + timer_inc, 0)
    hb_fire = is_leader & ((hb >= cfg.heartbeat_ticks) | become_leader
                           | (total_app > 0) | force_bcast
                           | (commit > commit0))
    hb = torch.where(hb_fire, 0, hb)

    # ---- Phase 8b: leader leases (write-only outputs).
    tick_now = state.tick.reshape(bs + (1, 1))
    lease_role = role == LEADER
    resp_tick = torch.where(bumped[..., None], 0, state.resp_tick)
    resp_tick = torch.where(rs, tick_now, resp_tick)
    resp_tick = torch.where(become_leader[..., None], 0, resp_tick)
    resp_tick = torch.where(
        lease_role[..., None],
        torch.where(self_onehot, tick_now, resp_tick), 0)
    if cfg.lease_ticks > 0:
        if cfg.static_full_voters:
            q_tick = quorum_match_index(resp_tick, cfg.write_size)
        else:
            q_tick = torch.minimum(
                masked_quorum_match_index(resp_tick, voters,
                                          cfg.write_quorum),
                masked_quorum_match_index(resp_tick, jvoters,
                                          cfg.write_quorum))
        cur_ok = (commit >= 1) & (term_of1(commit) == term)
        lease_until = torch.where(lease_role & cur_ok & (q_tick > 0),
                                  q_tick - 1 + cfg.lease_ticks, 0)
    else:
        lease_until = torch.zeros(bs + (G,), dtype=I32, device=dev)

    # ---- Phase 9: compose the outbox (responses outrank broadcasts).
    my_last_term2 = term_of1(log_len)

    is_cand = role == CANDIDATE
    cand_bcast = is_cand[..., None] & ~self_onehot
    pre_bcast = (role == PRECANDIDATE)[..., None] & ~self_onehot
    o_v_type = torch.where(
        cand_bcast, MSG_REQ,
        torch.where(vreq, MSG_RESP,
                    torch.where(preq, MSG_PRERESP,
                                torch.where(pre_bcast, MSG_PREREQ,
                                            MSG_NONE)))).to(I32)
    resp_term = torch.where(pre_grant, inbox.v_term, vterm_resp[..., None])
    o_v_term = torch.where(
        cand_bcast, term[..., None],
        torch.where(vreq | preq, resp_term,
                    torch.where(pre_bcast, term[..., None] + 1,
                                resp_term)))
    gp = bs + (G, P)
    o_v_last_idx = log_len[..., None].expand(gp)
    o_v_last_term = my_last_term2[..., None].expand(gp)
    o_v_granted = (grant | pre_grant) & ~cand_bcast

    # Leadership transfer, leader side: TimeoutNow to a caught-up voter.
    xfer = state.xfer_target
    tgt_clip = torch.clamp(xfer, 0, P - 1)
    tgt_is_voter = dense.pick_peer((voters | jvoters).to(I32),
                                   tgt_clip) > 0
    tgt_caught = dense.pick_peer(match, tgt_clip) >= log_len
    send_tnow = transferring & (xfer >= 0) & (xfer < P) \
        & (xfer != sid) & tgt_is_voter
    if not cfg.unsafe_transfer:
        send_tnow = send_tnow & tgt_caught
    tnow_dst = send_tnow[..., None] & (src_ids == tgt_clip[..., None])
    o_v_type = torch.where(tnow_dst, MSG_TIMEONOW, o_v_type)
    o_v_term = torch.where(tnow_dst, term[..., None], o_v_term)
    o_v_granted = o_v_granted & ~tnow_dst
    if cfg.unsafe_transfer:
        role = torch.where(send_tnow, FOLLOWER, role)
        leader_hint = torch.where(send_tnow, NO_LEADER, leader_hint)

    # Append responses (to every append request seen).
    chosen_mask = areq_cur & (src_ids == asrc[..., None]) & any_app[..., None]
    succ = chosen_mask & accept[..., None]
    floor_rej = chosen_mask & ~accept[..., None] & (prev < floor0)[..., None]
    rej_hint = torch.clamp(torch.minimum(prev - 1, follower_len0), min=0)
    resp_match = torch.where(
        succ, app_end[..., None],
        torch.where(floor_rej, follower_len0[..., None] + FLOOR_HINT_BIAS,
                    torch.where(chosen_mask, rej_hint[..., None], 0)))

    # Leader append broadcast, inside the known-term window.
    send_app = is_leader[..., None] & ~self_onehot & (
        hb_fire[..., None] | (next_idx <= log_len[..., None]))
    prev_s = torch.minimum(torch.clamp(next_idx - 1, min=0),
                           log_len[..., None])
    n_s = torch.clamp(log_len[..., None] - prev_s, 0, E)
    win_floor = log_len[..., None] - W
    min_acc = torch.where(prev_s > 0, prev_s, (n_s > 0).to(I32))
    in_window = (min_acc == 0) | ((min_acc > win_floor)
                                  & (min_acc >= floor1[..., None]))
    prev_s = torch.where(in_window, prev_s, 0)
    n_s = torch.where(in_window, n_s, 0)
    prev_t_s = term_of1(prev_s)
    ent_pos_s = prev_s[..., None] + 1 + erange                   # [.,G,P,E]
    ents_s = term_of1(ent_pos_s.reshape(bs + (G, P * E))).reshape(
        bs + (G, P, E))

    # Pipelined replication, capped at max_inflight_msgs batches.
    inflight_cap = match + 1 + cfg.max_inflight_msgs * E
    next_idx = torch.where(send_app & (n_s > 0),
                           torch.maximum(next_idx,
                                         torch.minimum(prev_s + n_s + 1,
                                                       inflight_cap)),
                           next_idx)

    o_a_type = torch.where(send_app, MSG_REQ,
                           torch.where(areq, MSG_RESP, MSG_NONE)).to(I32)
    o_a_term = torch.where(send_app, term[..., None], term_resp[..., None])
    o_a_prev_idx = torch.where(send_app, prev_s, 0)
    o_a_prev_term = torch.where(send_app, prev_t_s, 0)
    o_a_n = torch.where(send_app, n_s, 0)
    o_a_ents = torch.where(send_app[..., None], ents_s, 0)
    o_a_commit = torch.where(send_app, commit[..., None], 0)
    o_a_success = succ & ~send_app
    o_a_match = torch.where(send_app, 0, resp_match)

    outbox = Outbox(
        v_type=o_v_type, v_term=o_v_term, v_last_idx=o_v_last_idx,
        v_last_term=o_v_last_term, v_granted=o_v_granted,
        a_type=o_a_type, a_term=o_a_term, a_prev_idx=o_a_prev_idx,
        a_prev_term=o_a_prev_term, a_n=o_a_n, a_ents=o_a_ents,
        a_commit=o_a_commit, a_success=o_a_success, a_match=o_a_match)

    # Transfer latch carry: held only while this row still leads.
    xfer = torch.where(role == LEADER, xfer, NO_XFER)

    new_state = PeerState(
        term=term, voted_for=voted, role=role, leader_hint=leader_hint,
        commit=commit, log_len=log_len, log_term=log_term,
        tbl_pos=tbl_pos, tbl_term=tbl_term,
        elapsed=elapsed, timeout=timeout, hb_elapsed=hb,
        votes=votes, match=match, next_idx=next_idx,
        voters=voters, voters_joint=jvoters,
        resp_tick=resp_tick, xfer_target=xfer,
        rng=state.rng, tick=state.tick + 1)

    is_leader2 = role == LEADER
    big = 1 << 30
    elec_rem = torch.where(is_leader2, big, timeout - elapsed)
    hb_rem = torch.where(is_leader2, cfg.heartbeat_ticks - hb, big)
    timer_margin = torch.clamp(
        torch.minimum(elec_rem.amin(-1), hb_rem.amin(-1)), min=1)

    info = StepInfo(
        commit=commit, role=role, term=term, voted_for=voted,
        leader_hint=leader_hint,
        prop_base=prop_base, prop_accepted=n_acc, noop=noop_n > 0,
        app_from=torch.where(accept, asrc, -1),
        app_start=torch.where(accept, prev + 1, 0),
        app_n=torch.where(accept, a_n, 0),
        app_conflict=conflict,
        new_log_len=log_len,
        lease=lease_until,
        xfer=xfer,
        next_idx=next_idx,
        floor=floor1,
        timer_margin=timer_margin)

    return new_state, outbox, info


# ---------------------------------------------------------------------------
# Packed host boundary: column orders shared with the JAX package.

MSG_FIELDS = ("v_type", "v_term", "v_last_idx", "v_last_term", "v_granted",
              "a_type", "a_term", "a_prev_idx", "a_prev_term", "a_n",
              "a_commit", "a_success", "a_match")
IB_NCOLS = len(MSG_FIELDS)
INFO_FIELDS = ("commit", "role", "term", "voted_for", "leader_hint",
               "prop_base", "prop_accepted", "noop", "app_from",
               "app_start", "app_n", "app_conflict", "new_log_len",
               "floor", "lease", "xfer")
INFO_NCOLS = len(INFO_FIELDS)


def unpack_inbox(packed: torch.Tensor) -> Inbox:
    """[..., G, P, IB_NCOLS + E] i32 -> Inbox."""
    f = {n: packed[..., i] for i, n in enumerate(MSG_FIELDS)}
    f["v_granted"] = f["v_granted"].to(torch.bool)
    f["a_success"] = f["a_success"].to(torch.bool)
    return Inbox(a_ents=packed[..., IB_NCOLS:], **f)


def pack_outbox(ob: Outbox) -> torch.Tensor:
    head = torch.stack([getattr(ob, n).to(I32) for n in MSG_FIELDS], dim=-1)
    return torch.cat([head, ob.a_ents.to(I32)], dim=-1)


def pack_info(info: StepInfo) -> torch.Tensor:
    """[..., G] info columns -> [..., G, INFO_NCOLS] i32."""
    return torch.stack([getattr(info, n).to(I32) for n in INFO_FIELDS],
                       dim=-1)


def peer_step_packed(cfg: RaftConfig, state: PeerState, packed: torch.Tensor,
                     prop_n: torch.Tensor, self_id: torch.Tensor,
                     timer_inc: torch.Tensor | int = 1,
                     force_bcast: torch.Tensor | bool = False):
    """One peer's step with single-tensor host I/O (the distributed
    runtime's tick, runtime/node.py): `state` leaves are one peer's [G,
    ...], `packed` the [G, P, IB_NCOLS+E] i32 inbox, `self_id` a 0-dim
    tensor.  Returns (state, packed outbox [G, P, IB_NCOLS+E], packed
    info [G, INFO_NCOLS], next_idx [G, P], timer_margin []).  Under
    commit_rule="pallas" Phase 7 launches the quorum kernel once, on the
    peer's G rows."""
    if signature.ARMED:
        signature.note("peer_step_packed", (cfg,),
                       (state, packed, prop_n, self_id, timer_inc,
                        force_bcast))
    st, ob, info = peer_step(cfg, state, unpack_inbox(packed), prop_n,
                             self_id, timer_inc=timer_inc,
                             force_bcast=force_bcast)
    return (st, pack_outbox(ob), pack_info(info), info.next_idx,
            info.timer_margin)
