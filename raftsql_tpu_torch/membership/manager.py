"""MembershipManager — the host plane of dynamic membership.

Copy of raftsql_tpu/membership/manager.py for the PyTorch port (pure
Python and numpy, on the port's transport/codec.py).

One manager per runtime instance (RaftNode, or the whole fused
cluster).  It owns the APPLIED configuration per group, validates and
builds conf-change entries (transport/codec.py conf-entry kind), tracks
conf entries that are appended-but-uncommitted so the publish plane can
apply + scrub them by index without scanning payload bytes on the hot
path, and enforces the two-phase joint protocol:

    admin op        entry 1 (at commit)          entry 2 (auto, leader)
    add learner     LEARNER  (1-phase)           —
    promote/remove  ENTER_JOINT (C_old,new)      LEAVE_JOINT (C_new)

with at most ONE change in flight per group: a new change is refused
while a conf entry is pending or the group sits in a joint config (the
leader auto-proposes the LEAVE_JOINT; any leader — including one
elected mid-transition — finishes an open joint state, so a leader
crash between the two entries cannot wedge the group).

Masks are u64 slot bitmasks (bit p = peer slot p); P <= 64.

Threading: admin/API threads call make_change/describe/counts; the
runtime's tick thread calls note_appended/note_truncated/take_committed/
apply.  All config mutation happens under one lock; the tick-side lists
are tick-thread-only.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from raftsql_tpu_torch.transport.codec import (CONF_KIND_ENTER_JOINT,
                                         CONF_KIND_LEARNER,
                                         CONF_KIND_LEAVE_JOINT,
                                         decode_conf_entry,
                                         encode_conf_entry,
                                         is_conf_entry)


class MembershipError(ValueError):
    """An illegal membership change (unknown op, peer not a learner,
    change already in flight, would empty the voter set, ...)."""


class MembershipLagError(MembershipError):
    """Learner too far behind to promote safely; retry after catch-up
    (the leader's host catch-up / InstallSnapshot path is feeding it)."""


class NotLeaderForChange(MembershipError):
    """Membership changes are accepted at the group's leader only;
    retry at `leader` (1-based node id, 0 = unknown)."""

    def __init__(self, group: int, leader: int):
        super().__init__(
            f"group {group}: membership changes go to the leader"
            + (f"; leader is node {leader}" if leader > 0 else ""))
        self.group = group
        self.leader = leader


def popcount(mask: int) -> int:
    return bin(mask).count("1")


def mask_bits(mask: int, p: int) -> List[int]:
    return [i for i in range(p) if mask >> i & 1]


@dataclasses.dataclass
class GroupConfig:
    """The APPLIED configuration of one group.

    `joint == voters` in the stable state; while a joint change is in
    flight `joint` holds C_old and `voters` C_new (commit and election
    need a majority of both — ops/quorum.py).  `index` is the log index
    of the conf entry that produced this config (0 = boot default).
    """
    voters: int
    joint: int
    learners: int
    index: int = 0

    @property
    def is_joint(self) -> bool:
        return self.joint != self.voters

    def entry(self, kind: int) -> bytes:
        return encode_conf_entry(kind, self.voters, self.joint,
                                 self.learners)

    def describe(self, p: int) -> dict:
        return {
            "voters": mask_bits(self.voters, p),
            "joint_old_voters": (mask_bits(self.joint, p)
                                 if self.is_joint else None),
            "learners": mask_bits(self.learners, p),
            "joint": self.is_joint,
            "conf_index": self.index,
        }


class MembershipManager:
    def __init__(self, num_peers: int, num_groups: int,
                 initial_voters: Optional[Tuple[int, ...]] = None,
                 write_quorum: Optional[int] = None,
                 election_quorum: Optional[int] = None,
                 witnesses: Tuple[int, ...] = (),
                 unsafe_geometry: bool = False):
        if num_peers > 64:
            raise MembershipError(
                "membership masks are u64 slot bitmasks: P <= 64")
        self.P = num_peers
        self.G = num_groups
        # Quorum geometry (config.py flexible quorums): explicit sizes
        # apply only to FULL masks (ops/quorum.py mask_threshold
        # contract); reduced masks fall back to their own majority.
        self.write_quorum = write_quorum
        self.election_quorum = election_quorum
        self.witness_mask = 0
        for w in witnesses:
            self.witness_mask |= 1 << w
        self.unsafe_geometry = unsafe_geometry
        full = (1 << num_peers) - 1
        if initial_voters is not None:
            full = 0
            for v in initial_voters:
                full |= 1 << v
        self._boot_voters = full
        self._lock = threading.Lock()
        self._cfg: List[GroupConfig] = [
            GroupConfig(voters=full, joint=full, learners=0)
            for _ in range(num_groups)]
        # Tick-thread state: conf entries appended to the local log but
        # not yet committed, [(idx, data)] ascending per group.
        self._appended: List[List[Tuple[int, bytes]]] = [
            [] for _ in range(num_groups)]
        # One-in-flight latch per group: held from make_change until the
        # resulting entry APPLIES (or its log slot is truncated away).
        self._pending: List[Optional[str]] = [None] * num_groups
        # Leader-side LEAVE_JOINT pacing (re-propose after a quiet spell
        # so a lost/truncated proposal cannot wedge the transition).
        self._leave_tick: Dict[int, int] = {}
        self.joint_groups: set = set()
        self.conf_changes_applied = 0

    # -- introspection --------------------------------------------------

    def config(self, group: int) -> GroupConfig:
        with self._lock:
            return dataclasses.replace(self._cfg[group])

    def is_default(self, group: int) -> bool:
        c = self._cfg[group]
        return (c.index == 0 and not c.learners
                and c.voters == c.joint == (1 << self.P) - 1)

    def is_voter(self, group: int, peer: int) -> bool:
        c = self._cfg[group]
        return bool((c.voters | c.joint) >> peer & 1)

    def voter_mask(self, group: int) -> int:
        """voters|joint bitmask of the applied config (invariant
        checkers' view of who may hold leadership)."""
        with self._lock:
            c = self._cfg[group]
        return c.voters | c.joint

    def describe(self, group: int) -> dict:
        with self._lock:
            d = self._cfg[group].describe(self.P)
        d["pending"] = self._pending[group]
        return d

    def counts(self) -> Tuple[int, int]:
        """(total voter slots, total learner slots) across all groups —
        the /metrics members_voters / members_learners export."""
        with self._lock:
            v = sum(popcount(c.voters) for c in self._cfg)
            l = sum(popcount(c.learners) for c in self._cfg)
        return v, l

    def device_rows(self, group: int, self_id: int):
        """(voters_row [P] bool, joint_row [P] bool, self_is_voter) for
        core/state.py set_group_config."""
        with self._lock:
            c = self._cfg[group]
        vrow = np.zeros(self.P, bool)
        jrow = np.zeros(self.P, bool)
        for i in range(self.P):
            vrow[i] = bool(c.voters >> i & 1)
            jrow[i] = bool(c.joint >> i & 1)
        return vrow, jrow, bool((c.voters | c.joint) >> self_id & 1)

    def quorum_confirmed(self, group: int, ok: np.ndarray,
                         self_id: int) -> bool:
        """ReadIndex confirmation under the active config: `ok[p]` =
        peer p echoed a current-term round; self counts implicitly.
        Needs a majority of BOTH masks (joint)."""
        with self._lock:
            c = self._cfg[group]
        conf = ok.astype(bool).copy()
        if 0 <= self_id < self.P:
            conf[self_id] = True

        def maj(mask: int) -> bool:
            n = popcount(mask)
            got = sum(1 for i in range(self.P)
                      if mask >> i & 1 and conf[i])
            return got >= self._write_need(mask)
        return maj(c.voters) and maj(c.joint)

    def quorum_nth(self, group: int, vals: np.ndarray) -> int:
        """Mask-weighted quorum-th largest of per-peer values under the
        active config — the lease plane's "latest clock at which a full
        quorum had confirmed us" (runtime/node.py lease_read; vals[p]
        already carries the caller's self stamp).  Joint consensus
        takes the MIN of both masks' quorum values: a lease is only as
        fresh as the staler majority, exactly like the masked commit
        rule."""
        with self._lock:
            c = self._cfg[group]

        def nth(mask: int) -> int:
            got = sorted((int(vals[i]) for i in range(self.P)
                          if mask >> i & 1), reverse=True)
            if not got:
                return -(1 << 40)    # all-learner: no quorum, no lease
            return got[self._write_need(mask) - 1]
        return min(nth(c.voters), nth(c.joint))

    def _write_need(self, mask: int) -> int:
        """Write-quorum threshold for a voter mask: the explicit
        flexible size on a FULL mask, the mask's own majority otherwise
        (mask_threshold contract — an explicit size was validated
        against all P slots and carries no intersection guarantee over
        a subset)."""
        n = popcount(mask)
        if self.write_quorum is not None and n == self.P:
            return self.write_quorum
        return n // 2 + 1

    def _check_geometry(self, new_voters: int, old_voters: int) -> None:
        """Re-validate quorum geometry across both joint halves before
        a config change flies (config.py validated the boot geometry
        against all P slots; a change must not re-open the hole).  Each
        half's effective thresholds follow the full-mask contract, so
        the intersection invariants W+E > n and 2E > n must hold per
        half — and a half whose voters are all witnesses could never
        elect a leader or apply a command, so at least one non-witness
        voter must survive in both."""
        if not self.unsafe_geometry:
            for mask in (new_voters, old_voters):
                n = popcount(mask)
                full = n == self.P
                w = self.write_quorum if (
                    full and self.write_quorum is not None) else n // 2 + 1
                e = self.election_quorum if (
                    full and self.election_quorum is not None) else n // 2 + 1
                if w + e <= n or 2 * e <= n:
                    raise MembershipError(
                        f"change would yield non-intersecting quorum "
                        f"geometry (W={w}, E={e}, n={n})")
        for mask in (new_voters, old_voters):
            if mask and not mask & ~self.witness_mask:
                raise MembershipError(
                    "change would leave only witness voters (someone "
                    "has to lead and apply)")

    # -- building changes (admin plane) ---------------------------------

    OPS = ("add", "add_learner", "remove_learner", "promote", "remove")

    def make_change(self, group: int, op: str, peer: int) -> bytes:
        """Validate and build the conf entry for an admin op.  Raises
        MembershipError; never touches the applied config (that happens
        at commit, via apply())."""
        if not 0 <= peer < self.P:
            raise MembershipError(
                f"peer slot {peer} out of range [0, {self.P})")
        bit = 1 << peer
        with self._lock:
            c = self._cfg[group]
            if self._pending[group] is not None:
                raise MembershipError(
                    f"group {group}: a membership change is already in "
                    f"flight ({self._pending[group]}); one at a time")
            if c.is_joint:
                raise MembershipError(
                    f"group {group}: joint config transition still "
                    "completing; retry shortly")
            if op in ("add", "add_learner"):
                if c.voters & bit:
                    raise MembershipError(f"peer {peer} is already a voter")
                if c.learners & bit:
                    raise MembershipError(
                        f"peer {peer} is already a learner")
                entry = encode_conf_entry(
                    CONF_KIND_LEARNER, c.voters, c.voters,
                    c.learners | bit)
            elif op == "remove_learner":
                if not c.learners & bit:
                    raise MembershipError(f"peer {peer} is not a learner")
                entry = encode_conf_entry(
                    CONF_KIND_LEARNER, c.voters, c.voters,
                    c.learners & ~bit)
            elif op == "promote":
                if not c.learners & bit:
                    raise MembershipError(
                        f"peer {peer} is not a learner (add it first)")
                self._check_geometry(c.voters | bit, c.voters)
                entry = encode_conf_entry(
                    CONF_KIND_ENTER_JOINT, c.voters | bit, c.voters,
                    c.learners & ~bit)
            elif op == "remove":
                if not c.voters & bit:
                    raise MembershipError(f"peer {peer} is not a voter")
                if popcount(c.voters & ~bit) == 0:
                    raise MembershipError(
                        "refusing to remove the last voter")
                self._check_geometry(c.voters & ~bit, c.voters)
                entry = encode_conf_entry(
                    CONF_KIND_ENTER_JOINT, c.voters & ~bit, c.voters,
                    c.learners)
            else:
                raise MembershipError(
                    f"unknown membership op {op!r}; one of {self.OPS}")
            self._pending[group] = f"{op} peer {peer}"
        return entry

    def maybe_leave(self, group: int, tick_no: int,
                    cooldown: int) -> Optional[bytes]:
        """LEAVE_JOINT entry for a joint group, rate-limited: the
        group's leader calls this every tick; a proposal goes out at
        most once per `cooldown` ticks until the leave applies."""
        with self._lock:
            c = self._cfg[group]
            if not c.is_joint:
                return None
            last = self._leave_tick.get(group, -cooldown)
            if tick_no - last < cooldown:
                return None
            self._leave_tick[group] = tick_no
            return encode_conf_entry(CONF_KIND_LEAVE_JOINT, c.voters,
                                     c.voters, c.learners)

    # -- tick-thread plumbing -------------------------------------------

    def note_appended(self, group: int, idx: int, data: bytes) -> None:
        """A conf entry landed in the local log at `idx` (leader append
        or accepted follower append/catch-up)."""
        lst = self._appended[group]
        # A re-accepted duplicate (same idx) or an overwrite after
        # truncation replaces the stale record.
        lst[:] = [(i, d) for (i, d) in lst if i < idx]
        lst.append((idx, data))

    def note_truncated(self, group: int, start: int) -> None:
        """Conflict truncation from `start`: pending conf entries in
        the clobbered suffix never commit."""
        lst = self._appended[group]
        lst[:] = [(i, d) for (i, d) in lst if i < start]

    def take_committed(self, group: int, lo: int,
                       hi: int) -> List[Tuple[int, bytes]]:
        """Pop appended conf entries with lo < idx <= hi (they are
        committing now); ascending order."""
        lst = self._appended[group]
        if not lst:
            return []
        out = [(i, d) for (i, d) in lst if lo < i <= hi]
        if out:
            lst[:] = [(i, d) for (i, d) in lst if i > hi]
        return out

    def has_appended(self, group: int) -> bool:
        return bool(self._appended[group])

    def appended_list(self, group: int) -> List[Tuple[int, bytes]]:
        """Copy of the appended-but-uncommitted conf entries (the fused
        runtime merges per-peer restore views through this)."""
        return list(self._appended[group])

    def abort_pending(self, group: int) -> None:
        """Release the one-in-flight latch: the pending entry's log
        slot was conflict-truncated before commit (the change never
        happened) — a new admin op may be issued."""
        with self._lock:
            self._pending[group] = None

    # -- apply at commit ------------------------------------------------

    def apply(self, group: int, idx: int,
              data: bytes) -> Optional[GroupConfig]:
        """Apply a COMMITTED conf entry.  Full-picture entries make
        this an unconditional set, so re-delivery/replay is idempotent;
        entries at or below the applied baseline are stale and skipped.
        Returns the new config, or None if nothing changed."""
        got = decode_conf_entry(data)
        if got is None:
            return None
        kind, voters, joint, learners = got
        with self._lock:
            c = self._cfg[group]
            if idx <= c.index:
                return None
            if voters == 0:
                return None          # corrupt/hostile: keep a voter set
            new = GroupConfig(voters=voters, joint=joint,
                              learners=learners, index=idx)
            self._cfg[group] = new
            self._pending[group] = None
            if new.is_joint:
                self.joint_groups.add(group)
            else:
                self.joint_groups.discard(group)
                self._leave_tick.pop(group, None)
            self.conf_changes_applied += 1
            return dataclasses.replace(new)

    # -- restart / snapshot recovery ------------------------------------

    def restore(self, group: int,
                baseline: Optional[Tuple[int, int, int, int, int]],
                entries, start: int, commit: int) -> bool:
        """Rebuild the group's active config after a WAL replay.

        `baseline` is the replayed REC_CONF (or None); `entries` the
        replayed (term, data) list beginning at log index start+1, and
        `commit` the replayed commit index.  Conf entries committed
        above the baseline re-apply in order; appended-but-uncommitted
        ones re-enter the pending list so the live publish path applies
        them when they commit.  Returns True when the group ends in a
        non-default config (caller patches the device masks)."""
        if baseline is not None:
            idx, kind, voters, joint, learners = baseline
            with self._lock:
                self._cfg[group] = GroupConfig(
                    voters=voters, joint=joint, learners=learners,
                    index=idx)
                if self._cfg[group].is_joint:
                    self.joint_groups.add(group)
        for off, (_, data) in enumerate(entries):
            idx = start + 1 + off
            if not is_conf_entry(data):
                continue
            if idx <= commit:
                self.apply(group, idx, data)
            else:
                self.note_appended(group, idx, data)
        return not self.is_default(group)
