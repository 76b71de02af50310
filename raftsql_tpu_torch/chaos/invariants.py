"""Invariant checkers the fused chaos runner enforces during and after
runs.

Port of the part of raftsql_tpu/chaos/invariants.py the fused and
node runners use (pure numpy/Python, copied so the port imports nothing of the JAX
package).  Four invariants (raft paper §5.4 + the durability contract):

  * ELECTION SAFETY — at most one leader per (group, term), across the
    whole run including restarts.
  * COMMIT MONOTONICITY — a peer's durably-observed commit index never
    regresses, including across crash/restart (observations are taken
    only after the tick's fsync barrier, so every observed value is
    durable).
  * LOG MATCHING — survivors agree entry-for-entry (term and payload)
    on the overlap of their committed prefixes.
  * DURABILITY — every entry ever published to the apply plane (i.e.
    acked to a client) reappears, byte-identical, in the post-restart
    replay.

plus a single-register-per-key LINEARIZABILITY check over the KV
plane's completed PUT/GET history, SESSION CONSISTENCY for watermark
reads (the read nemesis), TRANSFER AVAILABILITY (the transfer
nemesis), REMOVED-QUORUM SAFETY (the membership plane's own invariant),
the post-snapshot CONVERGENCE of the node plane's snapshot family, and
the elastic keyspace's NO-ACKED-WRITE-LOST and NO-AVAILABILITY-LOSS
(the reshard nemesis).
Violations raise `InvariantViolation` (an AssertionError so pytest
reports them as failures, not errors).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class InvariantViolation(AssertionError):
    pass


class ElectionSafety:
    """At most one leader per (group, term) for the run's lifetime."""

    def __init__(self, leader_code: int = 2):
        self._leader_code = leader_code
        self._leader_of_term: Dict[Tuple[int, int], int] = {}
        self.observations = 0

    def observe(self, tick: int, roles: np.ndarray,
                terms: np.ndarray) -> None:
        """roles/terms are [P, G] snapshots (one peer's row may be
        masked with role -1 for a dead node)."""
        self.observations += 1
        lead_p, lead_g = np.nonzero(roles == self._leader_code)
        for p, g in zip(lead_p.tolist(), lead_g.tolist()):
            key = (g, int(terms[p, g]))
            prev = self._leader_of_term.setdefault(key, p)
            if prev != p:
                raise InvariantViolation(
                    f"t={tick} g={g}: two leaders ({prev}, {p}) "
                    f"in term {key[1]}")


class CommitMonotonic:
    """Durably-observed commit indexes never regress."""

    def __init__(self, peers: int, groups: int):
        self._hi = np.zeros((peers, groups), np.int64)

    def observe(self, tick: int, commits: np.ndarray) -> None:
        if (commits < self._hi).any():
            p, g = np.nonzero(commits < self._hi)
            p, g = int(p[0]), int(g[0])
            raise InvariantViolation(
                f"t={tick} p={p} g={g}: commit regressed "
                f"{self._hi[p, g]} -> {commits[p, g]}")
        np.maximum(self._hi, commits, out=self._hi)


def check_log_matching(tick: int, commits: np.ndarray, plogs) -> None:
    """Survivors' committed prefixes agree entry-for-entry.

    commits: [P, G] committed indexes; plogs: per-peer payload logs
    (storage/log.py — `slice_columns(g, start, n) -> (terms, datas)`).
    Compares every pair's overlap ABOVE both peers' compaction floors:
    compacting scenarios (the compact/InstallSnapshot families) drop
    prefixes at different rates per peer, so the comparable region of a
    pair is (max(floor_a, floor_b), min(commit_a, commit_b)].  Entries
    below a peer's floor were already audited while they were live —
    the floor only ever covers published (committed) entries.
    """
    P, G = commits.shape
    for g in range(G):
        ref_p: Optional[int] = None
        ref_c = 0
        for p in range(P):
            c = int(commits[p, g])
            if c <= 0:
                continue
            if plogs[p].length(g) < c:
                raise InvariantViolation(
                    f"t={tick} p={p} g={g}: payload log shorter than "
                    f"commit ({plogs[p].length(g)} < {c})")
            if ref_p is None:
                ref_p, ref_c = p, c
                continue
            lo = max(plogs[p].start(g), plogs[ref_p].start(g))
            n = min(c, ref_c) - lo
            if n > 0:
                terms, datas = plogs[p].slice_columns(g, lo + 1, n)
                rterms, rdatas = plogs[ref_p].slice_columns(g, lo + 1, n)
                if list(terms) != list(rterms) \
                        or list(datas) != list(rdatas):
                    raise InvariantViolation(
                        f"t={tick} g={g}: committed prefixes diverge "
                        f"between p{ref_p} and p{p}")
            if c > ref_c:
                ref_p, ref_c = p, c


class DurabilityLedger:
    """Every published (client-visible) entry must survive restart."""

    def __init__(self):
        self._committed: Dict[Tuple[int, int], bytes] = {}

    def record(self, group: int, index: int, payload: bytes) -> None:
        prev = self._committed.setdefault((group, index), payload)
        if prev != payload:
            raise InvariantViolation(
                f"g{group} i{index}: committed entry changed content "
                f"({prev!r} -> {payload!r})")

    def __len__(self) -> int:
        return len(self._committed)

    def verify_replay(self, replayed: Dict[Tuple[int, int], bytes],
                      context: str = "",
                      floors: Optional[np.ndarray] = None) -> None:
        """`replayed` maps (group, index) -> payload from the restart's
        replay stream; it must be a superset of everything recorded
        ABOVE the replaying peer's compaction floors (`floors[g]`,
        optional): a compacted prefix legitimately does not replay — its
        entries live on in the state-machine snapshot the compaction was
        gated on, which the runner carries forward separately."""
        for (g, i), payload in self._committed.items():
            if floors is not None and i <= int(floors[g]):
                continue
            got = replayed.get((g, i))
            if got is None:
                raise InvariantViolation(
                    f"{context}: committed entry g{g} i{i} "
                    f"({payload!r}) lost across restart")
            if got != payload:
                raise InvariantViolation(
                    f"{context}: committed entry g{g} i{i} changed "
                    f"across restart ({payload!r} -> {got!r})")


def check_convergence(group: int, survivors: List[Tuple[int, int, Dict]],
                      context: str = "") -> None:
    """CONVERGENCE (post-snapshot survivors): after a fault-free heal
    window, every surviving peer of a group must have applied to the
    SAME index and hold IDENTICAL state-machine state — a peer rebuilt
    through InstallSnapshot included.  This is the end-to-end check the
    per-entry invariants cannot give: an installed snapshot could be
    internally consistent yet wrong (stale applied index, dropped dedup
    window, a key lost in blob serialization) and still pass log
    matching, because the installed peer no longer HAS the log below
    its floor to compare.

    survivors: [(peer, applied_index, state_dict)] for live peers.
    """
    if len(survivors) < 2:
        return
    tops = {a for (_, a, _) in survivors}
    if len(tops) != 1:
        raise InvariantViolation(
            f"{context}: g{group} survivors failed to converge: "
            f"applied indexes "
            f"{sorted((p, a) for (p, a, _) in survivors)}")
    _, _, ref = survivors[0]
    for (p, _, st) in survivors[1:]:
        if st != ref:
            raise InvariantViolation(
                f"{context}: g{group} survivor p{p} state diverges "
                f"from p{survivors[0][0]} at applied "
                f"{survivors[0][1]}")


class RemovedQuorumSafety:
    """NO QUORUM FROM A REMOVED MAJORITY (dynamic membership,
    raftsql_tpu_torch/membership/): every observed leader must be a voter of
    its OWN node's active configuration.  Leadership requires a quorum
    of vote grants; grantors only grant to peers they believe are
    voters (core/step.py voter_src gate) and tallies count only voters
    (mask-weighted quorum) — so once a removal has applied at a
    majority, the removed peers can never again assemble a quorum, and
    a leader observed outside its own config means exactly that
    property broke.  Additionally, once EVERY live node's applied
    config excludes a peer from group g, that peer must never be
    observed leading g at any later tick (covers a stale-config node
    trying to lead on the strength of other removed peers)."""

    def __init__(self, leader_code: int = 2):
        self._leader_code = leader_code
        # (group) -> set of peers fully removed (excluded by every live
        # node's applied config at some earlier observation).
        self._fully_removed: Dict[int, set] = {}
        self.observations = 0

    def observe(self, tick: int, roles: np.ndarray, voter_of,
                live_configs) -> None:
        """roles: [P, G] (dead rows < 0).  voter_of(p, g) -> bool: is p
        a voter (either joint mask) of NODE p's own applied config.
        live_configs: iterable of per-node (voters|joint) bitmask
        getters `fn(g) -> int` for live nodes (used for the
        fully-removed tracking)."""
        self.observations += 1
        P, G = roles.shape
        lead_p, lead_g = np.nonzero(roles == self._leader_code)
        for p, g in zip(lead_p.tolist(), lead_g.tolist()):
            if not voter_of(p, g):
                raise InvariantViolation(
                    f"t={tick} g={g}: peer {p} leads but is not a "
                    f"voter of its own applied configuration")
            if p in self._fully_removed.get(g, ()):
                raise InvariantViolation(
                    f"t={tick} g={g}: REMOVED peer {p} regained "
                    f"leadership — a removed majority formed a quorum")
        fns = list(live_configs)
        if not fns:
            return
        for g in range(G):
            masks = [fn(g) for fn in fns]
            excluded = {p for p in range(P)
                        if all(not (m >> p & 1) for m in masks)}
            if excluded:
                self._fully_removed.setdefault(g, set()).update(excluded)


class SessionConsistency:
    """Read-your-writes / monotonic reads for WATERMARK-carrying reads
    (the session/follower read modes): a read presenting watermark `w`
    on key k must return a committed write to k at log index >= the
    newest committed write to k at-or-below w — i.e. at least as fresh
    as everything the watermark covers.  Weaker than linearizability
    (a session read may legally miss writes committed after w), which
    is exactly why these modes get their own checker instead of the
    register rule.

    The committed write history arrives via note_commit(group, index,
    key, value) from whatever apply stream the runner trusts (unique
    values, like the register checker).  Thread-safe.
    """

    def __init__(self):
        import threading
        self._mu = threading.Lock()
        # key -> sorted-ish list of (global_order, value); value -> ord.
        self._by_key: Dict[Tuple[int, str], List[Tuple[int, str]]] = {}
        self._ord: Dict[str, Tuple[int, int]] = {}  # value -> (g, idx)
        self.reads_checked = 0

    def note_commit(self, group: int, index: int, key: str,
                    value: str) -> None:
        with self._mu:
            self._by_key.setdefault((group, key), []).append(
                (index, value))
            self._ord[value] = (group, index)

    def check_read(self, group: int, key: str, watermark: int,
                   value: str, mode: str = "session") -> None:
        """`value` came back from a read of `key` carrying `watermark`
        (a commit index of `group`)."""
        with self._mu:
            self.reads_checked += 1
            hist = self._by_key.get((group, key), ())
            floor = 0
            floor_val = None
            for (idx, v) in hist:
                if idx <= watermark and idx > floor:
                    floor, floor_val = idx, v
            if floor_val is None:
                return               # watermark predates every write
            if value == "":
                raise InvariantViolation(
                    f"{mode} read(g{group} {key!r}, wm={watermark}) "
                    f"returned the initial value but {floor_val!r} "
                    f"committed at index {floor} <= wm")
            got = self._ord.get(value)
            if got is None or got[0] != group:
                raise InvariantViolation(
                    f"{mode} read(g{group} {key!r}) returned a value "
                    f"never committed to that key: {value!r}")
            if got[1] < floor:
                raise InvariantViolation(
                    f"{mode} read(g{group} {key!r}, wm={watermark}) "
                    f"returned STALE {value!r} (index {got[1]}) — "
                    f"{floor_val!r} committed at {floor} <= wm")


class RegisterLinearizability:
    """Per-key register linearizability over completed PUT/GET history.

    PUT values are globally unique (the runners guarantee it), so a
    read names exactly the write it observed and the real-time
    precedence check is direct — no state-space search:

      a GET returning write w's value is legal iff
        * w was invoked before the GET's response (no reading the
          future), and
        * w does not STRICTLY PRECEDE (w.resp <= w2.inv) any write w2
          on the key that completed before the GET was invoked — such
          a w2 must linearize after w and before the GET, making w
          stale.

    The initial value "" is legal only while no write on the key has
    completed before the GET's invocation.  Incomplete writes (e.g.
    proposals lost in a crash, which may still commit after a restart)
    may linearize anywhere after their invocation or never — exactly
    the window these rules grant.  Overlapping writes to one key may
    legally complete in either order (leader failover reorders
    re-routed proposal queues), which is why precedence, not issue
    order, is the test.  This is the standard necessary-condition
    per-op check (cf. Jepsen's register checkers); it does not search
    for a single total order across reads.
    """

    def __init__(self):
        import threading
        # One lock serializes the logical clock and every history
        # mutation: the process-plane read nemesis drives this checker
        # from concurrent client threads, where an unlocked clock
        # could order two racing ops identically and mask (or invent)
        # a precedence edge.  Single-threaded runners pay one
        # uncontended acquire per op.
        self._mu = threading.Lock()
        self._clock = 0
        self._writes: Dict[str, list] = {}   # value -> [key, inv, resp]
        # key -> [(inv, resp), ...] of COMPLETED writes.
        self._completed: Dict[str, List[Tuple[int, int]]] = {}
        self.reads_checked = 0
        # Per read MODE accounting (lease/read_index/session/follower/
        # linear/...): the nemesis report proves every family actually
        # exercised the invariant.
        self.reads_by_mode: Dict[str, int] = {}

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # -- write lifecycle -----------------------------------------------

    def begin_write(self, key: str, value: str) -> None:
        with self._mu:
            if value in self._writes:
                raise ValueError(
                    f"write values must be unique: {value!r}")
            self._writes[value] = [key, self._tick(), None]

    def end_write(self, value: str) -> None:
        with self._mu:
            w = self._writes.get(value)
            if w is None or w[2] is not None:
                return                   # unknown or already completed
            w[2] = self._tick()
            self._completed.setdefault(w[0], []).append((w[1], w[2]))

    # -- read lifecycle ------------------------------------------------

    def begin_read(self, key: str, mode: str = "linear"
                   ) -> Tuple[str, int, str]:
        with self._mu:
            return key, self._tick(), mode

    def end_read(self, handle, value: str) -> None:
        key, inv, mode = (handle if len(handle) == 3
                          else (*handle, "linear"))
        with self._mu:
            resp = self._tick()
            self.reads_checked += 1
            self.reads_by_mode[mode] = self.reads_by_mode.get(mode,
                                                              0) + 1
            completed = self._completed.get(key, ())
            if value == "":
                for (i2, r2) in completed:
                    if r2 <= inv:
                        raise InvariantViolation(
                            f"{mode} read({key!r}) returned the "
                            f"initial value after a write completed "
                            f"before it")
                return
            w = self._writes.get(value)
            if w is None or w[0] != key:
                raise InvariantViolation(
                    f"{mode} read({key!r}) returned a value never "
                    f"written to that key: {value!r}")
            _, w_inv, w_resp = w
            if w_inv > resp:
                raise InvariantViolation(
                    f"{mode} read({key!r}) returned {value!r} invoked "
                    f"after the read's response")
            if w_resp is not None:
                for (i2, r2) in completed:
                    if r2 <= inv and w_resp <= i2:
                        raise InvariantViolation(
                            f"{mode} read({key!r}) returned STALE "
                            f"value {value!r}: a later write "
                            f"completed before the read began")


class TransferAvailability:
    """No availability loss during graceful leadership transfer.
    Every violation message carries the TRANSFER-AVAILABILITY
    token so the falsification harness can match on it precisely.

    Checks, per issued transfer:
      * the latch RESOLVES (completed or aborted) within the engine
        deadline plus a two-election-cycle settling margin — a stuck
        latch is a permanently closed group;
      * `must_complete` transfers (the directed falsification probe)
        must end `completed` with stall <= max_stall_ticks — the
        broken unsafe kernel deterministically ABORTS here because the
        behind target cannot win the election it was handed;
      * a transfer resolving in fault-free air must be followed by a
        committed probe write within probe_ticks (aborted transfers
        leave the group SERVING, not just unlatched).

    The runner feeds outcomes from the host's transfer event log and
    calls check(t) every tick; crashes wipe pending state (the latch
    dies with the process — a transfer outstanding at crash time is
    void, not violated)."""

    def __init__(self, election_ticks: int, deadline_ticks: int,
                 max_stall_ticks: int, probe_ticks: int):
        self.election_ticks = election_ticks
        self.deadline_ticks = deadline_ticks
        self.max_stall_ticks = max_stall_ticks
        self.probe_ticks = probe_ticks
        # group -> (issue_tick, must_complete)
        self._pending: Dict[int, Tuple[int, bool]] = {}
        # probe value -> (deadline_tick, group)
        self._probes: Dict[str, Tuple[int, int]] = {}
        self.completed = 0
        self.aborted = 0
        self.max_stall = 0
        self.probes_confirmed = 0

    # -- transfer lifecycle --------------------------------------------

    def note_issued(self, tick: int, group: int,
                    must_complete: bool) -> None:
        self._pending[group] = (tick, must_complete)

    def note_outcome(self, tick: int, group: int, outcome: str,
                     stall_ticks: int) -> None:
        issued = self._pending.pop(group, None)
        self.max_stall = max(self.max_stall, int(stall_ticks))
        if outcome == "completed":
            self.completed += 1
        else:
            self.aborted += 1
        if issued is None:
            return
        _t0, must = issued
        if must and outcome != "completed":
            raise InvariantViolation(
                f"TRANSFER-AVAILABILITY: directed transfer of group "
                f"{group} was required to complete but ended "
                f"{outcome!r} after {stall_ticks} ticks — the engine "
                f"deposed a leader without getting its successor "
                f"elected")
        if must and stall_ticks > self.max_stall_ticks:
            raise InvariantViolation(
                f"TRANSFER-AVAILABILITY: directed transfer of group "
                f"{group} stalled proposals for {stall_ticks} ticks "
                f"(bound {self.max_stall_ticks})")

    def note_crash(self) -> None:
        # Latches (and any not-yet-committed probe) die with the
        # process; outstanding transfers are void, not violated.
        self._pending.clear()
        self._probes.clear()

    # -- serving probes ------------------------------------------------

    def arm_probe(self, tick: int, group: int, value: str) -> None:
        self._probes[value] = (tick + self.probe_ticks, group)

    def probe_committed(self, value: str) -> None:
        if self._probes.pop(value, None) is not None:
            self.probes_confirmed += 1

    # -- per-tick / end-of-run checks ----------------------------------

    def check(self, tick: int) -> None:
        limit = self.deadline_ticks + 2 * self.election_ticks
        for group, (t0, _must) in self._pending.items():
            if tick - t0 > limit:
                raise InvariantViolation(
                    f"TRANSFER-AVAILABILITY: transfer of group {group} "
                    f"issued at tick {t0} still unresolved at tick "
                    f"{tick} (engine deadline {self.deadline_ticks})")
        for value, (dl, group) in self._probes.items():
            if tick > dl:
                raise InvariantViolation(
                    f"TRANSFER-AVAILABILITY: post-transfer probe write "
                    f"{value!r} on group {group} did not commit within "
                    f"{self.probe_ticks} ticks — the group stopped "
                    f"serving after its transfer resolved")

    def final_check(self, tick: int) -> None:
        for group, (t0, _must) in self._pending.items():
            raise InvariantViolation(
                f"TRANSFER-AVAILABILITY: transfer of group {group} "
                f"issued at tick {t0} never resolved by end of run "
                f"({tick} ticks)")


class NoAckedWriteLost:
    """Elastic-keyspace safety: every acked write stays readable
    in EXACTLY ONE post-reshard group.  Every violation message carries
    the NO-ACKED-WRITE-LOST token so the falsification harness can
    match on it precisely.

    The runner feeds it the client ack stream (`note_ack` fires when
    peer 0 applies a keyed write that was not bounced by the reshard
    fence) and asks for two checks:

      * `check_moved` at the instant a router flip lands: the moved
        keys' latest acked values must already be served by the NEW
        owner — a coordinator that flipped before the destination
        durably applied the copies fails here (the broken_flip
        falsification variant);
      * `check_exclusive` at verb completion and after every restart
        with no verb in flight (the WAL-fold post-mortem: the runner's
        keyed state was just rebuilt from the replayed logs): each
        acked key's latest value is served by its owner and by NO other
        group — a half-cleaned source or a half-copied destination
        fails here.
    """

    def __init__(self):
        self.acked: Dict[str, str] = {}    # key -> latest acked value
        self.moved_checks = 0
        self.exclusive_checks = 0

    def note_ack(self, key: str, value: str) -> None:
        self.acked[key] = value

    def check_moved(self, moved_keys, dst: int, dst_kv: Dict[str, str],
                    context: str = "") -> None:
        for k in sorted(moved_keys):
            want = self.acked.get(k)
            if want is None:
                continue                   # never acked: nothing owed
            got = dst_kv.get(k)
            self.moved_checks += 1
            if got != want:
                raise InvariantViolation(
                    f"NO-ACKED-WRITE-LOST: router flipped key {k!r} to "
                    f"group {dst} but the acked value {want!r} is not "
                    f"there (new owner serves {got!r}) — the flip "
                    f"outran the copy fence{context}")

    def check_exclusive(self, keymap, gkvs: Dict[int, Dict[str, str]],
                        context: str = "") -> None:
        for k in sorted(self.acked):
            want = self.acked[k]
            owner = keymap.group_of(k)
            got = gkvs.get(owner, {}).get(k)
            self.exclusive_checks += 1
            if got != want:
                raise InvariantViolation(
                    f"NO-ACKED-WRITE-LOST: acked key {k!r}={want!r} not "
                    f"served by its owner group {owner} (serves "
                    f"{got!r}){context}")
            for g, kv in gkvs.items():
                if g != owner and k in kv:
                    raise InvariantViolation(
                        f"NO-ACKED-WRITE-LOST: key {k!r} readable in "
                        f"group {g} AND its owner {owner} — reshard "
                        f"cleanup left a duplicate shard{context}")


class NoAvailabilityLoss:
    """Elastic-keyspace availability: resharding one key range
    never takes the REST of the keyspace down, and verbs always
    resolve.  Every violation message carries the NO-AVAILABILITY-LOSS
    token.

    Probe writes to keys outside the moving range, armed only in
    fault-free air while a verb is active, must commit within
    `probe_ticks`.  A verb unresolved `verb_deadline_ticks` after issue
    (or still in flight at end of run) is a violation — a wedged
    coordinator is a permanently frozen key range.  Crashes void armed
    probes (the client died with the process) and restart the active
    verb's clock (recovery legitimately takes time)."""

    def __init__(self, probe_ticks: int, verb_deadline_ticks: int):
        self.probe_ticks = probe_ticks
        self.verb_deadline_ticks = verb_deadline_ticks
        self._probes: Dict[str, Tuple[int, str]] = {}
        self._verb: Optional[Tuple[int, int]] = None  # (issue_tick, id)
        self.probes_confirmed = 0

    # -- verb lifecycle ------------------------------------------------
    def verb_started(self, tick: int, vid: int) -> None:
        self._verb = (tick, vid)

    def verb_resolved(self) -> None:
        self._verb = None

    def note_crash(self, tick: int) -> None:
        self._probes.clear()
        if self._verb is not None:
            self._verb = (tick, self._verb[1])

    # -- probes --------------------------------------------------------
    def arm_probe(self, tick: int, key: str, value: str) -> None:
        self._probes[value] = (tick + self.probe_ticks, key)

    def probe_committed(self, value: str) -> None:
        if self._probes.pop(value, None) is not None:
            self.probes_confirmed += 1

    # -- per-tick / end-of-run checks ----------------------------------
    def check(self, tick: int) -> None:
        for value, (dl, key) in self._probes.items():
            if tick > dl:
                raise InvariantViolation(
                    f"NO-AVAILABILITY-LOSS: probe write {value!r} to "
                    f"key {key!r} (outside the moving range) did not "
                    f"commit within {self.probe_ticks} ticks of a "
                    f"reshard verb — the verb took the rest of the "
                    f"keyspace down with it")
        if self._verb is not None:
            t0, vid = self._verb
            if tick - t0 > self.verb_deadline_ticks:
                raise InvariantViolation(
                    f"NO-AVAILABILITY-LOSS: reshard verb {vid} issued "
                    f"at tick {t0} still unresolved at tick {tick} "
                    f"(bound {self.verb_deadline_ticks}) — its key "
                    f"range is frozen indefinitely")

    def final_check(self, tick: int) -> None:
        if self._verb is not None:
            t0, vid = self._verb
            raise InvariantViolation(
                f"NO-AVAILABILITY-LOSS: reshard verb {vid} issued at "
                f"tick {t0} never resolved by end of run ({tick} "
                f"ticks)")
