"""Reshard coordinator: SPLIT / MERGE / MIGRATE as resumable step machines.

One verb runs at a time (the membership plane's single-latch precedent).
The coordinator owns no durable state of its own: every step it takes is
journaled through the SOURCE group's raft log before the next step may
begin, so a coordinator SIGKILLed anywhere can be rebuilt from the
journal fold (`recover`) and either resumes the verb forward or aborts
it cleanly — it never half-applies a flip.

Step order for SPLIT (MERGE is a SPLIT of all the source's slots plus a
retire; both move slots src -> dst):

  begin   journal `begin`, freeze the moving slots (intake refused)
  drain   wait until src has APPLIED everything it committed for them
  copy    propose every moving row to dst, wait until dst APPLIED them
          — this is the durability fence the router flip waits behind
  copied  journal `copied` (the fence is now in the log)
  flip    journal `flip`; once applied, move the slots in the keymap,
          bump the epoch, publish, unfreeze — dst owns the keys
  cleanup range-delete the moved rows out of src; journal `done`

MIGRATE ships the group's snapshot image to another host dir (disk
faults abort the verb cleanly) and cuts the leader over via the
existing catch-up-gated transfer kernel; the keyspace never moves.

The coordinator talks to the world through a duck-typed backend (the
chaos runner wires it to the in-process node plane; the serving plane
wires it to RaftDB), and advances only inside `step()` — callers choose
the cadence (the chaos runner calls it once per tick for determinism,
the server runs a small thread).

Copy of raftsql_tpu/reshard/coordinator.py, `broken_flip` and the
witness refusal included.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from .keymap import KeyMap

VERBS = ("split", "merge", "migrate")

# Re-propose cadence for idempotent pending work (journal records,
# copies, range deletes) while a waiting state is starved — proposals
# routed at a deposed leader are simply re-issued at the next one.
RETRY_STEPS = 40

# Duration histogram bucket upper bounds, in coordinator steps.
DURATION_BUCKETS = (5, 10, 20, 50, 100, 200, 500)


class ReshardRefused(Exception):
    """A verb was rejected (one already in flight, or invalid args)."""


class ReshardCoordinator:
    """Single-verb reshard executor over an abstract backend.

    Thread model: HTTP/admin threads call `enqueue`/`doc`/`metrics_doc`
    while one driver thread (or the chaos tick loop) calls `step` —
    every mutation of coordinator state happens under `_mu`.
    """

    def __init__(self, backend, keymap: KeyMap, *,
                 num_groups: Optional[int] = None,
                 broken_flip: bool = False,
                 retry_steps: int = RETRY_STEPS,
                 clock: Optional[Callable[[], float]] = None,
                 witness_peers: tuple = ()):
        self.backend = backend
        self.keymap = keymap
        # Witness peers (config.py quorum geometry) own no shard, so a
        # migrate verb must never pick one as its destination.
        self.witness_peers = frozenset(witness_peers)
        self.num_groups = int(num_groups) if num_groups is not None \
            else len(set(keymap.slots) | keymap.retired)
        # Falsification hook: flip the router WITHOUT waiting for the
        # destination group to durably apply the copied rows.  Chaos
        # harness only — NoAckedWriteLost MUST catch this variant.
        self.broken_flip = bool(broken_flip)
        self.retry_steps = int(retry_steps)
        self._clock = clock
        self._mu = threading.Lock()
        self._cur: Optional[Dict] = None  # raftlint: guarded-by=_mu
        self._steps = 0                   # raftlint: guarded-by=_mu
        self._next_id = 1                 # raftlint: guarded-by=_mu
        self.events: List[Dict] = []      # raftlint: guarded-by=_mu
        # raftlint: guarded-by=_mu
        self.counters = {"splits": 0, "merges": 0, "migrations": 0,
                         "aborted": 0, "resumed": 0, "fork_faults": 0}
        self._durations: Dict[str, List[float]] = {v: [] for v in VERBS}

    # ------------------------------------------------------------------
    # intake
    # ------------------------------------------------------------------
    def enqueue(self, verb: str, src: int, dst: int,
                slots=None) -> int:
        """Start a verb; returns its journal id.  Raises ReshardRefused
        while another verb is in flight or the arguments are invalid."""
        with self._mu:
            if self._cur is not None:
                raise ReshardRefused("reshard verb already in flight")
            if verb not in VERBS:
                raise ReshardRefused(f"unknown verb {verb!r}")
            src, dst = int(src), int(dst)
            if verb == "merge":
                slots = self.keymap.slots_of(src)
                if not slots:
                    raise ReshardRefused("merge source owns no slots")
            elif verb == "split":
                owned = set(self.keymap.slots_of(src))
                slots = sorted(int(s) for s in (slots or ()))
                if not slots or not set(slots) <= owned:
                    raise ReshardRefused("split slots not owned by src")
                if set(slots) == owned and dst != src:
                    verb = "merge"   # moving everything IS a merge
            else:                    # migrate: dst is a target peer
                if dst in self.witness_peers:
                    raise ReshardRefused(
                        f"peer {dst} is a witness (owns no shard); "
                        "not a migration destination")
                slots = []
            if verb != "migrate" and src == dst:
                raise ReshardRefused("src and dst are the same group")
            vid = self._next_id
            self._next_id += 1
            self._cur = {
                "id": vid, "verb": verb, "src": src, "dst": dst,
                "slots": list(slots), "state": "j:begin",
                "t_state": self._steps, "t0": self._steps,
                "wall0": self._clock() if self._clock else None,
                "rows": None, "shipped": False,
            }
            if verb != "migrate":
                self.keymap.freeze(slots)
            self._journal("begin")
            self.backend.publish(self.keymap)
            self._emit("begin")
            return vid

    # ------------------------------------------------------------------
    # recovery
    # ------------------------------------------------------------------
    def recover(self, records) -> None:
        """Rebuild router + verb state from applied journal records (the
        SIGKILL-restart path).  Folds the journal into the keymap, then
        re-enters the active verb at its last journaled step — or the
        abort path when the copy fence never made the log."""
        from .journal import fold_records
        with self._mu:
            km, active = fold_records(
                records, num_groups=self.num_groups,
                nslots=self.keymap.nslots)
            # fold_records rebuilt slot->group/epoch; graft it onto the
            # map object the router is already holding.
            self.keymap.slots = km.slots
            self.keymap.epoch = km.epoch
            self.keymap.retired = km.retired
            self.keymap.frozen = km.frozen
            ids = [0]
            for rec in records:
                if rec and "id" in rec:
                    ids.append(int(rec["id"]))
            self._next_id = max(ids) + 1
            self.backend.publish(self.keymap)
            if active is None:
                return
            steps = active["steps"]
            cur = {
                "id": active["id"], "verb": active.get("verb", "split"),
                "src": int(active.get("src", 0)),
                "dst": int(active.get("dst", 0)),
                "slots": list(active.get("slots", ())),
                "t_state": self._steps, "t0": self._steps,
                "wall0": self._clock() if self._clock else None,
                "rows": None, "shipped": "shipped" in steps,
            }
            self._cur = cur
            if cur["verb"] == "migrate":
                if "shipped" in steps:
                    cur["state"] = "cutover"   # re-drive the transfer
                else:
                    cur["state"] = "abort"     # ship not fenced: retry
            elif "flip" in steps:
                # Router flip is in the logs: finish the cleanup half
                # (re-sending the dst grant in case it never applied).
                self.backend.rdel(cur["src"], cur["slots"], cur["id"])
                self._journal_grant()
                cur["state"] = "cleanup"
            elif "copied" in steps:
                # Copy fence journaled: dst holds the rows; flip.
                self._journal("flip")
                cur["state"] = "j:flip"
            else:
                # Crashed before the copy fence: the slots may be
                # half-copied into dst.  Undo and release the freeze —
                # never guess forward past an unfenced copy.
                cur["state"] = "abort"
            self.counters["resumed"] += 1
            self._emit("resume", state=cur["state"])

    # ------------------------------------------------------------------
    # the step machine
    # ------------------------------------------------------------------
    def step(self) -> None:
        """Advance the active verb by at most one state transition.
        Non-blocking: every wait is a poll against the backend."""
        with self._mu:
            self._steps += 1
            cur = self._cur
            if cur is None:
                return
            state = cur["state"]
            handler = getattr(self, "_st_" + state.replace(":", "_"))
            handler(cur)

    def _goto(self, cur: Dict, state: str) -> None:
        cur["state"] = state
        cur["t_state"] = self._steps

    def _starved(self, cur: Dict) -> bool:
        """True once per retry window while a wait state is starved."""
        waited = self._steps - cur["t_state"]
        return waited > 0 and waited % self.retry_steps == 0

    def _journal(self, step: str) -> None:
        cur = self._cur
        rec = {"id": cur["id"], "verb": cur["verb"], "step": step,
               "src": cur["src"], "dst": cur["dst"],
               "slots": list(cur["slots"]),
               "nslots": self.keymap.nslots}
        self.backend.journal(cur["src"], rec)

    def _journal_grant(self) -> None:
        """Propose the flip record into the DESTINATION group's log too
        (fire-and-forget: the src copy is the authoritative gate).  In
        dst's own log order the grant sits after every copied row, so it
        (a) closes the verb against stale re-proposed copies and (b)
        clears dst's flipped-away fence if dst is re-acquiring slots it
        once flipped away."""
        cur = self._cur
        rec = {"id": cur["id"], "verb": cur["verb"], "step": "flip",
               "src": cur["src"], "dst": cur["dst"],
               "slots": list(cur["slots"]),
               "nslots": self.keymap.nslots}
        self.backend.journal(cur["dst"], rec, want=False)

    # raftlint: owner=driver -- only reached under _mu (step/enqueue/recover)
    def _emit(self, kind: str, **extra) -> None:
        cur = self._cur
        ev = {"kind": kind, "id": cur["id"], "verb": cur["verb"],
              "src": cur["src"], "dst": cur["dst"],
              "slots": list(cur["slots"])}
        ev.update(extra)
        self.events.append(ev)

    # -- split/merge states --------------------------------------------
    def _st_j_begin(self, cur: Dict) -> None:
        if not self.backend.journal_applied(cur["id"], "begin"):
            if self._starved(cur):
                self._journal("begin")
            return
        if cur["verb"] == "migrate":
            self._goto(cur, "ship")
        else:
            self._goto(cur, "drain")

    def _st_drain(self, cur: Dict) -> None:
        if not self.backend.drained(cur["src"], cur["slots"]):
            return
        cur["rows"] = self.backend.rows_of(cur["src"], cur["slots"])
        self.backend.copy(cur["dst"], cur["rows"])
        self._goto(cur, "copy")

    def _st_copy(self, cur: Dict) -> None:
        if not self.broken_flip:
            if not self.backend.copy_settled(cur["dst"], cur["rows"]):
                if self._starved(cur):
                    self.backend.copy(cur["dst"], cur["rows"])
                return
        # BROKEN variant falls straight through: the fence is journaled
        # before dst durably holds the rows — the premature router flip
        # NoAckedWriteLost exists to catch.
        self._journal("copied")
        self._goto(cur, "j:copied")

    def _st_j_copied(self, cur: Dict) -> None:
        if not self.backend.journal_applied(cur["id"], "copied"):
            if self._starved(cur):
                self._journal("copied")
            return
        self._journal("flip")
        self._goto(cur, "j:flip")

    def _st_j_flip(self, cur: Dict) -> None:
        if not self.backend.journal_applied(cur["id"], "flip"):
            if self._starved(cur):
                self._journal("flip")
            return
        self._flip_router(cur)
        self._journal_grant()
        self.backend.rdel(cur["src"], cur["slots"], cur["id"])
        self._emit("flip", epoch=self.keymap.epoch)
        self._goto(cur, "cleanup")

    def _flip_router(self, cur: Dict):  # raftlint: fail-closed
        """Atomically re-point the moving slots at dst and publish the
        new epoch.  Only reachable once the flip record is APPLIED in
        the source group's log — the flip exists in the same total
        order as the writes it fences."""
        self.keymap.move(cur["slots"], cur["dst"])
        self.keymap.unfreeze(cur["slots"])
        if cur["verb"] == "merge":
            try:
                self.keymap.retire(cur["src"])
            except ValueError:
                # src still owns slots — impossible while verbs are
                # serialized; publish the move, refuse the retire.
                return self.backend.publish(self.keymap)
        return self.backend.publish(self.keymap)

    def _st_cleanup(self, cur: Dict) -> None:
        if not self.backend.rdel_settled(cur["src"], cur["slots"],
                                         cur["id"]):
            if self._starved(cur):
                self.backend.rdel(cur["src"], cur["slots"], cur["id"])
                self._journal_grant()
            return
        self._journal("done")
        self._goto(cur, "j:done")

    def _st_j_done(self, cur: Dict) -> None:
        if not self.backend.journal_applied(cur["id"], "done"):
            if self._starved(cur):
                self._journal("done")
            return
        self._finish(cur, aborted=False)

    # -- migrate states ------------------------------------------------
    # raftlint: owner=driver -- only reached from step(), which holds _mu
    def _st_ship(self, cur: Dict) -> None:
        try:
            self.backend.ship(cur["src"], cur["dst"])
        except OSError:
            # Disk fault while forking/writing the snapshot image: the
            # target never saw a byte it could mistake for a shard —
            # journal the abort and leave the group where it is.
            self.counters["fork_faults"] += 1
            self._emit("fork-fault")
            self._goto(cur, "abort")
            return
        cur["shipped"] = True
        self._journal("shipped")
        self._goto(cur, "j:shipped")

    def _st_j_shipped(self, cur: Dict) -> None:
        if not self.backend.journal_applied(cur["id"], "shipped"):
            if self._starved(cur):
                self._journal("shipped")
            return
        self._goto(cur, "cutover")

    def _st_cutover(self, cur: Dict) -> None:
        outcome = self.backend.cutover(cur["src"], cur["dst"],
                                       retry=self._starved(cur))
        if outcome is None:
            return
        if outcome == "completed":
            self._journal("done")
            self._goto(cur, "j:done")
        else:
            self._goto(cur, "abort")

    # -- abort path ----------------------------------------------------
    def _st_abort(self, cur: Dict) -> None:
        if cur["verb"] != "migrate":
            # Undo any partial copies that landed in dst before the
            # crash; the rdel is idempotent and keyed by slot, and dst
            # owned none of these slots pre-flip, so it only ever
            # deletes the half-copied rows.
            self.backend.rdel(cur["dst"], cur["slots"], cur["id"])
        self._journal("abort")
        self._goto(cur, "j:abort")

    def _st_j_abort(self, cur: Dict) -> None:
        if cur["verb"] != "migrate" and not self.backend.rdel_settled(
                cur["dst"], cur["slots"], cur["id"]):
            if self._starved(cur):
                self.backend.rdel(cur["dst"], cur["slots"], cur["id"])
            return
        if not self.backend.journal_applied(cur["id"], "abort"):
            if self._starved(cur):
                self._journal("abort")
            return
        if cur["verb"] != "migrate":
            self.keymap.unfreeze(cur["slots"])
            self.backend.publish(self.keymap)
        self._finish(cur, aborted=True)

    # -- completion ----------------------------------------------------
    # raftlint: owner=driver -- only reached from step(), which holds _mu
    def _finish(self, cur: Dict, aborted: bool) -> None:
        if aborted:
            self.counters["aborted"] += 1
        else:
            key = {"split": "splits", "merge": "merges",
                   "migrate": "migrations"}[cur["verb"]]
            self.counters[key] += 1
        if self._clock and cur.get("wall0") is not None:
            dur = self._clock() - cur["wall0"]
        else:
            dur = float(self._steps - cur["t0"])
        self._durations[cur["verb"]].append(dur)
        self._emit("abort" if aborted else "done",
                   epoch=self.keymap.epoch)
        self._cur = None

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def busy(self) -> bool:
        with self._mu:
            return self._cur is not None

    def drain_events(self) -> List[Dict]:
        with self._mu:
            evs, self.events = self.events, []
            return evs

    def doc(self) -> Dict:
        with self._mu:
            cur = None
            if self._cur is not None:
                cur = {k: self._cur[k] for k in
                       ("id", "verb", "src", "dst", "slots", "state")}
            return {"active": cur, "keymap": self.keymap.to_doc(),
                    "counters": dict(self.counters)}

    def metrics_doc(self) -> Dict:
        """Counters + per-verb duration histogram for /metrics.
        Durations are in coordinator steps unless a wall clock was
        injected, in which case they are seconds."""
        with self._mu:
            hists = {}
            for verb, durs in self._durations.items():
                buckets = {}
                for le in DURATION_BUCKETS:
                    buckets[str(le)] = sum(1 for d in durs if d <= le)
                buckets["inf"] = len(durs)
                hists[verb] = {"count": len(durs),
                               "sum": round(sum(durs), 6),
                               "bucket": buckets}
            doc = dict(self.counters)
            doc["epoch"] = self.keymap.epoch
            doc["active"] = 1 if self._cur is not None else 0
            doc["duration"] = hists
            return doc
