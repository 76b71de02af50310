"""Serving-plane reshard: the coordinator wired to a live RaftDB.

`ReshardPlane` adapts the chaos-proven `ReshardCoordinator` step
machine onto the real serving stack: journal records are replicated as
rows of the `_reshard_journal` table THROUGH the raft log of the source
group (exactly as durable and ordered as the data they govern, and
carried inside every snapshot/fork — META_TABLES in fork.py), copies
are replicated `INSERT OR REPLACE` statements into the destination
group's log, the router is the shared `KeyMap` the /kv surface and the
worker shm plane consult, and MIGRATE ships a real
`SQLiteStateMachine.serialize` image through the fault-injectable fsio
plane before cutting the leader over with the existing catch-up-gated
transfer kernel.

Intake model (vs the chaos plane's in-log fence): the /kv surface
routes by the keymap and REFUSES writes to frozen slots up front
(503, client retries after the verb), so the drain step only has to
wait out writes already in flight at freeze time — applied catching
the group's commit watermark with no pending acks left.  The chaos
harness proves the stronger in-log-fence variant; this plane trades it
for zero per-statement overhead on the hot path, which is sound
because frozen-slot intake is refused BEFORE propose.

Clients fail closed on the mapping epoch: every /kv response carries
`X-Raft-Keymap-Epoch`, a request pinned to a stale epoch is refused
with 409 + the current keymap document, and `api/client.py` refreshes
its cached mapping from /healthz instead of guessing.

Crash recovery: `recover_from_db()` folds every group's journal table
(rebuilt by WAL replay / snapshot install before RaftDB's constructor
returns) and resumes or aborts the active verb — the same
`fold_records` path the chaos nemesis SIGKILLs against.

Port of raftsql_tpu/reshard/plane.py.  Where it meets the port's engine:
`drained` and `cutover` read the host plane's numpy caches
(`commit_watermark`, `leader_of`), never a device tensor, so the
coordinator thread never waits on the device; `ship` images a 0-page
database (a group whose only applied commands failed) through
SQLiteStateMachine's `VACUUM INTO` path; and `rows_of` and `copy`
handle a group that no keyed write has reached yet, where the JAX
package's plane raises on every step and the verb never resolves.
Under --workers the HTTP planes reach this plane over the ring
(runtime/ring.py ops 6 and 7).
"""
from __future__ import annotations

import logging
import os
import sqlite3
import threading
import time
from typing import Dict, List, Optional

from raftsql_tpu_torch.storage import fsio

from .coordinator import ReshardCoordinator
from .journal import decode_record, encode_record
from .keymap import DEFAULT_NSLOTS, KeyMap, slot_of

log = logging.getLogger("raftsql.reshard")

JOURNAL_DDL = ("CREATE TABLE IF NOT EXISTS _reshard_journal "
               "(rec TEXT NOT NULL)")

# Proposal ack budget for plane-internal writes (journal records, row
# copies, range deletes).  Generous: these ride the same log as client
# traffic and starvation is retried by the coordinator anyway.
ACK_TIMEOUT_S = 5.0


def _sql_str(s: str) -> str:
    return "'" + str(s).replace("'", "''") + "'"


class WrongEpoch(Exception):
    """A /kv request pinned a stale (or future) keymap epoch — the
    caller must refresh its mapping and retry (fail closed, never serve
    a key the router may have moved)."""

    def __init__(self, have: int, want: int):
        super().__init__(f"keymap epoch mismatch: request pinned "
                         f"{want}, serving {have}")
        self.have = have
        self.want = want


class FrozenSlot(Exception):
    """The key's slot is mid-reshard; intake is refused (retryable)."""

    def __init__(self, key: str, slot: int):
        super().__init__(f"key {key!r} (slot {slot}) is resharding; "
                         f"retry after the verb resolves")
        self.key = key
        self.slot = slot


class ReshardPlane:
    """Reshard coordinator + router for one RaftDB node.

    Thread model: HTTP/ring/admin threads call `route_*`/`enqueue`/
    `doc`; one driver thread (started by `start`, or the owner calls
    `step` directly in tests) advances the coordinator.  The KeyMap is
    only mutated inside the coordinator (under its lock); readers
    snapshot `epoch` first and fail closed on mismatch at response
    time, so a torn read of slots mid-flip cannot serve the wrong
    group silently.
    """

    def __init__(self, db, nslots: int = DEFAULT_NSLOTS,
                 ship_dir: Optional[str] = None,
                 table: str = "kv", keycol: str = "k",
                 valcol: str = "v",
                 step_interval_s: float = 0.02):
        self.db = db
        self.table = table
        self.keycol = keycol
        self.valcol = valcol
        self.step_interval_s = step_interval_s
        self.ship_dir = ship_dir or os.path.join(
            getattr(db, "data_dir", "."), "reshard-ship")
        self.keymap = KeyMap.initial(db.num_groups, nslots)
        wit = getattr(getattr(db.pipe, "node", None), "cfg", None)
        self.coord = ReshardCoordinator(
            self, self.keymap, num_groups=db.num_groups,
            clock=time.monotonic,
            witness_peers=tuple(wit.witness_set) if wit is not None
            else ())
        self._ddl_done: set = set()      # groups with the journal table
        self._kv_ddl_done: set = set()   # groups with the kv table
        # Per-slot PUT counters feeding split-hottest's partition
        # choice (placement/controller.py).  Bare int increments from
        # serving threads: a lost update only skews an advisory load
        # estimate, never routing — not worth a hot-path lock.
        self.slot_hits = [0] * int(nslots)
        self._jwant: Dict[tuple, int] = {}
        self._cutover_at: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        db.reshard = self

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        self.recover_from_db()
        self._thread = threading.Thread(target=self._drive, daemon=True,
                                        name="reshard-coordinator")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _drive(self) -> None:
        while not self._stop.is_set():
            try:
                self.coord.step()
            except Exception:                           # noqa: BLE001
                log.exception("reshard step failed; verb keeps retrying")
            self._stop.wait(self.step_interval_s)

    def step(self) -> None:
        self.coord.step()

    def recover_from_db(self) -> None:
        """Fold every group's replicated journal table (rebuilt by WAL
        replay before RaftDB's constructor returned) and resume/abort
        the active verb — the restarted-coordinator path."""
        records: List[dict] = []
        for g in range(self.db.num_groups):
            got = self._journal_rows(g)
            if got:
                # This group has the journal table.  (The JAX package
                # tests the records of every group so far, so after a
                # restart later groups count as having it, and the
                # flip grant into one of them fails: no such table.)
                self._ddl_done.add(g)
            records.extend(got)
        if records:
            self.coord.recover(records)

    # -- routing (the /kv surface) -------------------------------------

    def kv_put(self, key: str, value: str,
               epoch: Optional[int] = None):
        """Route a keyed write: epoch fail-closed check, frozen-slot
        refusal, then (group, sql) for the caller to propose.  Ensures
        the kv table exists on the target group first (idempotent DDL
        through the same log)."""
        self.check_epoch(epoch)
        g = self.group_for_write(key)
        self._ensure_kv(g)
        sql = (f"INSERT OR REPLACE INTO {self.table} "
               f"({self.keycol}, {self.valcol}) VALUES "
               f"({_sql_str(key)}, {_sql_str(value)})")
        return g, sql

    def kv_get(self, key: str, epoch: Optional[int] = None):
        """Route a keyed read: (group, sql).  Reads on frozen slots
        still serve (the source keeps the rows until the flip; after
        the flip the new epoch routes here to the destination).  The
        value is selected hex-encoded so the query plane's pipe-
        delimited row rendering cannot tear a value containing '|' —
        kv_value() decodes the response."""
        self.check_epoch(epoch)
        g = self.group_for_read(key)
        sql = (f"SELECT hex({self.valcol}) FROM {self.table} "
               f"WHERE {self.keycol} = {_sql_str(key)}")
        return g, sql

    @staticmethod
    def kv_value(rendered: str) -> Optional[str]:
        """Decode a kv_get response row (`|<hex>|\\n`) back to the
        value; None when the key does not exist (no rows)."""
        line = rendered.strip()
        if not line:
            return None
        return bytes.fromhex(line.strip("|")).decode("utf-8")

    def _ensure_kv(self, group: int) -> None:
        if group in self._kv_ddl_done:
            return
        self._propose(group,
                      f"CREATE TABLE IF NOT EXISTS {self.table} "
                      f"({self.keycol} TEXT PRIMARY KEY, "
                      f"{self.valcol} TEXT)")
        self._kv_ddl_done.add(group)

    def check_epoch(self, epoch: Optional[int]) -> int:
        """Fail closed: a request pinned to any epoch but the current
        one is refused with the current mapping attached."""
        have = self.keymap.epoch
        if epoch is not None and int(epoch) != have:
            raise WrongEpoch(have, int(epoch))
        return have

    def group_for_write(self, key: str) -> int:
        s = self.keymap.slot_of(key)
        if s in self.keymap.frozen:
            raise FrozenSlot(key, s)
        self.slot_hits[s] += 1
        return self.keymap.slots[s]

    def group_for_read(self, key: str) -> int:
        return self.keymap.group_of(key)

    # -- admin ---------------------------------------------------------

    def enqueue(self, verb: str, src: int, dst: int,
                slots=None) -> dict:
        vid = self.coord.enqueue(verb, src, dst, slots)
        return {"id": vid, "verb": verb, "src": int(src),
                "dst": int(dst), "epoch": self.keymap.epoch}

    def doc(self) -> dict:
        d = self.coord.doc()
        d["table"] = self.table
        return d

    def metrics_doc(self) -> dict:
        return self.coord.metrics_doc()

    # -- coordinator backend -------------------------------------------
    # All plane-internal reads go through the local state machine (the
    # apply thread's view): "applied" for this node IS the coordinator's
    # durability fence, same as the chaos runner's peer-0 stream.

    def _rows(self, group: int, sql: str) -> List[tuple]:
        sm = self.db._sms[group]
        fn = getattr(sm, "rows", None)
        if fn is not None:
            return fn(sql)
        out = []
        for line in sm.query(sql).splitlines():
            if line.startswith("|") and line.endswith("|"):
                out.append(tuple(line[1:-1].split("|")))
        return out

    def _journal_rows(self, group: int) -> List[dict]:
        try:
            raw = self._rows(group,
                             "SELECT rec FROM _reshard_journal")
        except Exception:                               # noqa: BLE001
            return []            # table not created yet on this group
        out = []
        for (payload,) in raw:
            rec = decode_record(payload)
            if rec is not None:
                out.append(rec)
        return out

    def _propose(self, group: int, sql: str) -> None:
        """Fire a plane-internal statement into a group's log.  Waits
        briefly for the ack (starvation is fine — every caller in the
        coordinator re-proposes idempotently on its retry cadence)."""
        fut = self.db.propose(sql, group)
        try:
            err = fut.wait(ACK_TIMEOUT_S)
            if err is not None:
                log.warning("reshard proposal %r on group %d: %s",
                            sql[:64], group, err)
        except TimeoutError:
            self.db.abandon(sql, group, fut)

    def _ensure_ddl(self, group: int) -> None:
        if group in self._ddl_done:
            return
        self._propose(group, JOURNAL_DDL)
        self._ddl_done.add(group)

    def journal(self, group: int, rec: dict, want: bool = True) -> None:
        group = int(group)
        if want:
            self._jwant[(int(rec["id"]), rec["step"])] = group
        self._ensure_ddl(group)
        self._propose(group,
                      f"INSERT INTO _reshard_journal (rec) VALUES "
                      f"({_sql_str(encode_record(rec))})")

    def journal_applied(self, vid: int, step: str) -> bool:
        g = self._jwant.get((int(vid), step))
        if g is None:
            return False
        for rec in self._journal_rows(g):
            if int(rec.get("id", -1)) == int(vid) \
                    and rec.get("step") == step:
                return True
        return False

    def drained(self, group: int, slots) -> bool:
        """Every write in flight at freeze time has applied: the local
        apply reached the group's current commit watermark and no acks
        are pending for the group.  New intake for the moving slots is
        already refused at the router (FrozenSlot)."""
        group = int(group)
        if self.db.pending_for(group):
            return False
        wm_fn = getattr(self.db.pipe.node, "commit_watermark", None)
        if wm_fn is None:
            return True
        return self.db.watermark(group) >= int(wm_fn(group))

    def rows_of(self, group: int, slots) -> Dict[str, str]:
        """The keyed rows of `group` whose slot is in `slots`; none when
        no keyed write ever reached the group (it has no kv table yet).
        The JAX package's copy raises there on every step, and a verb
        from or to such a group never resolves."""
        ss = set(int(s) for s in slots)
        out = {}
        try:
            rows = self._rows(int(group),
                              f"SELECT {self.keycol}, {self.valcol} "
                              f"FROM {self.table}")
        except sqlite3.OperationalError as e:
            if "no such table" not in str(e):
                raise
            rows = []
        for k, v in rows:
            if slot_of(str(k), self.keymap.nslots) in ss:
                out[str(k)] = str(v)
        return out

    def copy(self, dst: int, rows: Dict[str, str]) -> None:
        if not rows:
            return
        self._ensure_kv(int(dst))     # dst may never have had a key
        values = ", ".join(
            f"({_sql_str(k)}, {_sql_str(v)})"
            for k, v in sorted(rows.items()))
        self._propose(
            int(dst),
            f"INSERT OR REPLACE INTO {self.table} "
            f"({self.keycol}, {self.valcol}) VALUES {values}")

    def copy_settled(self, dst: int, rows: Dict[str, str]) -> bool:
        if not rows:
            return True
        have = self.rows_of(dst, set(
            slot_of(k, self.keymap.nslots) for k in rows))
        return all(have.get(k) == v for k, v in rows.items())

    def rdel(self, group: int, slots, vid: int) -> None:
        keys = sorted(self.rows_of(group, slots))
        if not keys:
            return
        inlist = ", ".join(_sql_str(k) for k in keys)
        self._propose(int(group),
                      f"DELETE FROM {self.table} "
                      f"WHERE {self.keycol} IN ({inlist})")

    def rdel_settled(self, group: int, slots, vid: int) -> bool:
        return not self.rows_of(group, slots)

    def publish(self, keymap: KeyMap) -> None:
        """New routing epoch: mirror it into the shm snapshot plane so
        worker readers fail closed on the next refresh."""
        shm = getattr(self.db, "shm", None)
        if shm is not None:
            set_epoch = getattr(shm, "set_keymap_epoch", None)
            if set_epoch is not None:
                try:
                    set_epoch(keymap.epoch)
                except Exception:                       # noqa: BLE001
                    log.exception("shm keymap epoch publish failed")

    # -- migrate -------------------------------------------------------

    def ship(self, group: int, target: int) -> None:
        """Write the group's snapshot image into the ship directory
        through the fault-injectable fsio plane (a failed fsync aborts
        the verb — the target never saw a partial image it could
        mistake for a shard)."""
        sm = self.db._sms[int(group)]
        index, image = sm.serialize_with_index()
        os.makedirs(self.ship_dir, exist_ok=True)
        path = os.path.join(self.ship_dir,
                            f"g{int(group)}-p{int(target)}-"
                            f"i{index}.img")
        with open(path, "wb") as f:
            fsio.write(f, image)
            fsio.fsync_file(f)
        fsio.fsync_dir(self.ship_dir)

    def cutover(self, group: int, target: int,
                retry: bool = False) -> Optional[str]:
        node = self.db.pipe.node
        group, target = int(group), int(target)
        if node.leader_of(group) == target:
            self._cutover_at = None
            return "completed"
        if self._cutover_at is None or retry:
            try:
                self.db.transfer(group, target)
                self._cutover_at = time.monotonic()
            except Exception:                           # noqa: BLE001
                # Not leader here / transfer refused: the coordinator
                # retries on its starvation cadence.
                if self._cutover_at is None:
                    self._cutover_at = time.monotonic()
        if time.monotonic() - self._cutover_at > 30.0:
            self._cutover_at = None
            return "aborted"
        return None
