"""The plain reference: what a run's answers, logs and state must be.

Python `sqlite3` and the standard library only; it imports nothing of
the program.  From the load generator's record of every request, the
WAL files as they lie on disk (decoded by waldec.py) and the program's
SQLite files, it works out again:

  - the committed log of every group: the longest commit index any peer
    persisted, the entries under it, and that a majority of the peers'
    WALs hold each of them (`below_quorum`), that no peer's committed
    prefix disagrees and that every entry is a statement some client
    sent, once (`log_faults`);
  - that every acknowledged write is in the committed log under the
    index the program applied, and that every write answered before the
    window's close was applied when it closed (`acks_not_applied`: the
    program acknowledges a write only after it is committed and
    applied);
  - the state: each group's committed statements replayed in log order
    into a fresh SQLite database, compared with the program's file at
    the index the program applied (`state_diffs`);
  - every answer: each linearizable read returns the record as it stood
    at some point between the read's send and its reply, by the log's
    order of writes, and no older than what any read of the same key
    answered before it was sent; each write's status matches the
    statement's outcome in the replay; no status outside the API's
    (`wrong_answers`);
  - every request got an answer (`unserved`), and none was refused
    (`refused`: 421, 429 or 503, retryable refusals that a sound run at
    these loads never needs).

Each count has the limit 0.
"""
from __future__ import annotations

import bisect
import sqlite3
import struct
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List

from portbench.reference import waldec

OP_DDL, OP_LOAD, OP_READ, OP_UPDATE, OP_UPSERT = range(5)
WRITES = (OP_DDL, OP_LOAD, OP_UPDATE, OP_UPSERT)
# Answers of the API: success, a refused statement (400), and the
# retryable refusals (421 another leader, 429 overload, 503 timeout).
KNOWN_STATUS = (200, 204, 400, 421, 429, 503)
REFUSALS = (421, 429, 503)
CHECKS = ("unserved", "refused", "wrong_answers", "acks_not_applied",
          "log_faults", "below_quorum", "state_diffs")

_REC = struct.Struct("<BBHIqqHII")


@dataclass
class Rec:
    op: int
    phase: int
    status: int
    group: int
    t0: int
    t1: int
    key: str
    sql: str
    body: bytes
    index: int = 0          # committed log index, 0 = not committed


def read_records(path: str) -> List[Rec]:
    with open(path, "rb") as f:
        blob = f.read()
    out, off = [], 0
    while off < len(blob):
        op, ph, st, g, t0, t1, kl, sl, bl = _REC.unpack_from(blob, off)
        off += _REC.size
        key = blob[off:off + kl].decode()
        off += kl
        sql = blob[off:off + sl].decode()
        off += sl
        body = blob[off:off + bl]
        off += bl
        out.append(Rec(op, ph, st, g, t0, t1, key, sql, body))
    return out


def render(rows) -> bytes:
    """A SELECT's rows as the upstream HTTP API renders them:
    `|v1|v2|...|\\n` a row, NULL as an empty cell."""
    def cell(v):
        if v is None:
            return ""
        if isinstance(v, bytes):
            return v.decode("utf-8", "replace")
        if isinstance(v, float):
            return repr(v)
        return str(v)
    return "".join("|" + "|".join(cell(v) for v in r) + "|\n"
                   for r in rows).encode()


def _payload(data: bytes) -> bytes:
    # A proposal envelope (0x01 | u64 id | payload) where the program
    # wraps one; a statement's first byte is never 0x01.
    if len(data) >= 9 and data[0] == 1:
        return data[9:]
    return data


class Checker:
    """One run's comparison.  `db_path(g)` names the program's SQLite
    file of group g; `applied[g]` is the index the program applied at
    the end, `at_close` = (t_close_ns, {g: index applied}) read just
    after the window closed."""

    def __init__(self, records: List[Rec], wal_dir: str, groups: int,
                 peers: int, table: str, key_column: str,
                 db_path: Callable[[int], str], applied: Dict[int, int],
                 at_close=(0, {})):
        self.recs = records
        self.wal_dir = wal_dir
        self.G, self.P = groups, peers
        self.table, self.keycol = table, key_column
        self.db_path = db_path
        self.applied = applied
        self.t_close, self.applied_close = at_close
        self.n = dict.fromkeys(CHECKS, 0)
        self.notes: List[str] = []

    def _fault(self, name: str, what: str) -> None:
        self.n[name] += 1
        if len(self.notes) < 20:
            self.notes.append(f"{name}: {what}")

    def run(self) -> Dict[str, int]:
        for r in self.recs:
            if r.t1 < 0:
                self._fault("unserved", f"{r.sql[:60]!r} on group "
                            f"{r.group}: no answer")
            elif r.status in REFUSALS:
                self._fault("refused", f"status {r.status} on group "
                            f"{r.group}: {r.body[:60]!r}")
            elif r.status not in KNOWN_STATUS:
                self._fault("wrong_answers", f"status {r.status} on "
                            f"group {r.group}")
        committed = self._committed_logs()
        self._match(committed)
        self._replay(committed)
        return dict(self.n)

    # -- the committed log ------------------------------------------------

    def _committed_logs(self) -> Dict[int, List[bytes]]:
        rp = waldec.replay(self.wal_dir)
        if rp.torn:
            self._fault("log_faults", f"{rp.torn} torn WAL record(s)")
        quorum = self.P // 2 + 1
        out = {}
        for g in range(self.G):
            logs = [rp.groups.get(p * self.G + g, waldec.GroupLog())
                    for p in range(self.P)]
            if any(gl.start for gl in logs):
                self._fault("log_faults", f"group {g}: compacted log")
            best = max(range(self.P), key=lambda p: logs[p].commit)
            c = logs[best].commit
            ents = logs[best].entries
            if len(ents) < c:
                self._fault("log_faults", f"group {g}: commit {c} past "
                            f"the log ({len(ents)})")
                c = len(ents)
            for p, gl in enumerate(logs):
                k = min(gl.commit, len(gl.entries), c)
                if gl.entries[:k] != ents[:k]:
                    self._fault("log_faults", f"group {g}: peer {p}'s "
                                "committed prefix disagrees")
                if gl.commit > len(gl.entries):
                    self._fault("log_faults", f"group {g}: peer {p} "
                                "commits past its log")
            for i in range(c):
                held = sum(1 for gl in logs if len(gl.entries) > i
                           and gl.entries[i] == ents[i])
                if held < quorum:
                    self._fault("below_quorum", f"group {g} index "
                                f"{i + 1}: {held} of {self.P} WALs")
            out[g] = [_payload(d) for _t, d in ents[:c]]
        return out

    def _match(self, committed: Dict[int, List[bytes]]) -> None:
        """Tie each committed statement to the request that sent it."""
        by_text: Dict[tuple, Rec] = {}
        for r in self.recs:
            if r.op in WRITES:
                by_text[(r.group, r.sql)] = r
        for g, ents in committed.items():
            for i, data in enumerate(ents, 1):
                if not data:
                    continue            # a leader's no-op
                r = by_text.get((g, data.decode("utf-8", "replace")))
                if r is None:
                    self._fault("log_faults", f"group {g} index {i}: a "
                                "statement no client sent")
                elif r.index:
                    self._fault("log_faults", f"group {g}: statement "
                                f"committed twice ({r.index}, {i})")
                else:
                    r.index = i
        for r in self.recs:
            if r.op not in WRITES or r.status != 204:
                continue
            if not 0 < r.index <= self.applied.get(r.group, 0):
                self._fault("acks_not_applied", f"group {r.group}: "
                            f"{r.sql[:60]!r} acknowledged, index "
                            f"{r.index}, applied "
                            f"{self.applied.get(r.group, 0)}")
            elif 0 <= r.t1 < self.t_close and r.index > \
                    self.applied_close.get(r.group, r.index):
                self._fault("acks_not_applied", f"group {r.group}: "
                            f"{r.sql[:60]!r} acknowledged before the "
                            f"close at index {r.index}, applied there "
                            f"{self.applied_close[r.group]}")

    # -- the state --------------------------------------------------------

    def _replay(self, committed: Dict[int, List[bytes]]) -> None:
        reads = defaultdict(list)             # group -> reads answered 200
        for r in self.recs:
            if r.op == OP_READ and r.status == 200:
                reads[r.group].append(r)
        by_index = {(r.group, r.index): r for r in self.recs
                    if r.op in WRITES and r.index}
        self._writes = defaultdict(list)      # (group, key) -> writes
        for r in self.recs:
            if r.op in (OP_UPDATE, OP_UPSERT) and r.index:
                self._writes[(r.group, r.key)].append(r)
        for g, ents in committed.items():
            self._replay_group(g, ents, reads.get(g, []), by_index)

    def _replay_group(self, g: int, ents: List[bytes], reads: List[Rec],
                      by_index) -> None:
        db = sqlite3.connect(":memory:")
        db.isolation_level = None
        want = sorted({r.key for r in reads})
        versions: Dict[str, list] = {}       # key -> [(index, row bytes)]
        applied = self.applied.get(g, 0)

        def snap_keys(keys, index):
            for k in keys:
                rows = db.execute(f"SELECT * FROM {self.table} WHERE "
                                  f"{self.keycol}=?", (k,)).fetchall()
                versions.setdefault(k, []).append((index, render(rows)))

        mix_started = False
        for i, data in enumerate(ents, 1):
            if i > applied:
                break
            rec = by_index.get((g, i))
            if (not mix_started and rec is not None
                    and rec.op in (OP_UPDATE, OP_UPSERT)):
                mix_started = True
                snap_keys(want, 0)
            ok = True
            if data:
                try:
                    db.execute(data.decode("utf-8", "replace"))
                except sqlite3.Error:
                    ok = False
            if rec is not None and rec.status in (204, 400) \
                    and (rec.status == 204) != ok:
                self._fault("wrong_answers", f"group {g} index {i}: "
                            f"status {rec.status}, the statement "
                            f"{'succeeds' if ok else 'fails'}")
            if mix_started and rec is not None and rec.key in versions:
                snap_keys([rec.key], i)
        if not mix_started:
            snap_keys(want, 0)
        self._check_reads(g, reads, versions)
        self._compare_state(g, db)
        db.close()

    def _check_reads(self, g: int, reads: List[Rec], versions) -> None:
        """Each read returns one version (idx, body) of its key, the
        record as it stood from log index idx up to the next version's.
        The read must see every write to its key acknowledged before it
        was sent, none sent after its reply, and no version older than
        one that a read of the key answered before it was sent."""
        seen = {id(r): self._version(r, versions, self._lo(g, r))
                for r in reads}
        answered = defaultdict(list)    # key -> [(reply time, version)]
        for r in reads:
            if seen[id(r)] is not None:
                answered[r.key].append((r.t1, seen[id(r)]))
        before = {}                     # key -> (reply times, running max)
        for k, tv in answered.items():
            tv.sort()
            run, top = [], 0
            for _t, v in tv:
                top = max(top, v)
                run.append(top)
            before[k] = ([t for t, _v in tv], run)
        for r in reads:
            lo = self._lo(g, r)
            if seen[id(r)] is not None:
                times, run = before[r.key]
                n = bisect.bisect_left(times, r.t0)
                if n:
                    lo = max(lo, run[n - 1])
            if seen[id(r)] is None or \
                    self._version(r, versions, lo) is None:
                self._fault("wrong_answers", f"group {g}: read of "
                            f"{r.key} returned {r.body[:40]!r}, allowed "
                            f"log range [{lo}, {self._hi(g, r)})")

    def _lo(self, g: int, r: Rec) -> int:
        """The index of the last write to r's key acknowledged before r
        was sent."""
        return max((w.index for w in self._writes.get((g, r.key), [])
                    if w.status == 204 and 0 <= w.t1 < r.t0), default=0)

    def _hi(self, g: int, r: Rec):
        """The index of the first write to r's key sent after r's
        reply."""
        return min((w.index for w in self._writes.get((g, r.key), [])
                    if w.t0 > r.t1), default=float("inf"))

    def _version(self, r: Rec, versions, lo):
        """The index of the earliest version of r's key that r's answer
        can be, live at or after log index lo and before _hi; None when
        none matches."""
        hi = self._hi(r.group, r)
        vs = versions.get(r.key, [])
        for j, (idx, body) in enumerate(vs):
            nxt = vs[j + 1][0] if j + 1 < len(vs) else float("inf")
            if idx < hi and nxt > lo and body == r.body:
                return idx
        return None

    def _compare_state(self, g: int, ref: sqlite3.Connection) -> None:
        q = f"SELECT * FROM {self.table} ORDER BY {self.keycol}"
        try:
            want = ref.execute(q).fetchall()
        except sqlite3.Error:
            want = None
        try:
            con = sqlite3.connect(f"file:{self.db_path(g)}?mode=ro",
                                  uri=True)
            try:
                got = con.execute(q).fetchall()
            finally:
                con.close()
        except sqlite3.Error:
            got = None
        if got != want:
            self._fault("state_diffs", f"group {g}: "
                        f"{'no table' if got is None else len(got)} rows "
                        f"against the reference's "
                        f"{'no table' if want is None else len(want)}")

