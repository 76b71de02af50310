"""SQLite state machine — reference-parity apply/query semantics.

Mirrors the reference's raftdb SQL handling (reference db.go):
  - the database file is DELETED on boot and rebuilt entirely from the
    replicated log — no snapshots yet (db.go:27-29);
  - writes are applied in commit order under a write lock (db.go:55-57);
  - reads run against the local replica only, never consulting the
    leader — stale reads are by design (db.go:128-130);
  - SELECT rows are rendered `|v1|v2|…|\n` with every column stringified
    via a byte-slice scan (db.go:137-156): NULL → empty cell, so the
    `||0|`-style strings the reference tests grep for fall out.

SQLite is C reached through CPython's `sqlite3` binding — the same
library the reference reaches through cgo (db.go:6), per SURVEY.md §2b V5.
A state machine on a file also holds a write connection of
native/sqlite_apply.cc, through which every apply goes (`apply_runs`):
one native call, which gives up the interpreter lock once, applies a
whole run of commits to every group it touches, where the binding would
give the lock up and take it back around each prepare and step.
"""
from __future__ import annotations

import ctypes
import os
import sqlite3
import threading
from itertools import accumulate
from typing import Optional


def is_select(query: str) -> bool:
    """First-token SELECT check, case-insensitive — the reference's naive
    write/read split (db.go:98-104), preserved deliberately."""
    tokens = query.strip(" ").split(" ")
    return len(tokens) > 0 and tokens[0].upper() == "SELECT"


def _cell(v) -> str:
    if v is None:
        return ""
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, float):
        return repr(v)
    return str(v)


# CPython's sqlite3 exception class by primary result code
# (Modules/_sqlite/util.c get_exception_class); DatabaseError otherwise.
_CLASSES = {
    2: sqlite3.InternalError, 12: sqlite3.InternalError,
    7: MemoryError, 11: sqlite3.DatabaseError, 18: sqlite3.DataError,
    19: sqlite3.IntegrityError, 20: sqlite3.IntegrityError,
    21: sqlite3.InterfaceError, 25: sqlite3.InterfaceError,
    **{c: sqlite3.OperationalError
       for c in (1, 3, 4, 5, 6, 8, 9, 10, 13, 14, 15, 16, 17)}}
# The binding's own refusals, as native/sqlite_apply.cc codes them.
_REFUSALS = {
    -1: (sqlite3.ProgrammingError,
         "You can only execute one statement at a time."),
    -2: (sqlite3.ProgrammingError, "the query contains a null character"),
    -3: (sqlite3.DataError, "query string is too large")}
_PRIMARY = ("OK ERROR INTERNAL PERM ABORT BUSY LOCKED NOMEM READONLY "
            "INTERRUPT IOERR CORRUPT NOTFOUND FULL CANTOPEN PROTOCOL EMPTY "
            "SCHEMA TOOBIG CONSTRAINT MISMATCH MISUSE NOLFS AUTH FORMAT "
            "RANGE NOTADB NOTICE WARNING ROW DONE").split()
# sqlite_errorname by extended code: the module's SQLITE_<primary>[_...]
# constants (its authorizer codes share the numbers, not the names).
_NAMES = {v: k for k, v in vars(sqlite3).items()
          if k.startswith("SQLITE_") and isinstance(v, int)
          and k[7:].split("_")[0] in _PRIMARY}


def _error(code: int, msg: str) -> Exception:
    """The exception CPython's sqlite3 raises for native code `code` and
    SQLite's message `msg` (util.c _pysqlite_seterror)."""
    if code < 0:
        cls, text = _REFUSALS[code]
        return cls(text)
    e = _CLASSES.get(code & 0xFF, sqlite3.DatabaseError)(msg)
    e.sqlite_errorcode = code
    e.sqlite_errorname = _NAMES.get(code, "unknown")
    return e


class _WriteConn:
    """The native write connection of one database file
    (native/sqlite_apply.cc `sa_open`), closed on close() or when
    dropped."""
    __slots__ = ("lib", "h")

    def __init__(self, lib, path: str, resume: bool):
        self.lib = lib
        self.h = lib.sa_open(path.encode(), int(resume))
        if not self.h:
            raise sqlite3.OperationalError("unable to open database file")

    def close(self) -> None:
        h, self.h = self.h, None
        if h:
            self.lib.sa_close(h)

    __del__ = close


def apply_runs(batches) -> tuple:
    """Apply `[(sm, [(command, index), ...]), ...]`, file-backed state
    machines in ascending group order, in one native call: each batch
    with `apply_batch`'s semantics, entry for entry.  Takes every batch's
    state-machine lock, in the given order (readers hold one at a time,
    so the order cannot deadlock), for the call.  A state machine whose
    native connection is gone (closed) applies through its Python
    connection.  Returns (one apply_batch result per batch, the
    nanoseconds spent inside the native call)."""
    locks = [sm._lock for sm, _ in batches]
    for lk in locks:
        lk.acquire()
    try:
        out = [None] * len(batches)
        nat = []
        for k, (sm, items) in enumerate(batches):
            if sm._native is None:
                out[k] = sm._apply_py(items)
            elif items:
                nat.append(k)
            else:
                out[k] = []
        if not nat:
            return out, 0
        sms = [batches[k][0] for k in nat]
        runs = [batches[k][1] for k in nat]
        cmds = [c.encode() for items in runs for c, _i in items]
        n, ng = len(cmds), len(nat)
        lens = [len(b) for b in cmds]
        i64 = ctypes.c_int64
        starts = (i64 * (ng + 1))(*accumulate(map(len, runs), initial=0))
        offs = (i64 * n)(*accumulate(lens[:-1], lambda a, x: a + x + 1,
                                     initial=0))
        rc = (ctypes.c_int32 * n)()
        moff, mlen = (i64 * n)(), (i64 * n)()
        applied = (i64 * ng)()
        msgs = ctypes.c_void_p()
        lib = sms[0]._native.lib
        ns = lib.sa_apply_run(
            (ctypes.c_void_p * ng)(*(sm._native.h for sm in sms)), ng,
            starts, (i64 * ng)(*(sm._applied for sm in sms)),
            b"\0".join(cmds) + b"\0", offs, (i64 * n)(*lens),
            (i64 * n)(*(i for items in runs for _c, i in items)),
            rc, moff, mlen, ctypes.byref(msgs), applied)
        for k, sm in enumerate(sms):
            sm._applied = applied[k]
    finally:
        for lk in locks:
            lk.release()
    text = msgs.value          # every message, or None without an error
    errs = [_error(c, ctypes.string_at(text + moff[i], mlen[i]).decode(
        "utf-8", "replace") if text else "") if c else None
        for i, c in enumerate(rc)]
    if text:
        lib.sa_free(text)
    for j, k in enumerate(nat):
        out[k] = errs[starts[j]:starts[j + 1]]
    return out, ns


class SQLiteStateMachine:
    """`resume=False` (default): reference parity — the DB file is deleted
    on boot and rebuilt from the log (db.go:29).

    `resume=True`: the DB file IS the snapshot.  Every apply writes the
    entry's log index into the `_raft_meta` table inside the SAME SQLite
    transaction as the command, so file-state and applied-index are
    crash-atomic; on reboot the engine skips entries at or below
    `applied_index()` instead of replaying from scratch."""

    def __init__(self, path: str, resume: bool = False):
        if not resume and path != ":memory:" and os.path.exists(path):
            os.remove(path)
        self.path = path
        self.resume = resume
        # WAL compaction may only trust applied_index() as a floor when it
        # survives a crash (models/base.py contract).
        self.has_durable_snapshot = resume and path != ":memory:"
        self._conn = self._connect()
        self._lock = threading.Lock()
        self._applied = 0
        if resume:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS _raft_meta "
                "(k TEXT PRIMARY KEY, v INTEGER)")
            self._conn.commit()
            row = self._conn.execute(
                "SELECT v FROM _raft_meta WHERE k='applied_index'"
            ).fetchone()
            self._applied = int(row[0]) if row else 0
        self._native: Optional[_WriteConn] = None
        self._open_native()

    def _open_native(self) -> None:
        """The native write connection, for a file; a `:memory:`
        database is private to its Python connection and keeps it."""
        if self.path != ":memory:":
            from raftsql_tpu_torch.native.build import load_sqlite_apply
            self._native = _WriteConn(load_sqlite_apply(), self.path,
                                      self.resume)

    def _close_native(self) -> None:
        if self._native is not None:
            self._native.close()
            self._native = None

    def _connect(self) -> sqlite3.Connection:
        """Open self.path configured for this state machine: manual
        transaction control (apply_batch brackets its own BEGIN/COMMIT
        group commit — the module's implicit-BEGIN machinery would fight
        the explicit statements) and journaling matched to the upstream
        durability model.  Durability belongs to the raft WAL, not
        SQLite:
          - parity mode deletes and rebuilds this file from the log on
            every boot (db.go:27-29), so per-statement fsync buys
            nothing — memory journal, no syncs;
          - resume mode needs (commands, applied_index) ATOMIC, not
            durable-per-statement: SQLite-WAL + synchronous=NORMAL can
            lose a recent tail on power loss but always rolls the file
            back to a consistent point whose applied_index matches, and
            the raft log replays forward from there — exactly-once
            preserved at a fraction of the fsync cost."""
        conn = sqlite3.connect(self.path, check_same_thread=False)
        conn.isolation_level = None
        try:
            if self.has_durable_snapshot:
                conn.execute("PRAGMA journal_mode=WAL")
                conn.execute("PRAGMA synchronous=NORMAL")
            else:
                conn.execute("PRAGMA journal_mode=MEMORY")
                conn.execute("PRAGMA synchronous=OFF")
        except sqlite3.Error:          # pragma: no cover - pragma support
            pass
        return conn

    def applied_index(self) -> int:
        return self._applied

    def apply(self, command: str, index: int = 0) -> Optional[Exception]:
        return self.apply_batch([(command, index)])[0]

    def apply_batch(self, items) -> list:
        """Apply `[(command, index), ...]` in ONE durable transaction
        (group commit): per-statement outcomes are isolated with
        SAVEPOINTs, and the batch's statements plus the final
        applied_index land atomically — so a crash re-delivers the whole
        batch (exactly-once via the applied floor), never half of it.
        Returns one Optional[Exception] per item.

        The exactly-once check lives under the SAME lock install()
        takes: a snapshot install racing the applier thread bumps
        _applied before this runs, so a stale queued entry can never
        re-apply over the installed image.

        A file goes through its native connection (`apply_runs`); the
        Python connection applies a `:memory:` database."""
        if self._native is not None:
            return apply_runs([(self, items)])[0][0]
        with self._lock:
            return self._apply_py(items)

    def _apply_py(self, items) -> list:
        """apply_batch through the Python connection; caller holds the
        lock."""
        errs: list = []
        attempted: list = []     # False = skipped as already applied
        last = 0
        try:
            self._conn.execute("BEGIN")
        except sqlite3.Error:       # already in a transaction
            pass
        for command, index in items:
            if self.resume and index and index <= self._applied:
                errs.append(None)
                attempted.append(False)
                continue
            attempted.append(True)
            try:
                self._conn.execute("SAVEPOINT _apply")
                self._conn.execute(command)
                self._conn.execute("RELEASE _apply")
                errs.append(None)
            except sqlite3.Error as e:
                # A failed command still consumes its entry (the
                # error is its outcome, reference db.go:55-80): undo
                # only ITS effects, keep the batch.
                try:
                    self._conn.execute("ROLLBACK TO _apply")
                    self._conn.execute("RELEASE _apply")
                except sqlite3.Error:
                    pass
                errs.append(e)
            if index:
                last = max(last, index)
        meta = ("INSERT INTO _raft_meta (k, v) VALUES "
                "('applied_index', ?) ON CONFLICT(k) DO UPDATE "
                "SET v=excluded.v")
        try:
            if self.resume and last:
                self._conn.execute(meta, (last,))
            self._conn.commit()
            if last:
                self._applied = last
        except sqlite3.Error as e:
            # Commit failure (disk full): nothing of the batch
            # landed.  Report it on every entry attempted in THIS
            # transaction (skipped duplicates keep their None — they
            # are durable from an earlier boot), then try to advance
            # the durable floor alone so the entries stay consumed
            # ("the error is their outcome") — the applied floor may
            # only move when it is durable, because WAL compaction
            # and snapshot labeling trust it (models/base.py).
            try:
                self._conn.rollback()
            except sqlite3.Error:
                pass
            errs = [err if (err is not None or not att) else e
                    for err, att in zip(errs, attempted)]
            if last:
                try:
                    if self.resume:
                        self._conn.execute(meta, (last,))
                        self._conn.commit()
                    self._applied = last
                except sqlite3.Error:
                    pass            # floor stays; log re-delivers
        return errs

    def _image(self) -> bytes:
        """Serialize in DELETE journal mode: a WAL-mode image cannot be
        `deserialize`d by a receiver (in-memory databases reject WAL),
        and an image header should not advertise a -wal sidecar it does
        not carry.  Caller holds the lock; the mode flip checkpoints,
        which is fine at InstallSnapshot cadence.

        `Connection.serialize` only exists on Python 3.11+; older
        interpreters fall back to `VACUUM INTO` a temp file (SQLite ≥
        3.27) — the vacuum output is always a standalone DELETE-mode
        image, so no journal flip is needed on that path."""
        if not hasattr(self._conn, "serialize") or self._empty():
            return self._vacuum_image()
        wal = self.has_durable_snapshot
        if wal:
            # SQLite leaves WAL mode only on the file's one connection.
            self._close_native()
            self._conn.execute("PRAGMA journal_mode=DELETE")
        try:
            return self._conn.serialize()
        finally:
            if wal:
                self._conn.execute("PRAGMA journal_mode=WAL")
                self._open_native()

    def _empty(self) -> bool:
        """A database of 0 pages: a new file or `:memory:` database
        before its first write, kept so by parity mode's MEMORY journal,
        or after applies that all failed (a failed statement still
        consumes its index).  `Connection.serialize` raises on it
        ("unable to serialize 'main'", inherited from
        raftsql_tpu/models/sqlite_sm.py `_image`); `VACUUM INTO` writes
        a valid one-page image of it, which install() restores.  Caller
        holds the lock."""
        return self._conn.execute("PRAGMA page_count").fetchone()[0] == 0

    def _vacuum_image(self) -> bytes:
        """Point-in-time image via `VACUUM INTO` (the py3.10 fallback
        for Connection.serialize): SQLite writes a consistent, compacted
        copy of the whole database to a fresh file inside one internal
        read transaction — the same snapshot guarantee serialize gives.
        Caller holds the lock."""
        import tempfile
        d = tempfile.mkdtemp(prefix="raftsql-snap-")
        target = os.path.join(d, "image.db")   # must not pre-exist
        try:
            self._conn.execute("VACUUM INTO ?", (target,))
            with open(target, "rb") as f:
                return f.read()
        finally:
            import shutil
            shutil.rmtree(d, ignore_errors=True)

    def serialize(self) -> bytes:
        """Consistent point-in-time image of the database (the blob of an
        InstallSnapshot transfer)."""
        with self._lock:
            return self._image()

    def serialize_with_index(self):
        """(applied_index, image) captured atomically — the pair an
        InstallSnapshot sender needs (an apply sneaking between the two
        reads would mislabel the image's log position)."""
        with self._lock:
            return self._applied, self._image()

    def install(self, blob: bytes, index: int) -> None:
        """Replace all state with a serialized image applied up to
        `index` (receiver side of InstallSnapshot).

        With a real file, the image replaces the FILE (atomic tmp +
        rename, stale -wal/-shm sidecars dropped) and the connection
        reopens on it — `deserialize` would silently detach the
        connection onto an in-memory copy, so post-install applies
        never reached disk and a restart resurrected the pre-install
        file.  The in-memory path keeps deserialize."""
        with self._lock:
            if self.path != ":memory:":
                # Image lands in a tmp file BEFORE the live connection
                # closes: if the write fails (ENOSPC), the pre-install
                # state machine stays fully usable and the node just
                # drops the transfer.
                tmp = self.path + ".snap"
                with open(tmp, "wb") as f:
                    f.write(blob)
                    f.flush()
                    os.fsync(f.fileno())
                self._close_native()
                self._conn.close()
                try:
                    os.replace(tmp, self.path)
                    for suffix in ("-wal", "-shm"):
                        try:
                            os.remove(self.path + suffix)
                        except OSError:
                            pass
                finally:
                    self._conn = self._connect()
                    self._open_native()
            elif hasattr(self._conn, "deserialize"):
                self._conn.deserialize(blob)
            else:
                # py3.10 fallback (Connection.deserialize is 3.11+):
                # land the image in a temp file and copy it over the
                # live in-memory database with Connection.backup, which
                # replaces the destination's entire content — the same
                # all-state-swap contract deserialize gives.
                import tempfile
                d = tempfile.mkdtemp(prefix="raftsql-snap-")
                tmp2 = os.path.join(d, "image.db")
                try:
                    with open(tmp2, "wb") as f:
                        f.write(blob)
                    src = sqlite3.connect(tmp2)
                    try:
                        src.backup(self._conn)
                    finally:
                        src.close()
                finally:
                    import shutil
                    shutil.rmtree(d, ignore_errors=True)
            if self.resume:
                self._conn.execute(
                    "CREATE TABLE IF NOT EXISTS _raft_meta "
                    "(k TEXT PRIMARY KEY, v INTEGER)")
                self._conn.execute(
                    "INSERT INTO _raft_meta (k, v) VALUES "
                    "('applied_index', ?) ON CONFLICT(k) DO UPDATE "
                    "SET v=excluded.v", (index,))
                self._conn.commit()
            self._applied = index

    def query(self, q: str) -> str:
        with self._lock:
            cur = self._conn.execute(q)
            rows = cur.fetchall()
        out = []
        for row in rows:
            out.append("|" + "|".join(_cell(v) for v in row) + "|\n")
        return "".join(out)

    def rows(self, q: str) -> list:
        """Structured read: the raw result tuples.  The reshard plane
        moves row values between groups verbatim, so it cannot use
        query()'s pipe-delimited rendering (a value containing '|'
        would be torn on re-parse)."""
        with self._lock:
            cur = self._conn.execute(q)
            return cur.fetchall()

    def close(self) -> None:
        with self._lock:
            self._close_native()
            self._conn.close()
