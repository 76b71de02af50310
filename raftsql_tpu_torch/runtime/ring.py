"""Propose ring: the shared-memory request plane for multi-worker serving.

Port of raftsql_tpu/runtime/ring.py; the ring files and the record
grammar below are the JAX package's, byte for byte.  One engine process
(the consensus tick, the WALs, SQLite apply and, in this port, the
eager dispatch of the device step) shares its GIL with request parsing
and ack serialization when it serves HTTP itself.  This module splits
the serving plane across OS processes the way the reference splits
peers (one process per concern) without giving up the single engine:

    worker 0 ─┐  request ring (mmap SPSC)  ┌─> RingServer drain ──┐
    worker 1 ─┼──────────────────────────>─┤   rdb.propose(...)    │ engine
    worker N ─┘ <────────────────────────  └─< completion rings <──┘
                completion ring (mmap SPSC, acks batched per commit)

Each worker is a full asyncio HTTP plane (api/aio.py) binding the SAME
port via SO_REUSEPORT — the kernel load-balances connections — whose
"RaftDB" is a `RingClient` facade: proposals become fixed-layout
records in a per-worker mmap'd SPSC request ring, acknowledgements
come back through a per-worker completion ring resolved straight into
the worker's event loop.  HTTP parsing and response serialization now
burn OTHER processes' GILs; the engine process spends its cycles on
the consensus tick and the WAL.

Ring design (`SpscRing`): a file-backed mmap with a 64-byte header
(head = consumer cursor, tail = producer cursor, both monotonically
increasing u64) and a power-of-two data region.  Records are
`u32 length | payload`, contiguous; a record that would straddle the
end of the region is preceded by a WRAP marker (length 0xFFFFFFFF) and
restarts at offset 0.  Exactly one producer and one consumer advance
their own cursor and only READ the other's, so no locks cross the
process boundary; `pop()` hands out a zero-copy memoryview into the
mmap that is valid until `pop_commit()` publishes the new head —
`pop_batch()` uses that window to decode a whole backlog before
releasing any of it.  Within the engine process several threads may
complete requests concurrently, so the completion ring's producer side
takes an in-process lock (the SPSC contract is per process pair, not
per thread).

Record grammar (little endian; shared by RingClient/RingServer only —
nothing else parses these):

  request:    u8 op | u64 req_id | u32 group | u8 flags | u64 token
              | u64 deadline | bytes body
      op 1 PUT      body = sql          (token: X-Raft-Retry-Token, 0 none)
      op 2 GET      body = sql          (flags bit 0: linearizable,
                                         bit 1: session, bit 2: follower;
                                         token = session watermark)
      op 3 DOC      body = document name (metrics/health/members/...)
      op 4 MEMBER   body = json {group, op, peer}
      op 5 XFER     body = json {group, target} (leadership transfer)
      op 6 RESHARD  body = json {verb, src, dst, slots} (POST /reshard)
      op 7 KV       body = json {method, key, value, epoch, mode}
                    (the keyed /kv surface: the engine's reshard plane
                    routes the key and proposes or reads in the same
                    request, so a worker never routes by a mapping the
                    router may have moved; token = retry token for PUT,
                    session watermark for GET)
      deadline: absolute CLOCK_MONOTONIC milliseconds after which the
      request is dead (0 = none).  Rings are same-machine mmaps, so the
      monotonic clock is shared; the engine sheds expired records at the
      drain (counted shed_ring) before any WAL/fsync cost.
  completion: u64 req_id | u8 status | u32 leader | bytes body
      status 0 OK   (body = rows/doc for GET/DOC/MEMBER, empty for PUT;
                     leader = the engine's session watermark for the
                     request's group — the X-Raft-Session echo)
      status 1 ERR  (body = message; deterministic 400 class)
      status 2 NOT_LEADER (leader = 1-based hint; 421 class)
      status 3 UNAVAILABLE (body = message; 503 class)
      status 4 OVERLOADED (body = message; 429 class — admission
                     refusal or ring-drain deadline shed; leader =
                     Retry-After in MILLISECONDS, the controller's
                     jittered drain-rate estimate)
      status 5 WRONG_EPOCH (op 7: body = json {error, have, keymap};
                     409 class)
      status 6 REFUSED (op 7: the key's slot is frozen, leader = the
                     slot; 503 class, retryable; op 6: the verb was
                     refused; 409 class)
      status 7 DOC_FILE (op 3: body = the name of a file in the ring
                     directory that holds the document, for a document
                     too large for the completion ring; the worker reads
                     and removes it)
  An op 7 OK carries body = json {group, epoch, rows} (rows for GET).
  Ops 6 and 7 are the port's repair of the JAX package's worker plane,
  whose api/aio.py handlers call the reshard plane's methods on
  RingClient.reshard, a method there: POST /reshard and /kv at a JAX
  worker answer 400.  Status 7 is its repair of GET /trace (and any
  document) at a worker: the JAX package's engine answers a document
  larger than the completion ring (4 MiB) with an error, and its worker
  drops the connection.
"""
from __future__ import annotations

import json
import logging
import mmap
import os
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

log = logging.getLogger("raftsql_tpu_torch.ring")

_MAGIC = 0x52494E47                   # "RING"
_HDR = 64                             # file header bytes
_OFF_MAGIC, _OFF_CAP, _OFF_HEAD, _OFF_TAIL = 0, 4, 16, 32
_WRAP = 0xFFFFFFFF

_REQ = struct.Struct("<BQIBQQ")       # op, req_id, group, flags, token,
#                                       deadline (monotonic ms, 0 none)
_CPL = struct.Struct("<QBI")          # req_id, status, leader

OP_PUT, OP_GET, OP_DOC, OP_MEMBER, OP_XFER, OP_RESHARD = 1, 2, 3, 4, 5, 6
OP_KV = 7
ST_OK, ST_ERR, ST_NOT_LEADER, ST_UNAVAILABLE, ST_OVERLOADED = 0, 1, 2, 3, 4
ST_WRONG_EPOCH, ST_REFUSED = 5, 6
ST_DOC_FILE = 7

DEFAULT_RING_BYTES = 4 << 20


class RingFull(RuntimeError):
    """Producer outran the consumer past the ring's capacity."""


class SpscRing:
    """File-backed single-producer/single-consumer byte ring (see
    module doc for the layout).  One side constructs with create=True
    (truncates + initializes), the other attaches."""

    def __init__(self, path: str, size: int = DEFAULT_RING_BYTES,
                 create: bool = False):
        if create:
            size = 1 << (size - 1).bit_length()        # power of two
            with open(path, "wb") as f:
                f.truncate(_HDR + size)
                f.flush()
            fd = os.open(path, os.O_RDWR)
            try:
                self._mm = mmap.mmap(fd, _HDR + size)
            finally:
                os.close(fd)
            struct.pack_into("<II", self._mm, _OFF_MAGIC, _MAGIC, size)
            struct.pack_into("<Q", self._mm, _OFF_HEAD, 0)
            struct.pack_into("<Q", self._mm, _OFF_TAIL, 0)
        else:
            fd = os.open(path, os.O_RDWR)
            try:
                st_size = os.fstat(fd).st_size
                self._mm = mmap.mmap(fd, st_size)
            finally:
                os.close(fd)
            magic, size = struct.unpack_from("<II", self._mm, _OFF_MAGIC)
            if magic != _MAGIC or st_size != _HDR + size:
                raise ValueError(f"{path}: not a ring file")
        self.path = path
        self.cap = size
        self._mask = size - 1
        self._view = memoryview(self._mm)
        # Cached cursors: the producer owns tail (its cached copy is
        # authoritative), the consumer owns head; each re-reads the
        # OTHER side's cursor from the mmap on demand.
        self._tail = self._load(_OFF_TAIL)
        self._head = self._load(_OFF_HEAD)
        self._pending_head: Optional[int] = None

    # -- cursor I/O ------------------------------------------------------

    def _load(self, off: int) -> int:
        return struct.unpack_from("<Q", self._mm, off)[0]

    def _store(self, off: int, v: int) -> None:
        struct.pack_into("<Q", self._mm, off, v)

    # -- producer --------------------------------------------------------

    def push(self, payload: bytes) -> bool:
        """Append one record; False when the ring lacks space (caller
        backs off — records are never torn)."""
        n = len(payload)
        if n == 0:
            # An empty record is indistinguishable from unwritten ring
            # memory — the consumer's corruption check keys on exactly
            # that, so empties are illegal (both codecs' records are
            # ≥ 13 bytes anyway).
            raise ValueError("empty ring records are not allowed")
        need = 4 + n
        if need + 4 > self.cap:
            raise ValueError(f"record of {n} bytes exceeds ring capacity")
        tail = self._tail
        head = self._load(_OFF_HEAD)
        pos = tail & self._mask
        room = self.cap - (tail - head)
        contig = self.cap - pos
        if contig < need:
            # Wrap: marker (if 4 bytes fit) + restart at 0.  The skipped
            # gap consumes capacity, so account for it in `room`.
            if room < contig + need:
                return False
            if contig >= 4:
                struct.pack_into("<I", self._mm, _HDR + pos, _WRAP)
            tail += contig
            pos = 0
        elif room < need:
            return False
        struct.pack_into("<I", self._mm, _HDR + pos, n)
        self._mm[_HDR + pos + 4:_HDR + pos + 4 + n] = payload
        tail += need
        self._tail = tail
        self._store(_OFF_TAIL, tail)
        return True

    # -- consumer --------------------------------------------------------

    def pop(self) -> Optional[memoryview]:
        """Next record as a zero-copy view into the mmap, or None when
        empty.  The view stays valid until pop_commit(); interleave
        pop/pop_commit freely (commit releases everything popped so
        far)."""
        head = self._pending_head if self._pending_head is not None \
            else self._head
        tail = self._load(_OFF_TAIL)
        # DIRECTIONAL emptiness check, not equality: both cursors are
        # monotone, so a cross-process read of the producer's tail can
        # only ever be STALE-SMALL — observed in practice (a freshly
        # faulted header page served an old value under memory
        # pressure).  With `==`, a stale tail below our head sails past
        # the check and pop() walks into unwritten bytes; with `<=` any
        # stale read just looks momentarily empty and the next poll
        # sees the real cursor.
        if tail <= head:
            return None
        pos = head & self._mask
        contig = self.cap - pos
        if contig < 4:
            head += contig
            pos = 0
        else:
            (n,) = struct.unpack_from("<I", self._mm, _HDR + pos)
            if n == _WRAP:
                head += contig
                pos = 0
            else:
                self._check_len(n, head, tail, pos)
                view = self._view[_HDR + pos + 4:_HDR + pos + 4 + n]
                self._pending_head = head + 4 + n
                return view
        if tail <= head:
            self._pending_head = head
            return None
        (n,) = struct.unpack_from("<I", self._mm, _HDR + pos)
        self._check_len(n, head, tail, pos)
        view = self._view[_HDR + pos + 4:_HDR + pos + 4 + n]
        self._pending_head = head + 4 + n
        return view

    def _check_len(self, n: int, head: int, tail: int,
                   pos: int) -> None:
        """A record length must be sane (records are never empty and
        never straddle the region end).  A violation means cursor
        desync or an outside writer — fail loudly with the cursor
        state instead of handing garbage to a decoder."""
        if n == 0 or pos + 4 + n > self.cap:
            raise RuntimeError(
                f"{self.path}: corrupt ring record: len={n} at "
                f"pos={pos} head={head} tail={tail} cap={self.cap}")

    def pop_commit(self) -> None:
        """Publish the consumer cursor past everything pop() returned —
        after this the producer may overwrite those bytes."""
        if self._pending_head is not None:
            self._head = self._pending_head
            self._pending_head = None
            self._store(_OFF_HEAD, self._head)

    def depth_bytes(self) -> int:
        """Unconsumed bytes (either side may call; approximate under
        concurrency — clamped, a stale cursor pair can momentarily
        invert)."""
        return max(0, self._load(_OFF_TAIL) - self._load(_OFF_HEAD))

    def cursors(self) -> Tuple[int, int]:
        """Raw (head, tail) byte cursors — the flight recorder's view
        of where each side of the ring stood at crash time."""
        return self._load(_OFF_HEAD), self._load(_OFF_TAIL)

    def close(self) -> None:
        self._view.release()
        self._mm.close()


# ---------------------------------------------------------------------------
# Record codecs.


def encode_request(op: int, req_id: int, group: int, flags: int,
                   token: int, body: bytes,
                   deadline_mono_ms: int = 0) -> bytes:
    return _REQ.pack(op, req_id, group, flags, token,
                     deadline_mono_ms) + body


def decode_request(view) -> Tuple[int, int, int, int, int, int, bytes]:
    op, req_id, group, flags, token, deadline = \
        _REQ.unpack_from(view, 0)
    return op, req_id, group, flags, token, deadline, \
        bytes(view[_REQ.size:])


def encode_completion(req_id: int, status: int, leader: int,
                      body: bytes) -> bytes:
    return _CPL.pack(req_id, status, leader) + body


def decode_completion(view) -> Tuple[int, int, int, bytes]:
    req_id, status, leader = _CPL.unpack_from(view, 0)
    return req_id, status, leader, bytes(view[_CPL.size:])


def ring_paths(dirname: str, worker: int) -> Tuple[str, str]:
    return (os.path.join(dirname, f"req-{worker}.ring"),
            os.path.join(dirname, f"cpl-{worker}.ring"))


def _spin_wait(last_work_s: float) -> float:
    """Adaptive poll backoff: hot rings poll back-to-back, idle rings
    sleep up to 2 ms (cheap enough that N workers' drains cost <1% of a
    core at idle, short enough to be invisible under load)."""
    idle = time.monotonic() - last_work_s
    if idle < 0.002:
        return 0.0
    return min(0.002, idle * 0.1)


# ---------------------------------------------------------------------------
# Engine side.


class RingServer:
    """Drains every worker's request ring into the shared RaftDB and
    routes acks back through the per-worker completion rings.

    One drain thread per worker: proposals are popped in BATCHES
    (everything queued between two polls joins one pop window), handed
    to `rdb.propose` whose AckFutures complete on the engine's commit-
    consumer thread — the completion write happens there, so ack
    batching follows commit batching for free.  Blocking work (reads,
    document renders, membership admin) runs on a small executor so a
    slow SQLite read cannot stall the propose drain.
    """

    def __init__(self, rdb, dirname: str, workers: int,
                 ring_bytes: int = DEFAULT_RING_BYTES,
                 timeout_s: float = 30.0):
        os.makedirs(dirname, exist_ok=True)
        self.rdb = rdb
        self.dirname = dirname
        self.workers = workers
        self.timeout_s = timeout_s
        self._req: List[SpscRing] = []
        self._cpl: List[SpscRing] = []
        self._cpl_mu: List[threading.Lock] = []
        self.proposed = 0
        self.completed = 0
        self.deduped = 0
        self._stop = threading.Event()
        # Retry-token dedup at the serving plane: the fused engine
        # routes proposals on the host with PLAIN payloads (FusedPipe
        # drops the envelope pid), so the engine-side dedup window the
        # distributed runtime uses never sees these tokens.  The ring
        # server is the single choke point every worker's PUT crosses —
        # an LRU of token → outcome makes client retry-after-accept
        # exactly-once across ALL workers: a re-sent token joins the
        # in-flight proposal's waiters or replays its recorded outcome
        # instead of re-proposing.
        from collections import OrderedDict
        self._tok_mu = threading.Lock()
        # token -> [resolved, err_body|None, waiters [(worker, req_id)]]
        self._tokens: "OrderedDict[int, list]" = OrderedDict()  # raftlint: guarded-by=_tok_mu
        self._tok_cap = 1 << 16
        for i in range(workers):
            req_p, cpl_p = ring_paths(dirname, i)
            self._req.append(SpscRing(req_p, ring_bytes, create=True))
            self._cpl.append(SpscRing(cpl_p, ring_bytes, create=True))
            self._cpl_mu.append(threading.Lock())
        from concurrent.futures import ThreadPoolExecutor
        self._read_pool = ThreadPoolExecutor(
            max_workers=max(4, 2 * workers),
            thread_name_prefix="ring-read")
        self._threads = [
            threading.Thread(target=self._drain, args=(i,), daemon=True,
                             name=f"ring-drain-{i}")
            for i in range(workers)]
        # Serving-plane gauges for GET /metrics (merged by
        # RaftDB.metrics via the serving_metrics hook).
        if hasattr(rdb, "serving_metrics"):
            rdb.serving_metrics = self.metrics
        # Cross-process trace merge: workers flush per-process trace
        # segments into the ring directory; pointing the engine's
        # RaftDB at it makes GET /trace one multi-process timeline.
        rdb.trace_segments_dir = dirname
        # Ring-drain phase profiling rides the engine's tick-phase
        # profiler (obs/prof.py) when the engine exposes one.
        self._prof_node = getattr(getattr(rdb, "pipe", None), "node",
                                  None)
        # Shared-memory snapshot plane (runtime/shm.py): the
        # read fast path workers map.  Attach the delta hook FIRST,
        # then start() with base images — the ordering makes the
        # published stream complete (shm.py start docstring).  Env
        # gate RAFTSQL_SHM_READS=0 turns the plane off on both sides
        # (chaos digest baselines run with it compiled in but idle).
        self.shm = None
        self._shm_thread = None
        if os.environ.get("RAFTSQL_SHM_READS", "1") != "0" \
                and hasattr(rdb, "_snapshot_of"):
            try:
                from raftsql_tpu_torch.runtime.shm import ShmSnapshotPublisher
                self.shm = ShmSnapshotPublisher(dirname, rdb.num_groups)
                rdb.shm = self.shm
                self.shm.start(rdb._snapshot_of, rdb.watermark)
            except Exception:                           # noqa: BLE001
                log.exception("shm snapshot plane disabled")
                rdb.shm = None
                self.shm = None
        if self.shm is not None:
            self._shm_thread = threading.Thread(
                target=self._shm_refresh, daemon=True,
                name="shm-refresh")

    def _shm_refresh(self) -> None:
        """Restamp the shm watermark/leader/lease columns from the
        engine's host caches every couple of milliseconds — the
        publisher heartbeat a worker's lease read requires to be
        fresh (shm.py PUB_STALE_NS).  The three reads are numpy host
        caches in every runtime of the port (hostplane.py `_hard`,
        `_hints`, `_lease_col`; node.py `_hard_np`, `_last_hint`), so
        this 2 ms loop never reads, or waits on, device memory."""
        node = self._prof_node
        commit_of = getattr(node, "commit_watermark", lambda g: 0)
        leader_of = getattr(node, "leader_of", lambda g: -1)
        lease_of = getattr(node, "lease_deadline_s", lambda g: 0.0)
        while not self._stop.is_set():
            try:
                self.shm.refresh(commit_of, leader_of, lease_of)
            except Exception:                           # noqa: BLE001
                log.exception("shm refresh failed; stopping")
                return
            self._stop.wait(0.002)

    def start(self) -> None:
        for t in self._threads:
            t.start()
        if self._shm_thread is not None:
            self._shm_thread.start()

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        if self._shm_thread is not None:
            self._shm_thread.join(timeout=5)
        if self.shm is not None:
            self.rdb.shm = None
            self.shm.close()
        # A commit may still resolve a PUT on an engine thread: close
        # each completion ring under its producer lock, so _complete
        # never writes into a closed mapping.
        for mu, r in zip(self._cpl_mu, self._cpl):
            with mu:
                r.close()
        for r in self._req:
            r.close()

    def metrics(self) -> dict:
        return {
            "ring_workers": self.workers,
            "ring_proposed": self.proposed,
            "ring_completed": self.completed,
            "ring_deduped": self.deduped,
            "ring_depth": sum(r.depth_bytes() for r in self._req),
        }

    def flight_doc(self) -> dict:
        """Serving-plane state for a chaos flight bundle
        (obs/flight.py): the counters plus every worker's raw ring
        cursors/depths — where each producer and consumer stood at
        crash time."""
        rings = []
        for i in range(self.workers):
            rh, rt = self._req[i].cursors()
            ch, ct = self._cpl[i].cursors()
            rings.append({"worker": i,
                          "req_head": rh, "req_tail": rt,
                          "req_depth": max(0, rt - rh),
                          "cpl_head": ch, "cpl_tail": ct,
                          "cpl_depth": max(0, ct - ch)})
        return {"counters": self.metrics(), "rings": rings}

    # -- completion path (any engine thread) ----------------------------

    def _complete(self, worker: int, req_id: int, status: int,
                  leader: int, body: bytes) -> None:
        rec = encode_completion(req_id, status, leader, body)
        deadline = time.monotonic() + self.timeout_s
        mu, ring = self._cpl_mu[worker], self._cpl[worker]
        while True:
            with mu:
                if self._stop.is_set():
                    return          # stop() closes the rings under mu
                if ring.push(rec):
                    self.completed += 1
                    return
            # Completion ring full: the worker is alive but behind —
            # wait it out (dropping an ack would hang a client).
            if time.monotonic() > deadline or self._stop.is_set():
                return
            time.sleep(0.0002)

    def _err_body(self, e: BaseException) -> bytes:
        return str(e).encode("utf-8", "replace")[:4096]

    def _overload(self):
        """The engine's attached admission controller, or None — the
        same attachment point the HTTP planes consult
        (node.overload, raftsql_tpu_torch/overload/)."""
        return getattr(getattr(getattr(self.rdb, "pipe", None),
                               "node", None), "overload", None)

    def _retry_after_ms(self) -> int:
        """Retry-After for an ST_OVERLOADED completion's leader field
        (milliseconds, clamped to the wire's u32)."""
        ov = self._overload()
        if ov is None:
            return 1000
        return min(int(ov.retry_after_s() * 1000), 0xFFFFFFFF)

    # -- request handlers -----------------------------------------------

    def _watermark(self, group: int) -> int:
        """Engine session watermark for a ST_OK completion's leader
        field (clamped to the wire's u32; advisory, never fatal)."""
        try:
            return min(int(self.rdb.watermark(group)), 0xFFFFFFFF)
        except Exception:                               # noqa: BLE001
            return 0

    def _handle_put(self, worker: int, req_id: int, group: int,
                    token: int, body: bytes,
                    deadline_ms: Optional[float] = None) -> None:
        entry = None
        if token:
            with self._tok_mu:
                ent = self._tokens.get(token)
                if ent is not None:
                    self._tokens.move_to_end(token)
                    if ent[0]:          # resolved: replay the outcome
                        self.deduped += 1
                        err_body, wm = ent[1], ent[3]
                    else:               # in flight: join its waiters
                        ent[2].append((worker, req_id))
                        self.deduped += 1
                        return
                else:
                    entry = [False, None, [(worker, req_id)], 0]
                    self._tokens[token] = entry
                    while len(self._tokens) > self._tok_cap:
                        self._tokens.popitem(last=False)
            if entry is None:
                if err_body is None:
                    self._complete(worker, req_id, ST_OK, wm, b"")
                else:
                    self._complete(worker, req_id, ST_ERR, 0, err_body)
                return
        try:
            fut = self.rdb.propose(body.decode("utf-8"), group,
                                   token=token or None,
                                   **({} if deadline_ms is None
                                      else {"deadline_ms": deadline_ms}))
        except Exception as e:                          # noqa: BLE001
            from raftsql_tpu_torch.overload import Overloaded
            if isinstance(e, Overloaded):
                # Admission refusal: 429 class — Retry-After rides the
                # completion's leader field (milliseconds).  Drop the
                # token entry (nothing is in flight), so a backed-off
                # retry re-proposes fresh instead of joining a waiter
                # list nothing will ever resolve.
                waiters = [(worker, req_id)]
                if entry is not None:
                    with self._tok_mu:
                        self._tokens.pop(token, None)
                        waiters = entry[2]
                ra = min(int(e.retry_after_s * 1000), 0xFFFFFFFF)
                for (w, rid) in waiters:
                    self._complete(w, rid, ST_OVERLOADED, ra,
                                   self._err_body(e))
                return
            self._resolve_put(entry, worker, req_id, self._err_body(e),
                              0)
            return
        self.proposed += 1

        def _done(err):
            self._resolve_put(
                entry, worker, req_id,
                None if err is None else self._err_body(err),
                self._watermark(group) if err is None else 0)

        fut.add_done_callback(_done)

    def _resolve_put(self, entry, worker: int, req_id: int,
                     err_body: Optional[bytes], wm: int) -> None:
        """Deliver a PUT outcome to its requester — and, for a
        tokenized PUT, to every retry that joined while it was in
        flight, recording the outcome (incl. the session watermark)
        for late retries."""
        if entry is None:
            waiters = [(worker, req_id)]
        else:
            with self._tok_mu:
                entry[0] = True
                entry[1] = err_body
                entry[3] = wm
                waiters, entry[2] = entry[2], []
        for (w, rid) in waiters:
            if err_body is None:
                self._complete(w, rid, ST_OK, wm, b"")
            else:
                self._complete(w, rid, ST_ERR, 0, err_body)

    def _handle_get(self, worker: int, req_id: int, group: int,
                    flags: int, token: int, body: bytes,
                    deadline_ms: Optional[float] = None) -> None:
        from raftsql_tpu_torch.overload import Overloaded
        from raftsql_tpu_torch.runtime.db import NotLeaderError
        # Flags bit 0 = linear, bit 1 = session (token carries the
        # watermark), bit 2 = follower; no bit = stale local read.
        mode = ("linear" if flags & 1 else
                "session" if flags & 2 else
                "follower" if flags & 4 else "local")

        def _run():
            try:
                rows = self.rdb.query(
                    body.decode("utf-8"), group, mode=mode,
                    watermark=token, timeout=self.timeout_s,
                    **({} if deadline_ms is None
                       else {"deadline_ms": deadline_ms}))
            except Overloaded as e:
                # Brownout refusal at the engine: over the ring the
                # opt-in downgrade is NOT offered (the completion has
                # no served-mode channel and a silent downgrade is
                # forbidden) — 429 + Retry-After, the client backs off.
                self._complete(worker, req_id, ST_OVERLOADED,
                               min(int(e.retry_after_s * 1000),
                                   0xFFFFFFFF), self._err_body(e))
            except NotLeaderError as e:
                self._complete(worker, req_id, ST_NOT_LEADER,
                               max(e.leader, 0), self._err_body(e))
            except TimeoutError as e:
                self._complete(worker, req_id, ST_UNAVAILABLE, 0,
                               self._err_body(e))
            except Exception as e:                      # noqa: BLE001
                self._complete(worker, req_id, ST_ERR, 0,
                               self._err_body(e))
            else:
                self._complete(worker, req_id, ST_OK,
                               self._watermark(group),
                               rows.encode("utf-8"))

        self._read_pool.submit(_run)

    def _handle_doc(self, worker: int, req_id: int, body: bytes) -> None:
        name = body.decode("utf-8", "replace")
        render = {
            "metrics": self.rdb.render_metrics,
            "health": self.rdb.render_health,
            "members": self.rdb.render_members,
            "trace": self.rdb.render_trace,
            "events": self.rdb.render_events,
        }.get(name)

        def _run():
            if render is None:
                self._complete(worker, req_id, ST_ERR, 0,
                               f"unknown document {name!r}".encode())
                return
            try:
                doc = render().encode("utf-8")
                if len(doc) > self._cpl[worker].cap // 4:
                    # Too large for one completion record: hand it over
                    # as a file beside the rings.
                    fname = f"doc-{worker}-{req_id}.json"
                    path = os.path.join(self.dirname, fname)
                    with open(path + ".tmp", "wb") as f:
                        f.write(doc)
                    os.replace(path + ".tmp", path)
                    self._complete(worker, req_id, ST_DOC_FILE, 0,
                                   fname.encode())
                else:
                    self._complete(worker, req_id, ST_OK, 0, doc)
            except Exception as e:                      # noqa: BLE001
                self._complete(worker, req_id, ST_ERR, 0,
                               self._err_body(e))

        self._read_pool.submit(_run)

    def _handle_member(self, worker: int, req_id: int,
                       body: bytes) -> None:
        from raftsql_tpu_torch.runtime.db import NotLeaderError

        def _run():
            try:
                req = json.loads(body.decode("utf-8") or "{}")
                got = self.rdb.member_change(int(req.get("group", 0)),
                                             str(req.get("op", "")),
                                             int(req.get("peer", -1)))
            except NotLeaderError as e:
                self._complete(worker, req_id, ST_NOT_LEADER,
                               max(e.leader, 0), self._err_body(e))
            except Exception as e:                      # noqa: BLE001
                self._complete(worker, req_id, ST_ERR, 0,
                               self._err_body(e))
            else:
                self._complete(worker, req_id, ST_OK, 0,
                               (json.dumps(got, sort_keys=True) + "\n")
                               .encode("utf-8"))

        self._read_pool.submit(_run)

    def _handle_transfer(self, worker: int, req_id: int,
                         body: bytes) -> None:
        from raftsql_tpu_torch.runtime.db import NotLeaderError

        def _run():
            try:
                req = json.loads(body.decode("utf-8") or "{}")
                got = self.rdb.transfer(int(req.get("group", 0)),
                                        int(req.get("target", -1)))
            except NotLeaderError as e:
                self._complete(worker, req_id, ST_NOT_LEADER,
                               max(e.leader, 0), self._err_body(e))
            except Exception as e:                      # noqa: BLE001
                self._complete(worker, req_id, ST_ERR, 0,
                               self._err_body(e))
            else:
                self._complete(worker, req_id, ST_OK, 0,
                               (json.dumps(got, sort_keys=True) + "\n")
                               .encode("utf-8"))

        self._read_pool.submit(_run)

    def _handle_reshard(self, worker: int, req_id: int,
                        body: bytes) -> None:
        """POST /reshard over the ring (op 6): enqueue an elastic-
        keyspace verb at the engine's reshard plane.  A refused verb
        (one in flight, invalid arguments) answers ST_REFUSED, no plane
        ST_UNAVAILABLE, anything else ST_ERR: the worker maps them back
        onto 409, 503 and 400 as the in-process plane answers."""
        from raftsql_tpu_torch.reshard.coordinator import ReshardRefused

        def _run():
            try:
                if self.rdb.reshard is None:
                    self._complete(worker, req_id, ST_UNAVAILABLE, 0,
                                   b"no reshard plane (--reshard)")
                    return
                req = json.loads(body.decode("utf-8") or "{}")
                got = self.rdb.reshard.enqueue(
                    str(req.get("verb", "")),
                    int(req.get("src", -1)),
                    int(req.get("dst", -1)),
                    req.get("slots"))
            except ReshardRefused as e:
                self._complete(worker, req_id, ST_REFUSED, 0,
                               self._err_body(e))
            except Exception as e:                      # noqa: BLE001
                self._complete(worker, req_id, ST_ERR, 0,
                               self._err_body(e))
            else:
                self._complete(worker, req_id, ST_OK, 0,
                               (json.dumps(got, sort_keys=True) + "\n")
                               .encode("utf-8"))

        self._read_pool.submit(_run)

    def _handle_kv(self, worker: int, req_id: int, token: int,
                   body: bytes,
                   deadline_ms: Optional[float] = None) -> None:
        """The keyed /kv surface over the ring (op 7): the engine's
        reshard plane routes the key (epoch fail-closed, frozen-slot
        refusal) and the engine proposes or reads it in the same
        request, as the in-process HTTP planes do."""
        from raftsql_tpu_torch.overload import Overloaded
        from raftsql_tpu_torch.reshard.plane import FrozenSlot, WrongEpoch
        from raftsql_tpu_torch.runtime.db import NotLeaderError
        plane = self.rdb.reshard

        def _fail(e: BaseException) -> None:
            if isinstance(e, WrongEpoch):
                self._complete(worker, req_id, ST_WRONG_EPOCH, 0,
                               json.dumps({"error": str(e),
                                           "have": e.have,
                                           "keymap": plane.keymap.to_doc()},
                                          sort_keys=True).encode())
            elif isinstance(e, FrozenSlot):
                self._complete(worker, req_id, ST_REFUSED, e.slot,
                               self._err_body(e))
            elif isinstance(e, Overloaded):
                self._complete(worker, req_id, ST_OVERLOADED,
                               min(int(e.retry_after_s * 1000),
                                   0xFFFFFFFF), self._err_body(e))
            elif isinstance(e, NotLeaderError):
                self._complete(worker, req_id, ST_NOT_LEADER,
                               max(e.leader, 0), self._err_body(e))
            elif isinstance(e, TimeoutError):
                self._complete(worker, req_id, ST_UNAVAILABLE, 0,
                               self._err_body(e))
            else:
                self._complete(worker, req_id, ST_ERR, 0,
                               self._err_body(e))

        def _ok(group: int, rows: Optional[str] = None) -> None:
            self._complete(worker, req_id, ST_OK, self._watermark(group),
                           json.dumps({"group": group,
                                       "epoch": plane.keymap.epoch,
                                       "rows": rows}).encode())

        if plane is None:
            self._complete(worker, req_id, ST_UNAVAILABLE, 0,
                           b"no reshard plane (--reshard)")
            return
        req = json.loads(body.decode("utf-8"))
        epoch = req.get("epoch")
        if req.get("method") == "PUT":
            try:
                group, sql = plane.kv_put(req["key"], req["value"], epoch)
                fut = self.rdb.propose(
                    sql, group, token=token or None,
                    **({} if deadline_ms is None
                       else {"deadline_ms": deadline_ms}))
            except Exception as e:                      # noqa: BLE001
                _fail(e)
                return
            self.proposed += 1
            fut.add_done_callback(
                lambda err: _ok(group) if err is None else _fail(err))
            return
        mode = req.get("mode") or "local"

        def _read():
            try:
                group, sql = plane.kv_get(req["key"], epoch)
                rows = self.rdb.query(
                    sql, group, mode=mode, watermark=token,
                    timeout=self.timeout_s,
                    **({} if deadline_ms is None
                       else {"deadline_ms": deadline_ms}))
            except Exception as e:                      # noqa: BLE001
                _fail(e)
            else:
                _ok(group, rows)

        self._read_pool.submit(_read)

    # -- the drain loop --------------------------------------------------

    def _drain(self, worker: int) -> None:
        ring = self._req[worker]
        last = time.monotonic()
        while not self._stop.is_set():
            worked = False
            t_b0 = time.monotonic()
            while True:
                view = ring.pop()
                if view is None:
                    break
                op, req_id, group, flags, token, wire_dl, body = \
                    decode_request(view)
                ring.pop_commit()       # bytes copied out; release early
                worked = True
                # Ring-phase deadline shed (overload plane): a record
                # whose absolute monotonic-ms deadline already passed
                # while queued does no consensus work — ST_OVERLOADED
                # before any WAL/fsync cost, counted shed_ring.
                deadline_ms = None
                if wire_dl:
                    remain = wire_dl - time.monotonic() * 1000.0
                    if remain <= 0:
                        ov = self._overload()
                        if ov is not None:
                            ov.note_shed("ring")
                        self._complete(worker, req_id, ST_OVERLOADED,
                                       self._retry_after_ms(),
                                       b"deadline exceeded (ring)")
                        continue
                    deadline_ms = remain
                try:
                    if op == OP_PUT:
                        self._handle_put(worker, req_id, group, token,
                                         body, deadline_ms)
                    elif op == OP_GET:
                        self._handle_get(worker, req_id, group, flags,
                                         token, body, deadline_ms)
                    elif op == OP_DOC:
                        self._handle_doc(worker, req_id, body)
                    elif op == OP_MEMBER:
                        self._handle_member(worker, req_id, body)
                    elif op == OP_XFER:
                        self._handle_transfer(worker, req_id, body)
                    elif op == OP_RESHARD:
                        self._handle_reshard(worker, req_id, body)
                    elif op == OP_KV:
                        self._handle_kv(worker, req_id, token, body,
                                        deadline_ms)
                    else:
                        self._complete(worker, req_id, ST_ERR, 0,
                                       f"unknown op {op}".encode())
                except Exception as e:                  # noqa: BLE001
                    self._complete(worker, req_id, ST_ERR, 0,
                                   self._err_body(e))
            if worked:
                last = time.monotonic()
                # ring_drain phase sample (obs/prof.py): how long this
                # batch of popped requests took to hand off, tagged
                # with the worker id it drained.
                prof = getattr(self._prof_node, "prof", None)
                if prof is not None:
                    tick = int(getattr(self._prof_node, "_tick_no", 0))
                    if prof.sampled(tick):
                        prof.record("ring_drain", tick, t_b0,
                                    last - t_b0, tid=worker)
            else:
                delay = _spin_wait(last)
                if delay:
                    time.sleep(delay)


# ---------------------------------------------------------------------------
# Worker side.


class RingNotLeader(Exception):
    def __init__(self, leader: int, text: str):
        super().__init__(text)
        self.leader = leader


class RingClient:
    """The worker's RaftDB facade: the exact surface api/aio.py
    consumes — propose/abandon/query/member_change plus the render_*
    documents — implemented as ring round trips to the engine process.

    Proposals return an AckFuture-compatible object (add_done_callback
    + wait); completions are resolved by one consumer thread off the
    completion ring, so the aio plane's batched ack bridge works
    unchanged on top.
    """

    def __init__(self, dirname: str, worker: int,
                 attach_timeout_s: float = 60.0, trace: bool = False):
        req_p, cpl_p = ring_paths(dirname, worker)
        deadline = time.monotonic() + attach_timeout_s
        while True:
            try:
                self._req = SpscRing(req_p)
                self._cpl = SpscRing(cpl_p)
                break
            except (OSError, ValueError):
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        self.dirname = dirname
        self.worker = worker
        self._mu = threading.Lock()                 # producer + id alloc
        self._next_id = 1
        self._pending: Dict[int, "RingFuture"] = {}
        self._stop = threading.Event()
        self.error: Optional[Exception] = None      # facade parity
        # Session watermarks observed from ST_OK completions (the
        # engine's leader-field echo), per group: this worker's
        # X-Raft-Session response header source.  Monotone max — a
        # slightly stale value only makes a session read wait less.
        self._wm: Dict[int, int] = {}
        self._req_group: Dict[int, int] = {}
        # Cross-process trace merge (--trace): this worker stamps each
        # ring round trip (submit -> completion, pid/worker-id tagged)
        # into a per-process segment file under the ring dir; the
        # engine's /trace merges every segment into ONE multi-process
        # Perfetto timeline (obs/export.py TraceSegmentWriter).
        self._obs = None
        self._t0s: Dict[int, Tuple[float, str]] = {}
        if trace:
            from raftsql_tpu_torch.obs.export import TraceSegmentWriter
            self._obs = TraceSegmentWriter(
                dirname, f"http worker {worker}",
                tag=f"w{worker}-{os.getpid()}")
        # Shared-memory read fast path (runtime/shm.py):
        # best-effort attach — the engine creates the snapshot region
        # before the rings, so if the map fails (gate off, older
        # engine) every read simply takes the ring round trip.
        self._shm = None
        self._shm_hits = 0
        self._shm_fallbacks = 0
        self._kmap_adoptions = 0
        # The elastic-keyspace surface (POST /reshard, /kv) the HTTP
        # planes call on `rdb.reshard`, over ops 6 and 7.
        self.reshard = RingKeyspace(self)
        if os.environ.get("RAFTSQL_SHM_READS", "1") != "0":
            try:
                from raftsql_tpu_torch.runtime.shm import ShmSnapshotReader
                self._shm = ShmSnapshotReader(dirname)
            except Exception:                           # noqa: BLE001
                self._shm = None
        self._consumer = threading.Thread(
            target=self._consume, daemon=True,
            name=f"ring-cpl-{worker}")
        self._consumer.start()

    # -- plumbing --------------------------------------------------------

    _OP_NAMES = {OP_PUT: "ring.put", OP_GET: "ring.get",
                 OP_DOC: "ring.doc", OP_MEMBER: "ring.member",
                 OP_XFER: "ring.transfer", OP_RESHARD: "ring.reshard",
                 OP_KV: "ring.kv"}

    def _submit(self, op: int, group: int, flags: int, token: int,
                body: bytes, deadline_s: Optional[float] = None,
                deadline_ms: Optional[float] = None) -> "RingFuture":
        """`deadline_s` bounds the ring-full backoff below — callers
        plumb their own timeout through (member/transfer/doc pass
        their wait budgets, query passes its `timeout`) instead of the
        old hardcoded 2 s, so worker-side timeouts and engine-side
        deadlines agree.  `deadline_ms` (remaining client budget)
        additionally rides the record as an absolute monotonic-ms
        deadline the engine sheds against."""
        if deadline_s is None:
            deadline_s = 2.0
        wire_dl = 0 if deadline_ms is None else \
            max(1, int(time.monotonic() * 1000.0 + deadline_ms))
        fut = RingFuture()
        with self._mu:
            req_id = self._next_id
            self._next_id += 1
            self._pending[req_id] = fut
            self._req_group[req_id] = group
            if self._obs is not None:
                # Submit stamp: the span closes when the completion
                # pops (the client-visible ring round trip — HTTP
                # parse happened just before, the ack rides after).
                self._t0s[req_id] = (time.monotonic(),
                                     self._OP_NAMES.get(op, "ring.op"))
            ok = self._req.push(encode_request(op, req_id, group, flags,
                                               token, body, wire_dl))
        if not ok:
            # Ring full: back off briefly — the engine drains in big
            # gulps, so a full ring clears in microseconds unless the
            # engine is down.
            deadline = time.monotonic() + deadline_s
            while not ok:
                time.sleep(0.0002)
                with self._mu:
                    ok = self._req.push(encode_request(
                        op, req_id, group, flags, token, body, wire_dl))
                    if not ok and time.monotonic() > deadline:
                        self._pending.pop(req_id, None)
                        raise RingFull("propose ring full "
                                       "(engine stalled?)")
        return fut

    def _consume(self) -> None:
        last = time.monotonic()
        while not self._stop.is_set():
            worked = False
            while True:
                view = self._cpl.pop()
                if view is None:
                    break
                req_id, status, leader, body = decode_completion(view)
                self._cpl.pop_commit()
                worked = True
                fut = self._pending.pop(req_id, None)
                g = self._req_group.pop(req_id, None)
                if status == ST_OK and g is not None:
                    # ST_OK's leader field is the engine's session
                    # watermark echo — record BEFORE resolving so a
                    # caller reading watermark(g) right after wait()
                    # sees a value covering its own request.
                    if leader > self._wm.get(g, 0):
                        self._wm[g] = leader
                if fut is not None:
                    fut._resolve(status, leader, body)
                if self._obs is not None:
                    got = self._t0s.pop(req_id, None)
                    if got is not None:
                        now = time.monotonic()
                        self._obs.note(got[1], got[0], now - got[0],
                                       tid=0, status=status)
            if worked:
                last = time.monotonic()
                if self._obs is not None:
                    self._obs.maybe_flush()
            else:
                delay = _spin_wait(last)
                if delay:
                    time.sleep(delay)

    def close(self) -> None:
        self._stop.set()
        self._consumer.join(timeout=2)
        if self._obs is not None:
            self._obs.flush()       # the segment file outlives us
        if self._shm is not None:
            self._shm.close()
        self._req.close()
        self._cpl.close()

    # -- the RaftDB surface ---------------------------------------------

    def propose(self, query: str, group: int = 0,
                token: Optional[int] = None,
                deadline_ms: Optional[float] = None) -> "RingFuture":
        """`deadline_ms` (the client's remaining X-Raft-Deadline-Ms
        budget) rides the ring record so the engine sheds expired
        proposals before staging, and bounds the ring-full backoff so
        the worker never outwaits its own client."""
        return self._submit(
            OP_PUT, group, 0, token or 0, query.encode("utf-8"),
            deadline_s=(None if deadline_ms is None
                        else max(deadline_ms / 1000.0, 0.001)),
            deadline_ms=deadline_ms)

    def abandon(self, query: str, group: int, fut) -> None:
        """Deregister a timed-out proposal's callback (parity with
        RaftDB.abandon): the engine may still commit it — only this
        worker's interest is dropped."""
        with self._mu:
            for req_id, f in list(self._pending.items()):
                if f is fut:
                    self._pending.pop(req_id, None)
                    self._req_group.pop(req_id, None)
                    return

    def watermark(self, group: int = 0) -> int:
        """Session watermark for this worker's X-Raft-Session response
        header: the newest engine watermark observed on this worker's
        own completions (monotone; covers every request this worker
        has acked)."""
        return self._wm.get(group, 0)

    def query(self, query: str, group: int = 0, linear: bool = False,
              timeout: float = 10.0, mode: Optional[str] = None,
              watermark: int = 0, deadline_ms: Optional[float] = None,
              brownout: bool = False,
              info: Optional[dict] = None) -> str:
        """`deadline_ms` bounds the wait AND rides the ring record so
        the engine sheds the read once expired.  `brownout` (the
        client's X-Raft-Brownout opt-in) is accepted for facade parity
        but NOT forwarded: the completion wire has no served-mode
        channel and the overload contract forbids a silent downgrade,
        so a browned-out lease miss surfaces as Overloaded (429) here
        and the client backs off or retries another node."""
        from raftsql_tpu_torch.overload import Overloaded
        from raftsql_tpu_torch.runtime.db import NotLeaderError
        if deadline_ms is not None:
            timeout = min(timeout, max(deadline_ms / 1000.0, 0.0))
        if info is not None:
            info["served"] = mode if mode is not None else \
                ("linear" if linear else "local")
        if mode is None:
            mode = "linear" if linear else "local"
        flags = {"local": 0, "linear": 1, "session": 2,
                 "follower": 4}.get(mode)
        if flags is None:
            raise ValueError(f"unknown read mode {mode!r}")
        if self._shm is not None:
            # Zero-round-trip fast path: serve from the mapped
            # snapshot when it PROVES this mode's freshness contract
            # (shm.py module docstring); anything unprovable — stale
            # epoch, uncovered watermark, lapsed lease, SQL error —
            # falls through to the authoritative ring path below.
            got = None
            try:
                got = self._shm.try_read(mode, group, query,
                                         max(int(watermark), 0))
            except Exception:                           # noqa: BLE001
                self._shm.close()      # release the mmap, don't leak
                self._shm = None       # a broken mapping is dead
            if got is not None:
                rows, wm = got
                self._shm_hits += 1
                if wm > self._wm.get(group, 0):
                    self._wm[group] = wm
                return rows
            self._shm_fallbacks += 1
            if self._shm is not None:
                # A reshard flip moved the published mapping version:
                # this read fails closed to the ring.  The worker routes
                # no key by itself (op 7 routes at the engine), so it
                # adopts the new version and its next reads serve from
                # the mapped snapshot again.
                self.adopt_keymap_epoch(self._shm.keymap_epoch())
        fut = self._submit(OP_GET, group, flags,
                           max(int(watermark), 0),
                           query.encode("utf-8"),
                           deadline_s=timeout, deadline_ms=deadline_ms)
        status, leader, body = fut.wait_raw(timeout)
        if status == ST_OK:
            return body.decode("utf-8")
        text = body.decode("utf-8", "replace")
        if status == ST_NOT_LEADER:
            raise NotLeaderError(group, leader)
        if status == ST_UNAVAILABLE:
            raise TimeoutError(text)
        if status == ST_OVERLOADED:
            # leader field = Retry-After in milliseconds.
            raise Overloaded("ring", max(leader, 10) / 1000.0, text)
        raise ValueError(text)

    def member_change(self, group: int, op: str, peer: int) -> dict:
        from raftsql_tpu_torch.runtime.db import NotLeaderError
        fut = self._submit(OP_MEMBER, group, 0, 0,
                           json.dumps({"group": group, "op": op,
                                       "peer": peer}).encode(),
                           deadline_s=10.0)
        status, leader, body = fut.wait_raw(10.0)
        if status == ST_OK:
            return json.loads(body.decode("utf-8"))
        if status == ST_NOT_LEADER:
            raise NotLeaderError(group, leader)
        raise ValueError(body.decode("utf-8", "replace"))

    def transfer(self, group: int, target: int) -> dict:
        """POST /transfer over the ring (op 5): arm a leadership
        transfer at the engine — same surface as RaftDB.transfer."""
        from raftsql_tpu_torch.runtime.db import NotLeaderError
        fut = self._submit(OP_XFER, group, 0, 0,
                           json.dumps({"group": group,
                                       "target": target}).encode(),
                           deadline_s=10.0)
        status, leader, body = fut.wait_raw(10.0)
        if status == ST_OK:
            return json.loads(body.decode("utf-8"))
        if status == ST_NOT_LEADER:
            raise NotLeaderError(group, leader)
        raise ValueError(body.decode("utf-8", "replace"))

    def adopt_keymap_epoch(self, epoch: int) -> None:
        """Revalidate the shm fast path against the engine's current
        elastic-keyspace mapping version (shm.py note_keymap_epoch)."""
        if self._shm is not None and epoch != self._shm._kmap_epoch:
            self._shm.note_keymap_epoch(epoch)
            self._kmap_adoptions += 1

    def _doc(self, name: str, timeout: float = 5.0) -> str:
        fut = self._submit(OP_DOC, 0, 0, 0, name.encode(),
                           deadline_s=timeout)
        status, _leader, body = fut.wait_raw(timeout)
        if status == ST_DOC_FILE:
            path = os.path.join(self.dirname, body.decode("utf-8"))
            try:
                with open(path, "rb") as f:
                    return f.read().decode("utf-8")
            finally:
                os.unlink(path)
        if status != ST_OK:
            raise RuntimeError(body.decode("utf-8", "replace"))
        return body.decode("utf-8")

    def _inject_reads(self, doc: dict) -> dict:
        """Fold this worker's shm fast-path counters into the engine's
        metrics document (the engine's own shm_hits/shm_fallbacks are
        always 0 — hits happen HERE).  Same mutation on both the JSON
        and prom renders, so scripts/check_prom.py's round-trip check
        stays exact."""
        r = doc.setdefault("reads", {})
        r["shm_hits"] = int(r.get("shm_hits", 0)) + self._shm_hits
        r["shm_fallbacks"] = (int(r.get("shm_fallbacks", 0))
                              + self._shm_fallbacks)
        r["shm_keymap_adoptions"] = (int(r.get("shm_keymap_adoptions", 0))
                                     + self._kmap_adoptions)
        return doc

    def render_metrics(self) -> str:
        return json.dumps(
            self._inject_reads(json.loads(self._doc("metrics"))),
            sort_keys=True) + "\n"

    def render_metrics_prom(self) -> str:
        """Prometheus exposition at a worker: fetch the engine's JSON
        document over the ring and render locally — same mapping as
        RaftDB.render_metrics_prom, no new ring op."""
        from raftsql_tpu_torch.utils.metrics import prom_render
        return prom_render(
            self._inject_reads(json.loads(self._doc("metrics"))))

    def render_health(self) -> str:
        return self._doc("health")

    def render_members(self) -> str:
        return self._doc("members")

    def render_trace(self) -> str:
        return self._doc("trace", timeout=30.0)

    def render_events(self) -> str:
        return self._doc("events", timeout=30.0)


class RingFuture:
    """AckFuture-compatible result carrier for ring round trips: PUT
    consumers use add_done_callback(err)/wait(err contract); raw
    consumers (GET/DOC) read (status, leader, body)."""

    def __init__(self):
        self._evt = threading.Event()
        self._raw: Tuple[int, int, bytes] = (ST_UNAVAILABLE, 0,
                                             b"no completion")
        self._cb: Optional[Callable] = None
        self._mu = threading.Lock()

    def _resolve(self, status: int, leader: int, body: bytes) -> None:
        self._raw = (status, leader, body)
        self._evt.set()
        with self._mu:
            cb, self._cb = self._cb, None
        if cb is not None:
            cb(self._err())

    def _err(self) -> Optional[Exception]:
        status, leader, body = self._raw
        if status == ST_OK:
            return None
        text = body.decode("utf-8", "replace")
        if status == ST_NOT_LEADER:
            return RingNotLeader(leader, text)
        if status == ST_OVERLOADED:
            # leader field = Retry-After in milliseconds; the worker's
            # HTTP plane maps this onto 429 + Retry-After.
            from raftsql_tpu_torch.overload import Overloaded
            return Overloaded("ring", max(leader, 10) / 1000.0, text)
        return RuntimeError(text)

    def add_done_callback(self, cb) -> None:
        with self._mu:
            if not self._evt.is_set():
                self._cb = cb
                return
        cb(self._err())

    def wait(self, timeout: Optional[float] = None) -> Optional[Exception]:
        if not self._evt.wait(timeout):
            raise TimeoutError("proposal not committed in time")
        return self._err()

    def wait_raw(self, timeout: Optional[float]) -> Tuple[int, int, bytes]:
        if not self._evt.wait(timeout):
            raise TimeoutError("no answer from engine in time")
        return self._raw


class RingKeyspace:
    """A worker's `rdb.reshard`: the elastic-keyspace surface the HTTP
    planes call (POST /reshard: `enqueue`; the keyed /kv surface: `kv`),
    carried to the engine's ReshardPlane over ring ops 6 and 7, with the
    in-process plane's refusals (ReshardRefused, WrongEpoch, FrozenSlot,
    NotLeaderError, Overloaded) raised again here.  `keymap` is the last
    mapping the engine answered with (epoch and document only)."""

    def __init__(self, client: "RingClient"):
        self._client = client
        self.keymap = _KeymapEcho()

    def enqueue(self, verb: str, src: int, dst: int,
                slots=None) -> dict:
        from raftsql_tpu_torch.reshard.coordinator import ReshardRefused
        fut = self._client._submit(
            OP_RESHARD, 0, 0, 0,
            json.dumps({"verb": verb, "src": src, "dst": dst,
                        "slots": slots}).encode(), deadline_s=10.0)
        status, _leader, body = fut.wait_raw(10.0)
        text = body.decode("utf-8", "replace")
        if status == ST_OK:
            return json.loads(text)
        if status == ST_REFUSED:
            raise ReshardRefused(text)
        if status == ST_UNAVAILABLE:
            raise TimeoutError(text)
        raise ValueError(text)

    def kv(self, method: str, key: str, value: Optional[str] = None,
           epoch: Optional[int] = None, mode: Optional[str] = None,
           session: int = 0, token: Optional[int] = None,
           timeout: float = 10.0,
           deadline_ms: Optional[float] = None) -> dict:
        """One keyed request at the engine: {"group", "epoch", "rows"}
        (rows for GET), or the in-process plane's exception."""
        from raftsql_tpu_torch.overload import Overloaded
        from raftsql_tpu_torch.reshard.plane import FrozenSlot, WrongEpoch
        from raftsql_tpu_torch.runtime.db import NotLeaderError
        c = self._client
        if deadline_ms is not None:
            timeout = min(timeout, max(deadline_ms / 1000.0, 0.0))
        tok = (token or 0) if method == "PUT" else max(int(session), 0)
        fut = c._submit(OP_KV, 0, 0, tok,
                        json.dumps({"method": method, "key": key,
                                    "value": value, "epoch": epoch,
                                    "mode": mode}).encode(),
                        deadline_s=timeout, deadline_ms=deadline_ms)
        status, leader, body = fut.wait_raw(timeout)
        text = body.decode("utf-8", "replace")
        if status == ST_OK:
            got = json.loads(text)
            g = int(got["group"])
            if leader > c._wm.get(g, 0):
                c._wm[g] = leader
            self.keymap.epoch = int(got["epoch"])
            c.adopt_keymap_epoch(self.keymap.epoch)
            return got
        if status == ST_WRONG_EPOCH:
            got = json.loads(text)
            self.keymap.epoch = int(got["have"])
            self.keymap.doc = got["keymap"]
            c.adopt_keymap_epoch(self.keymap.epoch)
            raise WrongEpoch(int(got["have"]),
                             -1 if epoch is None else int(epoch))
        if status == ST_REFUSED:
            raise FrozenSlot(key, leader)
        if status == ST_NOT_LEADER:
            raise NotLeaderError(0, leader)
        if status == ST_UNAVAILABLE:
            raise TimeoutError(text)
        if status == ST_OVERLOADED:
            raise Overloaded("ring", max(leader, 10) / 1000.0, text)
        raise ValueError(text)


class _KeymapEcho:
    """The engine's mapping as a worker last saw it: `epoch`, and the
    document a 409 carried (`to_doc`)."""

    def __init__(self):
        self.epoch = 0
        self.doc: dict = {}

    def to_doc(self) -> dict:
        return self.doc
