"""Single-threaded asyncio HTTP plane — same client API as api/http.py.

The reference serves its HTTP API with Go's net/http (one goroutine per
connection, reference httpapi.go:26-79).  The stdlib-threaded port of
that shape (api/http.py) spends most of its request budget on thread
machinery once clients are concurrent: one OS thread per connection
contending for the GIL with the consensus tick thread, plus one
Event.wait/set round trip per acknowledged proposal.

This plane is the event-loop redesign: ONE thread runs a minimal
HTTP/1.1 state machine for every connection, proposals go straight to
`RaftDB.propose`, and commit acknowledgements ride a BATCHED bridge —
the consensus consumer resolves AckFutures from its own thread, the
bridge coalesces every ack that lands between two loop iterations into
a single `call_soon_threadsafe` wakeup (one loop wakeup per commit
batch, not per request).  A read takes its read point on the loop
thread, parks on the engine's apply (RaftDB.park) through the same
bridge, and only its SQLite query (or a ReadIndex round that must wait
for its confirmation) runs in a small executor, so the loop never
stalls and no executor thread waits for the apply.

Semantics parity with api/http.py, pinned by the parametrized fixture
in tests/test_api_http.py (every test runs against both planes):
PUT 204/400 + blocking-until-applied contract (reference
httpapi.go:38-49), GET local reads + X-Consistency: linear (421 +
X-Raft-Leader elsewhere, 503 on timeout), GET /metrics, 405 with Allow
on anything else (connection stays usable), X-Raft-Group routing.
"""
from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Optional

from raftsql_tpu_torch.overload import (Overloaded, retry_after_header,
                                  retryable_refusal)
from raftsql_tpu_torch.runtime.db import NotLeaderError, RaftDB

log = logging.getLogger("raftsql.api.aio")

_MAX_HEAD = 64 * 1024          # header block cap before we drop the conn
_MAX_BODY = 4 * 1024 * 1024    # SQL statement cap (parity: unbounded-ish)
_ALLOW = (b"HTTP/1.1 405 Method Not Allowed\r\nAllow: PUT, GET\r\n"
          b"Content-Length: 19\r\n\r\nMethod not allowed\n")
_ALLOW_NOBODY = (b"HTTP/1.1 405 Method Not Allowed\r\nAllow: PUT, GET\r\n"
                 b"Content-Length: 0\r\n\r\n")
_204 = b"HTTP/1.1 204 No Content\r\n\r\n"


def _resp(code: int, reason: bytes, body: bytes = b"",
          ctype: bytes = b"text/plain; charset=utf-8",
          extra: tuple = ()) -> bytes:
    head = [b"HTTP/1.1 " + str(code).encode() + b" " + reason]
    for k, v in extra:
        head.append(k + b": " + v)
    head.append(b"Content-Type: " + ctype)
    head.append(b"Content-Length: " + str(len(body)).encode())
    head.append(b"")
    return b"\r\n".join(head) + b"\r\n" + body


def _refusal_resp(e: Exception) -> bytes:
    """THE retryable-refusal response for this plane — the same
    contract api/http.py emits via its `_refuse` helper: `Overloaded`
    is 429 with the controller's jittered drain-rate Retry-After,
    every other transient condition is 503 with its default; both
    ALWAYS carry Retry-After so api/client.py holds off per-node."""
    code, retry_s = retryable_refusal(e)
    reason = (b"Too Many Requests" if code == 429
              else b"Service Unavailable")
    return _resp(code, reason, (str(e) + "\n").encode(),
                 extra=((b"Retry-After",
                         retry_after_header(retry_s).encode()),))


def _parsed_kw(rdb) -> dict:
    """The `parsed` stamp of a write for the engine's span tracer
    (obs/spans.py), as `RaftDB.propose` keywords; empty with tracing
    off."""
    node = getattr(getattr(rdb, "pipe", None), "node", None)
    if getattr(node, "tracer", None) is None:
        return {}
    return {"t_parsed": time.monotonic()}


def _note_reply(fut) -> None:
    """Stamp `reply` on the finished span `fut` carries, if any (the
    response was just written)."""
    span = getattr(fut, "span", None)
    if span is not None:
        span[0].note_reply(span[1])


def _note_read_reply(span) -> None:
    """Fold a read's stamps, the reply's now, into its tracer (`span`
    is what `_Conn._read` returned, None with tracing off)."""
    if span is not None:
        tracer, group, stamps = span
        stamps.append(time.monotonic())
        tracer.note_read(group, stamps)


def _session_extra(rdb, group: int) -> tuple:
    """X-Raft-Session commit-watermark echo as a `_resp` extra-header
    tuple (advisory — a failed gauge read never fails the request)."""
    try:
        return ((b"X-Raft-Session", str(rdb.watermark(group)).encode()),)
    except Exception:                                   # noqa: BLE001
        return ()


class _AckBridge:
    """Batch cross-thread ack delivery into the event loop.

    AckFuture callbacks fire on the commit-consumer thread, one per
    request; waking the loop per request would re-create the per-ack
    syscall the redesign removes.  Every ack landing while a flush is
    pending is appended under the lock and delivered by the SAME
    scheduled flush — one loop wakeup per commit batch under load."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self.loop = loop
        self._mu = threading.Lock()
        self._pending: list = []
        self._scheduled = False

    def deliver(self, afut: asyncio.Future, err) -> None:
        with self._mu:
            self._pending.append((afut, err))
            if self._scheduled:
                return
            self._scheduled = True
        try:
            self.loop.call_soon_threadsafe(self._flush)
        except RuntimeError:     # loop closed during shutdown
            with self._mu:       # un-mute: a live loop must reschedule
                self._scheduled = False

    def _flush(self) -> None:
        with self._mu:
            items, self._pending = self._pending, []
            self._scheduled = False
        for afut, err in items:
            if not afut.done():
                afut.set_result(err)


class _Conn(asyncio.Protocol):
    """One HTTP/1.1 keep-alive connection: sequential request/response
    (pipelined bytes buffer and are parsed as soon as the in-flight
    response is written)."""

    def __init__(self, srv: "AioSQLServer"):
        self.srv = srv
        self.buf = bytearray()
        self.busy = False      # a request handler owns the connection
        self.closed = False

    # -- transport events ----------------------------------------------

    def connection_made(self, transport) -> None:
        self.tr = transport
        try:
            import socket
            sock = transport.get_extra_info("socket")
            if sock is not None:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:          # pragma: no cover - platform quirk
            pass

    def connection_lost(self, exc) -> None:
        self.closed = True

    def data_received(self, data: bytes) -> None:
        self.buf += data
        if not self.busy:
            self._pump()

    # -- request framing -----------------------------------------------

    def _pump(self) -> None:
        while not self.busy and not self.closed:
            req = self._parse_one()
            if req is None:
                return
            method, path, headers, body = req
            if path.startswith(b"/kv/") and method in (b"PUT", b"GET"):
                # Keyed surface over the elastic keyspace
                # (raftsql_tpu/reshard/): routed by hash slot through
                # the reshard plane's keymap, epoch fail-closed.
                self.busy = True
                self.srv.loop.create_task(
                    self._do_kv(method, path, headers, body))
            elif method == b"PUT":
                self.busy = True
                self.srv.loop.create_task(self._do_put(headers, body))
            elif method == b"GET":
                if path == b"/healthz":
                    # Readiness probe — parity with api/http.py.
                    self.tr.write(_resp(200, b"OK",
                                        self.srv.rdb.render_health()
                                        .encode(), b"application/json"))
                    continue
                if path.partition(b"?")[0] == b"/metrics":
                    # Prometheus negotiation, parity with api/http.py:
                    # ?format=prom or an OpenMetrics Accept header.
                    from raftsql_tpu_torch.utils.metrics import (
                        PROM_CONTENT_TYPE, wants_prom)
                    if wants_prom(
                            path.partition(b"?")[2].decode("latin-1"),
                            headers.get("accept", "")):
                        payload = self.srv.rdb.render_metrics_prom() \
                            .encode()
                        self.tr.write(_resp(
                            200, b"OK", payload,
                            PROM_CONTENT_TYPE.encode("latin-1")))
                    else:
                        payload = self.srv.rdb.render_metrics().encode()
                        self.tr.write(_resp(200, b"OK", payload,
                                            b"application/json"))
                    continue
                if path in (b"/trace", b"/events"):
                    # Observability exports (raftsql_tpu/obs/): Chrome
                    # trace JSON / raw event rows, parity with the
                    # threaded plane.
                    render = (self.srv.rdb.render_trace
                              if path == b"/trace"
                              else self.srv.rdb.render_events)
                    self.tr.write(_resp(200, b"OK", render().encode(),
                                        b"application/json"))
                    continue
                if path == b"/members":
                    # Membership admin read — parity with api/http.py.
                    self.tr.write(_resp(
                        200, b"OK", self.srv.rdb.render_members()
                        .encode(), b"application/json"))
                    continue
                self.busy = True
                self.srv.loop.create_task(self._do_get(headers, body))
            elif method == b"POST" and path == b"/members":
                self.busy = True
                self.srv.loop.create_task(self._do_members(body))
            elif method == b"POST" and path == b"/transfer":
                self.busy = True
                self.srv.loop.create_task(self._do_transfer(body))
            elif method == b"POST" and path == b"/reshard":
                self.busy = True
                self.srv.loop.create_task(self._do_reshard(body))
            elif method == b"HEAD":
                self.tr.write(_ALLOW_NOBODY)
            else:
                self.tr.write(_ALLOW)

    def _parse_one(self):
        """One complete request from self.buf, or None if incomplete.
        Malformed framing answers 400 and drops the connection (the
        stream position is unrecoverable)."""
        buf = self.buf
        end = buf.find(b"\r\n\r\n")
        if end < 0:
            if len(buf) > _MAX_HEAD:
                self._fail(b"header block too large\n")
            return None
        try:
            head = bytes(buf[:end]).split(b"\r\n")
            method, path, _version = head[0].split(b" ", 2)
            clen = 0
            group = b"0"
            mode = "local"
            session = 0
            token = None
            accept = b""
            kepoch = None
            deadline = None
            brownout = False
            for line in head[1:]:
                k, _, v = line.partition(b":")
                k = k.strip().lower()
                if k == b"content-length":
                    clen = int(v.strip())
                elif k == b"x-raft-group":
                    group = v.strip()
                elif k == b"x-consistency":
                    # Read mode: local (default) / session / follower
                    # / linear — README read-modes table.
                    mode = v.strip().lower().decode("latin-1") or "local"
                elif k == b"x-raft-session":
                    # Session watermark: the commit-watermark echo a
                    # previous response carried (read-your-writes).
                    session = int(v.strip() or 0)
                elif k == b"accept":
                    # /metrics content negotiation (Prometheus text).
                    accept = v.strip()
                elif k == b"x-raft-retry-token":
                    # Hex u64 retry token: pins the proposal's envelope
                    # id so client re-sends apply exactly once.
                    token = int(v.strip(), 16) & ((1 << 64) - 1)
                elif k == b"x-raft-keymap-epoch":
                    # Elastic keyspace: the mapping version the client
                    # routed by — the reshard plane fails closed on
                    # any mismatch (409 + the current keymap).
                    kepoch = int(v.strip())
                elif k == b"x-raft-deadline-ms":
                    # Overload plane: the client's REMAINING end-to-end
                    # budget for this attempt, in milliseconds.
                    deadline = float(v.strip())
                elif k == b"x-raft-brownout":
                    # Client consents to a session-read downgrade when
                    # the brownout ladder engages (never silent).
                    brownout = v.strip().lower() == b"allow"
        except (ValueError, IndexError):
            self._fail(b"malformed request\n")
            return None
        if not 0 <= clen <= _MAX_BODY:
            self._fail(b"bad content-length\n")
            return None
        total = end + 4 + clen
        if len(buf) < total:
            return None
        body = bytes(buf[end + 4:total])
        del buf[:total]
        return method, path, {"group": group, "mode": mode,
                              "session": session, "token": token,
                              "accept": accept.decode("latin-1"),
                              "kepoch": kepoch, "deadline": deadline,
                              "brownout": brownout}, body

    def _fail(self, msg: bytes) -> None:
        self.tr.write(_resp(400, b"Bad Request", msg))
        self.tr.close()
        self.closed = True

    # -- handlers (one in flight per connection) -----------------------

    def _finish(self, payload: bytes) -> None:
        if not self.closed:
            self.tr.write(payload)
        self.busy = False
        if self.buf and not self.closed:
            self._pump()

    def _shed_expired(self, deadline_ms) -> bool:
        """Edge shed (overload plane): a request whose budget is
        already spent does no consensus work — 504, counted shed_edge.
        Returns True when the request was answered here."""
        if deadline_ms is None or deadline_ms > 0:
            return False
        ov = getattr(self.srv.rdb.pipe.node, "overload", None)
        if ov is not None:
            ov.note_shed("edge")
        self._finish(_resp(504, b"Gateway Timeout",
                           b"deadline exceeded (edge)\n"))
        return True

    async def _do_put(self, headers: dict, body: bytes) -> None:
        rdb = self.srv.rdb
        try:
            query = body.decode("utf-8")
            group = int(headers["group"] or 0)
        except ValueError as e:
            self._finish(_resp(400, b"Bad Request",
                               (str(e) + "\n").encode()))
            return
        parsed = _parsed_kw(rdb)
        dl = headers["deadline"]
        if self._shed_expired(dl):
            return
        # The whole propose+await runs under the broad handling _do_get
        # uses: an unexpected exception (e.g. pipe/queue closed during
        # node shutdown) would otherwise kill this task and leave the
        # connection busy=True forever — the client hangs instead of
        # seeing a 400 (the threaded plane's do_PUT catches everything).
        fut = None
        try:
            fut = rdb.propose(query, group, token=headers["token"],
                              **({} if dl is None
                                 else {"deadline_ms": dl}), **parsed)
            afut = self.srv.loop.create_future()
            fut.add_done_callback(
                lambda err: self.srv.bridge.deliver(afut, err))
            err = await asyncio.wait_for(
                afut, self.srv.timeout_s if dl is None
                else min(self.srv.timeout_s, dl / 1000.0))
        except asyncio.TimeoutError:
            # Deregister the ack so it cannot leak; the statement may
            # still commit later (api/http.py's abandon contract).
            rdb.abandon(query, group, fut)
            if dl is not None:
                ov = getattr(rdb.pipe.node, "overload", None)
                if ov is not None:
                    ov.note_shed("commit_wait")
            self._finish(_refusal_resp(
                TimeoutError("proposal not committed in time")))
            return
        except Overloaded as e:
            # Admission refusal: nothing was enqueued (rdb.propose
            # abandoned the ack) — 429 + jittered Retry-After.
            self._finish(_refusal_resp(e))
            return
        except NotLeaderError as e:
            # --pod owner refusal (server/main.py PodRaftDB), parity
            # with the threaded plane: 421 + X-Raft-Leader names the
            # owner host so the client chases instead of erroring.
            extra = ((b"X-Raft-Leader", str(e.leader).encode()),) \
                if e.leader > 0 else ()
            self._finish(_resp(421, b"Misdirected Request",
                               (str(e) + "\n").encode(), extra=extra))
            return
        except Exception as e:                      # noqa: BLE001
            log.info("client error: %s", e)
            if fut is not None:
                try:
                    rdb.abandon(query, group, fut)
                except Exception:                   # noqa: BLE001
                    pass
            self._finish(_resp(400, b"Bad Request",
                               (str(e) + "\n").encode()))
            return
        if err is not None:
            if isinstance(err, Overloaded):
                # Ring deployments surface admission refusals through
                # the ack path (RingFuture._err) — same 429 contract.
                self._finish(_refusal_resp(err))
                return
            log.info("client error: %s", err)
            self._finish(_resp(400, b"Bad Request",
                               (str(err) + "\n").encode()))
        else:
            # Commit-watermark echo (X-Raft-Session): the ack implies
            # local apply, so this watermark covers the write — a
            # session read presenting it gets read-your-writes at any
            # replica.
            extra = _session_extra(rdb, group)
            if extra:
                self._finish(b"HTTP/1.1 204 No Content\r\n"
                             + extra[0][0] + b": " + extra[0][1]
                             + b"\r\n\r\n")
            else:
                self._finish(_204)
        _note_reply(fut)

    async def _do_members(self, body: bytes) -> None:
        """POST /members — membership admin write, parity with
        api/http.py: 200 + new config JSON, 421 + X-Raft-Leader at a
        non-leader, 400 on an illegal change."""
        import json as _json
        rdb = self.srv.rdb
        try:
            req = _json.loads(body.decode("utf-8") or "{}")
            got = await self.srv.loop.run_in_executor(
                self.srv._read_pool,
                lambda: rdb.member_change(int(req.get("group", 0)),
                                          str(req.get("op", "")),
                                          int(req.get("peer", -1))))
        except NotLeaderError as e:
            extra = ((b"X-Raft-Leader", str(e.leader).encode()),) \
                if e.leader > 0 else ()
            self._finish(_resp(421, b"Misdirected Request",
                               (str(e) + "\n").encode(), extra=extra))
            return
        except Exception as e:                      # noqa: BLE001
            log.info("client error: %s", e)
            self._finish(_resp(400, b"Bad Request",
                               (str(e) + "\n").encode()))
            return
        self._finish(_resp(200, b"OK",
                           (_json.dumps(got, sort_keys=True)
                            + "\n").encode(), b"application/json"))

    async def _do_transfer(self, body: bytes) -> None:
        """POST /transfer — graceful leadership transfer (thesis
        §3.10), parity with api/http.py: 200 + the armed-transfer JSON,
        421 + X-Raft-Leader at a non-leader, 400 on a refused request
        (in-flight transfer, learner target)."""
        import json as _json
        rdb = self.srv.rdb
        try:
            req = _json.loads(body.decode("utf-8") or "{}")
            got = await self.srv.loop.run_in_executor(
                self.srv._read_pool,
                lambda: rdb.transfer(int(req.get("group", 0)),
                                     int(req.get("target", -1))))
        except NotLeaderError as e:
            extra = ((b"X-Raft-Leader", str(e.leader).encode()),) \
                if e.leader > 0 else ()
            self._finish(_resp(421, b"Misdirected Request",
                               (str(e) + "\n").encode(), extra=extra))
            return
        except Exception as e:                      # noqa: BLE001
            log.info("client error: %s", e)
            self._finish(_resp(400, b"Bad Request",
                               (str(e) + "\n").encode()))
            return
        self._finish(_resp(200, b"OK",
                           (_json.dumps(got, sort_keys=True)
                            + "\n").encode(), b"application/json"))

    async def _do_reshard(self, body: bytes) -> None:
        """POST /reshard — enqueue an elastic-keyspace verb, parity
        with api/http.py: 200 + verb JSON, 409 while a verb is in
        flight, 503 with no plane compiled in."""
        import json as _json
        rdb = self.srv.rdb
        if rdb.reshard is None:
            self._finish(_resp(503, b"Service Unavailable",
                               b"no reshard plane (--reshard)\n"))
            return
        from raftsql_tpu_torch.reshard.coordinator import ReshardRefused
        try:
            req = _json.loads(body.decode("utf-8") or "{}")
            got = rdb.reshard.enqueue(str(req.get("verb", "")),
                                      int(req.get("src", -1)),
                                      int(req.get("dst", -1)),
                                      req.get("slots"))
        except ReshardRefused as e:
            self._finish(_resp(409, b"Conflict",
                               (str(e) + "\n").encode()))
            return
        except Exception as e:                      # noqa: BLE001
            log.info("client error: %s", e)
            self._finish(_resp(400, b"Bad Request",
                               (str(e) + "\n").encode()))
            return
        self._finish(_resp(200, b"OK",
                           (_json.dumps(got, sort_keys=True)
                            + "\n").encode(), b"application/json"))

    async def _do_kv(self, method: bytes, path: bytes,
                     headers: dict, body: bytes) -> None:
        """PUT/GET /kv/<key> — the keyed elastic-keyspace surface.
        Responses pin X-Raft-Keymap-Epoch; a request routed by a stale
        epoch is refused with 409 + the current keymap document (fail
        closed — never silently served by a moved mapping)."""
        import json as _json
        rdb = self.srv.rdb
        plane = rdb.reshard
        if plane is None:
            self._finish(_resp(503, b"Service Unavailable",
                               b"no reshard plane (--reshard)\n"))
            return
        from raftsql_tpu_torch.reshard.plane import FrozenSlot, WrongEpoch
        key = path[len(b"/kv/"):].decode("utf-8")

        def _epoch_extra():
            return ((b"X-Raft-Keymap-Epoch",
                     str(plane.keymap.epoch).encode()),)

        if hasattr(plane, "kv"):
            # A ring worker (runtime/ring.py RingKeyspace): the engine
            # routes the key and proposes or reads it in one request.
            await self._do_kv_ring(plane, method, key, headers, body,
                                   _epoch_extra)
            return

        fut = None
        sql, group = "", 0
        dl = headers["deadline"]
        served: dict = {}
        try:
            if method == b"PUT":
                group, sql = plane.kv_put(key, body.decode("utf-8"),
                                          headers["kepoch"])
                parsed = _parsed_kw(rdb)
                if self._shed_expired(dl):
                    return
                fut = rdb.propose(sql, group, token=headers["token"],
                                  **({} if dl is None
                                     else {"deadline_ms": dl}), **parsed)
                afut = self.srv.loop.create_future()
                fut.add_done_callback(
                    lambda err: self.srv.bridge.deliver(afut, err))
                err = await asyncio.wait_for(
                    afut, self.srv.timeout_s if dl is None
                    else min(self.srv.timeout_s, dl / 1000.0))
                if err is not None:
                    raise err
                extra = (_session_extra(rdb, group) + _epoch_extra())
                head = b"HTTP/1.1 204 No Content\r\n" + b"".join(
                    k + b": " + v + b"\r\n" for k, v in extra) + b"\r\n"
                self._finish(head)
                _note_reply(fut)
                return
            group, sql = plane.kv_get(key, headers["kepoch"])
            if self._shed_expired(dl):
                return
            rows, span = await self._read(sql, group, headers, served)
        except WrongEpoch as e:
            payload = (_json.dumps(
                {"error": str(e), "keymap": plane.keymap.to_doc()},
                sort_keys=True) + "\n").encode()
            self._finish(_resp(409, b"Conflict", payload,
                               b"application/json",
                               extra=_epoch_extra()))
            return
        except FrozenSlot as e:
            # Retryable: the verb resolves and unfreezes the slot.
            self._finish(_refusal_resp(e))
            return
        except asyncio.TimeoutError:
            rdb.abandon(sql, group, fut)
            if dl is not None:
                ov = getattr(rdb.pipe.node, "overload", None)
                if ov is not None:
                    ov.note_shed("commit_wait")
            self._finish(_refusal_resp(
                TimeoutError("proposal not committed in time")))
            return
        except Overloaded as e:
            self._finish(_refusal_resp(e))
            return
        except NotLeaderError as e:
            extra = ((b"X-Raft-Leader", str(e.leader).encode()),) \
                if e.leader > 0 else ()
            self._finish(_resp(421, b"Misdirected Request",
                               (str(e) + "\n").encode(), extra=extra))
            return
        except TimeoutError as e:
            self._finish(_refusal_resp(e))
            return
        except Exception as e:                      # noqa: BLE001
            log.info("client error: %s", e)
            if fut is not None:
                try:
                    rdb.abandon(sql, group, fut)
                except Exception:                   # noqa: BLE001
                    pass
            self._finish(_resp(400, b"Bad Request",
                               (str(e) + "\n").encode()))
            return
        extra = _session_extra(rdb, group) + _epoch_extra()
        if served.get("served"):
            extra = extra + ((b"X-Raft-Served-Mode",
                              served["served"].encode()),)
        val = plane.kv_value(rows)
        if val is None:
            self._finish(_resp(404, b"Not Found", b"", extra=extra))
        else:
            self._finish(_resp(200, b"OK", val.encode("utf-8"),
                               extra=extra))
        _note_read_reply(span)

    async def _do_kv_ring(self, plane, method: bytes, key: str,
                          headers: dict, body: bytes,
                          epoch_extra) -> None:
        """/kv at a ring worker: one ring request (op 7) carries the
        key to the engine's reshard plane; its answers and refusals map
        onto the responses the in-process path gives."""
        import json as _json
        from raftsql_tpu_torch.reshard.plane import (FrozenSlot,
                                                     ReshardPlane,
                                                     WrongEpoch)
        rdb = self.srv.rdb
        dl = headers["deadline"]
        if self._shed_expired(dl):
            return
        put = method == b"PUT"
        try:
            got = await self.srv.loop.run_in_executor(
                self.srv._read_pool, lambda: plane.kv(
                    "PUT" if put else "GET", key,
                    value=body.decode("utf-8") if put else None,
                    epoch=headers["kepoch"], mode=headers["mode"],
                    session=headers["session"], token=headers["token"],
                    timeout=self.srv.timeout_s, deadline_ms=dl))
        except WrongEpoch as e:
            payload = (_json.dumps(
                {"error": str(e), "keymap": plane.keymap.to_doc()},
                sort_keys=True) + "\n").encode()
            self._finish(_resp(409, b"Conflict", payload,
                               b"application/json", extra=epoch_extra()))
            return
        except (FrozenSlot, Overloaded, TimeoutError) as e:
            self._finish(_refusal_resp(e))
            return
        except NotLeaderError as e:
            extra = ((b"X-Raft-Leader", str(e.leader).encode()),) \
                if e.leader > 0 else ()
            self._finish(_resp(421, b"Misdirected Request",
                               (str(e) + "\n").encode(), extra=extra))
            return
        except Exception as e:                      # noqa: BLE001
            log.info("client error: %s", e)
            self._finish(_resp(400, b"Bad Request",
                               (str(e) + "\n").encode()))
            return
        extra = _session_extra(rdb, got["group"]) + epoch_extra()
        if put:
            self._finish(b"HTTP/1.1 204 No Content\r\n" + b"".join(
                k + b": " + v + b"\r\n" for k, v in extra) + b"\r\n")
            return
        val = ReshardPlane.kv_value(got["rows"])
        if val is None:
            self._finish(_resp(404, b"Not Found", b"", extra=extra))
        else:
            self._finish(_resp(200, b"OK", val.encode("utf-8"),
                               extra=extra))

    async def _do_get(self, headers: dict, body: bytes) -> None:
        rdb = self.srv.rdb
        try:
            query = body.decode("utf-8")
            group = int(headers["group"] or 0)
        except ValueError as e:
            self._finish(_resp(400, b"Bad Request",
                               (str(e) + "\n").encode()))
            return
        dl = headers["deadline"]
        if self._shed_expired(dl):
            return
        served: dict = {}
        try:
            rows, span = await self._read(query, group, headers, served)
        except Overloaded as e:
            # Admission refusal or brownout without opt-in: 429 +
            # jittered Retry-After — never a silent downgrade.
            self._finish(_refusal_resp(e))
            return
        except NotLeaderError as e:
            extra = ((b"X-Raft-Leader", str(e.leader).encode()),) \
                if e.leader > 0 else ()
            self._finish(_resp(421, b"Misdirected Request",
                               (str(e) + "\n").encode(), extra=extra))
            return
        except TimeoutError as e:
            self._finish(_refusal_resp(e))
            return
        except Exception as e:                      # noqa: BLE001
            log.info("client error: %s", e)
            self._finish(_resp(400, b"Bad Request",
                               (str(e) + "\n").encode()))
            return
        extra = _session_extra(rdb, group)
        if served.get("served"):
            # The brownout contract: the response always names the
            # mode it was actually served at.
            extra = extra + ((b"X-Raft-Served-Mode",
                              served["served"].encode()),)
        self._finish(_resp(200, b"OK", rows.encode("utf-8"),
                           extra=extra))
        _note_read_reply(span)

    async def _read(self, query: str, group: int, headers: dict,
                    served: dict):
        """A GET's answer and its span's stamps (None with tracing
        off), or the read's typed refusal raised.  Against a RaftDB the
        read point is taken here on the loop (`read_point(block=False)`),
        the wait for the apply is parked on the engine's waiters and
        resolved through the ack bridge, and only the SQLite query runs
        in the read pool; a ReadIndex round that must wait for its
        confirmation (runtime/node.py `read_join`) runs there first.
        Any other engine (a ring worker's RingClient, a replica) answers
        the whole query in the pool, as it blocks."""
        srv = self.srv
        rdb, loop, pool = srv.rdb, srv.loop, srv._read_pool
        kw = {"timeout": srv.timeout_s, "mode": headers["mode"],
              "watermark": headers["session"],
              "deadline_ms": headers["deadline"],
              "brownout": headers["brownout"], "info": served}
        if not isinstance(rdb, RaftDB):
            rows = await loop.run_in_executor(
                pool, lambda: rdb.query(query, group, **kw))
            return rows, None
        tracer = getattr(rdb.pipe.node, "tracer", None)
        stamps = None if tracer is None else [time.monotonic()]
        p = rdb.read_point(query, group, block=False, **kw)
        target = p.target
        if p.round is not None:
            target = await loop.run_in_executor(pool, p.round)
        if stamps is not None:
            stamps.append(time.monotonic())
        released = None
        if rdb.watermark(group) < target:
            afut = loop.create_future()
            w = rdb.park(group, target,
                         lambda: srv.bridge.deliver(afut, None))
            if w is not None:
                try:
                    await asyncio.wait_for(
                        afut, max(p.deadline - time.monotonic(), 0.0))
                except asyncio.TimeoutError:
                    rdb.unpark(group, w)
                released = w.t1
            rdb.settle_read(group, target, p.phase)
        rows = await loop.run_in_executor(pool, rdb.local_query, query,
                                          group)
        if stamps is None:
            return rows, None
        stamps += [stamps[1] if released is None else released,
                   time.monotonic()]
        return rows, (tracer, group, stamps)


class AioSQLServer:
    """Drop-in alternative to api/http.py's SQLServer: same constructor
    shape, same start()/stop() lifecycle, one event-loop thread."""

    def __init__(self, port: int, rdb: RaftDB, host: str = "",
                 timeout_s: float = 30.0, reuse_port: bool = False):
        self.port = port
        self.rdb = rdb
        self.host = host
        self.timeout_s = timeout_s
        # SO_REUSEPORT: N worker processes bind the SAME port and the
        # kernel load-balances accepted connections across them — the
        # multi-worker serving plane (runtime/ring.py, --workers N).
        self.reuse_port = reuse_port
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self.bridge: Optional[_AckBridge] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._start_err: Optional[BaseException] = None
        self._server = None
        from concurrent.futures import ThreadPoolExecutor
        self._read_pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="aio-read")

    async def _serve(self) -> None:
        self.loop = asyncio.get_running_loop()
        self.bridge = _AckBridge(self.loop)
        self._server = await self.loop.create_server(
            lambda: _Conn(self), self.host or None, self.port,
            backlog=256, reuse_address=True,
            reuse_port=self.reuse_port or None)
        if self.port == 0:      # tests bind port 0 and read it back
            self.port = self._server.sockets[0].getsockname()[1]
        self._started.set()
        async with self._server:
            await self._server.serve_forever()

    def serve_forever(self) -> None:
        try:
            asyncio.run(self._serve())
        except asyncio.CancelledError:
            pass
        except BaseException as e:    # surface bind errors to start()
            self._start_err = e
            self._started.set()
            if threading.current_thread() is not self._thread:
                raise               # direct serve_forever() callers

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.serve_forever, daemon=True, name="aio-http")
        self._thread.start()
        if not self._started.wait(10):
            raise RuntimeError("aio http server failed to start")
        if self._start_err is not None:
            # The threaded SQLServer raises e.g. EADDRINUSE from its
            # constructor; re-raise the real cause here for parity.
            raise self._start_err

    def stop(self) -> None:
        loop = self.loop
        if loop is not None and loop.is_running():
            def _shutdown():
                for task in asyncio.all_tasks(loop):
                    task.cancel()
            try:
                loop.call_soon_threadsafe(_shutdown)
            except RuntimeError:  # pragma: no cover - already closed
                pass
        if self._thread is not None:
            self._thread.join(5)
        self._read_pool.shutdown(wait=False)
