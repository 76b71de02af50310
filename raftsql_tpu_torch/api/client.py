"""Hardened HTTP client: retries, leader caching, exactly-once PUTs.

The README's curl recipe and the process tests talked to the cluster
with ad-hoc helpers that could only retry a PUT while the connection
was REFUSED — once a server had accepted the bytes, a re-send risked a
duplicate apply (the reference's content-keyed ack model has no request
identity, db.go:112-118).  This client closes that gap and is what both
the process-plane chaos nemesis (chaos/proc.py) and operators should
use:

  * per-request timeouts — a stalled (SIGSTOPped) server costs one
    timeout, not a hung client;
  * jittered exponential backoff across retries, rotating through the
    cluster's nodes so a dead node is routed around;
  * leader caching: a 421 Misdirected Request carries X-Raft-Leader
    (linearizable reads, membership writes) — the hint is remembered
    per group and tried first next time;
  * PROACTIVE routing hints (PR 12): /healthz publishes each group's
    role/leader plus the node's remaining read-lease seconds; the
    client sweeps it (refresh_hints) so writes go leader-first and
    linear reads go lease-holder-first WITHOUT paying a 421 round
    trip at all in steady state;
  * RETRY TOKENS: every logical PUT draws one 64-bit token, sent as
    X-Raft-Retry-Token on every attempt.  The server pins the
    proposal's envelope id to it (runtime/envelope.py), so however many
    attempts reach however many leaders across crashes and failovers,
    the statement applies EXACTLY ONCE — which is what makes
    retry-after-accept safe at all.

Deterministic apply errors (HTTP 400) are never retried — the statement
itself is wrong and a re-send cannot fix it.  503 (quorum/apply
timeout), 421, connection errors, and request timeouts are retried
until the caller's deadline.

Copy of raftsql_tpu/api/client.py for the PyTorch port (plain Python:
the port's process tests and chip_smoke.py drive its clusters with it).
"""
from __future__ import annotations

import http.client
import random
import secrets
import socket
import time
from typing import Dict, List, Optional, Tuple


class ClientError(Exception):
    """Base class for terminal client failures."""


class SQLError(ClientError):
    """The server answered 400: the statement failed deterministically
    (bad SQL, apply error).  Retrying cannot help."""

    def __init__(self, status: int, text: str):
        super().__init__(f"HTTP {status}: {text.strip()}")
        self.status = status
        self.text = text


class Unavailable(ClientError):
    """No node produced a definitive answer before the deadline."""


_RETRYABLE_OS = (ConnectionRefusedError, ConnectionResetError,
                 BrokenPipeError, socket.timeout, TimeoutError, OSError)


class _NodePool:
    """Keep-alive connection pool for ONE node: bounded concurrency
    (the semaphore is the per-node in-flight cap — a loadgen with 500
    threads cannot open 500 sockets to one server), idle connections
    reused LIFO (warmest first).  http.client connections are not
    thread-safe; each is owned by exactly one borrower at a time."""

    def __init__(self, host: str, port: int, max_conns: int,
                 max_idle: int):
        import threading
        self.host, self.port = host, port
        self._idle: List[http.client.HTTPConnection] = []
        self._mu = threading.Lock()
        self._sem = threading.BoundedSemaphore(max_conns)
        self._max_idle = max_idle

    def acquire(self, timeout_s: float):
        """(conn, reused): a pooled keep-alive connection when one is
        idle, else a fresh one.  Blocks while the node is at its
        concurrency cap."""
        if not self._sem.acquire(timeout=timeout_s):
            raise socket.timeout(
                f"{self.host}:{self.port}: per-node concurrency cap")
        with self._mu:
            conn = self._idle.pop() if self._idle else None
        if conn is not None:
            conn.timeout = timeout_s
            if conn.sock is not None:
                conn.sock.settimeout(timeout_s)
            return conn, True
        return http.client.HTTPConnection(
            self.host, self.port, timeout=timeout_s), False

    def release(self, conn, keep: bool) -> None:
        if keep:
            with self._mu:
                if len(self._idle) < self._max_idle:
                    self._idle.append(conn)
                    conn = None
        if conn is not None:
            try:
                conn.close()
            except OSError:          # pragma: no cover - teardown race
                pass
        self._sem.release()

    def close(self) -> None:
        with self._mu:
            idle, self._idle = self._idle, []
        for c in idle:
            try:
                c.close()
            except OSError:          # pragma: no cover - teardown race
                pass


class RaftSQLClient:
    """Client for one cluster: `nodes` is a list of "host:port" (or
    bare port numbers, meaning localhost) client-API endpoints, indexed
    the way the caller thinks of node ids (0-based).

    Connection handling is a load-balancing POOL (PR 7): keep-alive
    connections per node reused across requests (the old one-connection
    -per-request shape spent most of a small PUT's budget on TCP
    setup/teardown), per-node in-flight caps, and a leader cache + RR
    cursor shared THREAD-SAFELY across every thread using this client
    — a bench loadgen drives one client object from hundreds of
    workers.  A request that fails on a REUSED connection (the server
    closed the idle socket) transparently retries once on a fresh
    connection before surfacing the error; fresh-connection failures
    surface unchanged, so the callers' retry policies see exactly the
    old contract."""

    def __init__(self, nodes: List, timeout_s: float = 10.0,
                 backoff_s: float = 0.05, backoff_cap_s: float = 1.0,
                 rng: Optional[random.Random] = None,
                 max_conns_per_node: int = 64,
                 max_idle_per_node: int = 32,
                 hint_refresh_s: float = 2.0):
        import threading
        self.nodes: List[Tuple[str, int]] = []
        for n in nodes:
            if isinstance(n, int):
                self.nodes.append(("127.0.0.1", n))
            else:
                host, _, port = str(n).rpartition(":")
                self.nodes.append((host or "127.0.0.1", int(port)))
        self.timeout_s = timeout_s
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        self.hint_refresh_s = hint_refresh_s
        self._rng = rng or random.Random()
        self._mu = threading.Lock()            # leader cache + rr cursor
        self._leader: Dict[int, int] = {}      # group -> node index
        # Overload plane (raftsql_tpu_torch/overload/): node index -> the
        # monotonic time a 429/503 Retry-After holds that node out of
        # the rotation until.  Per-node, so one saturated engine is
        # avoided while its peers keep serving — never a retry storm.
        self._holdoff: Dict[int, float] = {}
        self._lease: Dict[int, Tuple[int, float]] = {}
        #   group -> (node index, monotonic lease-hint expiry)
        # Witness replicas (config.py quorum geometry): they accept
        # forwarded writes like any follower but refuse every read
        # (400), so the read rotation must never land on one.
        self._witness: set = set()
        self._hints_at = 0.0                   # last /healthz sweep
        self._keymap: Optional[dict] = None    # elastic-keyspace doc
        self._rr = 0                           # round-robin cursor
        self._max_conns = max_conns_per_node   # pod-host adoption
        self._max_idle = max_idle_per_node
        self._pools = [_NodePool(h, p, max_conns_per_node,
                                 max_idle_per_node)
                       for (h, p) in self.nodes]
        # Read-replica tier (raftsql_tpu/replica/): endpoints adopted
        # from the engines' /healthz `replica.endpoints`, routed
        # nearest-first by a measured per-endpoint RTT EWMA (CD-Raft's
        # placement story: reads go to the closest live replica, and
        # ANY refusal — the replicas' fail-closed 421 ladder — falls
        # back to the write tier).  All lists are index-aligned and
        # append-only under _mu, like the pod-host adoption above.
        self._replicas: List[Tuple[str, int]] = []
        self._rpools: List[_NodePool] = []
        self._rtt: List[Optional[float]] = []  # EWMA ms, None unmeasured
        self._ralive: List[bool] = []
        # endpoint -> [hits, refusals]: the georeads bench's evidence
        # of which replica served what.
        self.replica_stats: Dict[str, List[int]] = {}

    def close(self) -> None:
        for p in self._pools + self._rpools:
            p.close()

    # -- low-level -----------------------------------------------------

    def raw(self, node: int, method: str, path: str = "/",
            body: str = "", headers: Optional[dict] = None,
            timeout_s: Optional[float] = None):
        """One request to one node, no cluster-level retries:
        (status, headers, text).  Raises the underlying OSError on
        connection trouble — the retry policy lives in the callers.
        (A stale KEEP-ALIVE socket is retried once on a fresh
        connection internally; that is connection reuse mechanics, not
        policy.)"""
        t = timeout_s or self.timeout_s
        return self._pooled(self._pools[node], method, path,
                            body, headers, t)

    def _pooled(self, pool: _NodePool, method: str, path: str,
                body: str, headers: Optional[dict], t: float):
        for attempt in (0, 1):
            conn, reused = pool.acquire(t)
            keep = False
            try:
                conn.request(method, path, body=body.encode("utf-8"),
                             headers=headers or {})
                r = conn.getresponse()
                text = r.read().decode("utf-8", "replace")
                keep = not r.will_close
                return r.status, dict(r.getheaders()), text
            except _RETRYABLE_OS:
                if reused and attempt == 0:
                    continue           # stale keep-alive: one fresh try
                raise
            except http.client.HTTPException as e:
                # A half-closed keep-alive socket surfaces as
                # BadStatusLine/RemoteDisconnected, not OSError.
                if reused and attempt == 0:
                    continue
                raise ConnectionResetError(str(e)) from e
            finally:
                pool.release(conn, keep)
        raise AssertionError("unreachable")    # pragma: no cover

    def _order(self, group: int, node: Optional[int],
               prefer: Optional[int] = None,
               for_read: bool = False) -> List[int]:
        """Attempt order: pinned node only, else `prefer` (a live lease
        hint) first, then cached leader, then round-robin over the
        rest.  `for_read` drops known witness replicas from the
        rotation (they refuse every read with 400 — a terminal answer,
        not a retry); a pinned node is the caller's explicit choice
        and is honored either way."""
        if node is not None:
            return [node]
        n = len(self.nodes)
        now = time.monotonic()
        with self._mu:
            start = self._rr % n
            self._rr += 1
            lead = self._leader.get(group)
            skip = set(self._witness) if for_read else set()
            # Retry-After holdoff: a node that refused with 429/503
            # stays out of the rotation until its estimate passes —
            # unless that would empty it (then desperation wins).
            skip |= {i for i, t in self._holdoff.items() if t > now}
        order = [(start + i) % n for i in range(n)
                 if (start + i) % n not in skip] \
            or [(start + i) % n for i in range(n)]
        for front in (lead, prefer):
            if front is not None and front in order:
                order.remove(front)
                order.insert(0, front)
        return order

    # -- routing hints (PR 12 front router) ----------------------------

    def _adopt_pod_hosts(self, hosts) -> int:
        """A pod deployment (raftsql_tpu/pod/) publishes the full host
        table in /healthz ("pod" section, --pod-id order); adopt every
        not-yet-known host so a client pointed at ONE pod host learns
        to sweep — and route to — them all.  Returns adopted count.
        Appending under _mu is safe against concurrent raw() readers
        (existing node indexes never move)."""
        added = 0
        for n in hosts:
            host, _, port = str(n).rpartition(":")
            try:
                entry = (host or "127.0.0.1", int(port))
            except ValueError:
                continue
            with self._mu:
                if entry in self.nodes:
                    continue
                self.nodes.append(entry)
                self._pools.append(_NodePool(entry[0], entry[1],
                                             self._max_conns,
                                             self._max_idle))
                added += 1
        return added

    # -- read-replica tier (raftsql_tpu/replica/) ----------------------

    def _adopt_replicas(self, endpoints) -> int:
        """Adopt replica HTTP endpoints published in an engine's
        /healthz `replica.endpoints` (each replica advertises its own
        via SUBSCRIBE).  Append-only under _mu: indexes never move, so
        concurrent raw_replica callers stay valid."""
        added = 0
        for n in endpoints or ():
            host, _, port = str(n).rpartition(":")
            try:
                entry = (host or "127.0.0.1", int(port))
            except ValueError:
                continue
            with self._mu:
                if entry in self._replicas:
                    continue
                self._replicas.append(entry)
                self._rpools.append(_NodePool(entry[0], entry[1],
                                              self._max_conns,
                                              self._max_idle))
                self._rtt.append(None)
                self._ralive.append(True)
                added += 1
        return added

    def raw_replica(self, ridx: int, method: str, path: str = "/",
                    body: str = "", headers: Optional[dict] = None,
                    timeout_s: Optional[float] = None):
        """raw(), but against replica `ridx` — and every answered
        request feeds the endpoint's RTT EWMA (the nearest-replica
        routing signal)."""
        t = timeout_s or self.timeout_s
        with self._mu:
            pool = self._rpools[ridx]
        t0 = time.monotonic()
        got = self._pooled(pool, method, path, body, headers, t)
        self._note_rtt(ridx, (time.monotonic() - t0) * 1e3)
        return got

    def _note_rtt(self, ridx: int, ms: float) -> None:
        """EWMA (alpha 0.3) of measured request wall time per replica
        endpoint; an answer also marks the endpoint live again."""
        with self._mu:
            if ridx < len(self._rtt):
                prev = self._rtt[ridx]
                self._rtt[ridx] = ms if prev is None \
                    else 0.7 * prev + 0.3 * ms
                self._ralive[ridx] = True

    def _replica_order(self) -> List[int]:
        """Live replica indexes, nearest (lowest RTT EWMA) first;
        unmeasured endpoints go last until their first probe."""
        with self._mu:
            pairs = sorted(
                (self._rtt[i] if self._rtt[i] is not None
                 else float("inf"), i)
                for i in range(len(self._replicas)) if self._ralive[i])
        return [i for _rtt, i in pairs]

    def replica_endpoints(self) -> List[str]:
        with self._mu:
            return [f"{h}:{p}" for h, p in self._replicas]

    def replica_rtt_ms(self) -> Dict[str, Optional[float]]:
        with self._mu:
            return {f"{h}:{p}": (round(self._rtt[i], 3)
                                 if self._rtt[i] is not None else None)
                    for i, (h, p) in enumerate(self._replicas)}

    def _try_replicas(self, sql: str, group: int, headers: dict):
        """One pass over the replica tier, nearest first: (rows,
        watermark) on a 200, None to fall back to the write tier.  The
        headers dict is the caller's — so session watermarks and the
        consistency mode propagate to replicas verbatim.  A 421 is the
        replica's fail-closed ladder refusing (stale epoch, uncovered
        watermark, lapsed lease, stale heartbeat): record the leader
        hint it carries and move on — the write tier is authoritative.
        Connection errors mark the endpoint dead until the next
        answered probe."""
        for ridx in self._replica_order():
            with self._mu:
                if ridx >= len(self._replicas):
                    continue
                ep = "%s:%d" % self._replicas[ridx]
            try:
                status, hdrs, text = self.raw_replica(
                    ridx, "GET", "/", sql, headers)
            except _RETRYABLE_OS:
                with self._mu:
                    if ridx < len(self._ralive):
                        self._ralive[ridx] = False
                continue
            with self._mu:
                stats = self.replica_stats.setdefault(ep, [0, 0])
                stats[0 if status == 200 else 1] += 1
            if status == 200:
                return text, self._session_of(hdrs)
            if status == 421:
                self._note_leader(group, hdrs)
        return None

    def refresh_hints(self, timeout_s: float = 1.0) -> int:
        """Sweep GET /healthz and prime the routing tables from the
        per-group rows (runtime/db.py health_doc): a node whose row
        says `role == "leader"` is the group's write target, and a node
        reporting `lease_s > 0` holds the group's read lease RIGHT NOW
        — a linear read routed there is served from the local lease
        fast path instead of paying a quorum round.  Steady state then
        has no 421 redirects at all: the first request of a fresh
        client already goes to the right node.  Returns the number of
        groups with a usable leader hint.

        Pod deployments (raftsql_tpu/pod/): a host whose /healthz
        carries a "pod" section publishes the full pod hosts table —
        the sweep ADOPTS any host it did not know (and walks it in
        this same pass), and per-group routing merges by OWNERSHIP
        instead of engine role: every pod host truthfully reports
        every group (replicated compute), but only the owner host
        serves a group (server/main.py PodRaftDB), so its `pod_owned`
        rows become the group's write/lease targets."""
        leaders: Dict[int, int] = {}
        leases: Dict[int, Tuple[int, float]] = {}
        witnesses: set = set()
        answered: set = set()
        now = time.monotonic()
        idx = 0
        while idx < len(self.nodes):   # adoption may grow the sweep
            doc = self.health(idx, timeout_s=timeout_s)
            if not doc:
                idx += 1
                continue
            answered.add(idx)
            if doc.get("witness"):
                witnesses.add(idx)
            pod = doc.get("pod")
            if pod:
                self._adopt_pod_hosts(pod.get("hosts") or ())
            # Read-replica tier: an engine with --replica-listen lists
            # the HTTP endpoints its subscribers advertised.
            rep = doc.get("replica")
            if isinstance(rep, dict):
                self._adopt_replicas(rep.get("endpoints") or ())
            for key, row in (doc.get("groups") or {}).items():
                try:
                    g = int(key)
                except (TypeError, ValueError):
                    continue
                if pod is not None:
                    if row.get("pod_owned"):
                        leaders[g] = idx     # owner host serves g
                        lease = row.get("lease_s")
                        if isinstance(lease, (int, float)) and lease > 0:
                            leases[g] = (idx, now + float(lease))
                    continue
                if row.get("role") == "leader":
                    leaders[g] = idx           # self-report wins
                else:
                    hint = row.get("leader")
                    if isinstance(hint, int) and hint > 0:
                        leaders.setdefault(g,
                                           (hint - 1) % len(self.nodes))
                lease = row.get("lease_s")
                if isinstance(lease, (int, float)) and lease > 0:
                    leases[g] = (idx, now + float(lease))
            # Elastic keyspace (raftsql_tpu/reshard/): adopt the
            # newest published key->group mapping seen on the sweep.
            self._note_keymap(doc.get("keymap"))
            idx += 1
        with self._mu:
            self._leader.update(leaders)
            self._lease.update(leases)
            # Witness identity is static per process: only nodes that
            # ANSWERED update their entry (an unreachable node keeps
            # whatever the last sweep learned).
            self._witness -= answered
            self._witness |= witnesses
            self._hints_at = time.monotonic()
        # Probe adopted replicas once per sweep: seeds the RTT EWMA
        # (nearest-first routing needs a measurement) and revives
        # endpoints marked dead by a connection error.
        with self._mu:
            n_rep = len(self._replicas)
        for ridx in range(n_rep):
            try:
                self.raw_replica(ridx, "GET", "/healthz",
                                 timeout_s=timeout_s)
            except _RETRYABLE_OS:
                with self._mu:
                    if ridx < len(self._ralive):
                        self._ralive[ridx] = False
        return len(leaders)

    def _maybe_refresh_hints(self, group: int) -> None:
        """Opportunistic hint sweep: only when the group has no cached
        leader AND the last sweep is stale — a warm cache costs
        nothing, and 421 hints keep it warm between sweeps."""
        with self._mu:
            if group in self._leader or (
                    time.monotonic() - self._hints_at
                    < self.hint_refresh_s):
                return
        self.refresh_hints(timeout_s=0.5)

    def _lease_target(self, group: int) -> Optional[int]:
        """Node index holding a still-live lease hint for `group`, or
        None.  Hints are short (the engine caps published deadlines at
        its lease horizon) — an expired hint is simply ignored."""
        with self._mu:
            hint = self._lease.get(group)
        if hint is not None and time.monotonic() < hint[1]:
            return hint[0]
        return None

    def _note_leader(self, group: int, headers: dict) -> bool:
        """Record a 421's X-Raft-Leader hint.  Returns True when the
        hint names a DIFFERENT node than the cache — the caller should
        abandon the current rotation and retry at the new leader
        immediately (a graceful transfer moved leadership mid-request,
        PR 11).  A 421 WITHOUT a usable hint invalidates the cache
        instead: the node we believed led the group demonstrably does
        not, and pinning it first would only repeat the miss."""
        hint = headers.get("X-Raft-Leader")
        if hint and hint.isdigit() and int(hint) > 0:
            idx = (int(hint) - 1) % len(self.nodes)
            with self._mu:
                changed = self._leader.get(group) != idx
                self._leader[group] = idx
            return changed
        with self._mu:
            self._leader.pop(group, None)
        return False

    def _note_retry_after(self, idx: int, headers: dict) -> None:
        """Honor a 429/503 Retry-After (decimal seconds): hold THIS
        node out of the rotation until the server's estimate passes.
        Other nodes are still tried immediately — per-node backoff,
        not a global stall."""
        ra = headers.get("Retry-After")
        if not ra:
            return
        try:
            delay = min(float(ra), 30.0)
        except ValueError:
            return
        if delay <= 0:
            return
        until = time.monotonic() + delay
        with self._mu:
            if until > self._holdoff.get(idx, 0.0):
                self._holdoff[idx] = until

    def _sleep_backoff(self, attempt: int, deadline: float) -> bool:
        """Jittered exponential backoff; False when the deadline would
        pass before the sleep ends."""
        delay = min(self.backoff_cap_s,
                    self.backoff_s * (2 ** min(attempt, 8)))
        delay *= 0.5 + self._rng.random()      # 0.5x .. 1.5x jitter
        if time.monotonic() + delay >= deadline:
            return False
        time.sleep(delay)
        return True

    # -- public API ----------------------------------------------------

    @staticmethod
    def _session_of(hdrs: dict) -> Optional[int]:
        wm = hdrs.get("X-Raft-Session")
        if wm is not None and wm.isdigit():
            return int(wm)
        return None

    def put(self, sql: str, group: int = 0, node: Optional[int] = None,
            deadline_s: float = 60.0,
            token: Optional[int] = None) -> Optional[int]:
        """Write SQL through consensus; returns once SOME attempt was
        acked (204).  Safe to retry past acceptance: every attempt
        carries the same retry token, so duplicates collapse server-side
        to one apply.  400 raises SQLError immediately (deterministic);
        everything else retries until the deadline.

        Returns the acking node's X-Raft-Session commit watermark
        (None on older servers): present it on a `consistency="session"`
        get() to read-your-write from ANY replica."""
        token = secrets.randbits(64) if token is None else token
        headers = {"X-Raft-Retry-Token": f"{token:016x}"}
        if group:
            headers["X-Raft-Group"] = str(group)
        deadline = time.monotonic() + deadline_s
        attempt = 0
        last: object = None
        if node is None:
            self._maybe_refresh_hints(group)
        while True:
            for idx in self._order(group, node):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break     # fail fast below — no network round trip
                # End-to-end deadline propagation: the server sheds
                # this attempt once the budget is spent (edge / ring /
                # stage) instead of burning WAL cost on a dead request.
                headers["X-Raft-Deadline-Ms"] = str(
                    max(int(remaining * 1000), 1))
                try:
                    status, hdrs, text = self.raw(
                        idx, "PUT", "/", sql, headers)
                except _RETRYABLE_OS as e:
                    last = e
                    continue
                if status == 204:
                    return self._session_of(hdrs)
                if status == 400:
                    raise SQLError(status, text)
                if status == 421:
                    # A hint naming a node OTHER than the cached leader
                    # means leadership moved (graceful transfer): chase
                    # it immediately instead of finishing the rotation.
                    if self._note_leader(group, hdrs) and node is None:
                        last = (status, text.strip())
                        break
                if status in (429, 503):
                    self._note_retry_after(idx, hdrs)
                last = (status, text.strip())
            attempt += 1
            if time.monotonic() >= deadline \
                    or not self._sleep_backoff(attempt, deadline):
                raise Unavailable(
                    f"PUT {sql!r} (group {group}): no ack before "
                    f"deadline; last={last!r}")

    def get(self, sql: str, group: int = 0, node: Optional[int] = None,
            linear: bool = False, deadline_s: float = 60.0,
            consistency: Optional[str] = None,
            session: int = 0) -> str:
        """Read SQL (idempotent — free to retry).  `consistency` picks
        the read mode (local/session/follower/linear; linear=True is
        shorthand for "linear"); `session` carries the X-Raft-Session
        watermark a previous response returned.  421 redirects chase
        X-Raft-Leader."""
        return self.get_session(sql, group=group, node=node,
                                linear=linear, deadline_s=deadline_s,
                                consistency=consistency,
                                session=session)[0]

    def get_session(self, sql: str, group: int = 0,
                    node: Optional[int] = None, linear: bool = False,
                    deadline_s: float = 60.0,
                    consistency: Optional[str] = None,
                    session: int = 0) -> Tuple[str, Optional[int]]:
        """get(), returning (rows, response watermark): the watermark
        is the serving replica's X-Raft-Session echo — carry the max
        of these into later session reads for monotonic reads."""
        headers = {}
        if group:
            headers["X-Raft-Group"] = str(group)
        if consistency is None and linear:
            consistency = "linear"
        if consistency and consistency != "local":
            headers["X-Consistency"] = consistency
        if session > 0:
            headers["X-Raft-Session"] = str(session)
        deadline = time.monotonic() + deadline_s
        attempt = 0
        last: object = None
        if node is None:
            self._maybe_refresh_hints(group)
            # Read-replica tier: route to the nearest live replica
            # first (RTT EWMA, CD-Raft style).  The shared headers
            # carry the session watermark and consistency mode
            # verbatim; ANY refusal (the replica's fail-closed ladder
            # answers 421, never a stale row) falls through to the
            # write tier below.
            if self._replicas:
                got = self._try_replicas(sql, group, headers)
                if got is not None:
                    return got
        while True:
            # Linear reads chase the lease holder first: served there,
            # the read needs no quorum round at all (lease fast path).
            prefer = (self._lease_target(group)
                      if consistency == "linear" else None)
            for idx in self._order(group, node, prefer=prefer,
                                   for_read=True):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break     # fail fast below — no network round trip
                headers["X-Raft-Deadline-Ms"] = str(
                    max(int(remaining * 1000), 1))
                try:
                    status, hdrs, text = self.raw(
                        idx, "GET", "/", sql, headers)
                except _RETRYABLE_OS as e:
                    last = e
                    continue
                if status == 200:
                    return text, self._session_of(hdrs)
                if status == 400:
                    raise SQLError(status, text)
                if status == 421:
                    # Non-leader for a linear read: chase the hint
                    # immediately (no backoff — the leader is up).
                    if self._note_leader(group, hdrs) and node is None:
                        break
                if status in (429, 503):
                    self._note_retry_after(idx, hdrs)
                last = (status, text.strip())
            attempt += 1
            if time.monotonic() >= deadline \
                    or not self._sleep_backoff(attempt, deadline):
                raise Unavailable(
                    f"GET {sql!r} (group {group}): no answer before "
                    f"deadline; last={last!r}")

    # -- elastic keyspace (/kv surface, raftsql_tpu/reshard/) ----------

    def _note_keymap(self, doc) -> bool:
        """Adopt a key->group mapping document if it is NEWER than the
        cached one (mapping epochs only move forward — a stale sweep
        must not roll the router back).  Returns True on adoption."""
        if not isinstance(doc, dict) or "epoch" not in doc:
            return False
        with self._mu:
            have = self._keymap
            if have is not None \
                    and int(have.get("epoch", -1)) >= int(doc["epoch"]):
                return False
            self._keymap = doc
            return True

    def keymap_epoch(self) -> Optional[int]:
        """The cached mapping version, or None before any /kv traffic
        or /healthz sweep saw a reshard-enabled node."""
        with self._mu:
            return (int(self._keymap["epoch"])
                    if self._keymap is not None else None)

    def refresh_keymap(self, timeout_s: float = 1.0) -> Optional[int]:
        """Sweep /healthz for the current key->group mapping (the
        unknown-group recovery path after a split/merge moved the
        keyspace under this client).  Returns the adopted epoch."""
        for idx in range(len(self.nodes)):
            doc = self.health(idx, timeout_s=timeout_s)
            if doc:
                self._note_keymap(doc.get("keymap"))
        return self.keymap_epoch()

    def _kv_headers(self) -> dict:
        headers = {}
        epoch = self.keymap_epoch()
        if epoch is not None:
            headers["X-Raft-Keymap-Epoch"] = str(epoch)
        return headers

    def _note_kv_epoch(self, hdrs: dict) -> None:
        """Every /kv response echoes the epoch it served under; a
        NEWER one than our cache means the keyspace moved (split/merge
        behind our back) — sweep /healthz for the full mapping so
        subsequent requests pin the current epoch."""
        e = hdrs.get("X-Raft-Keymap-Epoch")
        if e is None or not e.isdigit():
            return
        have = self.keymap_epoch()
        if have is None or int(e) > have:
            self.refresh_keymap()

    def _kv_refused(self, status: int, text: str) -> bool:
        """Handle a 409 mapping-epoch refusal: adopt the server's
        CURRENT keymap from the response body (fallback: a /healthz
        sweep) and tell the caller to retry immediately."""
        import json
        if status != 409:
            return False
        try:
            self._note_keymap(json.loads(text).get("keymap"))
        except ValueError:
            self.refresh_keymap()
        return True

    def put_kv(self, key: str, value: str,
               deadline_s: float = 60.0,
               token: Optional[int] = None) -> Optional[int]:
        """Keyed write over the elastic keyspace (PUT /kv/<key>): the
        server routes by hash slot under its CURRENT mapping; this
        client pins the epoch it believes in and fails closed — a 409
        (the mapping moved: split/merge/migrate) refreshes the cache
        and retries, a frozen-slot 503 backs off until the verb
        resolves.  Exactly-once via the same retry-token contract as
        put()."""
        from urllib.parse import quote
        token = secrets.randbits(64) if token is None else token
        deadline = time.monotonic() + deadline_s
        attempt = 0
        last: object = None
        path = "/kv/" + quote(key, safe="")
        while True:
            headers = self._kv_headers()
            headers["X-Raft-Retry-Token"] = f"{token:016x}"
            for idx in self._order(0, None):
                try:
                    status, hdrs, text = self.raw(
                        idx, "PUT", path, value, headers)
                except _RETRYABLE_OS as e:
                    last = e
                    continue
                if status == 204:
                    self._note_kv_epoch(hdrs)
                    return self._session_of(hdrs)
                if self._kv_refused(status, text):
                    last = (status, "keymap moved")
                    break              # re-route under the new mapping
                if status == 400:
                    raise SQLError(status, text)
                if status in (429, 503):
                    self._note_retry_after(idx, hdrs)
                last = (status, text.strip())
            attempt += 1
            if time.monotonic() >= deadline \
                    or not self._sleep_backoff(attempt, deadline):
                raise Unavailable(
                    f"PUT /kv/{key}: no ack before deadline; "
                    f"last={last!r}")

    def get_kv(self, key: str, deadline_s: float = 60.0,
               consistency: Optional[str] = None,
               session: int = 0) -> Optional[str]:
        """Keyed read (GET /kv/<key>): the value, or None when the key
        does not exist.  Same mapping-epoch fail-closed handling as
        put_kv."""
        from urllib.parse import quote
        deadline = time.monotonic() + deadline_s
        attempt = 0
        last: object = None
        path = "/kv/" + quote(key, safe="")
        while True:
            headers = self._kv_headers()
            if consistency and consistency != "local":
                headers["X-Consistency"] = consistency
            if session > 0:
                headers["X-Raft-Session"] = str(session)
            for idx in self._order(0, None, for_read=True):
                try:
                    status, hdrs, text = self.raw(
                        idx, "GET", path, "", headers)
                except _RETRYABLE_OS as e:
                    last = e
                    continue
                if status == 200:
                    self._note_kv_epoch(hdrs)
                    return text
                if status == 404:
                    self._note_kv_epoch(hdrs)
                    return None
                if self._kv_refused(status, text):
                    last = (status, "keymap moved")
                    break
                if status == 400:
                    raise SQLError(status, text)
                if status in (429, 503):
                    self._note_retry_after(idx, hdrs)
                last = (status, text.strip())
            attempt += 1
            if time.monotonic() >= deadline \
                    or not self._sleep_backoff(attempt, deadline):
                raise Unavailable(
                    f"GET /kv/{key}: no answer before deadline; "
                    f"last={last!r}")

    def reshard(self, verb: str, src: int, dst: int, slots=None,
                node: Optional[int] = None,
                deadline_s: float = 10.0) -> dict:
        """POST /reshard: enqueue an elastic-keyspace verb.  409 (a
        verb already in flight) surfaces as SQLError — the caller
        decides whether to wait."""
        import json
        body = json.dumps({"verb": verb, "src": src, "dst": dst,
                           "slots": slots})
        deadline = time.monotonic() + deadline_s
        attempt = 0
        last: object = None
        while True:
            for idx in self._order(0, node):
                try:
                    status, _hdrs, text = self.raw(
                        idx, "POST", "/reshard", body)
                except _RETRYABLE_OS as e:
                    last = e
                    continue
                if status == 200:
                    return json.loads(text)
                if status in (400, 409):
                    raise SQLError(status, text)
                last = (status, text.strip())
            attempt += 1
            if time.monotonic() >= deadline \
                    or not self._sleep_backoff(attempt, deadline):
                raise Unavailable(
                    f"POST /reshard {verb}: no answer; last={last!r}")

    def get_until(self, sql: str, want: str, group: int = 0,
                  node: Optional[int] = None,
                  deadline_s: float = 60.0,
                  poll_s: float = 0.25) -> str:
        """Poll an idempotent read until the answer matches `want`
        (replication is async — the reference's own tests poll the same
        way, raftsql_test.go:159-170)."""
        deadline = time.monotonic() + deadline_s
        last: object = None
        while time.monotonic() < deadline:
            try:
                got = self.get(sql, group=group, node=node,
                               deadline_s=min(
                                   5.0, max(0.1,
                                            deadline - time.monotonic())))
                if got == want:
                    return got
                last = got
            except (Unavailable, SQLError) as e:
                last = e
            time.sleep(poll_s)
        raise Unavailable(f"GET {sql!r}: wanted {want!r}, last={last!r}")

    def health(self, node: int,
               timeout_s: float = 2.0) -> Optional[dict]:
        """GET /healthz of one node; None when unreachable/stalled (a
        SIGSTOPped process simply eats the timeout)."""
        import json
        try:
            status, _, text = self.raw(node, "GET", "/healthz",
                                       timeout_s=timeout_s)
        except _RETRYABLE_OS:
            return None
        if status != 200:
            return None
        try:
            return json.loads(text)
        except ValueError:
            return None

    def wait_healthy(self, node: int, deadline_s: float = 30.0,
                     poll_s: float = 0.2) -> dict:
        """Block until the node answers /healthz (restart detection —
        the probe the nemesis uses instead of a write)."""
        deadline = time.monotonic() + deadline_s
        while True:
            doc = self.health(node)
            if doc is not None:
                return doc
            if time.monotonic() >= deadline:
                raise Unavailable(f"node {node}: /healthz never came up")
            time.sleep(poll_s)
