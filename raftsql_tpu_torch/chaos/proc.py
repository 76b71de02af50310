"""Process-plane chaos: a seeded nemesis over REAL server processes
of the port.

Port of raftsql_tpu/chaos/proc.py.  `ProcCluster` runs N
`python -m raftsql_tpu_torch.server.main --id I --cluster ...` children
on localhost (the reference's Procfile topology), TcpTransport between
them and HTTP on top, each stepping its consensus on `device` (CUDA by
default).  `ProcChaosRunner` drives them through a seeded
`ProcChaosPlan`:

  * SIGKILL crashes — leader-targeted (resolved live via /healthz) and
    random — with respawn on the SAME ports and data dirs;
  * SIGSTOP/SIGCONT stalls — a frozen leader must be deposed and rejoin
    as a follower, with every write acked before the stall intact;
  * rolling-restart storms — clean SIGTERM stops (the graceful-shutdown
    path) with immediate same-port rebinds, one node at a time;
  * env-injected storage faults — RAFTSQL_FSIO_FAULTS specs
    (storage/fsio.py) give children ENOSPC at a chosen WAL write and a
    hard process exit at a chosen WAL fsync.

A workload of acked PUTs (api/client.py, whose retry tokens make
re-sends across crashes exactly-once) feeds the ledger; live /healthz
polling feeds the single-leader invariant; after the heal window the
survivors must CONVERGE (identical rows everywhere, a superset of every
acked write, each exactly once), and a post-mortem replays every WAL
dir and re-opens every SQLite DB to re-prove durability from disk.
`ProcReadChaosRunner` races linear, session and follower GETs against
the same script; `ProcTransferChaosRunner` interleaves `POST /transfer`
at the group-0 leader.

Determinism contract: the SCHEDULE is a pure function of the seed (its
digest equals the JAX package's) and the invariant VERDICTS must
reproduce across runs of one seed, but the committed history crosses
several kernels' schedulers and is not bit-reproducible.  On any
invariant failure the runner dumps a flight bundle (per-process log
tails, /metrics, /trace, WAL dir listings) via obs/flight.py.
"""
from __future__ import annotations

import hashlib
import json
import os
import signal
import sqlite3
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Set

import numpy as np

from raftsql_tpu_torch.api.client import RaftSQLClient, SQLError, Unavailable
from raftsql_tpu_torch.chaos.invariants import (ElectionSafety,
                                                InvariantViolation,
                                                RegisterLinearizability)
from raftsql_tpu_torch.chaos.schedule import LEADER_TARGET, ProcChaosPlan
from raftsql_tpu_torch.core.state import resolve_device
from raftsql_tpu_torch.storage.fsio import EXIT_CODE_FSYNC_CRASH

# server/main.py EXIT_CODE_FATAL without importing the server module
# (it pulls the whole engine; the harness stays engine-import-free so
# it can babysit children that ARE the engine).
EXIT_CODE_FATAL = 70

_LEADER = "leader"


def _reserve_ports(n: int):
    import socket
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class ProcCluster:
    """N `server/main.py` OS processes on localhost — the Procfile
    topology, each process's consensus stepping on `device`.  SIGTERM
    is "clean stop" (the graceful-shutdown handler flushes the WAL and
    exits 0); SIGKILL is "crash"; SIGSTOP/SIGCONT is "stall"."""

    def __init__(self, workdir: str, peers: int = 3, groups: int = 1,
                 tick: float = 0.02, http_engine: str = "aio",
                 device="cuda", resume: bool = False,
                 peer_ports: Optional[List[int]] = None,
                 http_ports: Optional[List[int]] = None):
        self.workdir = str(workdir)
        self.device = str(device)
        self.resume = resume
        self.peers = peers
        self.groups = groups
        self.tick = tick
        self.http_engine = http_engine
        # Fixed ports (the Procfile's map) where given, else free ones.
        ports = _reserve_ports(2 * peers)
        self.peer_ports = list(peer_ports or ports[:peers])
        self.http_ports = list(http_ports or ports[peers:])
        self.cluster = ",".join(f"http://127.0.0.1:{p}"
                                for p in self.peer_ports)
        self.procs: List[Optional[subprocess.Popen]] = [None] * peers
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        self.env_base = dict(
            os.environ,
            PYTHONPATH=repo_root + (
                os.pathsep + os.environ["PYTHONPATH"]
                if os.environ.get("PYTHONPATH") else ""))
        # A CPU child steps with one torch thread: several servers share
        # the host's cores (and a test run shares them with its peers).
        if self.device == "cpu":
            self.env_base["OMP_NUM_THREADS"] = "1"
        self.env_base.pop("RAFTSQL_FSIO_FAULTS", None)
        os.makedirs(self.workdir, exist_ok=True)

    def spawn(self, i: int, fsio_spec: Optional[str] = None) -> None:
        """(Re)spawn peer i — same ports, same data dir, WAL replay.
        `fsio_spec` rides RAFTSQL_FSIO_FAULTS into the child."""
        assert self.procs[i] is None or self.procs[i].poll() is not None
        env = dict(self.env_base)
        if fsio_spec:
            env["RAFTSQL_FSIO_FAULTS"] = fsio_spec
        logf = open(os.path.join(self.workdir, f"node{i + 1}.log"), "ab")
        self.procs[i] = subprocess.Popen(
            [sys.executable, "-m", "raftsql_tpu_torch.server.main",
             "--id", str(i + 1), "--cluster", self.cluster,
             "--port", str(self.http_ports[i]),
             "--tick", str(self.tick), "--groups", str(self.groups),
             "--http-engine", self.http_engine, "--device", self.device]
            + (["--resume"] if self.resume else []),
            cwd=self.workdir, env=env, stdout=logf, stderr=logf)
        logf.close()      # child inherited the fd

    def alive(self, i: int) -> bool:
        p = self.procs[i]
        return p is not None and p.poll() is None

    def exit_code(self, i: int) -> Optional[int]:
        """Exit code if peer i's process has died, else None."""
        p = self.procs[i]
        if p is None:
            return None
        return p.poll()

    def sigkill(self, i: int) -> None:
        p = self.procs[i]
        if p is not None and p.poll() is None:
            p.send_signal(signal.SIGKILL)
            p.wait(timeout=15)

    def sigterm(self, i: int, timeout: float = 15.0) -> Optional[int]:
        """Clean stop; returns the exit code (0 = graceful)."""
        p = self.procs[i]
        if p is None:
            return None
        if p.poll() is None:
            p.terminate()
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        return p.returncode

    def sigstop(self, i: int) -> None:
        p = self.procs[i]
        if p is not None and p.poll() is None:
            p.send_signal(signal.SIGSTOP)

    def sigcont(self, i: int) -> None:
        p = self.procs[i]
        if p is not None and p.poll() is None:
            p.send_signal(signal.SIGCONT)

    def stop_all(self) -> List[Optional[int]]:
        codes = []
        for i in range(self.peers):
            p = self.procs[i]
            if p is not None and p.poll() is None:
                p.send_signal(signal.SIGCONT)   # a stalled child first
        for i in range(self.peers):
            codes.append(self.sigterm(i))
        return codes

    def data_dir(self, i: int) -> str:
        return os.path.join(self.workdir, f"raftsql-{i + 1}")

    def db_path(self, i: int) -> str:
        return os.path.join(self.workdir, f"raftsql-{i + 1}.db")

    def log_tail(self, i: int, nbytes: int = 4096) -> str:
        path = os.path.join(self.workdir, f"node{i + 1}.log")
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - nbytes))
                return f.read().decode("utf-8", "replace")
        except OSError:
            return ""

class ProcChaosRunner:
    """Drive a ProcChaosPlan against a real cluster; see module doc."""

    def __init__(self, plan: ProcChaosPlan, workdir: str,
                 http_engine: str = "aio", device="cuda"):
        self.plan = plan
        self.device = resolve_device(device)   # raises without the card
        self.cluster = ProcCluster(workdir, peers=plan.peers,
                                   groups=plan.groups,
                                   http_engine=http_engine,
                                   device=str(self.device))
        self.client = RaftSQLClient(
            [f"127.0.0.1:{p}" for p in self.cluster.http_ports],
            timeout_s=3.0)
        self.safety = ElectionSafety()
        self.acked: List[str] = []           # ledger: values acked 204
        self._acked_lock = threading.Lock()
        self._stop_workload = threading.Event()
        self._workload_err: Optional[BaseException] = None
        # peer -> tick at which to respawn; peer -> stalled flag.
        self._down_until: Dict[int, int] = {}
        self._stalled: Set[int] = set()
        self.report = {
            "kills": 0, "stalls": 0, "storm_restarts": 0,
            "respawns": 0, "fsio_exits": 0, "fatal_exits": 0,
            "unexpected_exits": 0, "acked": 0, "graceful_stops": 0,
        }
        self.verdicts: Dict[str, str] = {}

    # -- workload ------------------------------------------------------

    def _workload(self) -> None:
        """Acked-PUT feed: unique values, one retry token per value, so
        every 204 is a durability promise the post-mortem can hold the
        cluster to.  Engine-death 400s and deadline misses leave the
        value UNACKED (no promise) and move on."""
        n = 0
        while not self._stop_workload.is_set():
            val = f"w{n}"
            n += 1
            try:
                self.client.put(
                    f"INSERT INTO chaos (v) VALUES ('{val}')",
                    deadline_s=8.0)
                with self._acked_lock:
                    self.acked.append(val)
            except (SQLError, Unavailable):
                pass
            except BaseException as e:       # noqa: BLE001 - surfaced
                self._workload_err = e
                return
            time.sleep(0.08)

    # -- nemesis helpers -----------------------------------------------

    def _healthz_all(self) -> Dict[int, Optional[dict]]:
        docs: Dict[int, Optional[dict]] = {}
        for i in range(self.plan.peers):
            if not self.cluster.alive(i) or i in self._stalled:
                docs[i] = None
            else:
                docs[i] = self.client.health(i, timeout_s=1.0)
        return docs

    def _resolve(self, peer: int, docs: Dict[int, Optional[dict]]) -> int:
        """LEADER_TARGET → whoever reports role=leader for group 0 (a
        live node's own view wins; fall back to any live node's leader
        hint, then to the lowest live peer)."""
        if peer != LEADER_TARGET:
            return peer
        for i, doc in sorted(docs.items()):
            if doc and doc["groups"].get("0", {}).get("role") == _LEADER:
                return i
        for i, doc in sorted(docs.items()):
            if doc:
                lead = int(doc["groups"].get("0", {}).get("leader", 0))
                if lead > 0:
                    return lead - 1
        for i in range(self.plan.peers):
            if self.cluster.alive(i) and i not in self._stalled:
                return i
        return 0

    def _observe(self, t: int, docs: Dict[int, Optional[dict]]) -> None:
        """Feed /healthz snapshots to the single-leader invariant.
        Commit monotonicity is NOT asserted on this plane: /healthz
        reads the live cache, and a SIGKILL may legally roll an
        observed-but-unsynced commit index back to the WAL's."""
        P, G = self.plan.peers, self.plan.groups
        roles = np.full((P, G), -1, np.int64)
        terms = np.zeros((P, G), np.int64)
        code = {"follower": 0, "candidate": 1, _LEADER: 2,
                "precandidate": 3}
        for i, doc in docs.items():
            if not doc:
                continue
            for g in range(G):
                row = doc["groups"].get(str(g))
                if row:
                    roles[i, g] = code.get(row.get("role"), -1)
                    terms[i, g] = int(row.get("term", 0))
        self.safety.observe(t, roles, terms)

    def _handle_exits(self, t: int) -> None:
        """Unscheduled child deaths: injected crash points (exit 86),
        fatal-posture engine deaths (exit 70, e.g. injected ENOSPC),
        or a real bug (anything else — still respawned, but counted
        separately so the gate can flag it)."""
        for i in range(self.plan.peers):
            if i in self._down_until or i in self._stalled:
                continue
            code = self.cluster.exit_code(i)
            if code is None:
                continue
            if code == EXIT_CODE_FSYNC_CRASH:
                self.report["fsio_exits"] += 1
            elif code == EXIT_CODE_FATAL:
                self.report["fatal_exits"] += 1
            else:
                self.report["unexpected_exits"] += 1
            self._down_until[i] = t + 2      # the operator reacts fast

    def _respawn_due(self, t: int) -> None:
        for i in [i for i, d in self._down_until.items() if d <= t]:
            del self._down_until[i]
            # Faulted env specs are first-boot only: the crash point
            # fired, the disk "recovered", the respawn runs clean.
            self.cluster.spawn(i)
            self.report["respawns"] += 1

    # -- phases --------------------------------------------------------

    def _boot(self) -> None:
        """Spawn everyone (with their env fault specs) and wait healthy.
        A low-threshold env fault may fire DURING boot — the first
        election's hard-state writes count too — so a child death here
        is scored like any other and the peer is respawned clean."""
        spec_of = {f.peer: f.spec for f in self.plan.fsio}
        t0 = time.monotonic()
        for i in range(self.plan.peers):
            self.cluster.spawn(i, fsio_spec=spec_of.get(i))
        deadline = time.monotonic() + 90.0
        pending = set(range(self.plan.peers))
        while pending:
            if time.monotonic() > deadline:
                raise Unavailable(
                    f"nodes {sorted(pending)} never became healthy")
            for i in sorted(pending):
                code = self.cluster.exit_code(i)
                if code is not None:
                    if code == EXIT_CODE_FSYNC_CRASH:
                        self.report["fsio_exits"] += 1
                    elif code == EXIT_CODE_FATAL:
                        self.report["fatal_exits"] += 1
                    else:
                        self.report["unexpected_exits"] += 1
                    self.cluster.spawn(i)
                    self.report["respawns"] += 1
                    continue
                if self.client.health(i) is not None:
                    pending.discard(i)
                    # Seconds from the first spawn to the first healthy
                    # child (wall clock, not part of any digest).
                    self.report.setdefault("boot_s",
                                           time.monotonic() - t0)
            time.sleep(0.3)
        # Idempotent so a cross-call retry (fresh token) after an
        # engine-death 400 cannot fail on its own success.
        create_deadline = time.monotonic() + 60.0
        while True:
            try:
                self.client.put(
                    "CREATE TABLE IF NOT EXISTS chaos (v text)",
                    deadline_s=15.0)
                return
            except (SQLError, Unavailable):
                if time.monotonic() > create_deadline:
                    raise
                time.sleep(0.5)

    def _usable(self, p: int) -> bool:
        return self.cluster.alive(p) and p not in self._stalled \
            and p not in self._down_until

    def _script(self) -> None:
        """Run the scripted phase.  Events are DUE at their tick but
        DEFERRED — not dropped — while their target cannot take the
        fault (already dead of an injected disk fault, mid-respawn, or
        stalled): a nemesis that silently skips a scheduled kill makes
        the fired-families verdict a coin flip.  The script runs past
        plan.ticks (bounded) until every event has fired."""
        plan = self.plan
        kills = sorted(plan.kills, key=lambda k: k.tick)
        stalls = sorted(plan.stalls, key=lambda s: s.tick)
        storm_jobs = sorted(
            (storm.tick + k * storm.gap, k)
            for storm in plan.storms for k in range(plan.peers))
        cont_at: Dict[int, int] = {}        # tick -> peer to SIGCONT
        max_script = plan.ticks + 80
        t = 0
        while True:
            docs = self._healthz_all()
            self._observe(t, docs)
            for k in list(kills):
                if k.tick > t:
                    break
                p = self._resolve(k.peer, docs)
                if self._usable(p):
                    self.cluster.sigkill(p)
                    self._down_until[p] = t + k.down
                    self.report["kills"] += 1
                    kills.remove(k)
            for s in list(stalls):
                if s.tick > t:
                    break
                p = self._resolve(s.peer, docs)
                if self._usable(p):
                    self.cluster.sigstop(p)
                    self._stalled.add(p)
                    cont_at[t + s.ticks] = p
                    self.report["stalls"] += 1
                    stalls.remove(s)
            for (due, p) in list(storm_jobs):
                if due > t:
                    break
                if self._usable(p):
                    code = self.cluster.sigterm(p)
                    if code == 0:
                        self.report["graceful_stops"] += 1
                    self.cluster.spawn(p)   # immediate same-port rebind
                    self.report["storm_restarts"] += 1
                    storm_jobs.remove((due, p))
            p = cont_at.pop(t, None)
            if p is not None:
                self.cluster.sigcont(p)
                self._stalled.discard(p)
            self._handle_exits(t)
            self._respawn_due(t)
            time.sleep(plan.tick_s)
            if self._workload_err is not None:
                raise self._workload_err
            t += 1
            pending = kills or stalls or storm_jobs or cont_at
            if (t >= plan.ticks and not pending) or t >= max_script:
                break
        # End of script: everyone up and running for the heal window.
        for p in list(self._stalled):
            self.cluster.sigcont(p)
            self._stalled.discard(p)
        for i in list(self._down_until):
            del self._down_until[i]
            self.cluster.spawn(i)
            self.report["respawns"] += 1
        self._handle_exits(t)
        self._respawn_due(t + 3)
        for h in range(plan.heal_ticks):
            docs = self._healthz_all()
            self._observe(t + 1 + h, docs)
            self._handle_exits(t + 1 + h)
            self._respawn_due(t + 1 + h)
            time.sleep(plan.tick_s)

    def _converge(self, deadline_s: float = 60.0) -> List[str]:
        """Every node must answer the full ordered table identically,
        covering every acked write exactly once.  Returns the rows."""
        with self._acked_lock:
            acked = list(self.acked)
        want_rows = {f"|{v}|" for v in acked}
        deadline = time.monotonic() + deadline_s
        last: object = None
        query = "SELECT v FROM chaos ORDER BY v"
        while time.monotonic() < deadline:
            answers = []
            try:
                for i in range(self.plan.peers):
                    answers.append(self.client.get(
                        query, node=i, deadline_s=10.0))
            except (Unavailable, SQLError) as e:
                last = e
                time.sleep(0.5)
                continue
            rows = answers[0].splitlines()
            if all(a == answers[0] for a in answers) \
                    and want_rows.issubset(rows):
                dup = [v for v in acked if rows.count(f"|{v}|") != 1]
                if dup:
                    raise InvariantViolation(
                        f"exactly-once violated: acked values applied "
                        f"more than once: {dup[:5]} "
                        f"(of {len(dup)})")
                return rows
            last = [len(a.splitlines()) for a in answers]
            time.sleep(0.5)
        raise InvariantViolation(
            f"survivors failed to converge on {len(acked)} acked "
            f"writes before the deadline; last={last!r}")

    def _post_mortem(self) -> None:
        """Durability from DISK alone: replay every node's WAL dir and
        re-open every SQLite DB after the graceful stop — every acked
        write must be in every node's committed WAL prefix (exactly
        once, post-dedup) and in every rebuilt SQLite table."""
        from raftsql_tpu_torch.runtime.envelope import unwrap
        from raftsql_tpu_torch.storage.wal import WAL
        with self._acked_lock:
            acked = list(self.acked)
        for i in range(self.plan.peers):
            groups = WAL.replay(self.cluster.data_dir(i))
            gl = groups.get(0)
            if gl is None:
                raise InvariantViolation(
                    f"node {i + 1}: WAL replay has no group 0")
            committed = gl.entries[:max(0, gl.hard.commit - gl.start)]
            seen_pids: Set[int] = set()
            values: List[str] = []
            for (_term, data) in committed:
                if not data:
                    continue
                pid, payload = unwrap(data)
                if pid is not None:
                    if pid in seen_pids:
                        continue             # retry duplicate: one apply
                    seen_pids.add(pid)
                sql = payload.decode("utf-8", "replace")
                if "VALUES ('" in sql:
                    values.append(sql.split("('", 1)[1].split("')")[0])
            missing = [v for v in acked if v not in set(values)]
            if missing:
                raise InvariantViolation(
                    f"node {i + 1}: {len(missing)} acked writes missing "
                    f"from the committed WAL prefix, e.g. {missing[:5]}")
            dups = {v for v in acked if values.count(v) != 1}
            if dups:
                raise InvariantViolation(
                    f"node {i + 1}: acked writes applied more than once "
                    f"in the WAL apply stream: {sorted(dups)[:5]}")
            # The SQLite file the stopped process left behind IS the
            # applied state — read it cold.
            conn = sqlite3.connect(self.cluster.db_path(i))
            try:
                rows = [r[0] for r in conn.execute(
                    "SELECT v FROM chaos")]
            finally:
                conn.close()
            missing = [v for v in acked if v not in set(rows)]
            if missing:
                raise InvariantViolation(
                    f"node {i + 1}: {len(missing)} acked writes missing "
                    f"from the SQLite state, e.g. {missing[:5]}")

    # -- flight bundle -------------------------------------------------

    def _flight_dump(self, err: BaseException) -> None:
        from raftsql_tpu_torch.obs.flight import FlightRecorder
        bundle: dict = {"plan": self.plan.describe(),
                        "schedule_digest": self.plan.digest(),
                        "report": dict(self.report),
                        "acked": len(self.acked),
                        "logs": {}, "metrics": {}, "trace": {},
                        "wal_dirs": {}}
        for i in range(self.plan.peers):
            bundle["logs"][i] = self.cluster.log_tail(i)
            d = self.cluster.data_dir(i)
            try:
                bundle["wal_dirs"][i] = sorted(
                    f"{f} ({os.path.getsize(os.path.join(d, f))}B)"
                    for f in os.listdir(d))
            except OSError:
                bundle["wal_dirs"][i] = []
            if self.cluster.alive(i) and i not in self._stalled:
                try:
                    _, _, bundle["metrics"][i] = self.client.raw(
                        i, "GET", "/metrics", timeout_s=2.0)
                    _, _, bundle["trace"][i] = self.client.raw(
                        i, "GET", "/trace", timeout_s=2.0)
                except OSError:
                    pass
        FlightRecorder().dump(
            f"procs-seed{self.plan.seed}", repr(err), meta=bundle)

    # -- entry ---------------------------------------------------------

    def _verdict_digest(self) -> str:
        """Hash of what MUST reproduce across runs of one seed: the
        schedule, the per-invariant verdicts, and which fault families
        actually fired (booleans — counts are wall-clock-scheduled)."""
        r = self.report
        doc = {
            "schedule": self.plan.digest(),
            "invariants": dict(self.verdicts),
            "families": {
                "sigkill": r["kills"] >= len(self.plan.kills),
                "sigstop": r["stalls"] >= len(self.plan.stalls),
                "restart_storm": r["storm_restarts"]
                >= self.plan.peers * len(self.plan.storms),
                "enospc": r["fatal_exits"] >= 1,
                "exit_fsync": r["fsio_exits"] >= 1,
                "unexpected_exits": r["unexpected_exits"] == 0,
            },
        }
        blob = json.dumps(doc, sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def _run_impl(self) -> dict:
        wt = threading.Thread(target=self._workload, daemon=True,
                              name="proc-chaos-workload")
        try:
            self._boot()
            wt.start()
            try:
                self._script()
            finally:
                self._stop_workload.set()
                wt.join(timeout=30)
            self.verdicts["single_leader"] = "pass"   # observe() raised
            self._converge()
            self.verdicts["convergence"] = "pass"
            self.verdicts["exactly_once"] = "pass"
            codes = self.cluster.stop_all()
            self.report["graceful_stops"] += sum(
                1 for c in codes if c == 0)
            self._post_mortem()
            self.verdicts["durability"] = "pass"
        except BaseException as e:
            self._stop_workload.set()
            self._flight_dump(e)
            raise
        finally:
            self.cluster.stop_all()
        self.report["acked"] = len(self.acked)
        return {"schedule_digest": self.plan.digest(),
                "result_digest": self._verdict_digest(),
                "seed": self.plan.seed, **self.report}

    def run(self) -> dict:
        return self._run_impl()


class ProcReadChaosRunner(ProcChaosRunner):
    """The process-plane read nemesis (`chaos.run --reads`): the same
    seeded nemesis script (SIGKILLs, SIGSTOP stalls, restart storms,
    env disk faults) over real server processes, with the write
    workload replaced by a KV register workload that races every HTTP
    read mode against it through the hardened client:

      * linear GETs (X-Consistency: linear — lease or ReadIndex
        serves them engine-side, 421 redirects chased) checked by the
        thread-safe real-time register-linearizability invariant;
      * session GETs at RANDOM nodes presenting the X-Raft-Session
        watermark the last acked write returned — the answer must be
        at least as fresh as that write (read-your-writes across
        failover);
      * follower GETs (X-Consistency: follower) at random nodes —
        freshness floor = that replica's commit watermark, checked for
        monotonicity per key via the session rule.

    One sequential workload thread keeps the real-time order trivially
    sound (an op completes before the next is invoked).  Verdict
    digest extends the base families with the read families; counts
    stay wall-clock-scheduled, so the digest carries booleans."""

    KEYS = 4

    def __init__(self, plan: ProcChaosPlan, workdir: str,
                 http_engine: str = "aio", device="cuda"):
        super().__init__(plan, workdir, http_engine=http_engine,
                         device=device)
        self.lin = RegisterLinearizability()
        # key -> (last acked value seq, its session watermark).
        self._sess: Dict[str, tuple] = {}
        self.report.update({"linear_reads": 0, "session_reads": 0,
                            "follower_reads": 0, "stale_session": 0})

    def _boot(self) -> None:
        super()._boot()
        create_deadline = time.monotonic() + 60.0
        while True:
            try:
                self.client.put(
                    "CREATE TABLE IF NOT EXISTS kv "
                    "(k text PRIMARY KEY, v text)", deadline_s=15.0)
                return
            except (SQLError, Unavailable):
                if time.monotonic() > create_deadline:
                    raise
                time.sleep(0.5)

    def _workload(self) -> None:
        """Sequential PUT/linear-GET/session-GET/follower-GET cycle:
        unique values per key (the register checker's contract), one
        retry token per logical write so crash-retries stay
        exactly-once."""
        import random
        rng = random.Random(self.plan.seed ^ 0x4EAD)
        n = 0
        while not self._stop_workload.is_set():
            try:
                key = f"k{rng.randrange(self.KEYS)}"
                val = f"w{n}"
                n += 1
                self.lin.begin_write(key, val)
                try:
                    wm = self.client.put(
                        "INSERT INTO kv (k, v) VALUES "
                        f"('{key}', '{val}') ON CONFLICT(k) "
                        f"DO UPDATE SET v='{val}'", deadline_s=8.0)
                except (SQLError, Unavailable):
                    pass      # unacked: may still commit later (legal)
                else:
                    self.lin.end_write(val)
                    with self._acked_lock:
                        self.acked.append(val)
                    self._sess[key] = (n - 1, wm or 0)
                self._read_cycle(rng)
            except BaseException as e:   # noqa: BLE001 - surfaced by
                self._workload_err = e   # _script (incl. violations)
                return
            time.sleep(0.05)

    def _read_cycle(self, rng) -> None:
        sel = "SELECT v FROM kv WHERE k='{}'"
        # Linear read: full register linearizability, any entry node
        # (421s chase the leader hint inside the client).
        key = f"k{rng.randrange(self.KEYS)}"
        h = self.lin.begin_read(key, mode="linear")
        try:
            rows = self.client.get(sel.format(key), linear=True,
                                   deadline_s=8.0)
        except (SQLError, Unavailable):
            pass              # no answer: read never happened
        else:
            self.lin.end_read(h, rows.strip().strip("|"))
            self.report["linear_reads"] += 1
        # Session read: the last acked write's watermark must be
        # visible from ANY node.
        if self._sess:
            key = rng.choice(sorted(self._sess))
            seq, wm = self._sess[key]
            node = rng.randrange(self.plan.peers)
            try:
                rows = self.client.get(sel.format(key), node=node,
                                       consistency="session",
                                       session=wm, deadline_s=8.0)
            except (SQLError, Unavailable):
                pass
            else:
                self.report["session_reads"] += 1
                got = rows.strip().strip("|")
                if not got or (got.startswith("w")
                               and got[1:].isdigit()
                               and int(got[1:]) < seq):
                    self.report["stale_session"] += 1
                    raise InvariantViolation(
                        f"session read({key!r}, wm={wm}) at node "
                        f"{node} returned {got!r}, older than acked "
                        f"write w{seq}")
        # Follower read: replica-commit freshness, any node.
        key = f"k{rng.randrange(self.KEYS)}"
        node = rng.randrange(self.plan.peers)
        try:
            self.client.get(sel.format(key), node=node,
                            consistency="follower", deadline_s=8.0)
        except (SQLError, Unavailable):
            pass
        else:
            self.report["follower_reads"] += 1

    def _converge(self, deadline_s: float = 60.0) -> List[str]:
        """Every node must answer the full ordered KV table
        identically, with each key at least as fresh as its last ACKED
        write (an unacked trailing write may legally have landed too —
        upserts overwrite, so exact-set equality is the wrong ask)."""
        want = {k: seq for k, (seq, _wm) in self._sess.items()}
        query = "SELECT k, v FROM kv ORDER BY k"
        deadline = time.monotonic() + deadline_s
        last: object = None
        while time.monotonic() < deadline:
            answers = []
            try:
                for i in range(self.plan.peers):
                    answers.append(self.client.get(
                        query, node=i, deadline_s=10.0))
            except (Unavailable, SQLError) as e:
                last = e
                time.sleep(0.5)
                continue
            if all(a == answers[0] for a in answers):
                rows = {}
                for line in answers[0].splitlines():
                    parts = line.strip("|").split("|")
                    if len(parts) == 2:
                        rows[parts[0]] = parts[1]
                stale = {
                    k: (rows.get(k), s) for k, s in want.items()
                    if not (rows.get(k, "").startswith("w")
                            and rows[k][1:].isdigit()
                            and int(rows[k][1:]) >= s)}
                if not stale:
                    return answers[0].splitlines()
                last = ("stale", stale)
            else:
                last = [len(a.splitlines()) for a in answers]
            time.sleep(0.5)
        raise InvariantViolation(
            f"KV convergence failed before the deadline; last={last!r}")

    def _post_mortem(self) -> None:
        """Durability from DISK alone, upsert-aware: replay every
        node's WAL, fold the committed (post-dedup) upserts per key in
        order, and require (a) every node folds to the SAME final KV,
        (b) each key at least as fresh as its last acked write, and
        (c) each node's cold-opened SQLite kv table matches its own
        fold."""
        import re
        from raftsql_tpu_torch.runtime.envelope import unwrap
        from raftsql_tpu_torch.storage.wal import WAL
        pat = re.compile(r"VALUES \('(k\d+)', '(w\d+)'\)")
        want = {k: seq for k, (seq, _wm) in self._sess.items()}
        folds = []
        for i in range(self.plan.peers):
            groups = WAL.replay(self.cluster.data_dir(i))
            gl = groups.get(0)
            if gl is None:
                raise InvariantViolation(
                    f"node {i + 1}: WAL replay has no group 0")
            committed = gl.entries[:max(0, gl.hard.commit - gl.start)]
            seen_pids: Set[int] = set()
            kv: Dict[str, str] = {}
            for (_term, data) in committed:
                if not data:
                    continue
                pid, payload = unwrap(data)
                if pid is not None:
                    if pid in seen_pids:
                        continue
                    seen_pids.add(pid)
                m = pat.search(payload.decode("utf-8", "replace"))
                if m:
                    kv[m.group(1)] = m.group(2)
            folds.append(kv)
            for k, s in want.items():
                got = kv.get(k, "")
                if not (got.startswith("w") and got[1:].isdigit()
                        and int(got[1:]) >= s):
                    raise InvariantViolation(
                        f"node {i + 1}: key {k} folded to {got!r} in "
                        f"the committed WAL prefix — staler than "
                        f"acked w{s}")
            conn = sqlite3.connect(self.cluster.db_path(i))
            try:
                rows = dict(conn.execute("SELECT k, v FROM kv"))
            finally:
                conn.close()
            if rows != kv:
                raise InvariantViolation(
                    f"node {i + 1}: SQLite kv {rows!r} diverges from "
                    f"its committed WAL fold {kv!r}")
        if any(f != folds[0] for f in folds[1:]):
            raise InvariantViolation(
                f"nodes folded to different committed KV states: "
                f"{folds!r}")

    def _verdict_digest(self) -> str:
        """What must reproduce for the READ nemesis: the schedule, the
        invariant verdicts, and the read families.  The base runner's
        storage-fault booleans are deliberately excluded — their op
        thresholds accumulate with the wall-clock-paced workload, and
        whether they fire inside the window is kernel-scheduled (the
        signal nemesis families are guaranteed by the script's
        deferral loop and asserted by the gate instead)."""
        import hashlib as _h
        import json as _j
        r = self.report
        doc = {
            "schedule": self.plan.digest(),
            "invariants": dict(self.verdicts),
            "read_families": {
                "linear": r["linear_reads"] > 0,
                "session": r["session_reads"] > 0,
                "follower": r["follower_reads"] > 0,
                "stale_session": r["stale_session"] == 0,
                "unexpected_exits": r["unexpected_exits"] == 0,
            },
        }
        blob = _j.dumps(doc, sort_keys=True,
                        separators=(",", ":")).encode()
        return _h.sha256(blob).hexdigest()[:16]

    def run(self) -> dict:
        out = self._run_impl()
        out["result_digest"] = self._verdict_digest()
        return out


class ProcTransferChaosRunner(ProcChaosRunner):
    """Transfer-under-nemesis on the PROCESS plane (`chaos.run
    --transfers`): the same seeded nemesis script (SIGKILLs,
    SIGSTOP stalls, restart storms, env disk faults) over real server
    processes, with the acked-PUT workload interleaving graceful
    leadership transfers driven through the public admin surface —
    `POST /transfer` at whoever /healthz says leads group 0, then
    polling /healthz until leadership lands on the requested target.

    Reuses ProcChaosPlan unchanged (extending it would move every
    existing proc-family digest).  A transfer outstanding when the
    nemesis kills the leader is LOST (the latch dies with the process)
    — counted, not failed: availability through it all is what the
    acked-PUT stream plus convergence and the WAL post-mortem already
    assert.  Verdict digest carries transfer-family booleans (counts
    are wall-clock-paced)."""

    XFER_EVERY = 20          # workload iterations between attempts
    XFER_DEADLINE_S = 25.0   # generous: spans a stall + re-election

    def __init__(self, plan: ProcChaosPlan, workdir: str,
                 http_engine: str = "aio", device="cuda"):
        super().__init__(plan, workdir, http_engine=http_engine,
                         device=device)
        self.report.update({
            "transfers_requested": 0, "transfers_completed": 0,
            "transfers_refused": 0, "transfers_lost": 0,
        })

    def _workload(self) -> None:
        import random
        rng = random.Random(self.plan.seed ^ 0x7AFE)
        pending = None           # (target slot, wall deadline)
        n = 0
        while not self._stop_workload.is_set():
            val = f"w{n}"
            n += 1
            try:
                self.client.put(
                    f"INSERT INTO chaos (v) VALUES ('{val}')",
                    deadline_s=8.0)
                with self._acked_lock:
                    self.acked.append(val)
            except (SQLError, Unavailable):
                pass
            except BaseException as e:   # noqa: BLE001 - surfaced
                self._workload_err = e
                return
            if n % self.XFER_EVERY == 0 or pending is not None:
                try:
                    pending = self._transfer_cycle(rng, pending,
                                                   issue=n %
                                                   self.XFER_EVERY == 0)
                except BaseException as e:   # noqa: BLE001 - surfaced
                    self._workload_err = e
                    return
            time.sleep(0.08)

    def _transfer_cycle(self, rng, pending, issue: bool):
        """One observation of the transfer state machine: resolve the
        group-0 leader from /healthz, settle an outstanding request
        (completed / lost), and maybe issue a new one."""
        docs = self._healthz_all()
        lead = None
        for i, doc in sorted(docs.items()):
            if doc and doc["groups"].get("0", {}).get("role") == _LEADER:
                lead = i
                break
        if pending is not None:
            target, dl = pending
            if lead == target:
                self.report["transfers_completed"] += 1
                return None
            if time.monotonic() > dl:
                # Engine abort, or the latch died with a killed
                # leader: either way the group kept serving (the PUT
                # stream asserts that) — log and move on.
                self.report["transfers_lost"] += 1
                return None
            return pending
        if not issue or lead is None:
            return None
        target = (lead + 1
                  + rng.randrange(self.plan.peers - 1)) % self.plan.peers
        try:
            status, _hdrs, _text = self.client.raw(
                lead, "POST", "/transfer",
                body=json.dumps({"group": 0, "target": target}),
                timeout_s=3.0)
        except OSError:
            return None              # leader died under us: next cycle
        if status == 200:
            self.report["transfers_requested"] += 1
            return (target, time.monotonic() + self.XFER_DEADLINE_S)
        # 400 = engine refusal (latch in flight, learner target);
        # 421 = our /healthz view was stale — both retry next cycle.
        self.report["transfers_refused"] += 1
        return None

    def _verdict_digest(self) -> str:
        """What must reproduce for the transfer nemesis: the schedule,
        the invariant verdicts, and the transfer-family booleans.  The
        base storage-fault booleans are excluded for the same reason
        ProcReadChaosRunner excludes them — their op thresholds
        accumulate with the wall-clock-paced workload."""
        r = self.report
        doc = {
            "schedule": self.plan.digest(),
            "invariants": dict(self.verdicts),
            "transfer_families": {
                "requested": r["transfers_requested"] > 0,
                "completed": r["transfers_completed"] > 0,
                "unexpected_exits": r["unexpected_exits"] == 0,
            },
        }
        blob = json.dumps(doc, sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def run(self) -> dict:
        out = self._run_impl()
        out["result_digest"] = self._verdict_digest()
        return out
