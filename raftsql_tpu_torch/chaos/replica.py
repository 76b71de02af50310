"""Replica-tier chaos: a seeded nemesis over REAL replica processes.

Port of raftsql_tpu/chaos/replica.py.  The engine child steps on
`device` (the card by default; a missing card raises); the replica
children never touch it (CUDA_VISIBLE_DEVICES="").

The read-replica tier (raftsql_tpu_torch/replica/) promises exactly one
thing under fire: a replica NEVER answers a session or linear read
with data staler than the mode's contract — it refuses (421, toward
the authoritative tier) instead.  This nemesis attacks that promise
with a fused engine (`--replica-listen`), N `python -m
raftsql_tpu_torch.replica` processes, and a runner-owned TCP proxy in front
of each replica's stream subscription so the nemesis can:

  * CUT the subscription (blackhole the proxy) — the replica's fold
    freezes while the engine keeps acking writes; every session probe
    carrying a fresh watermark must refuse until the HEAL, and the
    resumed subscription must replay or resync the gap;
  * SIGKILL a replica mid-stream and RESPAWN it — fresh-state
    bootstrap (log replay below the head, fresh-base RESYNC above it)
    while the writer keeps moving;
  * CORRUPT one bit of the stream — the frame CRC must surface it as
    a typed fault (drop + resubscribe), never a wrong row.

Workload: a single-threaded deterministic loop writes acked rows
through the engine (per-group counts + the X-Raft-Session watermark
each ack returned), interleaves the fault timeline, and probes every
replica's HTTP plane in session and linear mode.  The StaleReadNever
invariant: a 200 session answer must reflect at least the rows acked
at the probe's watermark; a 200 linear answer at least every row
acked before the probe began; a 421 is always acceptable.  After the
timeline, the audit phase heals everything and requires every replica
to CONVERGE (serve the exact final per-group counts) and, when a
corruption was scripted, to have COUNTED it (healthz corrupt_frames).

Determinism tier matches the proc plane (README fault matrix): plan
digest + invariant-verdict digest reproduce across runs of one seed;
the history crosses real kernels and is not bit-stable.  The
falsification pair (schedule.py falsification_replica_plan): a
replica booted with --unsafe-serve under a never-healed cut serves
below acked watermarks / past its lease horizon and MUST be caught by
StaleReadNever; the same schedule with the gates on must pass.
"""
from __future__ import annotations

import hashlib
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from raftsql_tpu_torch.chaos.invariants import InvariantViolation
from raftsql_tpu_torch.chaos.schedule import ReplicaChaosPlan

READY_DEADLINE_S = 120.0
CONVERGE_DEADLINE_S = 30.0
PROBE_TIMEOUT_S = 2.0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _StreamProxy:
    """A TCP forwarder the nemesis owns: replica -> proxy -> engine
    stream port.  cut() closes every live pipe and makes new ones die
    instantly (a partition as the subscriber sees one: connect may
    succeed, bytes never flow); heal() restores forwarding;
    corrupt_next() flips one bit in the next engine->replica chunk —
    CRC-covered, so exactly one typed corruption surfaces."""

    def __init__(self, upstream_port: int):
        self.upstream_port = upstream_port
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        self._mu = threading.Lock()
        self._cut = False                  # raftlint: guarded-by=_mu
        self._corrupt_next = False         # raftlint: guarded-by=_mu
        self._pairs: List[socket.socket] = []  # raftlint: guarded-by=_mu
        self._stop = threading.Event()
        threading.Thread(target=self._accept, daemon=True,
                         name="replica-proxy").start()

    def cut(self) -> None:
        with self._mu:
            self._cut = True
            pairs, self._pairs = self._pairs, []
        for s in pairs:
            _sever(s)

    def heal(self) -> None:
        with self._mu:
            self._cut = False

    def corrupt_next(self) -> None:
        with self._mu:
            self._corrupt_next = True

    def stop(self) -> None:
        self._stop.set()
        self.cut()
        _sever(self._sock)

    def _accept(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with self._mu:
                if self._cut:
                    _sever(conn)
                    continue
            try:
                up = socket.create_connection(
                    ("127.0.0.1", self.upstream_port), timeout=5)
            except OSError:
                _sever(conn)
                continue
            with self._mu:
                self._pairs += [conn, up]
            threading.Thread(target=self._pump, args=(conn, up, False),
                             daemon=True).start()
            threading.Thread(target=self._pump, args=(up, conn, True),
                             daemon=True).start()

    def _pump(self, src: socket.socket, dst: socket.socket,
              downstream: bool) -> None:
        try:
            while True:
                data = src.recv(1 << 16)
                if not data:
                    break
                if downstream:
                    with self._mu:
                        flip = self._corrupt_next
                        if flip:
                            self._corrupt_next = False
                    if flip:
                        b = bytearray(data)
                        b[len(b) // 2] ^= 0x40
                        data = bytes(b)
                dst.sendall(data)
        except OSError:
            pass
        finally:
            _sever(src)
            _sever(dst)


def _sever(sock: socket.socket) -> None:
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _http(port: int, method: str, body: str = "", headers=None,
          path: str = "/", timeout: float = PROBE_TIMEOUT_S):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body.encode() or None,
                     headers=headers or {})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read().decode()
    finally:
        conn.close()


class ReplicaChaosRunner:
    """One seeded run: engine + proxies + replica processes, the
    single-threaded writer/fault/probe loop, then the audit."""

    def __init__(self, plan: ReplicaChaosPlan, workdir: str,
                 device="cuda"):
        from raftsql_tpu_torch.core.state import resolve_device
        self.plan = plan
        self.device = str(resolve_device(device))
        self.workdir = str(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        self.env = dict(
            os.environ,
            PYTHONPATH=repo_root + (
                os.pathsep + os.environ["PYTHONPATH"]
                if os.environ.get("PYTHONPATH") else ""))
        if self.device == "cpu":
            self.env["OMP_NUM_THREADS"] = "1"
        # Only the engine holds the card.
        self.replica_env = dict(self.env, CUDA_VISIBLE_DEVICES="")
        self.api_port = _free_port()
        self.stream_port = _free_port()
        self.engine: Optional[subprocess.Popen] = None
        self.proxies: List[_StreamProxy] = []
        self.http_ports: List[int] = []
        self.replicas: List[Optional[subprocess.Popen]] = []
        self.acked = [0] * plan.groups       # rows acked per group
        self.wm = [0] * plan.groups          # watermark of last ack
        self.report = {
            "acked": 0, "served_session": 0, "served_linear": 0,
            "refusals": 0, "conn_errors": 0,
            "cuts": 0, "heals": 0, "kills": 0, "restarts": 0,
            "corrupts": 0,
        }
        self.verdicts: Dict[str, str] = {}

    # -- process plumbing ------------------------------------------------

    def _spawn_engine(self) -> None:
        logf = open(os.path.join(self.workdir, "engine.log"), "ab")
        self.engine = subprocess.Popen(
            [sys.executable, "-m", "raftsql_tpu_torch.server.main", "--fused",
             "--port", str(self.api_port),
             "--groups", str(self.plan.groups), "--tick", "0.005",
             "--lease-ticks", "40",
             "--replica-listen", str(self.stream_port),
             "--device", self.device],
            cwd=self.workdir, env=self.env, stdout=logf, stderr=logf)
        logf.close()
        deadline = time.monotonic() + READY_DEADLINE_S
        for g in range(self.plan.groups):
            while True:
                if self.engine.poll() is not None \
                        or time.monotonic() > deadline:
                    raise RuntimeError(
                        "engine not ready: " + self._log_tail("engine"))
                try:
                    st, _h, _b = _http(
                        self.api_port, "PUT",
                        "CREATE TABLE IF NOT EXISTS t (k INTEGER, v TEXT)",
                        headers={"X-Raft-Group": str(g)}, timeout=10)
                    if st in (204, 400):
                        break
                except OSError:
                    pass
                time.sleep(0.3)

    def _spawn_replica(self, i: int) -> None:
        logf = open(os.path.join(self.workdir, f"replica{i}.log"), "ab")
        cmd = [sys.executable, "-m", "raftsql_tpu_torch.replica",
               "--upstream", f"127.0.0.1:{self.proxies[i].port}",
               "--port", str(self.http_ports[i]),
               "--advertise", f"127.0.0.1:{self.http_ports[i]}"]
        if self.plan.unsafe_serve:
            cmd.append("--unsafe-serve")
        self.replicas[i] = subprocess.Popen(
            cmd, cwd=self.workdir, env=self.replica_env,
            stdout=logf, stderr=logf)
        logf.close()

    def _log_tail(self, name: str, nbytes: int = 800) -> str:
        try:
            with open(os.path.join(self.workdir, f"{name}.log"),
                      "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - nbytes))
                return f.read().decode("utf-8", "replace")
        except OSError:
            return ""

    # -- workload --------------------------------------------------------

    def _write_one(self, n: int) -> None:
        g = n % self.plan.groups
        st, hdrs, body = _http(
            self.api_port, "PUT",
            f"INSERT INTO t VALUES ({n}, 'v{n}')",
            headers={"X-Raft-Group": str(g)}, timeout=15)
        if st != 204:
            raise RuntimeError(f"engine PUT failed: {st} {body[:200]}")
        self.acked[g] += 1
        self.report["acked"] += 1
        wm = hdrs.get("X-Raft-Session")
        if wm:
            self.wm[g] = max(self.wm[g], int(wm))

    def _probe(self, i: int) -> None:
        """One session + one linear probe at replica i, every group.
        StaleReadNever: an ANSWER below the mode's bound is the
        violation; a refusal (421) never is."""
        for g in range(self.plan.groups):
            floor = self.acked[g]            # rows acked at this instant
            for mode, extra in (
                    ("session", {"X-Raft-Session": str(self.wm[g])}),
                    ("linear", {})):
                headers = {"X-Consistency": mode,
                           "X-Raft-Group": str(g), **extra}
                try:
                    st, _h, body = _http(self.http_ports[i], "GET",
                                         "SELECT count(*) FROM t",
                                         headers=headers)
                except OSError:
                    self.report["conn_errors"] += 1
                    continue
                if st == 421:
                    self.report["refusals"] += 1
                    continue
                if st != 200:
                    self.report["conn_errors"] += 1
                    continue
                got = int(body.strip().strip("|"))
                if got < floor:
                    raise InvariantViolation(
                        f"STALE {mode} read at replica {i} group {g}: "
                        f"answered {got} rows with {floor} acked "
                        f"(watermark {self.wm[g]})")
                self.report[f"served_{mode}"] += 1

    def _fire(self, fault) -> None:
        i = fault.target
        if fault.kind == "cut":
            self.proxies[i].cut()
            self.report["cuts"] += 1
        elif fault.kind == "heal":
            self.proxies[i].heal()
            self.report["heals"] += 1
        elif fault.kind == "kill":
            p = self.replicas[i]
            if p is not None and p.poll() is None:
                p.send_signal(signal.SIGKILL)
                p.wait(10)
            self.report["kills"] += 1
        elif fault.kind == "restart":
            self._spawn_replica(i)
            self.report["restarts"] += 1
        elif fault.kind == "corrupt":
            self.proxies[i].corrupt_next()
            self.report["corrupts"] += 1

    def _settle(self) -> None:
        """Before the plan clock starts: every replica attached and
        serving a session read at the current watermark (so the first
        probes measure the ladder, not the bootstrap)."""
        deadline = time.monotonic() + READY_DEADLINE_S
        for i in range(self.plan.replicas):
            while True:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"replica {i} never caught up: "
                        + self._log_tail(f"replica{i}"))
                try:
                    st, _h, _b = _http(
                        self.http_ports[i], "GET",
                        "SELECT count(*) FROM t",
                        headers={"X-Consistency": "session",
                                 "X-Raft-Session": str(self.wm[0]),
                                 "X-Raft-Group": "0"})
                    if st == 200:
                        break
                except OSError:
                    pass
                time.sleep(0.2)

    # -- the run ---------------------------------------------------------

    def run(self) -> dict:
        try:
            self._run_inner()
        except BaseException as e:
            self._flight_dump(e)
            raise
        finally:
            self._teardown()
        return {"plan_digest": self.plan.digest(),
                "result_digest": self._verdict_digest(),
                "seed": self.plan.seed, **self.report}

    def _run_inner(self) -> None:
        plan = self.plan
        self._spawn_engine()
        for i in range(plan.replicas):
            self.proxies.append(_StreamProxy(self.stream_port))
            self.http_ports.append(_free_port())
            self.replicas.append(None)
            self._spawn_replica(i)
        for n in range(plan.groups * 2):     # seed rows + watermarks
            self._write_one(n)
        self._settle()

        faults = sorted(plan.faults, key=lambda f: f.t_ms)
        fi = 0
        n = plan.groups * 2
        t0 = time.monotonic()
        while True:
            t_ms = (time.monotonic() - t0) * 1e3
            if t_ms >= plan.duration_ms:
                break
            while fi < len(faults) and faults[fi].t_ms <= t_ms:
                self._fire(faults[fi])
                fi += 1
            self._write_one(n)
            n += 1
            for i in range(plan.replicas):
                self._probe(i)
            time.sleep(plan.writer_ms / 1e3)
        while fi < len(faults):              # a slow box can't skip one
            self._fire(faults[fi])
            fi += 1
        self.verdicts["stale_read_never"] = "pass"
        self._audit()

    def _audit(self) -> None:
        """Heal everything, then every replica must CONVERGE: serve
        the exact final counts in session mode at the final watermark
        (proving the stream replayed or resynced every gap), and a
        scripted corruption must have been COUNTED by the subscriber
        (healthz corrupt_frames — the CRC caught it)."""
        for proxy in self.proxies:
            proxy.heal()
        deadline = time.monotonic() + CONVERGE_DEADLINE_S
        for i in range(self.plan.replicas):
            for g in range(self.plan.groups):
                while True:
                    if time.monotonic() > deadline:
                        raise InvariantViolation(
                            f"CONVERGENCE: replica {i} group {g} never "
                            f"reached {self.acked[g]} acked rows: "
                            + self._log_tail(f"replica{i}"))
                    try:
                        st, _h, body = _http(
                            self.http_ports[i], "GET",
                            "SELECT count(*) FROM t",
                            headers={"X-Consistency": "session",
                                     "X-Raft-Session": str(self.wm[g]),
                                     "X-Raft-Group": str(g)})
                        if st == 200 \
                                and int(body.strip().strip("|")) \
                                == self.acked[g]:
                            break
                    except OSError:
                        pass
                    time.sleep(0.2)
        self.verdicts["converges"] = "pass"
        if any(f.kind == "corrupt" for f in self.plan.faults):
            target = next(f.target for f in self.plan.faults
                          if f.kind == "corrupt")
            st, _h, body = _http(self.http_ports[target], "GET", "",
                                 path="/healthz")
            doc = json.loads(body)
            if int(doc["replica"].get("corrupt_frames", 0)) < 1:
                raise InvariantViolation(
                    "CORRUPTION: the flipped bit was never surfaced "
                    "as a CRC failure at the subscriber")
            self.verdicts["corruption_detected"] = "pass"

    # -- teardown / flight / digest --------------------------------------

    def _teardown(self) -> None:
        for p in self.replicas:
            if p is not None and p.poll() is None:
                p.terminate()
        if self.engine is not None and self.engine.poll() is None:
            self.engine.terminate()
        for p in [*self.replicas, self.engine]:
            if p is None:
                continue
            try:
                p.wait(timeout=10)
            except Exception:                # noqa: BLE001
                p.kill()
        for proxy in self.proxies:
            proxy.stop()

    def _flight_dump(self, err: BaseException) -> None:
        from raftsql_tpu_torch.obs.flight import FlightRecorder
        bundle: dict = {"plan": self.plan.describe(),
                        "plan_digest": self.plan.digest(),
                        "report": dict(self.report),
                        "acked": list(self.acked),
                        "watermarks": list(self.wm),
                        "logs": {"engine": self._log_tail("engine")}}
        for i in range(len(self.replicas)):
            bundle["logs"][f"replica{i}"] = self._log_tail(f"replica{i}")
        FlightRecorder().dump(
            f"replica-seed{self.plan.seed}", repr(err), meta=bundle)

    def _verdict_digest(self) -> str:
        """What must reproduce across runs of one seed: the plan, the
        invariant verdicts, and which fault kinds fired — booleans,
        because counts beyond the plan's are wall-clock-scheduled."""
        r = self.report
        doc = {
            "plan": self.plan.digest(),
            "invariants": dict(self.verdicts),
            "fired": {k: r[k + "s"] >= sum(
                1 for f in self.plan.faults if f.kind == k)
                for k in ("cut", "heal", "kill", "restart", "corrupt")},
        }
        blob = json.dumps(doc, sort_keys=True,
                          separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()[:16]
