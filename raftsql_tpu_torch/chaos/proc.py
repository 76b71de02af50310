"""Process-plane cluster: real server processes of the port.

Port of the ProcCluster half of raftsql_tpu/chaos/proc.py: N
`python -m raftsql_tpu_torch.server.main --id I --cluster ...` children
on localhost (the reference's Procfile topology), TcpTransport between
them and HTTP on top, under the caller's control: SIGTERM is "clean
stop" (the graceful-shutdown handler flushes the WAL and exits 0),
SIGKILL is "crash", SIGSTOP/SIGCONT is "stall", and `spawn` restarts a
peer on the same ports and data dir (WAL replay).  Each child steps its
consensus on `device` (CUDA by default).

The seeded nemesis over these processes (the JAX package's
ProcChaosRunner and the process arms of its read and transfer
gauntlets) is not ported yet (ROADMAP Queue 1).
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
from typing import List, Optional

# server/main.py EXIT_CODE_FATAL without importing the server module
# (it pulls the whole engine; the harness stays engine-import-free so
# it can babysit children that ARE the engine).
EXIT_CODE_FATAL = 70


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
