"""The port's Procfile cluster end to end: the cases of
tests/test_server_procs.py on raftsql_tpu_torch.

Three `python -m raftsql_tpu_torch.server.main --id I --cluster ...`
processes on localhost (TcpTransport + HTTP API + WAL + SQLite, each
RaftNode stepping on the CPU with one torch thread) through the port's
ProcCluster, driven by the port's RaftSQLClient: the reference curl
recipe, then a crash-restart of a node that must catch up.
"""
import pytest

from raftsql_tpu_torch.api.client import RaftSQLClient, SQLError
from raftsql_tpu_torch.chaos.proc import ProcCluster

TIMEOUT = 90.0


def _boot3(tmp_path, groups: int = 1):
    c = ProcCluster(str(tmp_path), peers=3, groups=groups, tick=0.02,
                    device="cpu")
    for i in range(3):
        c.spawn(i)
    cli = RaftSQLClient([f"127.0.0.1:{p}" for p in c.http_ports],
                        timeout_s=10.0)
    return c, cli


def _logs(c: ProcCluster) -> str:
    return "\n".join(f"--- node{i + 1} ---\n" + c.log_tail(i, 2000)
                     for i in range(3))


def test_torch_three_process_cluster_put_get_restart(tmp_path):
    c, cli = _boot3(tmp_path)
    try:
        # README curl recipe: PUT on node 1, INSERT via node 2, read on 3.
        cli.put("CREATE TABLE t (name text)", node=0,
                deadline_s=TIMEOUT)
        cli.put("INSERT INTO t (name) VALUES ('abc')", node=1,
                deadline_s=TIMEOUT)
        cli.get_until("SELECT name FROM t", "|abc|\n", node=2,
                      deadline_s=TIMEOUT)
        # Method semantics over the real stack: 405 + Allow header.
        status, _, _ = cli.raw(0, "POST", "/", "x")
        assert status == 405
        # Bad SQL propagates the apply error as 400 (reference
        # httpapi.go:45-49 blocking-PUT contract) — the client must NOT
        # retry a deterministic failure.
        with pytest.raises(SQLError):
            cli.put("INSERT INTO nosuch VALUES (1)", node=0,
                    deadline_s=TIMEOUT)

        # Crash node 2 (SIGKILL), write while it is down, restart it, and
        # require the missed write to stream in from the leader
        # (reference raftsql_test.go:117-170).
        c.sigkill(1)
        cli.put("INSERT INTO t (name) VALUES ('while-down')", node=0,
                deadline_s=TIMEOUT)
        c.spawn(1)
        try:
            cli.get_until("SELECT count(*) FROM t", "|2|\n", node=1,
                          deadline_s=TIMEOUT)
        except BaseException:
            print(_logs(c))
            raise
        # Clean stop is SIGTERM (graceful-shutdown handler): the WAL is
        # flushed and every process exits 0 — SIGKILL above was "crash",
        # this is "stop".
        codes = c.stop_all()
        assert codes == [0, 0, 0], (codes, _logs(c))
    finally:
        c.stop_all()


def test_torch_multi_group_over_real_processes(tmp_path):
    """The flagship axis (N raft groups) over the reference's proof-of-
    life topology (3 OS processes, real sockets): writes routed to
    distinct groups via different nodes, per-group isolation (each group
    is its own SQLite database), and group state surviving a SIGKILL
    crash/restart — VERDICT r2 task 7."""
    c, cli = _boot3(tmp_path, groups=4)
    try:
        # One table per group, created via a different node each time;
        # rows encode the group id.
        for g in range(4):
            node = g % 3
            cli.put("CREATE TABLE t (v text)", group=g, node=node,
                    deadline_s=TIMEOUT)
            cli.put(f"INSERT INTO t (v) VALUES ('g{g}')", group=g,
                    node=node, deadline_s=TIMEOUT)
        # Every node serves every group; each group sees ONLY its row.
        for g in range(4):
            for node in range(3):
                cli.get_until("SELECT v FROM t", f"|g{g}|\n", group=g,
                              node=node, deadline_s=TIMEOUT)
        # Unknown group -> 400, not a crash.
        status, _, _ = cli.raw(0, "GET", "/", "SELECT v FROM t",
                               headers={"X-Raft-Group": "99"})
        assert status == 400

        # Crash node 3; write to two different groups while it is down;
        # restart; both groups' missed writes must stream in, and the
        # untouched groups must stay isolated.
        c.sigkill(2)
        cli.put("INSERT INTO t (v) VALUES ('late1')", group=1, node=0,
                deadline_s=TIMEOUT)
        cli.put("INSERT INTO t (v) VALUES ('late3')", group=3, node=1,
                deadline_s=TIMEOUT)
        c.spawn(2)
        try:
            for g, want in ((1, "|2|\n"), (3, "|2|\n"),
                            (0, "|1|\n"), (2, "|1|\n")):
                cli.get_until("SELECT count(*) FROM t", want, group=g,
                              node=2, deadline_s=TIMEOUT)
        except BaseException:
            print(_logs(c))
            raise
    finally:
        c.stop_all()
