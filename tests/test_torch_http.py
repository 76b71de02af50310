"""The port's `--fused --device cpu` server against the reference recipe.

raftsql_tpu_torch/server/main.py builds the fused durable cluster
(commit_rule="pallas", so Phase 7 runs the quorum kernels' plain
versions on the CPU) behind each HTTP engine, and the reference's curl
recipe must hold on both: PUT answers 204, GET returns `|abc|`-style
rows, POST answers 405, bad SQL answers 400, and `X-Raft-Group` routes
to a group's own database.
"""
import http.client

import pytest
import torch

from raftsql_tpu_torch.api.aio import AioSQLServer
from raftsql_tpu_torch.api.http import SQLServer
from raftsql_tpu_torch.server.main import build_fused_node, main

torch.set_num_threads(1)


@pytest.fixture(params=["threaded", "aio"])
def server(request, tmp_path):
    rdb = build_fused_node(groups=2, peers=3, tick=0.002,
                           data_prefix=str(tmp_path / "raftsql"),
                           commit_rule="pallas", device="cpu")
    cls = SQLServer if request.param == "threaded" else AioSQLServer
    srv = cls(0, rdb, host="127.0.0.1", timeout_s=30.0)
    srv.start()
    yield srv
    srv.stop()
    rdb.close()


def req(srv, method, body=b"", headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
    try:
        conn.request(method, "/", body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def test_reference_recipe(server):
    assert req(server, "PUT", b"CREATE TABLE main.t (name text)")[0] == 204
    assert req(server, "PUT",
               b'INSERT INTO main.t (name) VALUES ("abc")')[0] == 204
    status, body = req(server, "GET", b"SELECT * FROM main.t")
    assert status == 200 and body == b"|abc|\n"
    assert req(server, "POST", b"SELECT 1")[0] == 405
    assert req(server, "PUT", b"NOT SQL AT ALL")[0] == 400


def test_group_header_routes(server):
    g1 = {"X-Raft-Group": "1"}
    assert req(server, "PUT", b"CREATE TABLE main.u (v text)",
               g1)[0] == 204
    assert req(server, "PUT", b'INSERT INTO main.u (v) VALUES ("g1")',
               g1)[0] == 204
    assert req(server, "GET", b"SELECT * FROM main.u", g1) == (200,
                                                              b"|g1|\n")
    # Group 0 has its own database: the table does not exist there.
    assert req(server, "GET", b"SELECT * FROM main.u")[0] == 400
    assert req(server, "PUT", b"CREATE TABLE main.x (v text)",
               {"X-Raft-Group": "7"})[0] == 400


@pytest.mark.parametrize("argv", [
    ["--cluster", "http://127.0.0.1:1", "--id", "1", "--pod"],
    ["--fused", "--mesh"], ["--fused", "--reshard"],
    ["--fused", "--workers", "2"]])
def test_cli_refuses_unported_deployments(argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code != 0
    assert "not ported" in capsys.readouterr().err


def test_cli_cluster_node_needs_the_card_by_default(tmp_path,
                                                    monkeypatch):
    """The multi-process deployment (--cluster/--id) is served now; its
    default device is cuda, and without a card it raises instead of
    falling back to the CPU."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--cluster", "http://127.0.0.1:1", "--id", "1"])


@pytest.mark.parametrize("engine", ["threaded", "aio"])
def test_cli_fused_device_cpu_serves_recipe(tmp_path, engine):
    """`python -m raftsql_tpu_torch.server.main --fused --device cpu` as a
    process: the recipe, then SIGTERM stops it cleanly (exit 0)."""
    import os
    import signal
    import socket
    import subprocess
    import sys
    import time

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.Popen(
        [sys.executable, "-m", "raftsql_tpu_torch.server.main", "--fused",
         "--device", "cpu", "--groups", "2", "--port", str(port),
         "--http-engine", engine], cwd=str(tmp_path), env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        srv = type("S", (), {"port": port})
        deadline = time.monotonic() + 60
        while True:
            try:
                if req(srv, "GET", b"SELECT 1")[0] == 200:
                    break
            except OSError:
                pass
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            assert time.monotonic() < deadline, "server never came up"
            time.sleep(0.2)
        assert req(srv, "PUT", b"CREATE TABLE main.t (name text)")[0] == 204
        assert req(srv, "PUT",
                   b'INSERT INTO main.t (name) VALUES ("abc")')[0] == 204
        assert req(srv, "GET", b"SELECT * FROM main.t") == (200,
                                                            b"|abc|\n")
        assert req(srv, "POST", b"SELECT 1")[0] == 405
        assert req(srv, "PUT", b"NOT SQL")[0] == 400
        g1 = {"X-Raft-Group": "1"}
        assert req(srv, "PUT", b"CREATE TABLE main.u (v text)", g1)[0] == 204
        assert req(srv, "GET", b"SELECT * FROM main.u")[0] == 400
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    assert rc == 0
