"""The port's serving smoke: the native HTTP load generator
(raftsql_tpu_torch/native/http_load.cc, built by native/build.py
build_http_load) against `server/main.py --fused --workers 2 --device
cpu`, the analog of scripts/serving_smoke.py: zero errored requests, the
ring plane in /metrics, a clean SIGTERM.  And a failed build raises."""
import json
import os
import signal
import socket
import subprocess
import sys

import pytest

from raftsql_tpu_torch.native import build as native_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def test_http_load_against_two_workers(tmp_path):
    from raftsql_tpu_torch.api.client import RaftSQLClient

    loadgen = native_build.build_http_load(str(tmp_path / "build"))
    assert os.access(loadgen, os.X_OK)
    groups, port = 2, _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "raftsql_tpu_torch.server.main", "--fused",
         "--workers", "2", "--groups", str(groups), "--port", str(port),
         "--tick", "0.004", "--device", "cpu"],
        cwd=str(tmp_path), env=env,
        stdout=open(tmp_path / "server.log", "wb"),
        stderr=subprocess.STDOUT)
    client = RaftSQLClient([port], timeout_s=10)
    try:
        client.wait_healthy(0, deadline_s=90)
        for g in range(groups):
            client.put("CREATE TABLE t (v text)", group=g, deadline_s=60)
        out = subprocess.run([loadgen, "2", "16", str(groups), str(port)],
                             capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, out.stderr[-500:]
        j = json.loads(out.stdout.strip())
        assert j["errors"] == 0, j
        assert j["n"] > 0 and j["p99_ms"] >= j["p50_ms"] > 0, j
        st, _, text = client.raw(0, "GET", "/metrics")
        m = json.loads(text)
        assert st == 200 and m["ring_workers"] == 2
        assert m["ring_proposed"] >= j["n"] + groups
        rows = sum(int(client.get("SELECT count(*) FROM t", group=g)
                       .strip().strip("|")) for g in range(groups))
        assert rows == j["n"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        client.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_failed_loadgen_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "http_load.cc"
    bad.write_text("int main( {")
    monkeypatch.setattr(native_build, "HTTP_LOAD_SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_build.build_http_load(str(tmp_path / "build"))
    assert not any(os.scandir(tmp_path / "build"))
