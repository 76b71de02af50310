"""The cases of tests/test_api_http.py, on the port (a one-node
RaftNode cluster on the CPU behind each of its two HTTP planes).  The
reference file's docstring follows.

HTTP API tests: reference semantics (PUT/GET/405, httpapi.go:36-66)
plus the multi-group and robustness extensions.  Every test runs
against BOTH serving planes — the threaded stdlib port (api/http.py)
and the event-loop redesign (api/aio.py) — the parametrized fixture is
the parity contract between them."""
import http.client

import pytest
import torch

from raftsql_tpu_torch.config import RaftConfig
from raftsql_tpu_torch.api.aio import AioSQLServer
from raftsql_tpu_torch.api.http import SQLServer
from raftsql_tpu_torch.models.sqlite_sm import SQLiteStateMachine
from raftsql_tpu_torch.runtime.db import RaftDB
from raftsql_tpu_torch.runtime.pipe import RaftPipe
from raftsql_tpu_torch.transport.loopback import LoopbackHub, LoopbackTransport

torch.set_num_threads(1)

TIMEOUT = 30.0


@pytest.fixture(params=["threaded", "aio"])
def server(request, tmp_path):
    """Single-node cluster (self-elects) behind a real HTTP server."""
    cfg = RaftConfig(num_groups=2, num_peers=1, tick_interval_s=0.005,
                     log_window=64, max_entries_per_msg=4)
    pipe = RaftPipe.create(1, 1, cfg, LoopbackTransport(LoopbackHub()),
                           data_dir=str(tmp_path / "raftsql-1"),
                           device="cpu")
    rdb = RaftDB(lambda g: SQLiteStateMachine(
        str(tmp_path / f"api-g{g}.db")), pipe, num_groups=2)
    srv_cls = SQLServer if request.param == "threaded" else AioSQLServer
    srv = srv_cls(0, rdb, host="127.0.0.1", timeout_s=TIMEOUT)
    srv.start()
    yield srv
    srv.stop()
    rdb.close()


def req(srv, method, body=b"", headers=None, conn=None):
    own = conn is None
    if own:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
    conn.request(method, "/", body=body, headers=headers or {})
    r = conn.getresponse()
    data = r.read()
    if own:
        conn.close()
    return r, data


def test_put_get_roundtrip(server):
    r, _ = req(server, "PUT", b"CREATE TABLE main.t (v text)")
    assert r.status == 204
    r, _ = req(server, "PUT", b'INSERT INTO main.t (v) VALUES ("x")')
    assert r.status == 204
    r, data = req(server, "GET", b"SELECT * FROM main.t")
    assert r.status == 200 and data == b"|x|\n"


def test_group_header_out_of_range_is_400(server):
    for g in ("-1", "5", "junk"):
        r, data = req(server, "PUT", b"CREATE TABLE main.bad (v text)",
                      headers={"X-Raft-Group": g})
        assert r.status == 400, (g, r.status, data)
    r, data = req(server, "GET", b"SELECT 1",
                  headers={"X-Raft-Group": "7"})
    assert r.status == 400


def test_method_not_allowed_keeps_connection_usable(server):
    """405 must drain the request body and emit one `Allow: PUT, GET`
    header, or the keep-alive stream parses body bytes as the next
    request (reference semantics: httpapi.go:63-66)."""
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
    try:
        r, _ = req(server, "POST", b"some body that must be drained",
                   conn=conn)
        assert r.status == 405
        assert r.getheader("Allow") == "PUT, GET"
        # Same connection must still serve a clean request.
        r, data = req(server, "GET", b"SELECT 42", conn=conn)
        assert r.status == 200 and data == b"|42|\n"
    finally:
        conn.close()


def test_metrics_endpoint(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
    try:
        conn.request("GET", "/metrics")
        r = conn.getresponse()
        data = r.read()
    finally:
        conn.close()
    assert r.status == 200
    import json
    m = json.loads(data)
    assert {"ticks", "proposals", "commits", "msgs_sent"} <= set(m)


def test_healthz_endpoint(server):
    """GET /healthz (both planes): id, per-group role / leader hint /
    term / applied — the readiness probe the process-plane nemesis
    uses to detect restart completion without a write."""
    import json
    import time
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
    try:
        deadline = time.monotonic() + 15.0
        while True:
            conn.request("GET", "/healthz")
            r = conn.getresponse()
            doc = json.loads(r.read())
            assert r.status == 200
            assert doc["id"] == 1 and doc["ready"] is True
            assert set(doc["groups"]) == {"0", "1"}
            row = doc["groups"]["0"]
            assert {"role", "leader", "term", "commit",
                    "applied"} <= set(row)
            if row["role"] == "leader":     # single node self-elects
                assert row["leader"] == 1 and row["term"] >= 1
                break
            assert time.monotonic() < deadline, doc
            time.sleep(0.05)
    finally:
        conn.close()


def test_put_retry_token_applies_exactly_once(server):
    """X-Raft-Retry-Token (both planes): re-sending a PUT with the same
    token must ACK normally but apply once — the envelope dedup rides
    the token across client retries, so retry-after-accept is safe
    (api/client.py's whole premise)."""
    r, _ = req(server, "PUT", b"CREATE TABLE main.rt (v text)")
    assert r.status == 204
    hdr = {"X-Raft-Retry-Token": "00c0ffee00c0ffee"}
    for _ in range(3):
        r, data = req(server, "PUT",
                      b"INSERT INTO main.rt (v) VALUES ('once')",
                      headers=hdr)
        assert r.status == 204, (r.status, data)
    # A DIFFERENT token is a different logical request: applies again.
    r, _ = req(server, "PUT",
               b"INSERT INTO main.rt (v) VALUES ('once')",
               headers={"X-Raft-Retry-Token": "00000000deadbeef"})
    assert r.status == 204
    r, data = req(server, "GET", b"SELECT count(*) FROM main.rt")
    assert r.status == 200 and data == b"|2|\n", data


def test_concurrent_puts_all_ack(server):
    """Many keep-alive connections proposing at once: every PUT must
    block until ITS commit+apply and ack 204 (httpapi.go:38-49 under
    raftsql_test.go:79-90-style concurrency); the applied row count
    equals the acked request count."""
    import threading

    r, _ = req(server, "PUT", b"CREATE TABLE main.c (v text)")
    assert r.status == 204
    n_threads, per = 12, 8
    errs: list = []

    def worker(i):
        try:
            conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                              timeout=30)
            try:
                for k in range(per):
                    r, data = req(server, "PUT",
                                  f"INSERT INTO main.c (v) VALUES"
                                  f" ('t{i}_{k}')".encode(), conn=conn)
                    if r.status != 204:
                        errs.append((i, k, r.status, data))
            finally:
                conn.close()
        except Exception as e:          # noqa: BLE001 - must surface
            errs.append((i, repr(e)))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs[:3]
    r, data = req(server, "GET", b"SELECT count(*) FROM main.c")
    assert r.status == 200
    assert data == f"|{n_threads * per}|\n".encode()


def test_pipelined_requests_answer_in_order(server):
    """Two requests written back-to-back before any response is read:
    both planes must answer in order on the same connection (the aio
    state machine buffers the second while the first is in flight)."""
    import socket

    body1 = b"CREATE TABLE main.p (v text)"
    body2 = b"INSERT INTO main.p (v) VALUES ('x')"
    raw = b"".join(
        b"PUT / HTTP/1.1\r\nHost: t\r\nContent-Length: "
        + str(len(b)).encode() + b"\r\n\r\n" + b
        for b in (body1, body2))
    s = socket.create_connection(("127.0.0.1", server.port), timeout=30)
    try:
        s.sendall(raw)
        buf = b""
        deadline = 30
        import time
        t0 = time.monotonic()
        while buf.count(b"HTTP/1.1 ") < 2:    # any two responses
            assert time.monotonic() - t0 < deadline, buf
            chunk = s.recv(4096)
            assert chunk, buf
            buf += chunk
        assert buf.count(b"HTTP/1.1 204") == 2, buf
    finally:
        s.close()
    r, data = req(server, "GET", b"SELECT count(*) FROM main.p")
    assert r.status == 200 and data == b"|1|\n"


def test_group_header_routes_to_second_group(server):
    r, _ = req(server, "PUT", b"CREATE TABLE main.g1 (v text)",
               headers={"X-Raft-Group": "1"})
    assert r.status == 204
    # group 0 must not see group 1's table.
    r, data = req(server, "GET", b"SELECT * FROM main.g1")
    assert r.status == 400
    r, data = req(server, "GET", b"SELECT * FROM main.g1",
                  headers={"X-Raft-Group": "1"})
    assert r.status == 200


def test_put_propose_failure_answers_400(server, monkeypatch):
    """An unexpected exception from rdb.propose (e.g. pipe/queue closed
    during shutdown) must answer 400, not kill the handler and leave
    the connection hanging with busy=True (the aio
    plane's _do_put previously called propose outside any try)."""
    def boom(self, query, group=0, token=None):
        raise RuntimeError("injected propose failure")

    # Class-level: the threaded plane closes over the RaftDB instance
    # rather than exposing it.
    monkeypatch.setattr(RaftDB, "propose", boom)
    r, data = req(server, "PUT", b"INSERT INTO main.t VALUES (1)")
    assert r.status == 400
    assert b"injected propose failure" in data
    # The server keeps serving once the fault clears.
    monkeypatch.undo()
    r, _ = req(server, "PUT", b"CREATE TABLE main.after_fault (v text)")
    assert r.status == 204
