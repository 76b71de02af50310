"""Standalone read replica: subscribe to an engine's --replica-listen
stream and serve the read ladder over either HTTP plane.  Port of
raftsql_tpu/replica/__main__.py; the process hides every CUDA card
before it imports torch (it steps no consensus).

    python -m raftsql_tpu_torch.replica --upstream host:9220 --port 9221

The process is read-only by construction: PUT/POST answer 421 with the
upstream leader hint.  --advertise names the HTTP endpoint published
back to the engine (the client sweep adopts it from the engine's
/healthz `replica.endpoints`); it defaults to 127.0.0.1:<port> for
single-box deployments.  --unsafe-serve exists ONLY as the chaos
falsification seam (make chaos-replica): it disables the session and
linear fail-closed gates so the StaleReadNever invariant can prove it
would have caught a stale-serving replica.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

log = logging.getLogger("raftsql.replica")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raftsql_tpu_torch.replica",
        description="read replica: stream subscriber + HTTP read plane")
    ap.add_argument("--upstream", required=True,
                    help="engine --replica-listen endpoint, host:port")
    ap.add_argument("--port", type=int, default=9221,
                    help="HTTP port to serve reads on")
    ap.add_argument("--host", default="", help="HTTP bind host")
    ap.add_argument("--advertise", default="",
                    help="endpoint to publish to the engine's /healthz "
                         "(default 127.0.0.1:<port>)")
    ap.add_argument("--http-engine", choices=("threaded", "aio"),
                    default="threaded")
    ap.add_argument("--timeout", type=float, default=30.0,
                    help="per-request timeout seconds")
    ap.add_argument("--unsafe-serve", action="store_true",
                    help="DANGEROUS: disable the session/linear "
                         "fail-closed gates (chaos falsification only)")
    ap.add_argument("--write-cap", type=int, default=0,
                    help="bound on concurrent write-fallback redirects "
                         "(excess answers 429 + Retry-After; 0 = "
                         "unbounded)")
    args = ap.parse_args(argv)
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    from raftsql_tpu_torch.replica.node import ReplicaDB, ReplicaSubscriber
    from raftsql_tpu_torch.replica.stream import parse_hostport
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    advertise = args.advertise or f"127.0.0.1:{args.port}"
    sub = ReplicaSubscriber(parse_hostport(args.upstream),
                            advertise=advertise)
    sub.start()
    rdb = ReplicaDB(sub, unsafe_serve=args.unsafe_serve,
                    write_cap=args.write_cap)
    if args.unsafe_serve:
        log.warning("UNSAFE-SERVE: session/linear gates disabled — "
                    "chaos falsification mode, never production")
    # Reuse the server's SIGTERM/SIGINT plumbing: clean stop closes the
    # HTTP plane, then the subscriber + state machines.
    from raftsql_tpu_torch.server.main import _install_graceful_shutdown
    if args.http_engine == "aio":
        from raftsql_tpu_torch.api.aio import AioSQLServer
        srv = AioSQLServer(args.port, rdb, host=args.host,
                           timeout_s=args.timeout)
    else:
        from raftsql_tpu_torch.api.http import SQLServer
        srv = SQLServer(args.port, rdb, host=args.host,
                        timeout_s=args.timeout)
    _install_graceful_shutdown(rdb, srv.stop)
    log.info("replica serving on :%d (upstream %s, %s plane)",
             args.port, args.upstream, args.http_engine)
    srv.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
