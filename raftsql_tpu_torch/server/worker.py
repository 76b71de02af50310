"""HTTP worker process for the multi-worker serving plane.

Port of raftsql_tpu/server/worker.py.  Spawned by `server/main.py
--workers N` (one process per worker): runs the asyncio HTTP plane
(api/aio.py) over a `RingClient` facade (runtime/ring.py) instead of an
in-process RaftDB: every proposal becomes a record in this worker's
mmap'd propose ring, every ack a completion-ring record resolved into
the event loop.  All N workers bind the SAME port with SO_REUSEPORT;
the kernel spreads connections.

The worker holds no consensus, storage, or SQLite state: it can be
killed and respawned freely (in-flight requests on its connections
fail; the engine's retry-token dedup keeps client-side retries
exactly-once).  It never touches the card: the engine spawns it with
CUDA_VISIBLE_DEVICES="" (the worker sets it too), so only the engine
process holds a CUDA context.  It exits on SIGTERM, and when its engine
dies: `--engine-pid` names the engine, and the worker asks the kernel
for SIGTERM at its parent's death (PR_SET_PDEATHSIG) itself, then
checks that its parent is still that engine (a parent that died before
the request leaves the worker re-parented, and it exits at once).
"""
from __future__ import annotations

import argparse
import logging
import os
import signal


def die_with_parent(engine_pid: int) -> None:
    """SIGTERM this process when its parent dies, and exit now when the
    parent is already gone (no longer `engine_pid`).  Called in the
    child itself: the engine runs a tick thread and a CUDA context, and
    a `preexec_fn` between fork and exec is unsafe in a process with
    threads."""
    try:
        import ctypes
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGTERM)
    except OSError:                      # pragma: no cover - non-linux
        pass
    if engine_pid and os.getppid() != engine_pid:
        os._exit(0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="raftsql HTTP ring worker")
    ap.add_argument("--rings", required=True,
                    help="ring directory created by the engine process")
    ap.add_argument("--index", type=int, required=True,
                    help="worker index (selects the ring pair)")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--timeout", type=float, default=30.0)
    ap.add_argument("--engine-pid", type=int, default=0,
                    help="pid of the engine process: the worker exits "
                         "when its parent is no longer this process")
    ap.add_argument("--trace", action="store_true",
                    help="stamp each ring round trip into a per-process "
                         "trace segment (pid/worker-id tagged) the "
                         "engine's /trace merges into one Perfetto "
                         "timeline")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    die_with_parent(args.engine_pid)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s worker%(process)d %(levelname)s %(message)s")

    # The worker never touches a device: hide every card before
    # anything imports torch.
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    from raftsql_tpu_torch.api.aio import AioSQLServer
    from raftsql_tpu_torch.runtime.ring import RingClient

    rdb = RingClient(args.rings, args.index, trace=args.trace)
    srv = AioSQLServer(args.port, rdb, timeout_s=args.timeout,
                       reuse_port=True)

    def _term(signum, frame):
        os._exit(0)

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    try:
        srv.serve_forever()
    finally:
        rdb.close()


if __name__ == "__main__":
    main()
