"""CLI entry point of the PyTorch port — the `--fused` deployment only.

    python -m raftsql_tpu_torch.server.main --fused --groups 8 \
        --port 12380 [--device cuda]

Port of raftsql_tpu/server/main.py: the same composition (proposeC ->
pipe -> RaftDB -> HTTP, the reference's server/main.go:24-38) with the
fused co-located cluster underneath, stepping on `--device` (CUDA by
default; a missing card is an error, never a silent CPU fallback).  The
other deployments of the JAX package (the multi-process cluster, --mesh,
--pod) and the planes not ported yet (--workers, --reshard,
--replica-listen) exit with an error naming them.  `--placement` runs
the traffic-aware leadership controller (raftsql_tpu_torch/placement/)
over the fused host plane's transfer latch.
"""
from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading
import time

from raftsql_tpu_torch.api.http import SQLServer
from raftsql_tpu_torch.config import RaftConfig
from raftsql_tpu_torch.models.sqlite_sm import SQLiteStateMachine
from raftsql_tpu_torch.runtime.db import RaftDB


def build_fused_node(groups: int = 1, peers: int = 3,
                     tick: float = 0.002,
                     data_prefix: str = "raftsql",
                     resume: bool = False,
                     compact_every: int = 0, compact_keep: int = 1024,
                     wal_segment_bytes: int = 4 << 20,
                     wal_group_commit: bool = True,
                     lease_ticks: int = 0,
                     max_clock_skew: int = 1,
                     write_quorum: int | None = None,
                     election_quorum: int | None = None,
                     witnesses: tuple = (),
                     commit_rule: str = "point",
                     trace: bool = False,
                     device="cuda") -> RaftDB:
    """The --fused single-process deployment: all P peers of every group
    co-located in this process, consensus advanced by one fused cluster
    step per tick on `device` (runtime/fused.py), per-peer WALs on disk
    (one group-committed log by default), SQLite applied from peer 0's
    commit stream.  `commit_rule` picks the Phase-7 commit advance
    ("pallas" runs the CUDA quorum kernels).  `trace` turns on the obs
    plane (span tracer + device event ring) behind GET /trace and GET
    /events."""
    from raftsql_tpu_torch.runtime.fused import FusedClusterNode, FusedPipe

    if lease_ticks:
        election_default = RaftConfig.__dataclass_fields__[
            "election_ticks"].default
        lease_ticks = min(lease_ticks,
                          max(1, election_default - max_clock_skew - 1))
    if 0 in tuple(witnesses):
        raise ValueError("--fused applies from peer slot 0; pick a "
                         "different --witness slot")
    cfg = RaftConfig(num_groups=groups, num_peers=peers,
                     tick_interval_s=tick,
                     wal_segment_bytes=wal_segment_bytes,
                     lease_ticks=lease_ticks,
                     max_clock_skew=max_clock_skew,
                     write_quorum=write_quorum,
                     election_quorum=election_quorum,
                     witnesses=tuple(witnesses) or None,
                     commit_rule=commit_rule)
    node = FusedClusterNode(cfg, f"{data_prefix}-fused",
                            group_commit=wal_group_commit, device=device)
    if trace:
        node.enable_tracing()
    node.start(interval_s=max(tick, 0.0005))
    pipe = FusedPipe(node)

    def sm_factory(g: int) -> SQLiteStateMachine:
        path = (f"{data_prefix}-fused.db" if g == 0
                else f"{data_prefix}-fused-g{g}.db")
        return SQLiteStateMachine(path, resume=resume)

    return RaftDB(sm_factory, pipe, num_groups=groups, resume=resume,
                  compact_every=compact_every, compact_keep=compact_keep)


def attach_placement(rdb: RaftDB, interval_s: float = 0.5,
                     imbalance: float = 2.0):
    """--placement: start the traffic-aware leadership controller
    (raftsql_tpu_torch/placement/) over the fused host plane's traffic
    feed and transfer latch; GET /metrics then carries its gauges.
    Returns the controller (stop() ends its thread)."""
    from raftsql_tpu_torch.placement import PlacementController
    pc = PlacementController(rdb.pipe.node, interval_s=interval_s,
                             imbalance=imbalance)
    rdb.placement = pc
    pc.start()
    return pc


# Exit code for "the consensus engine failed" (unrecoverable WAL fsync,
# injected ENOSPC): a server that can no longer participate must crash,
# visibly, rather than keep answering HTTP with a dead engine behind it.
EXIT_CODE_FATAL = 70


def _install_graceful_shutdown(rdb, srv_stop) -> None:
    """SIGTERM/SIGINT -> clean stop: stop the HTTP plane, then close the
    pipe (flushes and fsyncs the WALs, closes the state machines) and
    exit 0.  A second signal while the first shutdown runs hard-exits."""
    fired = threading.Event()

    def _graceful(signum, frame):
        if fired.is_set():
            os._exit(0)
        fired.set()

        def _work():
            try:
                srv_stop()
            except Exception:                       # noqa: BLE001
                pass
            try:
                rdb.close()
            except Exception:                       # noqa: BLE001
                pass
            os._exit(0)

        threading.Thread(target=_work, daemon=False,
                         name="graceful-shutdown").start()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)


def _watch_fatal(rdb) -> None:
    """Exit the process (EXIT_CODE_FATAL) when the consensus engine
    records a terminal error."""
    def _work():
        while True:
            if rdb.pipe.error is not None:
                logging.getLogger("raftsql.server").error(
                    "consensus engine failed, exiting: %s",
                    rdb.pipe.error)
                os._exit(EXIT_CODE_FATAL)
            time.sleep(0.2)

    threading.Thread(target=_work, daemon=True,
                     name="fatal-watch").start()


# Flags of the JAX package's CLI whose deployment or plane this port has
# not reached yet: set, each exits with this error.
_NOT_PORTED = {
    "mesh": "--mesh (ROADMAP Queue 1 item 13)",
    "pod": "--pod (ROADMAP Queue 1 item 13)",
    "workers": "--workers (ROADMAP Queue 1 item 14)",
    "reshard": "--reshard (ROADMAP Queue 1 item 14)",
    "replica_listen": "--replica-listen (ROADMAP Queue 1 item 14)",
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="replicated SQL on the PyTorch/CUDA port (--fused)")
    ap.add_argument("--cluster", default="",
                    help="multi-process cluster peers (not ported: "
                         "use --fused)")
    ap.add_argument("--id", type=int, default=1, help="node ID (1-based)")
    ap.add_argument("--port", type=int, default=9121,
                    help="sql server port")
    ap.add_argument("--groups", type=int, default=1,
                    help="number of raft groups")
    ap.add_argument("--tick", type=float, default=0.01,
                    help="seconds per consensus tick")
    ap.add_argument("--resume", action="store_true",
                    help="snapshot-resume: keep the SQLite file across "
                         "restarts and skip re-applying the replayed "
                         "prefix (default: reference delete-and-replay)")
    ap.add_argument("--compact-every", type=int, default=0,
                    help="with --resume: advance WAL compaction floors "
                         "every N applies")
    ap.add_argument("--compact-keep", type=int, default=1024,
                    help="entries retained above the compaction floor")
    ap.add_argument("--wal-segment-bytes", type=int, default=4 << 20,
                    help="rotate WAL segments at this size")
    ap.add_argument("--fused", action="store_true",
                    help="single-process cluster: all --peers raft peers "
                         "co-located on one device, one fused step per "
                         "tick (the only deployment this port serves)")
    ap.add_argument("--peers", type=int, default=3,
                    help="with --fused: peers per group")
    ap.add_argument("--device", default="cuda",
                    help="torch device the consensus state steps on "
                         "(default cuda; 'cpu' runs the plain versions)")
    ap.add_argument("--mesh", action="store_true", help="not ported")
    ap.add_argument("--pod", action="store_true", help="not ported")
    ap.add_argument("--workers", type=int, default=0, help="not ported")
    ap.add_argument("--placement", action="store_true",
                    help="traffic-aware leadership placement "
                         "(raftsql_tpu_torch/placement/): a controller "
                         "thread watches the per-group traffic feed "
                         "and issues graceful leadership transfers "
                         "(POST /transfer machinery, thesis §3.10) to "
                         "balance hot groups across peers")
    ap.add_argument("--placement-interval", type=float, default=0.5,
                    help="seconds between placement passes")
    ap.add_argument("--placement-imbalance", type=float, default=2.0,
                    help="hottest/coldest per-peer load ratio that "
                         "triggers a transfer")
    ap.add_argument("--reshard", action="store_true", help="not ported")
    ap.add_argument("--replica-listen", type=int, default=0,
                    help="not ported")
    ap.add_argument("--trace", action="store_true",
                    help="enable the observability planes "
                         "(raftsql_tpu_torch/obs/): per-proposal "
                         "lifecycle spans + the on-device event ring, "
                         "exported at GET /trace (Perfetto) and GET "
                         "/events")
    ap.add_argument("--wal-group-commit", choices=("on", "off"),
                    default="on",
                    help="coalesce every peer's per-tick WAL records "
                         "into ONE shared log + ONE fsync")
    ap.add_argument("--lease-ticks", type=int, default=0,
                    help="leader-lease duration in ticks (0 = off)")
    ap.add_argument("--write-quorum", type=int, default=None,
                    help="flexible write quorum size (default majority)")
    ap.add_argument("--election-quorum", type=int, default=None,
                    help="flexible election quorum size (default "
                         "majority)")
    ap.add_argument("--witness", type=int, action="append", default=[],
                    metavar="SLOT", help="0-based witness peer slot "
                                         "(repeatable)")
    ap.add_argument("--max-clock-skew", type=int, default=1,
                    help="clock-skew slack (ticks) for lease checks")
    ap.add_argument("--http-engine", choices=("aio", "threaded"),
                    default="aio",
                    help="HTTP plane: asyncio event loop (default) or "
                         "thread-per-connection")
    ap.add_argument("--overload-cap", type=int, default=0,
                    help="max queued-but-unstaged proposals per engine "
                         "(429 + Retry-After beyond it); 0 = none")
    ap.add_argument("--overload-group-cap", type=int, default=0,
                    help="max queued-but-unstaged proposals per group")
    ap.add_argument("--brownout-hi", type=float, default=None,
                    help="queue-depth EWMA above which linear reads "
                         "degrade to lease-only")
    ap.add_argument("--brownout-lo", type=float, default=None,
                    help="queue-depth EWMA below which the brownout "
                         "ladder disengages")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    for name, what in _NOT_PORTED.items():
        if getattr(args, name):
            ap.error(f"{what} is not ported to raftsql_tpu_torch yet")
    if not args.fused:
        ap.error("raftsql_tpu_torch serves the --fused deployment only; "
                 "the multi-process cluster (--cluster/--id) is not "
                 "ported yet (ROADMAP Queue 1 item 8)")
    from raftsql_tpu_torch.storage import fsio
    fsio.install_from_env()
    sys.setswitchinterval(
        float(os.environ.get("RAFTSQL_GIL_SWITCH_S", "0.001")))
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    rdb = build_fused_node(groups=args.groups, peers=args.peers,
                           tick=args.tick, resume=args.resume,
                           compact_every=args.compact_every,
                           compact_keep=args.compact_keep,
                           wal_segment_bytes=args.wal_segment_bytes,
                           wal_group_commit=args.wal_group_commit == "on",
                           lease_ticks=args.lease_ticks,
                           max_clock_skew=args.max_clock_skew,
                           write_quorum=args.write_quorum,
                           election_quorum=args.election_quorum,
                           witnesses=tuple(args.witness),
                           trace=args.trace,
                           device=args.device)
    _watch_fatal(rdb)
    if args.overload_cap or args.overload_group_cap \
            or args.brownout_hi is not None:
        from raftsql_tpu_torch.overload import OverloadController
        rdb.pipe.node.overload = OverloadController(
            args.groups, group_cap=args.overload_group_cap,
            total_cap=args.overload_cap, seed=0,
            tick_interval_s=args.tick,
            brownout_hi=args.brownout_hi,
            brownout_lo=args.brownout_lo)
    if args.placement:
        attach_placement(rdb, interval_s=args.placement_interval,
                         imbalance=args.placement_imbalance)
    if args.http_engine == "aio":
        from raftsql_tpu_torch.api.aio import AioSQLServer
        srv = AioSQLServer(args.port, rdb)
    else:
        srv = SQLServer(args.port, rdb)
    _install_graceful_shutdown(rdb, srv.stop)
    srv.serve_forever()


if __name__ == "__main__":
    main()
