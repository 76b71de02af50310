"""CLI entry point of the PyTorch port.

    python -m raftsql_tpu_torch.server.main \
        --cluster http://127.0.0.1:12379,http://127.0.0.1:22379,... \
        --id 1 --port 12380 [--device cuda]
    python -m raftsql_tpu_torch.server.main --fused --groups 8 \
        --port 12380 [--device cuda]
    RAFTSQL_SHARD_SLOTS=4 python -m raftsql_tpu_torch.server.main \
        --mesh --groups 8 --group-shards 4 --port 12380 [--device cuda]
    RAFTSQL_SHARD_SLOTS=2 python -m raftsql_tpu_torch.server.main --pod \
        --pod-id I --pod-coord 127.0.0.1:CP --pod-hosts H0,H1 \
        --groups 8 --group-shards 2 --port P [--device cuda]
    RAFTSQL_POD_JAX_DISTRIBUTED=1 python -m raftsql_tpu_torch.server.main \
        --pod ... [--pod-dist-backend gloo]   # each host steps its shards

Port of raftsql_tpu/server/main.py: the same composition (proposeC ->
pipe -> RaftDB -> HTTP, the reference's server/main.go:24-38) with
consensus stepping on `--device` (CUDA by default; a missing card is an
error, never a silent CPU fallback).  Four deployments: the
reference's multi-process cluster (--cluster/--id, one RaftNode per
process over the TCP transport, as the Procfile runs it), the fused
co-located cluster (--fused), the same cluster stepped over a mesh of
shard slots (--mesh, runtime/mesh.py) and the multi-process pod (--pod,
raftsql_tpu_torch/pod/).  `--workers N` moves HTTP into N worker
processes that share the engine through mmap rings (runtime/ring.py,
server/worker.py); `--replica-listen PORT` publishes the read-replica
delta stream (raftsql_tpu_torch/replica/).
`--placement` runs the traffic-aware leadership controller
(raftsql_tpu_torch/placement/) over the co-located host plane's
transfer latch; `--reshard` the elastic keyspace
(raftsql_tpu_torch/reshard/: POST /reshard, the keyed /kv surface).
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
from raftsql_tpu_torch.runtime.pipe import RaftPipe
from raftsql_tpu_torch.transport.tcp import TcpTransport


def build_node(cluster: str, node_id: int, groups: int = 1,
               tick: float = 0.01, election_ticks: int | None = None,
               data_prefix: str = "raftsql", resume: bool = False,
               compact_every: int = 0, compact_keep: int = 1024,
               wal_segment_bytes: int = 4 << 20,
               trace: bool = False, lease_ticks: int = 0,
               max_clock_skew: int = 1,
               write_quorum: int | None = None,
               election_quorum: int | None = None,
               witnesses: tuple = (), device="cuda") -> RaftDB:
    """One process of the multi-process cluster (the reference's
    Procfile deployment): node `node_id` (1-based) of the peers listed
    in `cluster`, its RaftNode stepping all `groups` groups on `device`,
    its WAL in <data_prefix>-<id> and SQLite in <data_prefix>-<id>.db
    (per group g > 0: <data_prefix>-<id>-g<g>.db)."""
    peers = cluster.split(",")
    # Election/heartbeat timing in real time, whatever the tick (the
    # reference's ~1 s election timeout and ~100 ms heartbeat at its
    # 100 ms tick, raft.go:154-155, 207): timers advance only on
    # interval-paced steps, so a fast tick is a finer timer, not a
    # shorter election timeout.
    if tick > 0:
        if election_ticks is None:
            election_ticks = max(10, round(1.0 / tick))
        heartbeat_ticks = max(1, round(0.1 / tick))
        if election_ticks <= 2 * heartbeat_ticks:
            heartbeat_ticks = max(1, election_ticks // 3)
    else:
        # Untimed (step per loop): the reference's tick counts.
        election_ticks = election_ticks or 10
        heartbeat_ticks = 1
    # Leader leases: clamp to what the election timeout can protect.
    if lease_ticks:
        lease_ticks = min(lease_ticks,
                          max(1, election_ticks - max_clock_skew - 1))
    cfg = RaftConfig(num_groups=groups, num_peers=len(peers),
                     tick_interval_s=tick, election_ticks=election_ticks,
                     heartbeat_ticks=heartbeat_ticks,
                     wal_segment_bytes=wal_segment_bytes,
                     lease_ticks=lease_ticks,
                     max_clock_skew=max_clock_skew,
                     write_quorum=write_quorum,
                     election_quorum=election_quorum,
                     witnesses=tuple(witnesses) or None)
    transport = TcpTransport(peers, node_id - 1)
    pipe = RaftPipe.create(node_id, len(peers), cfg, transport,
                           data_dir=f"{data_prefix}-{node_id}",
                           device=device)
    if trace:
        pipe.node.enable_tracing()

    def sm_factory(g: int) -> SQLiteStateMachine:
        path = (f"{data_prefix}-{node_id}.db" if g == 0
                else f"{data_prefix}-{node_id}-g{g}.db")
        return SQLiteStateMachine(path, resume=resume)

    return RaftDB(sm_factory, pipe, num_groups=groups, resume=resume,
                  compact_every=compact_every, compact_keep=compact_keep)


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


def build_mesh_node(groups: int = 8, peers: int = 3,
                    tick: float = 0.002,
                    data_prefix: str = "raftsql",
                    group_shards: int = 0, peer_shards: int = 1,
                    resume: bool = False,
                    compact_every: int = 0, compact_keep: int = 1024,
                    wal_segment_bytes: int = 4 << 20,
                    trace: bool = False, device="cuda") -> RaftDB:
    """The --mesh deployment (runtime/mesh.py): the fused cluster with
    its consensus step sharded over a mesh of shard slots on `device`
    (G split over the `groups` axis) and the durable host plane sharded
    to match: per-shard WAL dirs under <prefix>-mesh/p<i>/s<j>,
    per-shard publish workers, and the SQLite state machines laid out
    per group shard under <prefix>-mesh-db/s<j>/.  `group_shards=0`
    picks the widest mesh the shard slots allow (RAFTSQL_SHARD_SLOTS
    counts each visible device as several slots)."""
    from raftsql_tpu_torch.runtime.fused import FusedPipe
    from raftsql_tpu_torch.runtime.mesh import MeshClusterNode, MeshConfig

    cfg = RaftConfig(num_groups=groups, num_peers=peers,
                     tick_interval_s=tick,
                     wal_segment_bytes=wal_segment_bytes)
    mc = (MeshConfig.for_groups(cfg, peer_shards=peer_shards,
                                device=device)
          if group_shards <= 0
          else MeshConfig(peer_shards=peer_shards,
                          group_shards=group_shards))
    mc.validate(cfg)
    logging.getLogger("raftsql.server").info(
        "mesh deployment: %dx%d shard slots, %d groups (%d per shard)",
        mc.peer_shards, mc.group_shards, groups,
        groups // mc.group_shards)
    node = MeshClusterNode(cfg, f"{data_prefix}-mesh",
                           mc.build(device=device))
    if trace:
        node.enable_tracing()
    node.start(interval_s=max(tick, 0.0005))
    pipe = FusedPipe(node)
    g_loc = groups // mc.group_shards

    def sm_factory(g: int) -> SQLiteStateMachine:
        d = f"{data_prefix}-mesh-db/s{g // g_loc}"
        os.makedirs(d, exist_ok=True)
        return SQLiteStateMachine(os.path.join(d, f"g{g}.db"),
                                  resume=resume)

    return RaftDB(sm_factory, pipe, num_groups=groups, resume=resume,
                  compact_every=compact_every, compact_keep=compact_keep)


class PodRaftDB(RaftDB):
    """RaftDB over a PodClusterNode: every group-scoped verb is served
    ONLY by the group's owner host.

    Ownership is the ack-soundness boundary: an HTTP write ack fires
    when the commit reaches THIS host's publish stream, which follows
    THIS host's WAL fsync; on the owner that is "durable where the
    group's whole P-peer history lives", on any other host it would ack
    a write whose only durable copy is still crossing the pod (the
    premature-ack hazard chaos/pod.py falsifies); and pending-ack
    matching is (group, query)-keyed, so two hosts holding futures for
    one group could cross-resolve each other's writes.  Non-owners
    answer 421 + X-Raft-Leader naming the owner host (1-based slot in
    the pod hosts table) and the client chases, as with a non-leader
    peer in the multi-process deployment."""

    def _pod_check(self, group: int) -> None:
        node = self.pipe.node
        if not node.owns_group(int(group)):
            from raftsql_tpu_torch.runtime.db import NotLeaderError
            raise NotLeaderError(int(group),
                                 node.group_owner(int(group)) + 1)

    def propose(self, query, group: int = 0, *a, **kw):
        self._pod_check(group)
        return super().propose(query, group, *a, **kw)

    def read_point(self, query, group: int = 0, *a, **kw):
        self._pod_check(group)
        return super().read_point(query, group, *a, **kw)

    def member_change(self, group: int, op: str, peer: int) -> dict:
        self._pod_check(group)
        return super().member_change(group, op, peer)

    def transfer(self, group: int, target: int) -> dict:
        self._pod_check(group)
        return super().transfer(group, target)


def build_pod_node(groups: int = 8, peers: int = 3, tick: float = 0.01,
                   data_prefix: str = "raftsql",
                   group_shards: int = 0,
                   pod_procs: int = 1, pod_id: int = 0,
                   pod_coord: str = "", pod_hosts: tuple = (),
                   resume: bool = False,
                   compact_every: int = 0, compact_keep: int = 1024,
                   wal_segment_bytes: int = 4 << 20,
                   trace: bool = False, device="cuda",
                   dist_backend: str = "") -> RaftDB:
    """The --pod deployment (raftsql_tpu_torch/pod/): N host PROCESSES
    jointly own one cluster.  Every host runs the identical replicated
    device step on its own `device`; the durable plane is sharded: this
    host materializes WAL dirs and SQLite files only for the group
    shards it OWNS (round-robin, pod/config.py), and the per-tick
    collective carries cross-host proposals and is the tick+fsync
    barrier.  Construction BLOCKS until all pod_procs processes join; a
    lost peer is pod-wide fail-stop (the engine error surfaces through
    _watch_fatal as EXIT_CODE_FATAL).  With RAFTSQL_POD_JAX_DISTRIBUTED=1
    (the JAX package's variable) the hosts form a torch.distributed
    process group first (PodConfig.init_distributed; `dist_backend`
    names its backend, default NCCL on a card and gloo on the CPU) and
    each steps only the group shards it owns."""
    from raftsql_tpu_torch.pod.config import POD_DISTRIBUTED_ENV, PodConfig
    from raftsql_tpu_torch.pod.node import PodClusterNode
    from raftsql_tpu_torch.runtime.fused import FusedPipe
    from raftsql_tpu_torch.runtime.mesh import MeshConfig

    pod = PodConfig(procs=pod_procs, proc_id=pod_id,
                    coordinator=pod_coord, hosts=tuple(pod_hosts))
    dist = os.environ.get(POD_DISTRIBUTED_ENV) == "1"
    cfg = RaftConfig(num_groups=groups, num_peers=peers,
                     tick_interval_s=tick,
                     wal_segment_bytes=wal_segment_bytes)
    mc = (MeshConfig.for_groups(cfg, peer_shards=1, device=device)
          if group_shards <= 0
          else MeshConfig(peer_shards=1, group_shards=group_shards))
    mc.validate(cfg)
    logging.getLogger("raftsql.server").info(
        "pod deployment: host %d/%d, %d groups over %d shards, "
        "coordinator %s%s", pod_id, pod.procs, groups, mc.group_shards,
        pod_coord or "(local)",
        ", one program over a process group" if dist else "")
    if dist:
        pod.init_distributed(device=device, backend=dist_backend or None)
    try:
        owned = pod.owned_shards(mc.group_shards) if dist else None
        node = PodClusterNode(pod, cfg, f"{data_prefix}-pod{pod_id}",
                              mc.build(device=device, owned=owned),
                              distributed=dist)
    except BaseException:
        if dist:
            pod.destroy_distributed()
        raise
    if trace:
        node.enable_tracing()
    node.start(interval_s=max(tick, 0.0005))
    pipe = FusedPipe(node)
    owned = {int(g) for g in node.owned_groups()}
    db_dir = f"{data_prefix}-pod{pod_id}-db"

    def sm_factory(g: int) -> SQLiteStateMachine:
        if g not in owned:
            # Replicated compute applies every group on every host, but
            # this host is not the durable authority for g: fold into a
            # throwaway in-memory replica (keeps watermarks and status
            # truthful for /healthz); reads and writes for g are
            # owner-served (PodRaftDB), so no file may exist here.
            return SQLiteStateMachine(":memory:", resume=False)
        os.makedirs(db_dir, exist_ok=True)
        return SQLiteStateMachine(os.path.join(db_dir, f"g{g}.db"),
                                  resume=resume)

    return PodRaftDB(sm_factory, pipe, num_groups=groups, resume=resume,
                     compact_every=compact_every,
                     compact_keep=compact_keep)


def attach_placement(rdb: RaftDB, interval_s: float = 0.5,
                     imbalance: float = 2.0):
    """--placement: start the traffic-aware leadership controller
    (raftsql_tpu_torch/placement/) over the co-located (fused or mesh)
    host plane's traffic feed and transfer latch; GET /metrics then carries its gauges.
    Returns the controller (stop() ends its thread)."""
    from raftsql_tpu_torch.placement import PlacementController
    pc = PlacementController(rdb.pipe.node, interval_s=interval_s,
                             imbalance=imbalance)
    rdb.placement = pc
    pc.start()
    return pc


def attach_reshard(rdb: RaftDB, nslots: int = 64,
                   ship_dir: str | None = None):
    """--reshard: start the elastic-keyspace plane
    (raftsql_tpu_torch/reshard/plane.py) over `rdb`; it recovers the
    journal fold, then drives its coordinator thread.  MIGRATE ships
    images into `ship_dir` (default reshard-ship/ in the working
    directory, beside the data dirs).  With placement attached, the
    split-hottest / merge-coldest verbs ride the controller.  Returns
    the plane (stop() ends its thread)."""
    from raftsql_tpu_torch.reshard.plane import ReshardPlane
    plane = ReshardPlane(rdb, nslots=nslots, ship_dir=ship_dir)
    plane.start()
    if rdb.placement is not None:
        rdb.placement.reshard = plane
    return plane


# Exit code for "the consensus engine failed" (unrecoverable WAL fsync,
# injected ENOSPC): a server that can no longer participate must crash,
# visibly, rather than keep answering HTTP with a dead engine behind it.
EXIT_CODE_FATAL = 70


def _install_graceful_shutdown(rdb, srv_stop) -> threading.Event:
    """SIGTERM/SIGINT -> clean stop: stop the HTTP plane, then close the
    pipe (flushes and fsyncs the WALs, closes the state machines) and
    exit 0.  A second signal while the first shutdown runs hard-exits.
    Returns the event set once a shutdown started."""
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
    return fired


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="replicated SQL on the PyTorch/CUDA port")
    ap.add_argument("--cluster", default="http://127.0.0.1:9021",
                    help="comma separated cluster peers")
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
                         "tick (no --cluster/--id needed)")
    ap.add_argument("--peers", type=int, default=3,
                    help="with --fused/--mesh/--pod: peers per group")
    ap.add_argument("--device", default="cuda",
                    help="torch device the consensus state steps on "
                         "(default cuda; 'cpu' runs the plain versions)")
    ap.add_argument("--mesh", action="store_true",
                    help="single-process cluster stepped over a MESH of "
                         "shard slots (runtime/mesh.py): G split over "
                         "the 'groups' axis, per-shard WAL dirs + "
                         "publish workers + SQLite shards (no "
                         "--cluster/--id)")
    ap.add_argument("--group-shards", type=int, default=0,
                    help="with --mesh/--pod: shard slots on the groups "
                         "axis (0 = widest fit for the shard slots; "
                         "RAFTSQL_SHARD_SLOTS counts each device as N)")
    ap.add_argument("--peer-shards", type=int, default=1,
                    help="with --mesh: shard slots on the peers axis "
                         "(the message exchange then copies blocks "
                         "between shards)")
    ap.add_argument("--pod", action="store_true",
                    help="multi-host pod (raftsql_tpu_torch/pod/): this "
                         "process is ONE of --pod-procs hosts jointly "
                         "owning the cluster: replicated device step, "
                         "durability sharded by group shard, one "
                         "cross-host collective per tick.  Boot blocks "
                         "until every host joins; a lost host is "
                         "pod-wide fail-stop (restart the whole pod)")
    ap.add_argument("--pod-procs", type=int, default=1,
                    help="with --pod: total host processes in the pod "
                         "(overridden by the length of --pod-hosts)")
    ap.add_argument("--pod-id", type=int, default=0,
                    help="with --pod: this host (0-based; 0 runs the "
                         "collective coordinator)")
    ap.add_argument("--pod-coord", default="",
                    help="with --pod: host:port the pod collective "
                         "coordinator (host 0) listens on")
    ap.add_argument("--pod-dist-backend", default="",
                    choices=("", "nccl", "gloo"),
                    help="with --pod and RAFTSQL_POD_JAX_DISTRIBUTED=1: "
                         "the process group's backend (default nccl on a "
                         "card, gloo on the CPU; gloo on a card runs "
                         "several hosts on one card)")
    ap.add_argument("--pod-hosts", default="",
                    help="with --pod: comma separated host:port HTTP "
                         "addresses of EVERY pod host in --pod-id order, "
                         "published at /healthz so a client pointed at "
                         "one host sweeps the whole pod")
    ap.add_argument("--workers", type=int, default=0,
                    help="N HTTP worker PROCESSES sharing this engine "
                         "through mmap propose/completion rings "
                         "(runtime/ring.py), all binding --port via "
                         "SO_REUSEPORT; only the engine holds the card.  "
                         "0 = serve HTTP in-process")
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
    ap.add_argument("--reshard", action="store_true",
                    help="elastic keyspace (raftsql_tpu_torch/reshard/): "
                         "a coordinator thread executes SPLIT / MERGE / "
                         "MIGRATE verbs (POST /reshard) journaled "
                         "through the raft logs, and the keyed "
                         "PUT/GET /kv/<key> surface routes by the "
                         "versioned hash-slot keymap (clients fail "
                         "closed on X-Raft-Keymap-Epoch mismatch)")
    ap.add_argument("--reshard-nslots", type=int, default=64,
                    help="hash slots in the key->group map (crc32 "
                         "%% nslots; fixed for the cluster's life)")
    ap.add_argument("--replica-listen", type=int, default=0,
                    help="publish the read-replica delta stream on "
                         "this TCP port (raftsql_tpu_torch/replica/): "
                         "replicas subscribe with `python -m "
                         "raftsql_tpu_torch.replica --upstream "
                         "host:PORT`; 0 = off")
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
    geometry = (args.write_quorum is not None
                or args.election_quorum is not None or args.witness)
    if args.pod:
        if geometry:
            ap.error("--write-quorum/--election-quorum/--witness are "
                     "not supported with --pod (the pod extends the "
                     "mesh runtime, which refuses them too)")
        if args.mesh or args.fused:
            ap.error("--pod is its own deployment; drop --mesh/--fused")
        if args.placement or args.reshard or args.workers:
            # Replicated controllers: N hosts each running a placement/
            # reshard controller would issue the same verbs N times;
            # the ring worker plane has no pod story yet.
            ap.error("--placement/--reshard/--workers are not "
                     "supported with --pod yet")
        if args.replica_listen:
            ap.error("--replica-listen is not supported with --pod yet "
                     "(the stream tee rides the single-engine shm "
                     "publisher)")
    elif args.mesh and geometry:
        # The mesh runtime shards the GROUP axis; its geometry plumbing
        # is untested: refuse rather than boot a cluster whose quorums
        # silently differ from the flags.
        ap.error("--write-quorum/--election-quorum/--witness are not "
                 "supported with --mesh (use --fused or the "
                 "multi-process deployment)")
    if args.overload_cap or args.overload_group_cap \
            or args.brownout_hi is not None:
        if not (args.fused or args.mesh):
            ap.error("--overload-cap/--overload-group-cap/--brownout-* "
                     "require --fused or --mesh (the co-located runtimes "
                     "own the propose queues)")
    if args.placement and not (args.fused or args.mesh):
        ap.error("--placement requires --fused or --mesh (the "
                 "co-located runtimes own the traffic feed)")
    from raftsql_tpu_torch.storage import fsio
    fsio.install_from_env()
    sys.setswitchinterval(
        float(os.environ.get("RAFTSQL_GIL_SWITCH_S", "0.001")))
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.pod:
        pod_hosts = tuple(h for h in args.pod_hosts.split(",") if h)
        rdb = build_pod_node(groups=args.groups, peers=args.peers,
                             tick=args.tick,
                             group_shards=args.group_shards,
                             pod_procs=(len(pod_hosts) or args.pod_procs),
                             pod_id=args.pod_id,
                             pod_coord=args.pod_coord,
                             pod_hosts=pod_hosts,
                             resume=args.resume,
                             compact_every=args.compact_every,
                             compact_keep=args.compact_keep,
                             wal_segment_bytes=args.wal_segment_bytes,
                             trace=args.trace, device=args.device,
                             dist_backend=args.pod_dist_backend)
    elif args.mesh:
        rdb = build_mesh_node(groups=args.groups, peers=args.peers,
                              tick=args.tick,
                              group_shards=args.group_shards,
                              peer_shards=args.peer_shards,
                              resume=args.resume,
                              compact_every=args.compact_every,
                              compact_keep=args.compact_keep,
                              wal_segment_bytes=args.wal_segment_bytes,
                               trace=args.trace, device=args.device)
    elif args.fused:
        rdb = build_fused_node(groups=args.groups, peers=args.peers,
                               tick=args.tick, resume=args.resume,
                               compact_every=args.compact_every,
                               compact_keep=args.compact_keep,
                               wal_segment_bytes=args.wal_segment_bytes,
                               wal_group_commit=args.wal_group_commit
                               == "on",
                               lease_ticks=args.lease_ticks,
                               max_clock_skew=args.max_clock_skew,
                               write_quorum=args.write_quorum,
                               election_quorum=args.election_quorum,
                               witnesses=tuple(args.witness),
                                 trace=args.trace,
                               device=args.device)
    else:
        rdb = build_node(args.cluster, args.id, groups=args.groups,
                         tick=args.tick, resume=args.resume,
                         compact_every=args.compact_every,
                         compact_keep=args.compact_keep,
                         wal_segment_bytes=args.wal_segment_bytes,
                         trace=args.trace,
                         lease_ticks=args.lease_ticks,
                         max_clock_skew=args.max_clock_skew,
                         write_quorum=args.write_quorum,
                         election_quorum=args.election_quorum,
                         witnesses=tuple(args.witness),
                         device=args.device)
    _watch_fatal(rdb)
    node = rdb.pipe.node
    wals = node.wals if (args.fused or args.mesh or args.pod) \
        else [node.wal]
    logging.getLogger("raftsql.server").info(
        "WAL backend: %s", "native" if all(w.is_native for w in wals)
        else "python")
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
    if args.reshard:
        attach_reshard(rdb, nslots=args.reshard_nslots)
    if args.workers > 0:
        _serve_workers(rdb, args)    # replica plane attaches there,
        return                       # reusing the ring's shm publisher
    if args.replica_listen:
        from raftsql_tpu_torch.replica.publisher import \
            attach_replica_plane
        attach_replica_plane(rdb, args.replica_listen)
    if args.http_engine == "aio":
        from raftsql_tpu_torch.api.aio import AioSQLServer
        srv = AioSQLServer(args.port, rdb)
    else:
        srv = SQLServer(args.port, rdb)
    stopping = _install_graceful_shutdown(rdb, srv.stop)
    srv.serve_forever()
    # Stopping the HTTP plane returns serve_forever while the shutdown
    # thread still closes the engine.  The main thread must not return
    # meanwhile: interpreter shutdown runs concurrent.futures' exit hook,
    # which stops every thread pool (the WAL sync pool among them) under
    # the engine's last ticks, and the engine then fails (exit 70 instead
    # of 0; seen on the card with --mesh).  The shutdown thread exits.
    while stopping.is_set():
        time.sleep(1.0)



def spawn_worker(ring_dir: str, index: int, port: int,
                 trace: bool = False, verbose: bool = False,
                 log_file=None) -> "subprocess.Popen":
    """One HTTP worker process (server/worker.py) over the rings in
    `ring_dir`, bound to `port` with SO_REUSEPORT, its output to
    `log_file` (an open file; default this process's).  The worker never
    sees the card (CUDA_VISIBLE_DEVICES=""), and it asks for SIGTERM at
    this process's death itself (`--engine-pid`): no `preexec_fn`, which
    is unsafe in a process running a tick thread and a CUDA context."""
    import subprocess
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    return subprocess.Popen(
        [sys.executable, "-m", "raftsql_tpu_torch.server.worker",
         "--rings", ring_dir, "--index", str(index), "--port", str(port),
         "--engine-pid", str(os.getpid())]
        + (["--trace"] if trace else [])
        + (["--verbose"] if verbose else []),
        env=env, stdout=log_file,
        stderr=None if log_file is None else subprocess.STDOUT)


def stop_workers(procs, timeout_s: float = 5.0) -> None:
    """SIGTERM every live worker, then SIGKILL any still up after
    `timeout_s`."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=timeout_s)
        except Exception:                               # noqa: BLE001
            p.kill()
            p.wait()


def _serve_workers(rdb, args) -> None:
    """The --workers N deployment: this process runs ONLY the engine
    (consensus tick + WAL + SQLite apply) and the ring drain
    (runtime/ring.py RingServer); N child processes each run the
    asyncio HTTP plane over a RingClient, all bound to --port via
    SO_REUSEPORT.  HTTP parsing/ack serialization then spends other
    GILs, not the engine's.  The ring directory is relative to the
    working directory, as in the JAX package.

    A worker that dies is respawned (it holds no state); the engine
    dying is fatal for everyone (EXIT_CODE_FATAL via _watch_fatal)."""
    from raftsql_tpu_torch.runtime.ring import RingServer

    log = logging.getLogger("raftsql.server")
    ring_dir = f"raftsql-rings-{os.getpid()}"
    ring = RingServer(rdb, ring_dir, args.workers)
    ring.start()
    if getattr(args, "replica_listen", 0):
        # The ring attached the shm publisher already; the stream tee
        # rides the same one (replica/publisher.py reuses rdb.shm).
        from raftsql_tpu_torch.replica.publisher import \
            attach_replica_plane
        attach_replica_plane(rdb, args.replica_listen)

    def spawn(i: int):
        return spawn_worker(ring_dir, i, args.port, trace=args.trace,
                            verbose=args.verbose)

    procs = [spawn(i) for i in range(args.workers)]
    stopping = threading.Event()

    def _stop_all():
        stopping.set()
        stop_workers(procs)
        ring.stop()

    _install_graceful_shutdown(rdb, _stop_all)
    log.info("engine up; %d HTTP workers on port %d (rings in %s)",
             args.workers, args.port, ring_dir)
    while True:
        for i, p in enumerate(procs):
            rc = p.poll()
            if rc is not None and not stopping.is_set():
                log.warning("worker %d exited rc=%s; respawning", i, rc)
                procs[i] = spawn(i)
        time.sleep(0.5)


if __name__ == "__main__":
    main()
