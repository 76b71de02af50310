"""PodClusterNode — the hostplane tick run by N processes at once.

Port of raftsql_tpu/pod/node.py.  Execution model: every pod process
runs the IDENTICAL global device program over its own mesh (each host
a single controller over its shard slots, parallel/sharded.py):
replicated compute, where each controller issues the same program and
per-host behavior differs only in which slice of the OUTPUT it takes
responsibility for.  Here the per-host slice is the DURABLE plane:

  * compute is replicated — every host holds the full [P, G] device
    state and steps it identically, so `_hard` / `_hints` / `_applied`
    agree bit-for-bit across hosts (and with a single-controller
    MeshClusterNode on the same schedule, the equivalence tier-1 tests
    pin in tests/test_torch_pod.py);
  * durability is sharded — PodShardedWAL materializes WAL directories
    only for the group shards this process OWNS (PodConfig round-robin
    assignment) and absorbs writes for the rest, so each group's whole
    P-peer history lives on exactly one host and the pod's aggregate
    fsync bandwidth scales with hosts;
  * the planes that cross hosts ride ONE per-tick collective
    (pod/transport.py): proposals accepted on any host are all-gathered
    and merged in pod-global sequence order before the dispatch (so
    every host proposes the same batch in the same order — the
    replicated trajectories cannot diverge), the owning host's
    durable-commit acks ride back, and the gather itself is the tick +
    fsync barrier (a host only joins collective t+1 after its durable
    phase for t completed).

Why a group's peers are NOT split across hosts: the P peer rows of one
group form one raft instance whose per-tick messages assume every
sender's WAL fsync preceded the receive (the hostplane contract).
With peer rows on different hosts, a mixed restart (host A at tick t,
host B at tick t-1) would resurrect a half-erased dispatch.  Keeping a
group's peer rows in one host's WAL makes per-group durability
single-host atomic — groups are independent raft instances, so
sharding BY GROUP loses nothing.

Restart model: fail-stop and pod-wide (transport docstring).  At boot
every host replays the shards it owns from local disk, and the pod
all-gathers the serialized GroupLogs so each host rebuilds the FULL
replicated image — the cross-host analogue of ShardedWAL's merged
replay, with the same wrong-shard refusal plus the PODMETA assignment
check (pod/config.py).

Overlap is disabled on the pod (`self._overlap = False`): the
collective is the pipeline barrier, and stashing a durable phase past
it would let this host's disk lag a dispatch other hosts already
observed — exactly the hazard the barrier exists to exclude.
"""
from __future__ import annotations

import base64
import json
import os
import threading
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from raftsql_tpu_torch.config import RaftConfig
from raftsql_tpu_torch.parallel.sharded import GROUPS_AXIS
from raftsql_tpu_torch.pod.config import PodConfig
from raftsql_tpu_torch.pod.transport import make_transport
from raftsql_tpu_torch.runtime.mesh import MeshClusterNode, ShardedWAL
from raftsql_tpu_torch.storage.wal import (DEFAULT_SEGMENT_BYTES, GroupLog,
                                     HardState, WAL, wal_exists)


class _NullShardWAL:
    """The write surface of a group shard OWNED BY ANOTHER POD HOST:
    absorbs every append/hardstate/fsync (that host is the durable
    authority for these groups) and replays nothing.  Keeping the
    surface identical to WAL lets ShardedWAL's routing stay oblivious
    to ownership."""

    def __init__(self) -> None:
        self.obs = None

    def append_ranges(self, groups, starts, counts, terms, datas) -> None:
        pass

    def set_hardstates(self, groups, terms, votes, commits) -> None:
        pass

    def set_conf(self, group, index, kind, voters, joint,
                 learners) -> None:
        pass

    def epoch_mark(self, no, end) -> None:
        pass

    def sync(self) -> None:
        pass

    def compact(self, floors, hard) -> int:
        return 0

    def close(self) -> None:
        pass


class PodShardedWAL(ShardedWAL):
    """ShardedWAL with per-host ownership: real WAL directories for the
    shards this process owns, null sinks for the rest.  Same routed
    write surface, same per-shard replay/repair (which simply never
    find non-owned directories on this host's disk)."""

    def __init__(self, dirname: str, num_shards: int,
                 groups_per_shard: int, owned,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES):
        self.dirname = dirname
        self.num_shards = num_shards
        self._gl = groups_per_shard
        self.owned = frozenset(owned)
        dirs = self.shard_dirs(dirname, num_shards)
        self.shards = [WAL(dirs[j], segment_bytes=segment_bytes)
                       if j in self.owned else _NullShardWAL()
                       for j in range(num_shards)]
        self._lib = None        # no cross-shard combined native calls

    @property
    def obs(self):
        for s in self.shards:
            if not isinstance(s, _NullShardWAL):
                return s.obs
        return None

    @obs.setter
    def obs(self, tracer) -> None:
        for s in self.shards:
            s.obs = tracer


# -- GroupLog wire form (the boot replay exchange) ----------------------

def encode_group_log(gl: GroupLog) -> dict:
    return {"h": [gl.hard.term, gl.hard.vote, gl.hard.commit],
            "s": gl.start, "st": gl.start_term,
            "c": list(gl.conf) if gl.conf is not None else None,
            "d": ([gl.dedup[0], [list(x) for x in gl.dedup[1]]]
                  if gl.dedup is not None else None),
            "e": [[t, base64.b64encode(d).decode()]
                  for (t, d) in gl.entries]}


def decode_group_log(doc: dict) -> GroupLog:
    gl = GroupLog(hard=HardState(*(int(x) for x in doc["h"])),
                  start=int(doc["s"]), start_term=int(doc["st"]))
    gl.entries = [(int(t), base64.b64decode(b)) for t, b in doc["e"]]
    if doc["c"] is not None:
        gl.conf = tuple(int(x) for x in doc["c"])
    if doc["d"] is not None:
        gl.dedup = (int(doc["d"][0]),
                    [(int(a), int(b)) for a, b in doc["d"][1]])
    return gl


class PodClusterNode(MeshClusterNode):
    """MeshClusterNode whose durable plane is one slice of a pod.

    Construction joins the pod (transport connect + replay exchange)
    and therefore BLOCKS until all `pod.procs` processes arrive — the
    pod is one program.  `transport` can be injected for tests; by
    default it is built from the PodConfig."""

    def __init__(self, pod: PodConfig, cfg: RaftConfig, data_dir: str,
                 mesh, transport=None, seed: Optional[int] = None,
                 connect_timeout_s: float = 30.0,
                 io_timeout_s: float = 600.0):
        gg = mesh.shape[GROUPS_AXIS]
        pod.validate(gg)
        if cfg.num_groups % gg:
            raise ValueError(f"num_groups {cfg.num_groups} not "
                             f"divisible by group shards {gg}")
        self.pod = pod
        self._pod_owned: Set[int] = set(pod.owned_shards(gg))
        pod.check_meta(data_dir, gg)
        self._pod_transport = transport if transport is not None \
            else make_transport(pod.procs, pod.proc_id, pod.coordinator,
                                connect_timeout_s=connect_timeout_s,
                                io_timeout_s=io_timeout_s)
        # Client-plane buffers: proposals offered on THIS host wait
        # here for the next collective; seqs are origin-strided so the
        # pod-global merge order is total without coordination.
        self._pod_mu = threading.Lock()
        self._pod_offers: List[Tuple[int, int, bytes]] = []  # raftlint: guarded-by=_pod_mu
        self._pod_acks_out: List[int] = []   # raftlint: guarded-by=_pod_mu
        self._pod_acked: Set[int] = set()    # raftlint: guarded-by=_pod_mu
        self._pod_seq = pod.proc_id
        # Boot replay exchange: local owned shards -> all-gather -> the
        # full per-peer-dir image, consumed through the hostplane
        # replay seams during super().__init__, then freed.
        g_loc = cfg.num_groups // gg
        self._pod_replay: Optional[Dict[str, Dict[int, GroupLog]]] = \
            self._pod_exchange_replay(cfg, data_dir, g_loc)
        super().__init__(cfg, data_dir, mesh, seed)
        self._pod_replay = None
        # The collective is the pipeline barrier: durable phase t must
        # complete before this host contributes gather t+1, so the
        # double-buffered stash (overlap) is disabled; tick() below
        # also retires any deferred publish before returning, so
        # in-memory == durable == published at every barrier.
        self._overlap = False

    # -- boot: the cross-host replay exchange ---------------------------

    def _pod_exchange_replay(self, cfg: RaftConfig, data_dir: str,
                             g_loc: int) -> Dict[str, Dict[int, GroupLog]]:
        contrib: Dict[str, Dict[str, dict]] = {}
        for p in range(cfg.num_peers):
            pd = os.path.join(data_dir, f"p{p + 1}")
            logs: Dict[int, GroupLog] = {}
            for j in sorted(self._pod_owned):
                sd = os.path.join(pd, f"s{j}")
                if not wal_exists(sd):
                    continue
                for g, gl in WAL.replay(sd).items():
                    if g // g_loc != j:
                        raise ValueError(
                            f"{pd}: group {g} replayed from shard {j} "
                            f"but belongs to shard {g // g_loc} — this "
                            "WAL was written under a different "
                            "group-shard count (re-sharding an "
                            "existing data dir is unsupported)")
                    logs[g] = gl
            if logs:
                contrib[str(p)] = {str(g): encode_group_log(gl)
                                   for g, gl in logs.items()}
        blob = json.dumps(contrib, sort_keys=True,
                          separators=(",", ":")).encode()
        parts = self._pod_transport.gather("replay", blob)
        merged: Dict[int, Dict[int, GroupLog]] = \
            {p: {} for p in range(cfg.num_peers)}
        for part in parts:
            if not part:
                continue
            doc = json.loads(part.decode())
            for ps, groups in doc.items():
                p = int(ps)
                for gs, gd in groups.items():
                    g = int(gs)
                    if g in merged[p]:
                        raise ValueError(
                            f"group {g} (peer {p + 1}) replayed by two "
                            "pod hosts — overlapping shard ownership; "
                            "the PODMETA assignment check should have "
                            "refused this layout")
                    merged[p][g] = decode_group_log(gd)
        return {os.path.join(data_dir, f"p{p + 1}"): merged[p]
                for p in range(cfg.num_peers)}

    # -- hostplane seams ------------------------------------------------

    def _new_wal(self, dirname: str) -> PodShardedWAL:
        return PodShardedWAL(dirname, self._gg, self._g_loc,
                             self._pod_owned,
                             segment_bytes=self.cfg.wal_segment_bytes)

    def _wal_exists(self, dirname: str) -> bool:
        if self._pod_replay is not None:
            return bool(self._pod_replay.get(dirname))
        return super()._wal_exists(dirname)

    def _wal_replay(self, dirname: str):
        if self._pod_replay is not None:
            return self._pod_replay.get(dirname, {})
        return super()._wal_replay(dirname)

    # (_wal_repair_epochs inherited: it walks this host's shard dirs
    # and repairs the ones that exist — non-owned shards have no local
    # directory.  The pod pins steps-per-dispatch to 1 via the mesh
    # runtime, so dispatch epoch framing is never written anyway.)

    # -- ownership ------------------------------------------------------

    def group_owner(self, group: int) -> int:
        """proc_id of the host that owns `group`'s durable plane (and
        therefore serves it — server/main.py PodRaftDB)."""
        return self.pod.shard_owner(group // self._g_loc)

    def owns_group(self, group: int) -> bool:
        return (group // self._g_loc) in self._pod_owned

    def owned_groups(self) -> np.ndarray:
        if not self._pod_owned:
            return np.zeros(0, np.int64)
        return np.concatenate(
            [np.arange(j * self._g_loc, (j + 1) * self._g_loc)
             for j in sorted(self._pod_owned)])

    # -- client plane ----------------------------------------------------

    def pod_propose(self, group: int, payloads) -> List[int]:
        """Offer payloads to the pod and return their pod-global seqs
        (origin-strided).  They are proposed — on EVERY host, in seq
        order — at the next collective; the ack for a seq arrives via
        pod_take_acked() once the owning host's durable commit covered
        it."""
        seqs: List[int] = []
        with self._pod_mu:
            for d in payloads:
                seqs.append(self._pod_seq)
                self._pod_offers.append(
                    (self._pod_seq, int(group), bytes(d)))
                self._pod_seq += self.pod.procs
        self._work_evt.set()
        return seqs

    def propose_many(self, group: int, payloads,
                     deadline_step: Optional[int] = None) -> None:
        # `deadline_step` is FusedPipe.propose's overload-plane keyword;
        # the pod has no overload plane (server/main.py refuses
        # --overload-* with --pod), so it is always None here.  (The JAX
        # package's PodClusterNode lacks the keyword, and its --pod
        # server's HTTP writes fail on it.)
        self.pod_propose(group, payloads)

    def pod_send_ack(self, seqs) -> None:
        """Owner-side: queue durable-commit acks to ride the next
        collective back to their origins.  Callers (the dry-run driver,
        the --pod server) invoke this only AFTER the committed entry is
        covered by this host's fsync barrier — publish follows the
        barrier, so acking off the publish stream is sound."""
        seqs = list(seqs)
        with self._pod_mu:
            self._pod_acks_out.extend(int(s) for s in seqs)
        self.metrics.pod_acks_tx += len(seqs)

    def pod_take_acked(self) -> Set[int]:
        """Origin-side: drain the set of this host's seqs acked by
        their owners since the last call."""
        with self._pod_mu:
            out, self._pod_acked = self._pod_acked, set()
        return out

    # -- the pod tick ----------------------------------------------------

    def tick(self) -> None:
        import time as _t
        t0 = _t.monotonic()
        with self._pod_mu:
            offers, self._pod_offers = self._pod_offers, []
            acks, self._pod_acks_out = self._pod_acks_out, []
        doc = {"p": [[s, g, base64.b64encode(d).decode()]
                     for (s, g, d) in offers],
               "a": acks}
        blob = json.dumps(doc, sort_keys=True,
                          separators=(",", ":")).encode()
        parts = self._pod_transport.gather(f"tick:{self._tick_no}", blob)
        merged: List[Tuple[int, int, bytes]] = []
        for part in parts:
            if not part:
                continue
            d = json.loads(part.decode())
            merged.extend((int(s), int(g), base64.b64decode(b))
                          for s, g, b in d["p"])
            for s in d["a"]:
                if self.pod.seq_origin(int(s)) == self.pod.proc_id:
                    self.metrics.pod_acks_rx += 1
                    with self._pod_mu:
                        self._pod_acked.add(int(s))
        # Pod-global proposal order: seqs are origin-strided ints, so
        # sorting gives every host the identical propose sequence —
        # the replicated trajectories cannot diverge, and a
        # single-controller run feeding the same global order is
        # bit-equivalent (tests/test_pod.py pins it).
        merged.sort(key=lambda x: x[0])
        for s, g, data in merged:
            if self.pod.seq_origin(s) != self.pod.proc_id:
                self.metrics.pod_proposals_routed += 1
            super().propose_many(g, [data])
        self.metrics.pod_gathers += 1
        self.metrics.pod_gather_wait_ms += (_t.monotonic() - t0) * 1e3
        tr = self._pod_transport
        self.metrics.pod_bytes_tx = int(getattr(tr, "bytes_tx", 0))
        self.metrics.pod_bytes_rx = int(getattr(tr, "bytes_rx", 0))
        super().tick()
        # Drain the tick fully before the next collective: a serial
        # host's deferred publish (base-class dispatch overlap) would
        # otherwise externalize tick t's commits only during tick t+1,
        # after other hosts already advanced past the barrier.
        if self._pending_pinfo is not None:
            self._publish(self._pending_pinfo)
            self._pending_pinfo = None
        self.publish_flush()

    # -- observability ---------------------------------------------------

    def pod_doc(self) -> dict:
        """The /healthz + /metrics `pod` section: topology, ownership,
        and transport counters for THIS host."""
        tr = self._pod_transport
        return {"procs": self.pod.procs,
                "proc_id": self.pod.proc_id,
                "coordinator": self.pod.coordinator,
                "hosts": list(self.pod.hosts),
                "owned_shards": sorted(self._pod_owned),
                "owned_groups": len(self._pod_owned) * self._g_loc,
                "groups_per_shard": self._g_loc,
                "gathers": int(getattr(tr, "gathers", 0)),
                "bytes_tx": int(getattr(tr, "bytes_tx", 0)),
                "bytes_rx": int(getattr(tr, "bytes_rx", 0))}

    def stop(self) -> None:
        try:
            super().stop()
        finally:
            self._pod_transport.close()
