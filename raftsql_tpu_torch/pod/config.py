"""PodConfig — the declarative description of a multi-host pod.

Port of raftsql_tpu/pod/config.py.  By default every host of the pod
steps the whole global program (pod/node.py, the replicated default)
and no process group exists.  The opt-in, `init_distributed`, is the
JAX package's `jax.distributed.initialize`: it forms one
torch.distributed process group over the pod's hosts, after which each
host steps only the group shards it owns and one all-gather a tick
hands every host the whole step (parallel/sharded.py
`make_distributed_cluster_step_host`).  The --pod server and the dry
run (pod/dryrun.py) take it when RAFTSQL_POD_JAX_DISTRIBUTED=1, the JAX
package's variable, kept so that a deployment's environment means the
same in both.

A pod is N host processes that jointly own one cluster: process i owns
a subset of the group shards (its WAL dirs + its SQLite files), every
process runs the same device program, and a per-tick collective keeps
the processes lockstepped (pod/transport.py).  The config is frozen
and pure data so every process — and the chaos nemesis that respawns
processes — can reconstruct the identical pod from (procs, proc_id,
coordinator) alone.

Shard ownership is round-robin over the group-shard axis
(`owner(j) = j % procs`): any procs <= group_shards layout works, the
assignment is a pure function of the two counts, and a host's owned
blocks interleave with its peers' so a host loss degrades every region
of the keyspace a little instead of one region entirely.

`PODMETA` (written next to the mesh runtime's `MESHMETA`) pins the
assignment a data dir was written under: a host restarted with a shard
assignment that disagrees with its on-disk layout is REFUSED, the
cross-host analogue of the mesh re-shard refusal — adopting another
host's dirs silently would double-own groups and fork history.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

POD_META = "PODMETA"
# The opt-in's environment variable (server/main.py --pod, pod/dryrun.py).
POD_DISTRIBUTED_ENV = "RAFTSQL_POD_JAX_DISTRIBUTED"


@dataclasses.dataclass(frozen=True)
class PodConfig:
    """One pod process's view of the whole pod.

    procs        total host processes in the pod
    proc_id      this process (0-based; 0 is the collective coordinator)
    coordinator  "host:port" the coordinator listens on ("" = in-process
                 LocalPodTransport, only valid for procs == 1)
    hosts        optional HTTP base URLs of every pod host, in proc_id
                 order — the routing table /healthz exports so a client
                 pointed at any one host can sweep the whole pod
    """

    procs: int = 1
    proc_id: int = 0
    coordinator: str = ""
    hosts: Tuple[str, ...] = ()

    def __post_init__(self) -> None:
        if self.procs <= 0:
            raise ValueError(f"pod needs >= 1 process, got {self.procs}")
        if not 0 <= self.proc_id < self.procs:
            raise ValueError(f"proc_id {self.proc_id} outside pod of "
                             f"{self.procs}")
        if self.procs > 1 and not self.coordinator:
            raise ValueError("a multi-process pod needs a coordinator "
                             "address (host:port)")
        if self.hosts and len(self.hosts) != self.procs:
            raise ValueError(f"hosts table has {len(self.hosts)} "
                             f"entries for {self.procs} processes")

    @property
    def is_coordinator(self) -> bool:
        return self.proc_id == 0

    def validate(self, group_shards: int) -> None:
        if self.procs > group_shards:
            raise ValueError(
                f"pod of {self.procs} processes over {group_shards} "
                "group shards: every process must own >= 1 shard")

    def shard_owner(self, shard: int) -> int:
        return shard % self.procs

    def owned_shards(self, group_shards: int) -> List[int]:
        return [j for j in range(group_shards)
                if self.shard_owner(j) == self.proc_id]

    def seq_origin(self, seq: int) -> int:
        """Which process originated a pod-global proposal sequence
        number (origin-strided allocation: origin + k * procs)."""
        return seq % self.procs

    # -- the process group (the one program over hosts) ----------------

    def distributed_address(self) -> str:
        """The process group's rendezvous: `tcp://host:port+1` for the
        coordinator `host:port`.  A pure function of the config, so a
        respawned process (the chaos nemesis rebuilds a pod from
        (procs, proc_id, coordinator)) finds it again; one port above
        the coordinator's, which pod/transport.py TcpPodTransport
        binds."""
        if not self.coordinator:
            raise ValueError("the distributed pod needs a coordinator "
                             "address (host:port): its process group "
                             "meets at the port above it")
        host, _, port = self.coordinator.rpartition(":")
        return f"tcp://{host}:{int(port) + 1}"

    def init_distributed(self, device="cuda", backend=None,
                         timeout_s: float = 600.0) -> str:
        """Form the pod's torch.distributed process group: world size
        `procs`, rank `proc_id`, meeting at `distributed_address()`.
        Returns the backend.

        The backend follows `device`: NCCL for a CUDA device, gloo for
        the CPU.  `backend="gloo"` with a CUDA device is allowed, and
        exists only because NCCL refuses two ranks on one card: it lets
        a pod of several processes on one card (chip_smoke.py) run the
        distributed step, the collective staged through host memory.
        NCCL without a card raises; nothing falls back from NCCL to
        gloo, or from the card to the CPU.  A collective that waits
        longer than `timeout_s` raises (a lost host)."""
        import datetime

        import torch
        import torch.distributed as dist

        from raftsql_tpu_torch.core.state import resolve_device
        dev = torch.device(device)
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend {backend!r}: nccl or gloo")
        if backend == "nccl" and (dev.type != "cuda"
                                  or not torch.cuda.is_available()
                                  or not dist.is_nccl_available()):
            raise RuntimeError(f"NCCL asked for on {dev} without a CUDA "
                               "card (torch.cuda.is_available() is "
                               f"{torch.cuda.is_available()})")
        resolve_device(dev)                   # a CUDA device needs a card
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)        # NCCL's card for this rank
        if dist.is_initialized():
            raise RuntimeError("this process already has a process group")
        dist.init_process_group(
            backend, init_method=self.distributed_address(),
            world_size=self.procs, rank=self.proc_id,
            timeout=datetime.timedelta(seconds=timeout_s))
        return backend

    def rank_group(self, group_shards: int):
        """The parallel/sharded.py RankGroup of this pod over
        `group_shards`: shard j's owner is shard_owner(j).  Needs the
        process group of init_distributed, of this pod's shape."""
        import torch.distributed as dist

        from raftsql_tpu_torch.parallel.sharded import RankGroup
        if not dist.is_initialized():
            raise RuntimeError("no process group: call init_distributed "
                               "first")
        if (dist.get_world_size(), dist.get_rank()) != (self.procs,
                                                       self.proc_id):
            raise ValueError(
                f"process group rank {dist.get_rank()} of "
                f"{dist.get_world_size()} is not pod host {self.proc_id} "
                f"of {self.procs}")
        self.validate(group_shards)
        return RankGroup([self.shard_owner(j) for j in range(group_shards)],
                         self.proc_id)

    @staticmethod
    def destroy_distributed() -> None:
        """Leave the process group, if this process is in one."""
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()

    # -- PODMETA --------------------------------------------------------

    def meta_doc(self, group_shards: int) -> dict:
        return {"procs": self.procs, "proc_id": self.proc_id,
                "group_shards": group_shards,
                "owned": self.owned_shards(group_shards)}

    def check_meta(self, data_dir: str, group_shards: int) -> None:
        """Refuse a data dir written under a different pod shard
        assignment: the per-shard WAL layout on THIS host holds exactly
        the groups this process owned when the records were written, so
        a changed assignment would silently drop (or double-own) group
        histories across hosts.  Same contract as MESHMETA, one level
        up the hierarchy."""
        os.makedirs(data_dir, exist_ok=True)
        path = os.path.join(data_dir, POD_META)
        doc = self.meta_doc(group_shards)
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as f:
                meta = json.load(f)
            if meta != doc:
                raise ValueError(
                    f"{data_dir}: written under pod assignment {meta}, "
                    f"opened with {doc} — changing a host's shard "
                    "assignment over an existing data dir is "
                    "unsupported; use a fresh dir (or the original "
                    "assignment)")
        else:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(doc, f)

    @staticmethod
    def read_meta(data_dir: str) -> Optional[dict]:
        path = os.path.join(data_dir, POD_META)
        if not os.path.exists(path):
            return None
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
