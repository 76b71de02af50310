"""PodConfig — the declarative description of a multi-host pod.

Port of raftsql_tpu/pod/config.py (pure Python).  The JAX package's
opt-in `init_distributed` (one jax.distributed program over every
host's devices) has no counterpart: the port's pod is the replicated
default, in which every host steps the whole global program and no
process group is needed.  ROADMAP Queue 1 keeps the opt-in last: its
process group would exchange shard blocks over NCCL between hosts'
cards, and one card cannot hold two ranks.

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
