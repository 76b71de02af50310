"""MeshClusterNode — the durable runtime over a mesh of shard devices.

Port of raftsql_tpu/runtime/mesh.py.  The per-tick consensus program is
the sharded step of parallel/sharded.py (G split over the `groups`
axis, the optional `peers` axis exchanging its messages by block
copies), while the durable host plane is sharded to match:

  * per-local-shard WAL dirs: each peer's log splits into one
    directory (one append stream and one fsync stream) per group shard
    (ShardedWAL below: data_dir/p<i>/s<j>);
  * per-shard publish workers: one ordered worker per group shard
    drains commits to the apply plane (ClusterHostPlane's publish
    seam);
  * per-shard state-machine placement: the server lays its SQLite
    files out under db/s<j>/ (server/main.py build_mesh_node).

The host phase itself (propose queues, WAL fsync barriers, commit
publish, membership apply-at-commit) is runtime/hostplane.py
ClusterHostPlane, shared with the single-device FusedClusterNode: the
two runtimes differ in `_device_step` and in where the cluster state
lives.  Here it lives as per-shard blocks (parallel/sharded.py
`Sharded`); the host plane's global view (`states`, `inboxes`) is
gathered on demand, once per tick at most, and a patch written through
it (membership, transfer) is laid back out over the mesh before the
next dispatch.

One process drives the whole mesh (the single-controller model), so
payload mirroring between peers stays a host-memory copy exactly as in
the fused runtime: only consensus math and message metadata are
sharded.  Per-peer clock skew is plumbed: the [P] timer advance splits
over the `peers` axis, so chaos SkewWindow schedules run on the mesh
exactly as on the fused runtime.

Testable without a card: RAFTSQL_SHARD_SLOTS=8 with device="cpu" gives
eight shard slots on the CPU (the JAX tests force eight host devices).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from raftsql_tpu_torch.config import RaftConfig
from raftsql_tpu_torch.parallel.sharded import (GROUPS_AXIS, PEERS_AXIS,
                                                inbox_specs, make_mesh,
                                                make_sharded_cluster_step_host,
                                                shard, shard_slots,
                                                state_specs)
from raftsql_tpu_torch.runtime.hostplane import ClusterHostPlane
from raftsql_tpu_torch.storage.wal import (DEFAULT_SEGMENT_BYTES, WAL,
                                           wal_exists)

MESH_META = "MESHMETA"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh description for the consensus runtime:
    `peer_shards x group_shards` shard slots arranged as the ('peers',
    'groups') mesh of parallel/sharded.py.  The group axis is the scale
    dimension; shard the peer axis only when one group's peers should
    span devices."""

    peer_shards: int = 1
    group_shards: int = 1

    def __post_init__(self) -> None:
        if self.peer_shards <= 0 or self.group_shards <= 0:
            raise ValueError(
                f"mesh axes must be positive, got "
                f"{self.peer_shards}x{self.group_shards}")

    @property
    def total_devices(self) -> int:
        return self.peer_shards * self.group_shards

    def validate(self, cfg: RaftConfig) -> None:
        if cfg.num_peers % self.peer_shards:
            raise ValueError(f"num_peers {cfg.num_peers} not divisible "
                             f"by peer shards {self.peer_shards}")
        if cfg.num_groups % self.group_shards:
            raise ValueError(f"num_groups {cfg.num_groups} not "
                             f"divisible by group shards "
                             f"{self.group_shards}")

    def build(self, devices=None, device="cuda"):
        """The Mesh over the first `total_devices` shard slots
        (`devices`, else parallel/sharded.py shard_slots(device))."""
        return make_mesh(self.peer_shards, self.group_shards,
                         devices=devices, device=device)

    @staticmethod
    def for_groups(cfg: RaftConfig, devices=None, peer_shards: int = 1,
                   device="cuda") -> "MeshConfig":
        """The widest groups-only mesh this process can run: the largest
        group-shard count that divides cfg.num_groups and fits the
        shard slots (after reserving `peer_shards` of them per group
        shard)."""
        n = len(shard_slots(device) if devices is None else devices)
        avail = max(1, n // peer_shards)
        gg = max(j for j in range(1, avail + 1)
                 if cfg.num_groups % j == 0)
        return MeshConfig(peer_shards=peer_shards, group_shards=gg)


class ShardedWAL:
    """A peer's durable log split per group shard.

    Implements the WAL surface the host plane writes through
    (append_ranges / set_hardstates / set_conf / sync / compact /
    close; epoch_mark refuses, see below), routing each group to the
    shard WAL that owns its block: group g lives in shard
    g // groups_per_shard, matching the mesh's block layout, so one
    directory holds exactly the groups one shard computes.  Each shard is a full storage/wal.py WAL (native by
    default, as everywhere in the port), so every durability property
    holds per shard; sync() syncs every dirty shard before returning.

    The combined native WAL+payload fast paths are per-directory and do
    not span shards: `_lib` is None, so wal_mirror_all and
    append_ranges_uniform take the shard-routed classic calls.
    """

    def __init__(self, dirname: str, num_shards: int,
                 groups_per_shard: int,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES):
        self.dirname = dirname
        self.num_shards = num_shards
        self._gl = groups_per_shard
        self.shards = [WAL(d, segment_bytes=segment_bytes)
                       for d in self.shard_dirs(dirname, num_shards)]
        self._lib = None        # no cross-shard combined native calls

    @property
    def is_native(self) -> bool:
        """Every shard's WAL runs on the native backend."""
        return all(s.is_native for s in self.shards
                   if hasattr(s, "is_native"))

    @staticmethod
    def shard_dirs(dirname: str, num_shards: int) -> List[str]:
        return [os.path.join(dirname, f"s{j}") for j in range(num_shards)]

    @classmethod
    def exists(cls, dirname: str, num_shards: int) -> bool:
        return any(wal_exists(d)
                   for d in cls.shard_dirs(dirname, num_shards))

    @classmethod
    def replay(cls, dirname: str, num_shards: int,
               groups_per_shard: int):
        """Merged per-group replay across every shard dir.  A group
        found in the wrong shard means the directory was written under a
        different group-shard count: re-sharding an existing data dir is
        unsupported, and fails loudly."""
        merged = {}
        for j, d in enumerate(cls.shard_dirs(dirname, num_shards)):
            if not wal_exists(d):
                continue
            for g, gl in WAL.replay(d).items():
                if g // groups_per_shard != j:
                    raise ValueError(
                        f"{dirname}: group {g} replayed from shard {j} "
                        f"but belongs to shard {g // groups_per_shard} "
                        "— this WAL was written under a different "
                        "group-shard count (re-sharding an existing "
                        "data dir is unsupported)")
                merged[g] = gl
        return merged

    @classmethod
    def repair_epochs(cls, dirname: str, committed: int,
                      num_shards: int) -> None:
        for d in cls.shard_dirs(dirname, num_shards):
            if wal_exists(d):
                WAL.repair_epochs(d, committed)

    # -- observability fan-out -----------------------------------------

    @property
    def obs(self):
        return self.shards[0].obs

    @obs.setter
    def obs(self, tracer) -> None:
        for s in self.shards:
            s.obs = tracer

    # -- routed write surface ------------------------------------------

    def _shard(self, group: int) -> WAL:
        return self.shards[group // self._gl]

    def append_ranges(self, groups, starts, counts, terms,
                      datas) -> None:
        by: Dict[int, Tuple[list, list, list, list, list]] = {}
        pos = 0
        for g, st, c, tm in zip(groups, starts, counts, terms):
            g = int(g)
            b = by.setdefault(g // self._gl, ([], [], [], [], []))
            b[0].append(g)
            b[1].append(st)
            b[2].append(c)
            b[3].append(tm)
            b[4].extend(datas[pos:pos + c])
            pos += c
        for j, b in by.items():
            self.shards[j].append_ranges(*b)

    def append_ranges_uniform(self, plog, groups, starts, counts, terms,
                              blob, lens) -> bool:
        # The combined WAL+payload native call is per-directory; the
        # caller falls back to append_ranges + plog.put_ranges.
        return False

    def set_hardstates(self, groups, terms, votes, commits) -> None:
        ga = np.asarray(groups)
        sh = ga // self._gl
        ta, va, ca = (np.asarray(terms), np.asarray(votes),
                      np.asarray(commits))
        for j in np.unique(sh):
            m = sh == j
            self.shards[int(j)].set_hardstates(ga[m], ta[m], va[m],
                                               ca[m])

    def set_conf(self, group: int, index: int, kind: int, voters: int,
                 joint: int, learners: int) -> None:
        self._shard(group).set_conf(group, index, kind, voters, joint,
                                    learners)

    def epoch_mark(self, no: int, end: bool) -> None:
        # The host plane frames only multi-step dispatches, and the mesh
        # runtime pins steps-per-dispatch to 1; a framed dispatch over
        # shards would need one commit point across the shard dirs.
        raise NotImplementedError(
            "ShardedWAL: multi-step dispatch framing is not supported "
            "(the mesh runtime runs one step per dispatch)")

    def sync(self) -> None:
        # Serial over shards: WAL.sync returns at once when a shard has
        # nothing pending, and the host plane already overlaps this
        # call across peers (its per-peer sync pool).
        for s in self.shards:
            s.sync()

    def compact(self, floors, hard) -> int:
        deleted = 0
        for j, s in enumerate(self.shards):
            fj = {g: v for g, v in floors.items() if g // self._gl == j}
            if not fj:
                continue
            hj = {g: v for g, v in hard.items() if g // self._gl == j}
            deleted += s.compact(fj, hj)
        return deleted

    def close(self) -> None:
        for s in self.shards:
            s.close()


class MeshClusterNode(ClusterHostPlane):
    """The durable runtime over a mesh of shard devices.

    Same host plane as FusedClusterNode (runtime/hostplane.py): WALs,
    payload mirroring, fsync-before-next-dispatch, publish; with three
    mesh-specific choices (module docstring): the sharded device step
    with the per-peer `timer_inc` split alongside, per-peer WALs split
    per group shard (ShardedWAL), and one publish worker per group
    shard.  The node's device is the mesh's shard (0, 0) device: where
    the packed info and the busy bit land for the one readback a step.
    """

    # The per-shard WAL layout supersedes the single-file group-commit
    # layout (each shard dir is its own append+fsync stream).  The
    # rotation hazard of the shared log (one worker syncing it while
    # another writes) cannot arise here: every peer and every shard has
    # a directory of its own.
    supports_group_commit = False

    def __init__(self, cfg: RaftConfig, data_dir: str, mesh,
                 seed: Optional[int] = None):
        gg = mesh.shape[GROUPS_AXIS]
        pp = mesh.shape[PEERS_AXIS]
        MeshConfig(peer_shards=pp, group_shards=gg).validate(cfg)
        self.mesh = mesh
        self._gg = gg
        self._g_loc = cfg.num_groups // gg
        # The cluster state: per-shard blocks (_st, _ib) and the host
        # plane's global view of them, gathered on demand (_st_view) and
        # laid back out before the next dispatch when written (_dirty).
        self._st = self._ib = None
        self._st_view = self._ib_view = None
        self._dirty = set()
        self._check_mesh_meta(data_dir, gg)
        super().__init__(cfg, data_dir, seed, group_commit=False,
                         device=mesh.devices[0][0])
        # The sharded step dispatches exactly one consensus step: pin
        # steps-per-dispatch so a RAFTSQL_FUSED_STEPS meant for the
        # single-device runtime cannot misreport the mesh's dispatch.
        self._steps = 1
        self._sharded_step = make_sharded_cluster_step_host(cfg, mesh)
        self._ti_ones = torch.ones((cfg.num_peers,), dtype=torch.int32,
                                   device=self.device)
        self._sync_blocks()

    # -- the cluster state: blocks and the host plane's global view -----

    @property
    def states(self):
        if self._st_view is None:
            self._st_view = self._st.gather()
        return self._st_view

    @states.setter
    def states(self, value) -> None:
        self._st_view = value
        self._dirty.add("states")

    @property
    def inboxes(self):
        if self._ib_view is None:
            self._ib_view = self._ib.gather()
        return self._ib_view

    @inboxes.setter
    def inboxes(self, value) -> None:
        self._ib_view = value
        self._dirty.add("inboxes")

    def _sync_blocks(self) -> None:
        """Lay each written global view back out over the mesh."""
        if "states" in self._dirty:
            self._st = shard(self.mesh, self._st_view, state_specs())
        if "inboxes" in self._dirty:
            self._ib = shard(self.mesh, self._ib_view, inbox_specs())
        self._dirty.clear()

    @staticmethod
    def _check_mesh_meta(data_dir: str, gg: int) -> None:
        """Refuse to open a data dir written under a different
        group-shard count: the per-shard WAL layout routes each group's
        records by the CURRENT shard count, so re-sharding in place
        would scatter one group's history across directories."""
        os.makedirs(data_dir, exist_ok=True)
        path = os.path.join(data_dir, MESH_META)
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as f:
                meta = json.load(f)
            if meta.get("group_shards") != gg:
                raise ValueError(
                    f"{data_dir}: written with group_shards="
                    f"{meta.get('group_shards')}, opened with {gg} — "
                    "re-sharding an existing data dir is unsupported; "
                    "use a fresh dir (or the original shard count)")
        else:
            with open(path, "w", encoding="utf-8") as f:
                json.dump({"group_shards": gg}, f)

    def enable_membership(self, initial_voters=None) -> None:
        # The sharded step captured the construction-time cfg; rebuild
        # it after the host plane leaves the static-full-voter fast path
        # (config.py dynamic_membership) so every shard's step reads the
        # masks membership will patch (K2 under commit_rule="pallas").
        super().enable_membership(initial_voters)
        self._sharded_step = make_sharded_cluster_step_host(self.cfg,
                                                            self.mesh)

    def _group_shard_of(self, group: int) -> int:
        """Which mesh group shard owns `group`: the `shard` column of
        the /metrics hot-groups table."""
        return group // self._g_loc

    # -- host-plane seams (runtime/hostplane.py) ------------------------

    def _new_wal(self, dirname: str) -> ShardedWAL:
        return ShardedWAL(dirname, self._gg, self._g_loc,
                          segment_bytes=self.cfg.wal_segment_bytes)

    def _wal_exists(self, dirname: str) -> bool:
        return ShardedWAL.exists(dirname, self._gg)

    def _wal_replay(self, dirname: str):
        return ShardedWAL.replay(dirname, self._gg, self._g_loc)

    def _wal_repair_epochs(self, dirname: str, committed: int) -> None:
        ShardedWAL.repair_epochs(dirname, committed, self._gg)

    def _pub_shard_groups(self) -> List[np.ndarray]:
        # One ordered publish worker per group shard, each owning the
        # shard's contiguous group block (disjoint by construction, so
        # per-group commit order is each worker's FIFO).
        return [np.arange(j * self._g_loc, (j + 1) * self._g_loc)
                for j in range(self._gg)]

    # -- the device step ------------------------------------------------

    def _device_step(self, prop_n: np.ndarray,
                     timer_inc: Optional[np.ndarray] = None):
        """One tick over the mesh.  `timer_inc` is the per-peer [P]
        timer advance (chaos skew schedules; None = lockstep), split
        over the `peers` axis so each peer block advances exactly its
        own peers' clocks, bit-identically to the fused step.  Returns
        (packed info [P, G, NCOLS] on the node's device, busy bit)."""
        self._sync_blocks()
        dev = self.device
        ti = self._ti_ones if timer_inc is None \
            else torch.as_tensor(np.asarray(timer_inc, np.int32),
                                 device=dev)
        # One host-to-device copy; the shards' blocks split on the card.
        pn = torch.as_tensor(np.asarray(prop_n, np.int32), device=dev)
        self._st, self._ib, pinfo_dev, busy = self._sharded_step(
            self._st, self._ib, pn, ti)
        self._st_view = self._ib_view = None
        return pinfo_dev, busy
