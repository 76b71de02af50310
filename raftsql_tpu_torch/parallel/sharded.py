"""The cluster step sharded over a mesh of shard devices, in PyTorch.

Port of raftsql_tpu/parallel/sharded.py (K7).  The JAX package lays the
whole multi-raft state onto a 2-D `jax.sharding.Mesh` and runs the
single-chip `peer_step` under `shard_map`:

  * ``groups`` axis: raft groups are independent, so sharding G needs
    no collective at all;
  * ``peers`` axis: when one group's peers live on different shards,
    the per-tick message exchange (the outbox's src->dst transpose)
    becomes a tiled ``all_to_all`` over the peers axis.

The port is single-controller: one Python process owns a `Mesh`, a
[pp, gg] grid of `torch.device`s, and drives every shard in turn.
Shard (i, j) holds the blocks [p_loc, G_loc, ...] of every PeerState
and Inbox leaf on its device (`Sharded`).  The per-shard program is the
port's own batched `core/step.py:peer_step` on the local block, with
`self_ids = i*p_loc + arange(p_loc)` and `group_offset = j*G_loc` (the
global group ids of the election jitter).  The tiled `all_to_all`
becomes block copies between shard devices: swap axes 0 and 2, split
the destination axis into pp blocks, copy block k to shard (k, j)'s
device, concatenate along the source axis in shard order.  `pmin`
over groups is a min over j and the busy `pmax` an OR over every
shard.  No copy goes through the host; where two shards share a
device, a block copy is a copy on that device.

The result is, leaf for leaf, the port's `core/cluster.py` step on the
concatenated state (tests/test_torch_parallel.py holds it to that and
to the JAX sharded step).  Under commit_rule="pallas" the quorum
kernel launches once per shard per step: pp x gg launches.

Over hosts (`make_distributed_cluster_step_host`).  The pod's opt-in
(pod/config.py `PodConfig.init_distributed`) runs one program over a
torch.distributed process group: every rank holds the blocks of only
the group shards it owns (`RankGroup.owner`, PodConfig.shard_owner),
steps those, and ONE all-gather a step carries the three cross-rank
parts of the tick: each rank's packed info of its owned shards (laid
back into global group order, since rank order is not shard order
under round-robin ownership), its timer_margin min over its shards and
its busy bit (the min and the OR are taken over the gathered words, the
all-reduce MIN and MAX of the JAX package's pmin/pmax).  Groups only:
the peers axis stays whole, so the message exchange needs no copy
between ranks.

Shard slots.  `make_mesh(pp, gg)` takes every visible device of the
requested kind, as `jax.devices()` does, and raises when there are
fewer than pp*gg.  RAFTSQL_SHARD_SLOTS=N (default 1) makes each
visible device (the card, or the CPU) count as N shard slots: the
port's counterpart of the JAX tests' forced host devices
(--xla_force_host_platform_device_count).  With the default, one card
gives one group shard, exactly as one TPU does in the JAX package.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from raftsql_tpu_torch.config import MSG_REQ, MSG_RESP, RaftConfig
from raftsql_tpu_torch.core.state import (I32, Inbox, PeerState, StepInfo,
                                          resolve_device)
from raftsql_tpu_torch.core.step import INFO_NCOLS, pack_info, peer_step

PEERS_AXIS = "peers"
GROUPS_AXIS = "groups"
SHARD_SLOTS_ENV = "RAFTSQL_SHARD_SLOTS"


class Mesh:
    """A ('peers', 'groups') grid of shard devices: `devices[i][j]` is
    where shard (i, j)'s blocks live (a device may repeat)."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        pp, gg = len(self.devices), len(self.devices[0])
        if any(len(row) != gg for row in self.devices):
            raise ValueError("mesh rows must have one length")
        self.shape = {PEERS_AXIS: pp, GROUPS_AXIS: gg}

    @property
    def size(self) -> int:
        return self.shape[PEERS_AXIS] * self.shape[GROUPS_AXIS]


def shard_slots(device="cuda") -> List[torch.device]:
    """Every shard slot this process sees: each visible device of the
    kind of `device` (every card for CUDA, else `device` itself),
    repeated RAFTSQL_SHARD_SLOTS times.  A missing card raises."""
    dev = resolve_device(device)
    n = int(os.environ.get(SHARD_SLOTS_ENV, "1"))
    if n < 1:
        raise ValueError(f"{SHARD_SLOTS_ENV}={n}: must be >= 1")
    base = ([torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
            if dev.type == "cuda" else [dev])
    return [d for d in base for _ in range(n)]


def make_mesh(n_peer_shards: int, n_group_shards: int,
              devices=None, device="cuda", columns=None) -> Mesh:
    """Build the ('peers', 'groups') mesh over the first pp*gg shard
    slots (`devices`, else shard_slots(device)).  With `columns` (the
    group shards this process holds, a distributed rank's owned
    shards) only those need slots: column `columns[k]` takes the k-th
    peer row of slots and every other column names the first slot,
    where nothing of it lives."""
    devices = shard_slots(device) if devices is None else list(devices)
    if columns is not None:
        cols = list(columns)
        need = n_peer_shards * len(cols)
        if len(devices) < need:
            raise ValueError(
                f"{len(cols)} owned group shards x {n_peer_shards} peer "
                f"shards need {need} devices, have {len(devices)} (set "
                f"{SHARD_SLOTS_ENV} to count each device as several "
                "shard slots)")
        return Mesh([[devices[i * len(cols) + cols.index(j)]
                      if j in cols else devices[0]
                      for j in range(n_group_shards)]
                     for i in range(n_peer_shards)])
    need = n_peer_shards * n_group_shards
    if len(devices) < need:
        raise ValueError(
            f"mesh {n_peer_shards}x{n_group_shards} needs {need} devices, "
            f"have {len(devices)} (set {SHARD_SLOTS_ENV} to count each "
            "device as several shard slots)")
    return Mesh([devices[i * n_group_shards:(i + 1) * n_group_shards]
                 for i in range(n_peer_shards)])


# ---------------------------------------------------------------------------
# Layouts: a spec names, per leading dimension, the mesh axis it is split
# over (None: replicated); trailing dimensions are replicated.

_S2 = (PEERS_AXIS, GROUPS_AXIS)
_S1 = (PEERS_AXIS,)


def state_specs() -> PeerState:
    """The spec tree of a stacked PeerState (leaves [P, G, ...]): the
    trailing peer axis of votes/match/next_idx is the message-slot axis
    and stays whole; rng and tick are split over peers only."""
    return PeerState(**{n: (_S1 if n in ("rng", "tick") else _S2)
                        for n in PeerState._fields})


def inbox_specs() -> Inbox:
    return Inbox(**{n: _S2 for n in Inbox._fields})


def info_specs() -> StepInfo:
    return StepInfo(**{n: (_S1 if n == "timer_margin" else _S2)
                       for n in StepInfo._fields})


def timer_spec() -> tuple:
    """The [P] per-peer timer advance: split with the owner-peer axis,
    replicated over groups."""
    return _S1


def _is_tree(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _split(x: torch.Tensor, spec: tuple, mesh: Mesh, i: int,
           j: int) -> torch.Tensor:
    """Shard (i, j)'s block of the global leaf `x`, on its device."""
    idx = []
    for d, ax in enumerate(spec):
        if ax is None:
            idx.append(slice(None))
            continue
        k = i if ax == PEERS_AXIS else j
        b = x.shape[d] // mesh.shape[ax]
        idx.append(slice(k * b, (k + 1) * b))
    return x[tuple(idx)].to(mesh.devices[i][j]).contiguous()


def _join(blocks, spec: tuple, mesh: Mesh,
          device: torch.device) -> torch.Tensor:
    """The global leaf from its per-shard blocks, on `device`."""
    pp, gg = mesh.shape[PEERS_AXIS], mesh.shape[GROUPS_AXIS]
    gdim = spec.index(GROUPS_AXIS) if GROUPS_AXIS in spec else None
    pdim = spec.index(PEERS_AXIS) if PEERS_AXIS in spec else None
    rows = []
    for i in range(pp if pdim is not None else 1):
        parts = [blocks[i][j].to(device)
                 for j in range(gg if gdim is not None else 1)]
        rows.append(torch.cat(parts, gdim) if len(parts) > 1 else parts[0])
    return torch.cat(rows, pdim) if len(rows) > 1 else rows[0]


class Sharded:
    """A tensor, or a NamedTuple of tensors, laid out over a mesh:
    `blocks[i][j]` is shard (i, j)'s local value, of the same type,
    each leaf on the shard's device; `specs` says how each leaf splits
    (a spec tuple, or a NamedTuple of them).  On a distributed rank a
    group shard this process does not hold has None blocks, and the
    value cannot be gathered here."""

    def __init__(self, mesh: Mesh, blocks, specs):
        self.mesh = mesh
        self.blocks = blocks
        self.specs = specs

    def gather(self, device=None):
        """The global value (a fresh copy), on `device` (default: shard
        (0, 0)'s device)."""
        if any(b is None for row in self.blocks for b in row):
            raise RuntimeError(
                "a distributed rank holds only its owned group shards: "
                "the global value lives on every rank together")
        dev = torch.device(device) if device is not None \
            else self.mesh.devices[0][0]
        b0 = self.blocks[0][0]
        if not _is_tree(b0):
            return _join(self.blocks, self.specs, self.mesh, dev)
        return type(b0)(*[
            _join([[getattr(blk, n) for blk in row] for row in self.blocks],
                  getattr(self.specs, n), self.mesh, dev)
            for n in b0._fields])


def shard(mesh: Mesh, value, specs, columns=None) -> Sharded:
    """Lay a global tensor (or NamedTuple of tensors, or numpy array)
    out over `mesh` by `specs`; with `columns`, only those group shards
    get blocks (a distributed rank's owned shards), the rest None."""
    pp, gg = mesh.shape[PEERS_AXIS], mesh.shape[GROUPS_AXIS]
    cols = set(range(gg) if columns is None else columns)
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(value)
    if _is_tree(value):
        blocks = [[type(value)(*[_split(x, s, mesh, i, j)
                                 for x, s in zip(value, specs)])
                   if j in cols else None
                   for j in range(gg)] for i in range(pp)]
    else:
        blocks = [[_split(value, specs, mesh, i, j) if j in cols else None
                   for j in range(gg)] for i in range(pp)]
    return Sharded(mesh, blocks, specs)


def _blocks(mesh: Mesh, x, spec, columns=None):
    """The per-shard blocks of `x`: a Sharded's own, else `x` (a global
    tensor or numpy array) split by `spec` (over `columns` only)."""
    return x.blocks if isinstance(x, Sharded) else \
        shard(mesh, x, spec, columns).blocks


def shard_cluster_arrays(mesh: Mesh, states: PeerState, inboxes: Inbox,
                         prop_n: Optional[torch.Tensor] = None):
    """Place host-built stacked state (and optional [P, G] proposals)
    onto the mesh with the right layout."""
    out = [shard(mesh, states, state_specs()),
           shard(mesh, inboxes, inbox_specs())]
    if prop_n is not None:
        out.append(shard(mesh, prop_n, _S2))
    return tuple(out)


def _route(outboxes, mesh: Mesh):
    """src->dst message exchange over the whole mesh.  Shard (i, j)'s
    outbox leaves are [p_loc(src), G_loc, P(dst global), ...]; the
    swapaxes is the on-device half of the permutation, and the tiled
    all_to_all's block copies hand shard (k, j) the destination block k
    of every source shard, concatenated along the source axis in shard
    order: [p_loc(dst), G_loc, P(src global), ...], the Inbox layout
    `peer_step` consumes.  With one peer shard this is core/cluster.py's
    `deliver` transpose (views, no copy), and a shard not computed here
    (None) stays None."""
    pp, gg = mesh.shape[PEERS_AXIS], mesh.shape[GROUPS_AXIS]
    swapped = [[Inbox(*[x.transpose(0, 2) for x in outboxes[i][j]])
                if outboxes[i][j] is not None else None
                for j in range(gg)] for i in range(pp)]
    if pp == 1:
        return swapped
    p_loc = swapped[0][0].v_type.shape[0] // pp
    out = [[None] * gg for _ in range(pp)]
    for k in range(pp):
        for j in range(gg):
            dev = mesh.devices[k][j]
            out[k][j] = Inbox(*[
                torch.cat([swapped[i][j][f][k * p_loc:(k + 1) * p_loc]
                           .to(dev) for i in range(pp)], 2)
                for f in range(len(Inbox._fields))])
    return out


def _validate(cfg: RaftConfig, mesh: Mesh) -> None:
    pp, gg = mesh.shape[PEERS_AXIS], mesh.shape[GROUPS_AXIS]
    if cfg.num_peers % pp:
        raise ValueError(f"num_peers {cfg.num_peers} not divisible by "
                         f"peer shards {pp}")
    if cfg.num_groups % gg:
        raise ValueError(f"num_groups {cfg.num_groups} not divisible by "
                         f"group shards {gg}")


def make_sharded_step_fn(cfg: RaftConfig, mesh: Mesh, columns=None):
    """The whole-mesh step over per-shard blocks (with `columns`, over
    those group shards only: a distributed rank's owned shards, the
    other blocks None in and out, and each info's timer_margin the min
    over `columns`).

    Validates divisibility, derives the per-shard config, and returns
    step(states, inboxes, prop_n, timer_inc) over block grids (each
    `[pp][gg]` lists): states [p_loc, G_loc, ...], inboxes [p_loc,
    G_loc, P, ...], prop_n [p_loc, G_loc], timer_inc [p_loc] (this peer
    block's slice of the global [P] per-peer timer advance, the skew
    seam core/cluster.py exposes).  Returns (states, delivered inboxes,
    infos) grids, each info's timer_margin already the min over the
    group shards."""
    _validate(cfg, mesh)
    pp, gg = mesh.shape[PEERS_AXIS], mesh.shape[GROUPS_AXIS]
    local_cfg = dataclasses.replace(cfg, num_groups=cfg.num_groups // gg)
    p_loc = cfg.num_peers // pp
    g_loc = local_cfg.num_groups
    cols = list(range(gg)) if columns is None else sorted(columns)
    if pp > 1 and len(cols) != gg:
        raise ValueError("a peer-sharded mesh steps every group shard "
                         "in one process")
    self_ids = [[torch.arange(i * p_loc, (i + 1) * p_loc, dtype=I32,
                              device=mesh.devices[i][j])
                 for j in range(gg)] for i in range(pp)]

    def _step(states, inboxes, prop_n, timer_inc):
        new_states = [[None] * gg for _ in range(pp)]
        outboxes = [[None] * gg for _ in range(pp)]
        infos = [[None] * gg for _ in range(pp)]
        for i in range(pp):
            for j in cols:
                new_states[i][j], outboxes[i][j], infos[i][j] = peer_step(
                    local_cfg, states[i][j], inboxes[i][j], prop_n[i][j],
                    self_ids[i][j], j * g_loc, timer_inc=timer_inc[i][j])
        delivered = _route(outboxes, mesh)
        # timer_margin is a per-(peer, group-shard) min; the host wants
        # the per-peer min over ALL groups (the JAX package's pmin over
        # the groups axis).
        for i in range(pp):
            d0 = mesh.devices[i][cols[0]]
            tm = infos[i][cols[0]].timer_margin
            for j in cols[1:]:
                tm = torch.minimum(tm, infos[i][j].timer_margin.to(d0))
            for j in cols:
                infos[i][j] = infos[i][j]._replace(
                    timer_margin=tm.to(mesh.devices[i][j]))
        return new_states, delivered, infos

    _step.p_loc = p_loc
    _step.ones = [[torch.ones((p_loc,), dtype=I32,
                              device=mesh.devices[i][j])
                   for j in range(gg)] for i in range(pp)]
    return _step


def make_sharded_cluster_step(cfg: RaftConfig, mesh: Mesh):
    """One whole-cluster LOCKSTEP tick over `mesh`.

    Returns fn(states, inboxes, prop_n) -> (states, inboxes, infos),
    every result a `Sharded` laid out by {state,inbox,info}_specs;
    `prop_n` is a Sharded [P, G] or a global tensor.  Timers advance 1
    per peer per tick; the durable mesh runtime uses
    `make_sharded_cluster_step_host`, which takes the per-peer vector."""
    step = make_sharded_step_fn(cfg, mesh)

    def _lockstep(states: Sharded, inboxes: Sharded, prop_n):
        st, ib, info = step(states.blocks, inboxes.blocks,
                            _blocks(mesh, prop_n, _S2), step.ones)
        return (Sharded(mesh, st, state_specs()),
                Sharded(mesh, ib, inbox_specs()),
                Sharded(mesh, info, info_specs()))

    return _lockstep


def _busy(ib: Inbox) -> torch.Tensor:
    return ((ib.v_type != 0).any()
            | ((ib.a_type == MSG_REQ) & (ib.a_n > 0)).any()
            | ((ib.a_type == MSG_RESP) & ~ib.a_success).any())


def make_sharded_cluster_step_host(cfg: RaftConfig, mesh: Mesh):
    """The sharded tick with single-tensor host info, for the durable
    mesh runtime (runtime/mesh.py MeshClusterNode): the same step as
    `make_sharded_cluster_step`, but StepInfo crosses to the host as
    ONE packed [P, G, INFO_NCOLS] int32 tensor in global order on shard
    (0, 0)'s device (core/step.py pack_info), so the host plane keeps
    one readback per step, not one per shard.

    Returns fn(states, inboxes, prop_n, timer_inc[P]) -> (states,
    inboxes, packed_info, busy).  `prop_n` [P, G] and `timer_inc` [P]
    are global tensors (or numpy arrays) or Sharded; `busy` is a 0-dim
    bool on shard (0, 0)'s device, the OR over every shard of vote
    traffic, entry-carrying appends and rejected append responses (the
    bit the fused runtime's idle parking keys on)."""
    step = make_sharded_step_fn(cfg, mesh)
    d0 = mesh.devices[0][0]

    def _step(states: Sharded, inboxes: Sharded, prop_n, timer_inc):
        st, ib, infos = step(states.blocks, inboxes.blocks,
                             _blocks(mesh, prop_n, _S2),
                             _blocks(mesh, timer_inc, timer_spec()))
        pinfo = _join([[pack_info(x) for x in row] for row in infos],
                      _S2, mesh, d0)
        busy = None
        for row in ib:
            for blk in row:
                b = _busy(blk).to(d0)
                busy = b if busy is None else busy | b
        return (Sharded(mesh, st, state_specs()),
                Sharded(mesh, ib, inbox_specs()), pinfo, busy)

    return _step


class RankGroup:
    """This process's place in the torch.distributed process group that
    steps one mesh together (the pod's opt-in, pod/config.py
    `PodConfig.init_distributed`).

    `owner[j]` is the rank that holds group shard j's blocks
    (PodConfig.shard_owner).  `all_gather` runs on the CPU under gloo,
    staging a CUDA tensor through host memory (the result stays there),
    and on the tensor's own card under NCCL.  `gathers` and `gather_s`
    count the collectives and their host wall time, staging copies
    excluded (under NCCL, the time to enqueue them)."""

    def __init__(self, owner: Sequence[int], rank: Optional[int] = None,
                 group=None):
        self.group = group
        self.procs = dist.get_world_size(group)
        self.rank = dist.get_rank(group) if rank is None else int(rank)
        self.backend = str(dist.get_backend(group))
        self.owner = [int(r) for r in owner]
        self.by_rank = [[j for j, r in enumerate(self.owner) if r == k]
                        for k in range(self.procs)]
        if any(not 0 <= r < self.procs for r in self.owner) \
                or not all(self.by_rank):
            raise ValueError(f"shard owners {self.owner} must name every "
                             f"rank of a group of {self.procs}, and only "
                             "those")
        self.owned = self.by_rank[self.rank]
        self.k_max = max(len(x) for x in self.by_rank)
        self.gathers = 0
        self.gather_s = 0.0

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (one shape and dtype on every rank), stacked
        in rank order: [procs, *t.shape]."""
        if self.backend == "gloo" and t.device.type != "cpu":
            t = t.to("cpu")
        t = t.contiguous()
        out = torch.empty((self.procs,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        t0 = time.perf_counter()
        dist.all_gather(list(out.unbind(0)), t, group=self.group)
        self.gather_s += time.perf_counter() - t0
        self.gathers += 1
        return out


class DistAux(NamedTuple):
    """What the distributed step gathers besides the packed info:
    `timer_margin` [P], the min over every group shard of the pod, and
    `ring_counts` [P, G, 2], per (peer, group) the delivered inbox's
    message slots in flight and the vote tally: the trace ring's two
    state-derived columns (obs/device_ring.py), which no rank could
    compute for groups it does not hold."""

    timer_margin: torch.Tensor
    ring_counts: torch.Tensor


def ring_counts(ib: Inbox, st: PeerState) -> torch.Tensor:
    """[..., G, 2] int32: inbox depth and vote tally per (peer, group),
    the device ring's `inbox_depth` and `votes` columns."""
    depth = (ib.v_type != 0).sum(-1) + (ib.a_type != 0).sum(-1)
    return torch.stack([depth.to(I32), st.votes.sum(-1).to(I32)], -1)


def make_distributed_cluster_step_host(cfg: RaftConfig, mesh: Mesh,
                                       ranks: RankGroup):
    """The sharded host step as one program over a process group: this
    rank steps only the group shards it owns (`ranks.owned`; K1 launches
    once per owned shard under commit_rule="pallas") and one all-gather
    hands every rank the whole step's outputs.

    Returns fn(states, inboxes, prop_n, timer_inc[P]) -> (states,
    inboxes, packed_info, busy, DistAux): states and inboxes are
    Sharded with blocks for the owned shards only; prop_n [P, G] and
    timer_inc [P] are global (every rank passes the same values);
    packed_info [P, G, INFO_NCOLS] int32 in global group order, busy a
    0-dim bool and DistAux are equal on every rank, and equal, leaf for
    leaf, to make_sharded_cluster_step_host's outputs (and the fused
    cluster_step_host's) on the concatenated state.  They lie on the
    collective's device: the CPU under gloo, the card under NCCL.

    Groups only: a peer-sharded mesh is refused (the pod always runs
    one peer shard, so `_route` stays on each rank)."""
    _validate(cfg, mesh)
    pp, gg = mesh.shape[PEERS_AXIS], mesh.shape[GROUPS_AXIS]
    if pp != 1:
        raise ValueError(f"the distributed step shards groups only: "
                         f"{pp} peer shards refused (use peer_shards=1)")
    if len(ranks.owner) != gg:
        raise ValueError(f"{len(ranks.owner)} shard owners for {gg} "
                         "group shards")
    owned = ranks.owned
    step = make_sharded_step_fn(cfg, mesh, columns=owned)
    P, g_loc = cfg.num_peers, cfg.num_groups // gg
    ncol = INFO_NCOLS + 2
    d0 = mesh.devices[0][owned[0]]
    n_blk = ranks.k_max * P * g_loc * ncol
    # Shard j is block k of rank r's contribution.
    where = [(ranks.owner[j], ranks.by_rank[ranks.owner[j]].index(j))
             for j in range(gg)]

    def _step(states: Sharded, inboxes: Sharded, prop_n, timer_inc):
        st, ib, infos = step(states.blocks, inboxes.blocks,
                             _blocks(mesh, prop_n, _S2, owned),
                             _blocks(mesh, timer_inc, timer_spec(), owned))
        rows = [torch.cat([pack_info(infos[0][j]),
                           ring_counts(ib[0][j], st[0][j])], -1).to(d0)
                for j in owned]
        rows += [torch.zeros_like(rows[0])] * (ranks.k_max - len(owned))
        busy = None
        for j in owned:
            b = _busy(ib[0][j]).to(d0)
            busy = b if busy is None else busy | b
        mine = torch.cat([torch.stack(rows).reshape(-1),
                          infos[0][owned[0]].timer_margin.to(d0, I32),
                          busy.to(I32).reshape(1)])
        every = ranks.all_gather(mine)
        blocks = every[:, :n_blk].reshape(ranks.procs, ranks.k_max, P,
                                          g_loc, ncol)
        full = torch.cat([blocks[r, k] for r, k in where], 1)
        aux = DistAux(every[:, n_blk:n_blk + P].amin(0),
                      full[..., INFO_NCOLS:])
        return (Sharded(mesh, st, state_specs()),
                Sharded(mesh, ib, inbox_specs()),
                full[..., :INFO_NCOLS].contiguous(),
                every[:, n_blk + P].amax(0) != 0, aux)

    return _step


def make_sharded_cluster_run(cfg: RaftConfig, mesh: Mesh, num_ticks: int):
    """A `num_ticks`-tick loop of the sharded step, device-resident.

    Returns fn(states, inboxes, prop_n[T, P, G]) -> (states, inboxes,
    committed_total), committed_total a 0-dim int32 tensor on shard
    (0, 0)'s device: the log entries newly committed across ALL groups
    over the run (per-group max commit over peers, summed over groups
    and over the group shards), the one scalar the benchmark moves to
    the host per run."""
    step = make_sharded_step_fn(cfg, mesh)
    pp, gg = mesh.shape[PEERS_AXIS], mesh.shape[GROUPS_AXIS]
    d0 = mesh.devices[0][0]
    spec_t = (None, PEERS_AXIS, GROUPS_AXIS)

    def group_commit(st):          # per shard column j: [G_loc] on d0
        return [torch.stack([st[i][j].commit.amax(0).to(d0)
                             for i in range(pp)]).amax(0)
                for j in range(gg)]

    def _run(states: Sharded, inboxes: Sharded, prop_n):
        st, ib = states.blocks, inboxes.blocks
        props = _blocks(mesh, prop_n, spec_t)
        commit0 = group_commit(st)
        for t in range(num_ticks):
            pt = [[props[i][j][t] for j in range(gg)] for i in range(pp)]
            st, ib, _ = step(st, ib, pt, step.ones)
        total = sum((c1 - c0).sum(dtype=I32)
                    for c0, c1 in zip(commit0, group_commit(st)))
        return (Sharded(mesh, st, state_specs()),
                Sharded(mesh, ib, inbox_specs()), total)

    return _run

