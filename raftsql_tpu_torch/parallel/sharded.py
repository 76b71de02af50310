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
from typing import List, Optional, Sequence

import numpy as np
import torch

from raftsql_tpu_torch.config import MSG_REQ, MSG_RESP, RaftConfig
from raftsql_tpu_torch.core.state import (I32, Inbox, PeerState, StepInfo,
                                          resolve_device)
from raftsql_tpu_torch.core.step import pack_info, peer_step

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
              devices=None, device="cuda") -> Mesh:
    """Build the ('peers', 'groups') mesh over the first pp*gg shard
    slots (`devices`, else shard_slots(device))."""
    devices = shard_slots(device) if devices is None else list(devices)
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
    (a spec tuple, or a NamedTuple of them)."""

    def __init__(self, mesh: Mesh, blocks, specs):
        self.mesh = mesh
        self.blocks = blocks
        self.specs = specs

    def gather(self, device=None):
        """The global value (a fresh copy), on `device` (default: shard
        (0, 0)'s device)."""
        dev = torch.device(device) if device is not None \
            else self.mesh.devices[0][0]
        b0 = self.blocks[0][0]
        if not _is_tree(b0):
            return _join(self.blocks, self.specs, self.mesh, dev)
        return type(b0)(*[
            _join([[getattr(blk, n) for blk in row] for row in self.blocks],
                  getattr(self.specs, n), self.mesh, dev)
            for n in b0._fields])


def shard(mesh: Mesh, value, specs) -> Sharded:
    """Lay a global tensor (or NamedTuple of tensors, or numpy array)
    out over `mesh` by `specs`."""
    pp, gg = mesh.shape[PEERS_AXIS], mesh.shape[GROUPS_AXIS]
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(value)
    if _is_tree(value):
        blocks = [[type(value)(*[_split(x, s, mesh, i, j)
                                 for x, s in zip(value, specs)])
                   for j in range(gg)] for i in range(pp)]
    else:
        blocks = [[_split(value, specs, mesh, i, j) for j in range(gg)]
                  for i in range(pp)]
    return Sharded(mesh, blocks, specs)


def _blocks(mesh: Mesh, x, spec):
    """The per-shard blocks of `x`: a Sharded's own, else `x` (a global
    tensor or numpy array) split by `spec`."""
    return x.blocks if isinstance(x, Sharded) else \
        shard(mesh, x, spec).blocks


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
    `deliver` transpose (views, no copy)."""
    pp, gg = mesh.shape[PEERS_AXIS], mesh.shape[GROUPS_AXIS]
    swapped = [[Inbox(*[x.transpose(0, 2) for x in outboxes[i][j]])
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


def make_sharded_step_fn(cfg: RaftConfig, mesh: Mesh):
    """The whole-mesh step over per-shard blocks.

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
    self_ids = [[torch.arange(i * p_loc, (i + 1) * p_loc, dtype=I32,
                              device=mesh.devices[i][j])
                 for j in range(gg)] for i in range(pp)]

    def _step(states, inboxes, prop_n, timer_inc):
        new_states = [[None] * gg for _ in range(pp)]
        outboxes = [[None] * gg for _ in range(pp)]
        infos = [[None] * gg for _ in range(pp)]
        for i in range(pp):
            for j in range(gg):
                new_states[i][j], outboxes[i][j], infos[i][j] = peer_step(
                    local_cfg, states[i][j], inboxes[i][j], prop_n[i][j],
                    self_ids[i][j], j * g_loc, timer_inc=timer_inc[i][j])
        delivered = _route(outboxes, mesh)
        # timer_margin is a per-(peer, group-shard) min; the host wants
        # the per-peer min over ALL groups (the JAX package's pmin over
        # the groups axis).
        for i in range(pp):
            d0 = mesh.devices[i][0]
            tm = infos[i][0].timer_margin
            for j in range(1, gg):
                tm = torch.minimum(tm, infos[i][j].timer_margin.to(d0))
            for j in range(gg):
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

