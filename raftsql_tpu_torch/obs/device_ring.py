"""Tick-indexed on-device event ring for the fused cluster runtime.

Port of raftsql_tpu/obs/device_ring.py.  The fused runtime's consensus
math is opaque to the host: one dispatch advances P peers x G groups
and the host sees only the packed StepInfo it needs for durability.
`NodeMetrics` aggregates further, to run totals.  This ring is the
per-tick history between those extremes: a fixed-shape
[depth, P, G, NEV] int32 tensor living ON the device, written one slot
per tick by `_record_slot` (a few elementwise ops over tensors already
resident, then one in-place copy into the slot), and drained to the
host in whole-ring batches — so with tracing enabled the per-tick cost
is those few launches, and one device-to-host copy every `depth`
ticks; with tracing disabled (the default) nothing here runs.

Per (peer, group) the slot records (EVENT_FIELDS order): the tick
number, term, role, leader hint, commit index, host applied index (the
host's pre-publish cursor, passed in), device log length, inbox depth
(message slots in flight to the NEXT tick — the post-step delivered
inbox), and the vote tally.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from raftsql_tpu_torch.core.state import resolve_device
from raftsql_tpu_torch.core.step import INFO_FIELDS

EVENT_FIELDS = ("tick", "term", "role", "leader", "commit", "applied",
                "log_len", "inbox_depth", "votes")
NEV = len(EVENT_FIELDS)
# The drained history's byte budget (DeviceEventRing budget_bytes).
DEFAULT_BUDGET_BYTES = 256 << 20

_C = {n: i for i, n in enumerate(INFO_FIELDS)}


def _record_slot(ring: torch.Tensor, slot: int, tick_no: int,
                 pinfo: torch.Tensor, votes: torch.Tensor,
                 v_type: torch.Tensor, a_type: torch.Tensor,
                 applied: torch.Tensor) -> None:
    """Write one [P, G, NEV] event row into ring[slot], in place.

    pinfo is the step's packed [P, G, INFO_NCOLS] info (the final step
    of a multi-step dispatch); votes/v_type/a_type are the post-step
    stacked state/inbox leaves; applied is the host's [P, G] apply
    cursor, already on the ring's device."""
    depth = (v_type != 0).sum(-1) + (a_type != 0).sum(-1)       # [P, G]
    _record_counts_slot(ring, slot, tick_no, pinfo, depth, votes.sum(-1),
                        applied)


def _record_counts_slot(ring: torch.Tensor, slot: int, tick_no: int,
                        pinfo: torch.Tensor, depth: torch.Tensor,
                        tally: torch.Tensor, applied: torch.Tensor) -> None:
    """`_record_slot` with the inbox depth and the vote tally ([P, G]
    each) already counted."""
    ev = torch.stack([torch.full_like(pinfo[:, :, 0], tick_no),
                      pinfo[:, :, _C["term"]],
                      pinfo[:, :, _C["role"]],
                      pinfo[:, :, _C["leader_hint"]],
                      pinfo[:, :, _C["commit"]],
                      applied,
                      pinfo[:, :, _C["new_log_len"]],
                      depth.to(pinfo.dtype), tally.to(pinfo.dtype)],
                     dim=-1)
    ring[slot].copy_(ev)


class DeviceEventRing:
    """Host manager for the on-device ring: owns the device tensor, the
    write cursor, and the drained host-side history (a bounded deque of
    [P, G, NEV] numpy rows, newest last).

    The history keeps at most `keep` rows and at most `budget_bytes` of
    them: max(1, min(keep, budget_bytes // row_bytes)) rows, where a row
    is P * G * NEV * 4 bytes.  At the server shapes (8 groups x 3 peers,
    864 B a row) that is the JAX package's 4,096 rows; at P = 3 and G =
    100,000 (10.8 MB a row) it is 24 rows under the default 256 MiB."""

    def __init__(self, num_peers: int, num_groups: int,
                 depth: int = 64, keep: int = 4096,
                 budget_bytes: int = DEFAULT_BUDGET_BYTES, device="cuda"):
        self.depth = depth
        self.device = resolve_device(device)
        self._ring = torch.zeros((depth, num_peers, num_groups, NEV),
                                 dtype=torch.int32, device=self.device)
        self._slot = 0
        self.row_bytes = num_peers * num_groups * NEV * 4
        self.capacity = max(1, min(keep, budget_bytes // self.row_bytes))
        self._events: deque = deque(maxlen=self.capacity)
        self.drains = 0
        # record() runs on the tick thread; drain()/rows() also run on
        # scrape threads (GET /trace, GET /events, the flight
        # recorder).  The lock serializes ring/cursor/deque access —
        # contention is one scrape against one tick, never tick-tick.
        self._mu = threading.Lock()

    def record(self, tick_no: int, pinfo_dev, votes, v_type, a_type,
               applied: np.ndarray) -> None:
        """Record one tick's events; auto-drains when the ring fills."""
        app = torch.from_numpy(applied.astype(np.int32)).to(self.device)
        with self._mu:
            _record_slot(self._ring, self._slot, tick_no, pinfo_dev,
                         votes, v_type, a_type, app)
            self._slot += 1
            if self._slot >= self.depth:
                self._drain_locked()

    def record_counts(self, tick_no: int, pinfo_dev, counts,
                      applied: np.ndarray) -> None:
        """`record` from counts gathered elsewhere: `counts` [P, G, 2]
        is the inbox depth and the vote tally per (peer, group)
        (parallel/sharded.py ring_counts; a distributed pod host holds
        no other host's state)."""
        app = torch.from_numpy(applied.astype(np.int32)).to(self.device)
        with self._mu:
            _record_counts_slot(self._ring, self._slot, tick_no, pinfo_dev,
                                counts[..., 0], counts[..., 1], app)
            self._slot += 1
            if self._slot >= self.depth:
                self._drain_locked()

    def drain(self) -> None:
        """Pull every undrained slot to the host (ONE device-to-host
        copy)."""
        with self._mu:
            self._drain_locked()

    def _drain_locked(self) -> None:
        if self._slot == 0:
            return
        # Only the slots the history keeps cross to the host, and each
        # kept row is a copy of its own: a row that were a view of the
        # drained block would hold the whole block alive, and the budget
        # would bound nothing.  (On the CPU a plain .cpu() would also
        # alias the ring, and the next slots would overwrite history.)
        lo = max(0, self._slot - self.capacity)
        host = self._ring[lo:self._slot].to("cpu", copy=True).numpy()
        self._events.extend(row.copy() for row in host)
        self._slot = 0
        self.drains += 1

    def history_bytes(self) -> int:
        """Bytes of drained history held on the host."""
        with self._mu:
            return sum(r.nbytes for r in self._events)

    def rows(self, last: Optional[int] = None) -> List[dict]:
        """Drained history as JSON-ready per-tick dicts (newest-last):
        {"tick": t, "<field>": [[G values] per peer], ...}.  Call
        drain() first for up-to-the-tick data."""
        with self._mu:
            events = list(self._events)
        if last is not None:
            events = events[-last:]
        out = []
        for row in events:                       # row: [P, G, NEV]
            d = {"tick": int(row[0, 0, 0])}
            for i, name in enumerate(EVENT_FIELDS):
                if name != "tick":
                    d[name] = row[:, :, i].tolist()
            out.append(d)
        return out

    def __len__(self) -> int:
        return len(self._events)
