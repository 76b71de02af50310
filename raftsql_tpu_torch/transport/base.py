"""Transport protocol + wire records for the peer message plane.

This is the TPU-native replacement for the reference's vendored
`etcd/rafthttp` transport (reference raft.go:170-184, 230, 248-273):
per-tick *batches* of fixed-layout records move between nodes, instead of a
stream of protobuf messages.  Three implementations share this interface:

  - transport.loopback — in-process, for tests and single-host clusters
    (the reference test harness's localhost trick, raftsql_test.go:19);
  - transport.tcp      — DCN path between hosts, length-prefixed frames
    over persistent sockets;
  - the fused on-device path (core/cluster.deliver) needs no transport at
    all — delivery is an array transpose (and an ICI all_to_all when the
    peer axis is sharded, parallel/sharded.py).

Wire records mirror the dense Inbox slots (core/state.py) one-to-one, so
staging inbound records into device arrays is a plain scatter.

Copy of raftsql_tpu/transport/base.py for the PyTorch port (the records
are plain Python; nothing here touches a device).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Protocol


@dataclass
class VoteRec:
    group: int
    type: int           # MSG_REQ / MSG_RESP / MSG_PREREQ / MSG_PRERESP
    term: int
    last_idx: int = 0   # request fields
    last_term: int = 0
    granted: bool = False  # response field


@dataclass
class AppendRec:
    group: int
    type: int           # MSG_REQ / MSG_RESP
    term: int
    prev_idx: int = 0
    prev_term: int = 0
    ent_terms: List[int] = field(default_factory=list)
    payloads: List[bytes] = field(default_factory=list)   # REQ only
    commit: int = 0
    success: bool = False   # response fields
    match: int = 0
    # Round binding for ReadIndex (raft §6.4): a REQ carries the sender's
    # tick number; the RESP echoes the seq of the request it answers, so
    # a leadership confirmation can be tied to rounds STARTED after a
    # read registration (a delayed pre-registration response must not
    # count — runtime/node.py read_ready).
    seq: int = 0

    @property
    def n(self) -> int:
        return len(self.ent_terms)


@dataclass
class ProposalRec:
    """Host-level proposal forward to the (hinted) leader.

    The reference gets leader forwarding for free from etcd/raft's MsgProp
    routing; here it is an explicit host-plane record.
    """
    group: int
    payload: bytes


@dataclass
class SnapshotRec:
    """InstallSnapshot: full state transfer for a follower whose needed
    log prefix has been compacted away (raft §7; the reference has no
    snapshots at all, db.go:27-29 — this is capability beyond parity).

    `blob` is the state machine's serialized image at `last_idx` (whose
    entry has term `last_term`); the receiver installs it, resets its
    group log to start at last_idx, and resumes replication from there.
    """
    group: int
    last_idx: int
    last_term: int
    term: int           # sender's (leader's) current term
    blob: bytes = b""


@dataclass
class ColRecs:
    """Columnar (struct-of-arrays) payload-free messages — the host-plane
    fast path.

    Per-record Python objects dominate the durable tick at scale: every
    leader group emits P-1 heartbeat appends per heartbeat tick and every
    follower answers each, so message count is O(G) regardless of load
    (~20-40 µs of build+stage Python per record).  Votes and payload-free
    appends (heartbeats, all responses) instead ride as parallel numpy
    int column arrays: the sender fancy-indexes them straight out of the
    device outbox, the receiver scatters them straight into its staging
    arrays, and the wire format is the raw little-endian array bytes
    (codec.py).  Payload-carrying appends, proposals, and snapshots keep
    the record path — their count is proportional to real traffic.

    This is SURVEY.md §2b V2's struct-of-arrays wire contract applied to
    the host plane end-to-end, not just the device boundary.
    """
    # Vote rows (all vote messages):
    v_group: "object" = None    # np.ndarray [Nv] i32
    v_type: "object" = None
    v_term: "object" = None
    v_last_idx: "object" = None
    v_last_term: "object" = None
    v_granted: "object" = None  # i32 0/1
    # Payload-free append rows (n == 0: heartbeats + responses):
    a_group: "object" = None    # np.ndarray [Na] i32
    a_type: "object" = None
    a_term: "object" = None
    a_prev_idx: "object" = None
    a_prev_term: "object" = None
    a_commit: "object" = None
    a_success: "object" = None  # i32 0/1
    a_match: "object" = None
    a_seq: "object" = None      # i64 (ReadIndex round binding)

    def n_votes(self) -> int:
        return 0 if self.v_group is None else len(self.v_group)

    def n_appends(self) -> int:
        return 0 if self.a_group is None else len(self.a_group)


@dataclass
class TickBatch:
    """Everything one node sends another for one tick."""
    votes: List[VoteRec] = field(default_factory=list)
    appends: List[AppendRec] = field(default_factory=list)
    proposals: List[ProposalRec] = field(default_factory=list)
    snapshots: List[SnapshotRec] = field(default_factory=list)
    cols: "ColRecs | None" = None

    def empty(self) -> bool:
        return not (self.votes or self.appends or self.proposals
                    or self.snapshots
                    or (self.cols is not None
                        and (self.cols.n_votes() or self.cols.n_appends())))


class Transport(Protocol):
    """Peer message plane for one node.

    `send` must not block the tick loop on slow peers (drop or buffer);
    raft tolerates loss.  Fatal transport errors surface via the error
    callback, which triggers node teardown (reference raft.go:136-142,
    237-239).
    """

    def start(self, node_id: int,
              deliver: Callable[[int, TickBatch], None],
              on_error: Callable[[Exception], None]) -> None: ...

    def send(self, dst: int, batch: TickBatch) -> None: ...

    def stop(self) -> None: ...
