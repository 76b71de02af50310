"""Dynamic membership: voter masks, joint consensus, learner catch-up.

The PyTorch port's copy of the JAX package's module of the same path.

The reference inherits etcd/raft's ConfChange machinery; the batched
rebuild froze the peer set (static cfg.quorum).  This package is the
TPU-native redesign: the per-group configuration is DEVICE data — a
[G, P] voter bitmask plus a second mask while a joint C_old,new change
is in flight (core/state.py PeerState.voters / voters_joint) — read by
every quorum in the fused step (ops/quorum.py mask-weighted kernels),
so N groups can sit in N different configurations inside one dispatch.

Changes travel as marked log entries (transport/codec.py conf-entry
record kind), apply at commit in the two-phase joint style
(C_old,new -> C_new, one in flight per group), and are durably
baselined in the WAL (storage/wal.py REC_CONF).  Learner slots receive
AppendEntries/InstallSnapshot but stay outside every quorum until
caught up and promoted.  P is provisioned slot CAPACITY (a static
device shape): membership moves voter bits between slots; it never
resizes P.
"""
from raftsql_tpu_torch.membership.manager import (GroupConfig, MembershipError,
                                            MembershipLagError,
                                            MembershipManager,
                                            NotLeaderForChange)

__all__ = ["GroupConfig", "MembershipError", "MembershipLagError",
           "MembershipManager", "NotLeaderForChange"]
