"""Witness state machine: a voter that owns no data.

A witness peer (config.py quorum geometry) is a full quorum citizen on
the durability plane — it votes, grants prevotes, accepts appends and
fsyncs its WAL — but it never applies, never serves a read, and never
leads (core/step.py gates its campaign timer).  This state machine is
what runtime/db.py installs in place of the real sm_factory on a
witness replica: the SQLite factory is never invoked, so no shard file
or directory ever exists, and committed payloads are discarded on
arrival — they are already durable in the WAL, which is the only thing
a witness owes the cluster.

This is the half-replica of Cheap Paxos / the witness in etcd's
learner-adjacent designs: N-1 full replicas plus a witness gives the
same fault tolerance as N full replicas for half the apply and shard
fsync cost, as long as the witness is never counted on to SERVE.

Copy of raftsql_tpu/models/witness.py for the PyTorch port.
"""
from __future__ import annotations

from typing import Optional


class WitnessQueryError(ValueError):
    """A read reached a witness replica.  ValueError so the HTTP
    planes answer 400 without a dedicated handler."""


class WitnessStateMachine:
    # No durable snapshot: a witness must never gate WAL compaction on
    # its (nonexistent) applied state (runtime/db.py checks this flag).
    has_durable_snapshot = False

    def __init__(self, path_or_group="", *_a, **_k):
        # Accepts and ignores the sm_factory signature (group index or
        # path): nothing is created anywhere.
        self._applied = 0

    def applied_index(self) -> int:
        return self._applied

    def apply(self, command: str, index: int = 0) -> Optional[Exception]:
        # Discard the payload, remember only how far the stream got
        # (volatile — a restart replays nothing because there is
        # nothing to rebuild).
        if index:
            self._applied = max(self._applied, index)
        return None

    def apply_batch(self, items) -> list:
        errs = []
        for _command, index in items:
            if index:
                self._applied = max(self._applied, index)
            errs.append(None)
        return errs

    def query(self, q: str) -> str:
        raise WitnessQueryError(
            "witness replica serves no reads (it owns no shard)")

    def close(self) -> None:
        pass
