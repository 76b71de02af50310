"""Read-replica tier: the shm delta stream as a replicated wire protocol.

Port of raftsql_tpu/replica/: the frames on the wire are the JAX
package's, byte for byte, and no process of the tier but the engine
touches the card.

The shared-memory snapshot plane (runtime/shm.py) made reads free on
the engine's OWN machine: workers map the per-group delta/base log and
serve local/session/follower/lease-linear GETs without a ring round
trip.  This package promotes that exact log into a length-framed,
CRC-checked TCP stream so the same read ladder runs CONTINENTS away —
CD-Raft's placement story (PAPERS.md): lease-holding read-serving peers
near the readers, zero consensus traffic on the read path.

Three pieces:

  * `stream` — the wire protocol: frames reuse transport/codec.py's
    framing discipline (length + whole-frame CRC32, bounds-validated
    before any decode; corruption surfaces as StreamCorruptError to
    DROP, never as an out-of-bounds read) and the record kinds are
    runtime/shm.py's own KIND_DELTA / KIND_BASE, unchanged.
  * `publisher` — engine side: `ReplicaStreamServer` rides the
    `ShmSnapshotPublisher` tee (every applied run, base image and
    keymap flip is mirrored to subscribers the instant it lands in the
    mmap) and bootstraps new subscribers by replaying the publisher's
    append-only log — or, when the log overflowed or a subscriber's
    queue fell behind, by shipping fresh KIND_BASE images (a RESYNC).
    Wired up by `--replica-listen PORT` on server/main.py.
  * `node` — replica side: `ReplicaSubscriber` folds the stream into
    per-group in-memory SQLite replicas exactly as ShmSnapshotReader
    folds the mmap, and `ReplicaDB` fronts it with the RaftDB facade
    both HTTP planes (api/http.py, api/aio.py) already speak — so a
    replica process serves the identical GET surface, and every
    refusal of the fail-closed ladder (stale epoch, uncovered session
    watermark, lapsed/unpublished lease, stream gap/overflow, stale
    heartbeat) degrades to 421 + X-Raft-Leader pointing at the
    authoritative tier, never a stale answer.

Run a replica:  python -m raftsql_tpu_torch.replica --upstream host:port \
                    --port 9221
"""
from raftsql_tpu_torch.replica.node import ReplicaDB, ReplicaSubscriber
from raftsql_tpu_torch.replica.publisher import (ReplicaStreamServer,
                                                 attach_replica_plane)
from raftsql_tpu_torch.replica.stream import StreamCorruptError

__all__ = ["ReplicaDB", "ReplicaSubscriber", "ReplicaStreamServer",
           "attach_replica_plane", "StreamCorruptError"]
