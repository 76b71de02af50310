"""Multi-host pod runtime: N host processes jointly own the cluster.

Port of raftsql_tpu/pod/.  N host processes each run the SAME hostplane
tick over the replicated global device step, lockstepped by a per-tick
collective, while durability is sharded across hosts (each host fsyncs
only the group shards it owns).  See pod/node.py for the execution
model, pod/transport.py for the collective, and pod/dryrun.py for the
dry-run rungs (N local processes).
"""
from raftsql_tpu_torch.pod.config import POD_META, PodConfig
from raftsql_tpu_torch.pod.node import PodClusterNode, PodShardedWAL
from raftsql_tpu_torch.pod.transport import (LocalPodTransport, PodPeerLost,
                                             TcpPodTransport)

__all__ = ["POD_META", "PodConfig", "PodClusterNode", "PodShardedWAL",
           "LocalPodTransport", "PodPeerLost", "TcpPodTransport"]
