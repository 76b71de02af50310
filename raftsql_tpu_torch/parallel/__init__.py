"""The batched consensus core sharded over a mesh of shard devices
(port of raftsql_tpu/parallel/)."""

from raftsql_tpu_torch.parallel.sharded import (GROUPS_AXIS, PEERS_AXIS,
                                                SHARD_SLOTS_ENV, DistAux,
                                                Mesh, RankGroup, Sharded,
                                                make_distributed_cluster_step_host,
                                                make_mesh,
                                                make_sharded_cluster_run,
                                                make_sharded_cluster_step,
                                                make_sharded_cluster_step_host,
                                                shard, shard_cluster_arrays,
                                                shard_slots, timer_spec)

__all__ = [
    "GROUPS_AXIS", "PEERS_AXIS", "SHARD_SLOTS_ENV", "DistAux", "Mesh",
    "RankGroup", "Sharded", "make_distributed_cluster_step_host",
    "make_mesh", "make_sharded_cluster_run", "make_sharded_cluster_step",
    "make_sharded_cluster_step_host", "shard", "shard_cluster_arrays",
    "shard_slots", "timer_spec",
]
