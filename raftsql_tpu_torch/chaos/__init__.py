"""Deterministic chaos harness for the port's fused runtime: seeded
fault schedules, crash/partition/disk-fault injection, and invariant
checking over the live engine.

Port of the fused plane of raftsql_tpu/chaos/: the dense message plane
(transport/faults.py masks) for seeded drops, delays and partitions;
the storage I/O seam (storage/fsio.py) for failed fsyncs, torn writes,
ENOSPC, fsync stalls and unsynced-tail loss; hard process-crash
simulation plus full restart-from-WAL.  Every scenario is a
tick-indexed `ChaosSchedule` derived from ONE seed; re-running a seed
reproduces the identical schedule and result digests
(`python -m raftsql_tpu_torch.chaos.run`), and they equal the JAX
package's for the same seed.
"""
from raftsql_tpu_torch.chaos.invariants import (CommitMonotonic,
                                                DurabilityLedger,
                                                ElectionSafety,
                                                InvariantViolation,
                                                RegisterLinearizability,
                                                check_log_matching)
from raftsql_tpu_torch.chaos.schedule import (LEADER_TARGET,
                                              AsymPartitionWindow,
                                              ChaosSchedule, CrashEvent,
                                              DelayWindow, DropWindow,
                                              EnospcFault, FsyncFault,
                                              FsyncStall, PartitionWindow,
                                              SkewWindow, TornWriteFault,
                                              generate, generate_asym,
                                              generate_compact,
                                              generate_enospc,
                                              generate_skew, generate_stall)
from raftsql_tpu_torch.chaos.scenarios import (FusedChaosRunner,
                                               schedule_peers)

__all__ = [
    "LEADER_TARGET", "AsymPartitionWindow", "ChaosSchedule",
    "CrashEvent", "DelayWindow", "DropWindow", "EnospcFault",
    "FsyncFault", "FsyncStall", "PartitionWindow", "SkewWindow",
    "TornWriteFault", "generate", "generate_asym", "generate_compact",
    "generate_enospc", "generate_skew", "generate_stall",
    "CommitMonotonic", "DurabilityLedger", "ElectionSafety",
    "InvariantViolation", "RegisterLinearizability",
    "check_log_matching", "FusedChaosRunner", "schedule_peers",
]
