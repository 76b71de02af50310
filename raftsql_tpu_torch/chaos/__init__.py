"""Deterministic chaos harness for the port's fused runtime: seeded
fault schedules, crash/partition/disk-fault injection, and invariant
checking over the live engine.

Port of raftsql_tpu/chaos/: the dense message plane
(transport/faults.py masks) for seeded drops, delays and partitions;
the storage I/O seam (storage/fsio.py) for failed fsyncs, torn writes,
ENOSPC, fsync stalls and unsynced-tail loss; hard process-crash
simulation plus full restart-from-WAL.  Every scenario is a
tick-indexed `ChaosSchedule` derived from ONE seed; re-running a seed
reproduces the identical schedule and result digests
(`python -m raftsql_tpu_torch.chaos.run`), and they equal the JAX
package's for the same seed.

The PROCESS plane (chaos/proc.py, `python -m raftsql_tpu_torch.chaos.run
--procs`) goes one level further down: a seeded nemesis over real
`raftsql_tpu_torch.server.main` OS processes — SIGKILL, SIGSTOP/SIGCONT
stalls, rolling-restart storms, and env-injected disk faults
(RAFTSQL_FSIO_FAULTS) — under a live acked-PUT workload through
api/client.py.  Its schedule and invariant VERDICTS are
seed-deterministic; its committed history crosses real kernel
scheduling and is not.
"""
from raftsql_tpu_torch.chaos.invariants import (CommitMonotonic,
                                                DurabilityLedger,
                                                ElectionSafety,
                                                InvariantViolation,
                                                RegisterLinearizability,
                                                RemovedQuorumSafety,
                                                check_convergence,
                                                check_log_matching)
from raftsql_tpu_torch.chaos.proc import (ProcChaosRunner, ProcCluster,
                                          ProcReadChaosRunner,
                                          ProcTransferChaosRunner)
from raftsql_tpu_torch.chaos.scenarios import (FusedChaosRunner,
                                               MembershipChaosRunner,
                                               NodeClusterChaosRunner,
                                               OverloadChaosRunner,
                                               SnapshotChaosRunner,
                                               TcpClusterChaosRunner,
                                               TcpRebindChaosRunner,
                                               TransferChaosRunner,
                                               schedule_peers)
from raftsql_tpu_torch.chaos.schedule import (
    LEADER_TARGET, AsymPartitionWindow, ChaosSchedule, CorruptWindow,
    CrashEvent, DelayWindow, DropWindow, EnospcFault, FsyncFault,
    FsyncStall, MemberEvent, MembershipChaosPlan, NodeBoot,
    NodeChaosPlan, NodeCrash, OverloadBurst, OverloadNemesisPlan,
    PartitionWindow, ProcChaosPlan, ProcFsioSpec, ProcKill,
    ProcRestartStorm, ProcStall, SkewWindow, TcpChaosPlan, TcpRebindPlan,
    TornWriteFault, TransferEvent, TransferNemesisPlan,
    falsification_overload_plan, falsification_transfer_plan, generate,
    generate_asym, generate_compact, generate_corrupt_plan,
    generate_enospc, generate_membership_plan, generate_node_plan,
    generate_overload, generate_procs, generate_skew,
    generate_snapshot_plan, generate_stall, generate_tcp_plan,
    generate_tcp_rebind_plan, generate_transfers)

__all__ = [
    "LEADER_TARGET", "AsymPartitionWindow", "ChaosSchedule",
    "CorruptWindow", "CrashEvent", "DelayWindow", "DropWindow",
    "EnospcFault", "FsyncFault", "FsyncStall", "MemberEvent",
    "MembershipChaosPlan", "NodeBoot", "NodeChaosPlan",
    "NodeCrash", "OverloadBurst", "OverloadNemesisPlan",
    "PartitionWindow", "ProcChaosPlan", "ProcChaosRunner",
    "ProcCluster", "ProcFsioSpec", "ProcKill", "ProcRestartStorm",
    "ProcStall", "SkewWindow", "TcpChaosPlan",
    "TcpRebindPlan", "TornWriteFault", "generate", "generate_asym",
    "generate_compact", "generate_corrupt_plan", "generate_enospc",
    "generate_membership_plan", "generate_node_plan", "generate_overload",
    "generate_procs", "generate_skew", "generate_snapshot_plan",
    "generate_stall", "generate_tcp_plan", "generate_tcp_rebind_plan",
    "generate_transfers", "falsification_overload_plan",
    "falsification_transfer_plan",
    "TransferEvent", "TransferNemesisPlan", "TransferChaosRunner",
    "ProcReadChaosRunner", "ProcTransferChaosRunner",
    "CommitMonotonic", "DurabilityLedger", "ElectionSafety",
    "InvariantViolation", "RegisterLinearizability", "RemovedQuorumSafety",
    "check_convergence", "check_log_matching", "FusedChaosRunner",
    "MembershipChaosRunner", "NodeClusterChaosRunner",
    "OverloadChaosRunner", "SnapshotChaosRunner",
    "TcpClusterChaosRunner", "TcpRebindChaosRunner", "schedule_peers",
]
