"""Run seeded chaos scenarios on the port and prove they reproduce.

    python -m raftsql_tpu_torch.chaos.run --seed 0 --ticks 240 --runs 2
    python -m raftsql_tpu_torch.chaos.run --matrix --seed 0
    python -m raftsql_tpu_torch.chaos.run --family reads --seed 3
    python -m raftsql_tpu_torch.chaos.run --procs --seed 0
    python -m raftsql_tpu_torch.chaos.run --overload --seed 0
    python -m raftsql_tpu_torch.chaos.run --reshard --seed 0
    python -m raftsql_tpu_torch.chaos.run --reads --no-procs
    RAFTSQL_SHARD_SLOTS=8 python -m raftsql_tpu_torch.chaos.run \
        --family mesh_skew
    RAFTSQL_SHARD_SLOTS=8 python -m raftsql_tpu_torch.chaos.run --pod
    python -m raftsql_tpu_torch.chaos.run --replica --seed 0
    python -m raftsql_tpu_torch.chaos.run --device cpu      # no card

Port of raftsql_tpu/chaos/run.py.  Default mode
generates the seed's full ChaosSchedule (>= 2 partitions, >= 2
crash/restart events, >= 1 injected fsync fault, plus a torn-write
power loss), runs it against a fresh FusedClusterNode data dir per run,
and prints one JSON line per run.  With --runs > 1 the runs must
produce IDENTICAL schedule and result digests.  The node boots from the
JAX package's threefry draws, so the digests equal the JAX package's
runner's for the same seed.

--matrix sweeps ONE seed through the scenario FAMILIES:

    asym             one-directional partitions          (fused plane)
    skew             per-peer clock skew                 (fused plane)
    mesh_skew        per-peer clock skew on the MESH runtime (groups
                     sharded over shard slots + per-shard WALs; needs
                     >= 2 group shards: RAFTSQL_SHARD_SLOTS=8)
    enospc           disk-full on WAL append             (fused plane)
    fsync_stall      slow-disk fsync latency             (fused plane)
    compact          compaction + crash interleaving     (fused plane)
    reads            every read mode under skew, partitions and crashes
    quorum           2 voters + 1 witness, W = E = 2, under the same
    transfers        graceful leadership transfers under the same
    corrupt          wire-frame corruption         (lockstep node plane)
    snapshot         compaction + InstallSnapshot + crash (node plane)
    membership       add/promote/remove churn + node replacement under
                     faults                        (lockstep node plane)
    tcp              drops/corruption/asym/delays  (REAL TCP transport)
    tcp_rebind       crash/restart with port rebinding      (REAL TCP)

Every family except tcp and tcp_rebind runs twice and must reproduce
identical schedule (or plan) + result digests, and every family's
signature faults must have fired.  The TCP families cross real kernel
sockets, so arrival interleaving is not virtualizable: their plan is
deterministic and their invariants must hold, but the committed history
is not bit-reproducible, so they run once.

--reads, --transfers, --quorum, --overload and --reshard are the
gauntlets: the family twice, then its falsification pairs (a
deliberately broken lease bound, transfer kernel, quorum geometry, a
missing admission bound or a premature reshard router flip must be
CAUGHT by the invariants, and the same schedule with the correct
setting must pass).  --reads and --transfers end with their
process-plane legs (ProcReadChaosRunner, ProcTransferChaosRunner over
generate_procs(seed, ticks=60)) unless --no-procs.

--procs is the PROCESS plane: a seeded nemesis over real
`raftsql_tpu_torch.server.main` OS processes — SIGKILL (leader-targeted
and random), SIGSTOP/SIGCONT stalls, a rolling-restart storm and
env-injected disk faults (RAFTSQL_FSIO_FAULTS: ENOSPC + a hard process
exit at a WAL fsync) — under a live acked-PUT workload.  The seed runs
twice; schedule and VERDICT digests must match (the committed history
crosses real kernel scheduling and is not bit-reproducible).
--proc-ticks (env PROC_TICKS, default 80) sizes its script.

--pod is the MULTI-HOST POD plane: a seeded nemesis over a real
2-process pod (raftsql_tpu_torch/pod/, chaos/pod.py: host processes
lockstepped by the TcpPodTransport collective, each durable for its own
group shards, each stepping on `--device` over RAFTSQL_SHARD_SLOTS
shard slots): a propose-plane cut, SIGKILL of the non-coordinator host,
SIGKILL of the coordinator, then a fault-free audit incarnation whose
merged cross-host replay must hold every acked write exactly once on
every host; plus the premature-ack falsification pair.  Process-plane
determinism tier (plan + verdict digests reproduce).

--replica is the READ-REPLICA tier (chaos/replica.py): a fused engine
on `--device` publishing the delta stream (`--replica-listen`), two
`python -m raftsql_tpu_torch.replica` processes subscribed through
nemesis-owned TCP proxies, and a seeded timeline of a subscription cut
and heal, a replica SIGKILL and respawn and one flipped stream bit under
acked writes; every session and linear read a replica answers must hold
every row acked at its bound (StaleReadNever), and every replica must
converge; plus the gate-less-replica falsification pair.

`--device` picks where the consensus state steps (default cuda; a
missing card is an error; the process families' children step there
too) and `--commit-rule` the Phase-7 commit rule of the in-process
runners ("pallas" runs the quorum kernels; server children run the
CLI's default rule).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def runner_class(plan):
    """The fused runner that drives `plan`, by the plan's type."""
    from raftsql_tpu_torch.chaos import scenarios as C
    from raftsql_tpu_torch.chaos import schedule as S
    return {S.ChaosSchedule: C.FusedChaosRunner,
            S.ReadNemesisPlan: C.ReadNemesisRunner,
            S.QuorumNemesisPlan: C.QuorumChaosRunner,
            S.TransferNemesisPlan: C.TransferChaosRunner,
            S.OverloadNemesisPlan: C.OverloadChaosRunner,
            S.ReshardNemesisPlan: C.ReshardChaosRunner}[type(plan)]


def run_fused(plan, steps: int = 1, device="cuda",
              commit_rule=None) -> dict:
    """One run of `plan` (a ChaosSchedule or a nemesis plan) by its
    fused runner in a fresh temporary data dir; returns its report.
    `steps` > 1 (epoch-framed multi-step dispatch) is for ChaosSchedule
    runs."""
    cls = runner_class(plan)
    kw = {"steps": steps} if steps != 1 else {}
    with tempfile.TemporaryDirectory(prefix="raftsql-chaos-") as d:
        return cls(plan, d, device=device, commit_rule=commit_rule,
                   **kw).run()


def run_mesh(sched, device="cuda", commit_rule=None) -> dict:
    """One run of ChaosSchedule `sched` by the mesh runner
    (MeshChaosRunner) in a fresh temporary data dir."""
    from raftsql_tpu_torch.chaos.scenarios import MeshChaosRunner
    with tempfile.TemporaryDirectory(prefix="raftsql-chaos-") as d:
        return MeshChaosRunner(sched, d, device=device,
                               commit_rule=commit_rule).run()


def _check(ok: bool, msg: str) -> bool:
    if not ok:
        print(f"CHAOS FAIL: {msg}", file=sys.stderr)
    return ok


# family -> (schedule generator, fired_predicate)
def family_specs():
    from raftsql_tpu_torch.chaos import schedule as S
    return {
        "asym": (S.generate_asym, lambda r: r["asym_partitions"] >= 2),
        "skew": (S.generate_skew, lambda r: r["skew_ticks"] > 0),
        "enospc": (S.generate_enospc, lambda r: r["enospc_hits"] >= 2),
        "fsync_stall": (S.generate_stall,
                        lambda r: r["fsync_stalls"] > 0),
        "compact": (S.generate_compact, lambda r: r["compactions"] > 0
                    and r["crashes"] >= 2),
        "reads": (S.generate_reads, lambda r: r["lease_reads"] > 0
                  and r["session_reads"] > 0
                  and r["follower_reads"] > 0
                  and r["reads_by_mode"].get("linear", 0) > 0
                  and r["skew_ticks"] > 0 and r["crashes"] >= 1),
        "quorum": (S.generate_quorum, lambda r: r["witness_appends"] > 0
                   and r["witness_publishes"] == 0
                   and r["apply_streams"] == r["wal_streams"] - 1
                   and r["lease_reads"] > 0 and r["crashes"] >= 1
                   and r["partitions"] >= 1),
        "transfers": (S.generate_transfers,
                      lambda r: r["transfers_requested"] >= 6
                      and r["transfers_completed"] >= 1
                      and r["transfer_probes_confirmed"] >= 1
                      and r["partitions"] >= 1 and r["crashes"] >= 1),
    }


# family -> (runner class, plan generator, deterministic, fired_predicate)
def node_family_specs():
    from raftsql_tpu_torch.chaos import scenarios as C
    from raftsql_tpu_torch.chaos import schedule as S
    return {
        "corrupt": (C.NodeClusterChaosRunner, S.generate_corrupt_plan,
                    True, lambda r: r["corrupt_frames"] > 0),
        "snapshot": (C.SnapshotChaosRunner, S.generate_snapshot_plan,
                     True, lambda r: r["snapshots_installed"] > 0
                     and r["compactions"] > 0 and r["crashes"] >= 2),
        "membership": (C.MembershipChaosRunner,
                       S.generate_membership_plan, True,
                       lambda r: r["member_ops_applied"] >= 2 * 3
                       and r["boots"] >= 1 and r["crashes"] >= 2
                       and r["commits"] > 20),
        "tcp": (C.TcpClusterChaosRunner, S.generate_tcp_plan, False,
                lambda r: r["corrupt_frames_dropped"] > 0
                and r["commits"] > 20),
        "tcp_rebind": (C.TcpRebindChaosRunner, S.generate_tcp_rebind_plan,
                       False, lambda r: r["rebinds"] == 2
                       and r["commits"] > 20),
    }


def run_node(name: str, seed: int, device="cuda",
             commit_rule=None) -> dict:
    """One run of node-plane family `name` at `seed` in a fresh
    temporary data dir; returns its report (plan_digest, and
    result_digest for the lockstep families)."""
    cls, gen, _, _ = node_family_specs()[name]
    with tempfile.TemporaryDirectory(prefix="raftsql-chaos-") as d:
        return cls(gen(seed), d, device=device,
                   commit_rule=commit_rule).run()


def _digests(r: dict):
    return (r.get("schedule_digest") or r.get("plan_digest"),
            r.get("result_digest"))


def run_matrix(seed: int, only=None, device="cuda",
               commit_rule=None) -> int:
    """Every family of the matrix (or those in `only`) at `seed`.  The
    whole matrix includes mesh_skew, which needs >= 2 group shards
    (RAFTSQL_SHARD_SLOTS)."""
    from raftsql_tpu_torch.chaos import schedule as S
    kw = dict(device=device, commit_rule=commit_rule)
    specs = {name: (lambda gen=gen: run_fused(gen(seed), **kw), True,
                    fired)
             for name, (gen, fired) in family_specs().items()}
    specs["mesh_skew"] = (
        lambda: run_mesh(S.generate_skew(seed), **kw), True,
        lambda r: r["skew_ticks"] > 0 and r["crashes"] >= 1)
    specs.update({name: (lambda name=name: run_node(name, seed, **kw),
                         det, fired)
                  for name, (_, _, det, fired)
                  in node_family_specs().items()})
    unknown = sorted(set(only or ()) - set(specs))
    if unknown:
        print(f"CHAOS FAIL: families not ported: {unknown} (ported: "
              f"{sorted(specs)})", file=sys.stderr)
        return 2
    ok = True
    for name, (run_fn, deterministic, fired) in specs.items():
        if only and name not in only:
            continue
        reports = [run_fn()]
        if deterministic:
            reports.append(run_fn())
            ok &= _check(
                _digests(reports[0]) == _digests(reports[1]),
                f"family {name}: non-deterministic "
                f"({_digests(reports[0])} != {_digests(reports[1])})")
        ok &= _check(fired(reports[0]),
                     f"family {name}: signature fault never fired "
                     f"({reports[0]})")
        out = {"family": name, "seed": seed,
               "deterministic": deterministic, **reports[0]}
        print(json.dumps(out, sort_keys=True))
    if ok:
        print(f"chaos matrix ok: seed={seed} families="
              f"{','.join(only or specs)}")
    return 0 if ok else 1


def falsification_arms(family: str) -> list:
    """The falsification pairs of a gauntlet: (arm, plan(seed, broken),
    marks one of which the broken run's violation must carry,
    passed(report) the control run must satisfy)."""
    from raftsql_tpu_torch.chaos import schedule as S
    stale = ("STALE", "stale")
    return {
        "reads": [("lease-bound", S.falsification_plan, stale,
                   lambda r: r["lease_reads"] > 0)],
        "transfers": [("unsafe-transfer", S.falsification_transfer_plan,
                       ("TRANSFER-AVAILABILITY",),
                       lambda r: r["transfers_completed"] >= 1)],
        "quorum": [("non-intersecting", S.falsification_quorum_plan,
                    ("changed content", "diverge", "regressed",
                     "two leaders"),
                    lambda r: r["committed_entries"] > 0),
                   ("witness-lease", S.falsification_witness_plan, stale,
                    lambda r: r["lease_reads"] > 0)],
        "overload": [("no-admission", S.falsification_overload_plan,
                      ("OVERLOAD-MEMORY",),
                      lambda r: r["committed_entries"] > 0
                      and r["overload_rejected"] > 0)],
        "reshard": [("premature-flip", S.falsification_reshard_plan,
                     ("NO-ACKED-WRITE-LOST",),
                     lambda r: r["reshard_splits"] >= 1)],
    }[family]


def _falsify(plan, marks, arm: str, **kw) -> bool:
    """Run a deliberately broken plan, whose invariant violation is
    EXPECTED (its flight bundle goes to a temporary dir, not the cwd):
    True when an InvariantViolation carrying one of `marks` fired."""
    from raftsql_tpu_torch.chaos.invariants import InvariantViolation
    prev = os.environ.get("RAFTSQL_FLIGHT_DIR")
    try:
        with tempfile.TemporaryDirectory(
                prefix="raftsql-falsification-") as fd:
            os.environ["RAFTSQL_FLIGHT_DIR"] = fd
            try:
                run_fused(plan, **kw)
            except InvariantViolation as e:
                print(json.dumps({"falsification": "caught", "arm": arm,
                                  "violation": str(e)}))
                return any(m in str(e) for m in marks)
    finally:
        if prev is None:
            os.environ.pop("RAFTSQL_FLIGHT_DIR", None)
        else:
            os.environ["RAFTSQL_FLIGHT_DIR"] = prev
    return False


def run_falsification(family: str, seed: int, device="cuda",
                      commit_rule=None) -> bool:
    """Every falsification pair of `family`: the broken plan must be
    CAUGHT by the invariants, and the SAME schedule with the correct
    setting must pass them — proving the harness detects exactly that
    mistake, not chaos in general."""
    from raftsql_tpu_torch.chaos.invariants import InvariantViolation
    kw = dict(device=device, commit_rule=commit_rule)
    ok = True
    for arm, plan, marks, passed in falsification_arms(family):
        ok &= _check(_falsify(plan(seed, broken=True), marks, arm, **kw),
                     f"falsification ({arm}): the BROKEN plan was NOT "
                     f"caught by the invariants")
        try:
            r = run_fused(plan(seed, broken=False), **kw)
        except InvariantViolation as e:
            ok = _check(False, f"falsification control ({arm}): the "
                               f"CORRECT plan tripped the invariant: {e}")
            continue
        print(json.dumps({"falsification_control": "passed",
                          "arm": arm}))
        ok &= _check(passed(r), f"falsification control ({arm}): {r}")
    return ok


def _family_twice(name: str, seed: int, runs: int, key: str, **kw):
    """The family `runs` times: every run's faults must fire and all
    runs must agree on (r[key], result digest).  Returns (ok, reports)."""
    gen, fired = family_specs()[name]
    ok = True
    reports = []
    for run in range(runs):
        r = run_fused(gen(seed), **kw)
        r["run"] = run
        reports.append(r)
        print(json.dumps(r, sort_keys=True))
        ok &= _check(fired(r), f"{name}: a signature fault never fired "
                               f"({r})")
    digests = {(r[key], r["result_digest"]) for r in reports}
    ok &= _check(len(digests) == 1, f"{name}: non-reproducible: {digests}")
    return ok, reports


# family -> (process runner, fired predicate(report, plan))
def proc_family_specs():
    from raftsql_tpu_torch.chaos import proc
    return {
        "procs": (proc.ProcChaosRunner,
                  lambda r, p: r["kills"] >= len(p.kills)
                  and r["stalls"] >= len(p.stalls)
                  and r["storm_restarts"] >= p.peers * len(p.storms)
                  and r["fsio_exits"] >= 1 and r["fatal_exits"] >= 1),
        "reads": (proc.ProcReadChaosRunner,
                  lambda r, p: r["linear_reads"] > 0
                  and r["session_reads"] > 0
                  and r["follower_reads"] > 0),
        "transfers": (proc.ProcTransferChaosRunner,
                      lambda r, p: r["transfers_requested"] > 0
                      and r["transfers_completed"] > 0),
    }


def procs_gauntlet(family: str, seed: int, ticks: int, runs: int = 2,
                   device="cuda"):
    """Process-plane chaos: `family`'s runner (procs, reads or
    transfers) over generate_procs(seed, ticks), `runs` times in fresh
    work dirs, its server children on `device`.  Every run must pass
    every invariant (violations raise), fire its families, and see no
    server die of anything unscripted; all runs must agree on schedule
    + verdict digests.  Returns (ok, reports), each report with its
    run's wall time (`wall_s`)."""
    from raftsql_tpu_torch.chaos.schedule import generate_procs
    cls, fired = proc_family_specs()[family]
    plan = generate_procs(seed, ticks=ticks)
    ok = True
    reports = []
    for run in range(runs):
        t0 = time.monotonic()
        with tempfile.TemporaryDirectory(prefix="raftsql-procs-") as d:
            r = cls(plan, d, device=device).run()
        r["wall_s"] = time.monotonic() - t0
        r["run"] = run
        reports.append(r)
        print(json.dumps(r, sort_keys=True))
        ok &= _check(fired(r, plan), f"{family}: a scripted fault family "
                                     f"never fired ({r})")
        ok &= _check(r["unexpected_exits"] == 0,
                     f"{family}: a server died of something unscripted "
                     f"({r})")
    digests = {(r["schedule_digest"], r["result_digest"])
               for r in reports}
    ok &= _check(len(digests) == 1,
                 f"{family}: non-reproducible verdicts: {digests}")
    return ok, reports


def run_procs(seed: int, ticks: int = 80, runs: int = 2,
              device="cuda") -> int:
    """`--procs`: the process-plane nemesis (SIGKILL, SIGSTOP, restart
    storms, env disk faults) over real `raftsql_tpu_torch.server.main`
    processes on `device`, through procs_gauntlet."""
    ok, reports = procs_gauntlet("procs", seed, ticks, runs=runs,
                                 device=device)
    if ok:
        print(f"chaos procs ok: seed={seed} "
              f"schedule={reports[0]['schedule_digest']} "
              f"verdict={reports[0]['result_digest']} (x{runs} "
              f"identical)")
    return 0 if ok else 1


def run_reads(seed: int, runs: int = 2, with_procs: bool = True,
              device="cuda", commit_rule=None) -> int:
    """The read-plane gauntlet: the fused read nemesis (family `reads`)
    `runs` times, then the lease falsification pair — the mis-sized
    lease bound under 4x skew must be caught as a stale lease read, and
    the same schedule with a correctly sized bound must pass — then,
    unless `with_procs` is False, the process-plane read nemesis
    (ProcReadChaosRunner: linear, session and follower HTTP reads race
    the nemesis over real server processes) `runs` times, whose verdict
    digests must reproduce.  `device` is also the children's."""
    kw = dict(device=device, commit_rule=commit_rule)
    ok, reports = _family_twice("reads", seed, runs, "schedule_digest",
                                **kw)
    ok &= run_falsification("reads", seed, **kw)
    if with_procs:
        ok &= procs_gauntlet("reads", seed, 60, runs=runs,
                             device=device)[0]
    if ok:
        print(f"chaos reads ok: seed={seed} "
              f"schedule={reports[0]['schedule_digest']} "
              f"result={reports[0]['result_digest']} "
              f"falsification=caught")
    return 0 if ok else 1


def run_transfers(seed: int, runs: int = 2, with_procs: bool = True,
                  device="cuda", commit_rule=None) -> int:
    """The leadership-transfer gauntlet: the transfer nemesis (family
    `transfers`) `runs` times, then the falsification pair — the broken
    kernel (unsafe_transfer: abdicate before the target caught up) must
    be caught by TransferAvailability on a directed lagging-target
    schedule, and the correct kernel on the same schedule must pass
    with the transfer completed — then, unless `with_procs` is False,
    the process-plane transfer nemesis (ProcTransferChaosRunner: POST
    /transfer against real server processes under the seeded script)
    `runs` times, whose verdict digests must reproduce."""
    kw = dict(device=device, commit_rule=commit_rule)
    ok, reports = _family_twice("transfers", seed, runs,
                                "schedule_digest", **kw)
    ok &= run_falsification("transfers", seed, **kw)
    if with_procs:
        ok &= procs_gauntlet("transfers", seed, 60, runs=runs,
                             device=device)[0]
    if ok:
        print(f"chaos transfers ok: seed={seed} "
              f"schedule={reports[0]['schedule_digest']} "
              f"result={reports[0]['result_digest']} "
              f"falsification=caught")
    return 0 if ok else 1


def run_quorum(seed: int, runs: int = 2, device="cuda",
               commit_rule=None) -> int:
    """The quorum-geometry gauntlet: the witness-cluster family
    (`quorum`: 2 voters + 1 witness, W = E = 2) `runs` times; W=1/E=2 on
    3 peers refused at config time; then arm A, non-intersecting
    quorums (the directed split-brain plan with the gate bypassed must
    be caught, W=2 on the same schedule must pass), and arm B, a
    witness counted toward the lease quorum (must be caught as a stale
    lease read; the honest witness must pass)."""
    from raftsql_tpu_torch.config import RaftConfig
    kw = dict(device=device, commit_rule=commit_rule)
    ok, reports = _family_twice("quorum", seed, runs, "plan_digest", **kw)
    try:
        RaftConfig(num_groups=1, num_peers=3,
                   write_quorum=1, election_quorum=2)
    except ValueError as e:
        refused = "intersect" in str(e)
        print(json.dumps({"geometry_guard": "refused", "error": str(e)}))
    else:
        refused = False
    ok &= _check(refused, "quorum: W=1/E=2 on 3 peers was NOT refused "
                          "at config time")
    ok &= run_falsification("quorum", seed, **kw)
    if ok:
        r0 = reports[0]
        print(f"chaos quorum ok: seed={seed} plan={r0['plan_digest']} "
              f"result={r0['result_digest']} "
              f"witness_appends={r0['witness_appends']} "
              f"apply_streams={r0['apply_streams']}/{r0['wal_streams']} "
              f"falsification=caught(x2)")
    return 0 if ok else 1


def overload_gauntlet(seed: int, runs: int = 2, device="cuda",
                      commit_rule=None):
    """The overload-control gauntlet.  The overload nemesis
    (generate_overload: an open-loop producer at ~2x the engine's drain
    rate with bursts, hot-group skew, device-step deadlines, slow-fsync
    stalls and a crash+restart mid-overload, against the bounded
    admission controller attached as the server attaches it) `runs`
    times: plan + result digests must reproduce, refusals, stage-sheds,
    stalls and the crash must fire, the propose backlog must stay at or
    under the cap, and the goodput and starvation floors must hold.
    Then the falsification pair: the same sustained 2x load with NO
    admission controller must be caught as OVERLOAD-MEMORY, and the
    bounded control must pass and refuse.  Returns (ok, reports), each
    report with its run's wall time (`wall_s`)."""
    from raftsql_tpu_torch.chaos import schedule as S
    kw = dict(device=device, commit_rule=commit_rule)
    plan = S.generate_overload(seed)
    ok = True
    reports = []
    for run in range(runs):
        t0 = time.monotonic()
        r = run_fused(plan, **kw)
        r["wall_s"] = time.monotonic() - t0
        r["run"] = run
        reports.append(r)
        print(json.dumps(r, sort_keys=True))
        ok &= _check(r["overload_rejected"] > 0
                     and r["overload_shed_stage"] > 0
                     and r["fsync_stalls"] > 0 and r["crashes"] >= 1,
                     f"overload: a pressure family never fired ({r})")
        ok &= _check(r["overload_depth_peak"] <= plan.total_cap,
                     f"overload: backlog peak "
                     f"{r['overload_depth_peak']} exceeded the cap "
                     f"{plan.total_cap} without tripping the "
                     f"invariant ({r})")
        ok &= _check(
            r["committed_entries"] >= plan.goodput_floor * plan.ticks,
            f"overload: goodput floor missed — "
            f"{r['committed_entries']} committed < "
            f"{plan.goodput_floor * plan.ticks} ({r})")
        ok &= _check(
            min(r["group_commits"]) >= plan.starvation_floor,
            f"overload: a group starved — per-group commits "
            f"{r['group_commits']} < floor {plan.starvation_floor} "
            f"({r})")
    digests = {(r["plan_digest"], r["result_digest"]) for r in reports}
    ok &= _check(len(digests) == 1,
                 f"overload: non-reproducible: {digests}")
    ok &= run_falsification("overload", seed, **kw)
    return ok, reports


def run_overload(seed: int, runs: int = 2, device="cuda",
                 commit_rule=None) -> int:
    """`--overload`: the overload-control gauntlet (overload_gauntlet)."""
    from raftsql_tpu_torch.chaos.schedule import generate_overload
    ok, reports = overload_gauntlet(seed, runs=runs, device=device,
                                    commit_rule=commit_rule)
    if ok:
        r0 = reports[0]
        cap = generate_overload(seed).total_cap
        print(f"chaos overload ok: seed={seed} "
              f"plan={r0['plan_digest']} "
              f"result={r0['result_digest']} "
              f"rejected={r0['overload_rejected']} "
              f"shed_stage={r0['overload_shed_stage']} "
              f"depth_peak={r0['overload_depth_peak']}"
              f"/{cap} (x{runs} identical) falsification=caught")
    return 0 if ok else 1


def reshard_gauntlet(seed: int, runs: int = 2, device="cuda",
                     commit_rule=None):
    """The elastic-keyspace gauntlet.  The reshard nemesis
    (generate_reshard: seeded split/merge/migrate verbs racing
    partitions, drops, a whole-cluster crash+restart, coordinator
    SIGKILL mid-verb and a disk fault on the migrate snapshot ship,
    under live acked-PUT load) `runs` times: plan + result digests must
    reproduce, NoAckedWriteLost / NoAvailabilityLoss (plus the standing
    election-safety / durability / linearizability suite) must hold, and
    the run must exercise every verb, a coordinator kill+recovery and
    the fork-fault abort.  Then the falsification pair
    (falsification_reshard_plan): a coordinator that flips the router
    BEFORE the destination group applied the copied rows must be caught
    by NoAckedWriteLost, and the same schedule with the correct
    coordinator must complete the split.  Returns (ok, reports), each
    report with its run's wall time (`wall_s`)."""
    from raftsql_tpu_torch.chaos import schedule as S
    kw = dict(device=device, commit_rule=commit_rule)
    plan = S.generate_reshard(seed)
    ok = True
    reports = []
    for run in range(runs):
        t0 = time.monotonic()
        r = run_fused(plan, **kw)
        r["wall_s"] = time.monotonic() - t0
        r["run"] = run
        reports.append(r)
        print(json.dumps(r, sort_keys=True))
        ok &= _check(r["reshard_splits"] >= 1
                     and r["reshard_merges"] >= 1
                     and r["reshard_migrations"] >= 1,
                     f"reshard: a verb family never completed ({r})")
        ok &= _check(r["coordinator_kills"] >= 1
                     and r["reshard_resumed"] >= 1,
                     f"reshard: no SIGKILL+journal-recovery cycle ({r})")
        ok &= _check(r["fork_faults"] >= 1
                     and r["reshard_aborted"] >= 1,
                     f"reshard: the disk-fault abort path never fired "
                     f"({r})")
    digests = {(r["plan_digest"], r["result_digest"]) for r in reports}
    ok &= _check(len(digests) == 1,
                 f"reshard: non-reproducible: {digests}")
    ok &= run_falsification("reshard", seed, **kw)
    return ok, reports


def run_reshard(seed: int, runs: int = 2, device="cuda",
                commit_rule=None) -> int:
    """`--reshard`: the elastic-keyspace gauntlet (reshard_gauntlet)."""
    ok, reports = reshard_gauntlet(seed, runs=runs, device=device,
                                   commit_rule=commit_rule)
    if ok:
        r0 = reports[0]
        print(f"chaos reshard ok: seed={seed} "
              f"plan={r0['plan_digest']} "
              f"schedule={r0['schedule_digest']} "
              f"result={r0['result_digest']} (x{runs} identical) "
              f"falsification=caught")
    return 0 if ok else 1


def run_pod_plan(plan, device="cuda") -> dict:
    """One run of PodChaosPlan `plan` (chaos/pod.py PodChaosRunner, its
    children on `device`) in a fresh temporary work dir."""
    from raftsql_tpu_torch.chaos.pod import PodChaosRunner
    with tempfile.TemporaryDirectory(prefix="raftsql-pod-") as d:
        return PodChaosRunner(plan, d, device=device).run()


def pod_gauntlet(seed: int, runs: int = 2, device="cuda",
                 workers: int = 1):
    """The multi-host pod gauntlet.

    1. The pod nemesis (schedule.py generate_pod): a 2-process pod runs
       three incarnations of an acked-write workload (a propose-plane
       cut, SIGKILL of the non-coordinator host, SIGKILL of the
       coordinator, then a fault-free audit incarnation), `runs` times.
       Every acked write must survive into the merged cross-host replay,
       apply exactly once post-dedup, and every host must fold to the
       identical state; plan + verdict digests must reproduce.
    2. The FALSIFICATION pair (schedule.py falsification_pod_plan):
       acks written at OFFER time plus a scripted pre-durability crash
       MUST be caught by the durability invariant, and the SAME schedule
       with honest post-publish acks must pass.

    The runs go in this order, one at a time, as the reference runs
    them.  They are independent pods (their own work dirs and
    coordinator ports) and most of their time is child processes
    starting, so `workers` > 1 runs that many at once, one thread each
    (chip_smoke.py does, to keep inside its time limit, and holds the
    verdicts to the JAX package's digests).  Returns (ok, reports),
    each report with its run's wall time."""
    from concurrent.futures import ThreadPoolExecutor

    from raftsql_tpu_torch.chaos import schedule as S
    from raftsql_tpu_torch.chaos.invariants import InvariantViolation

    def timed(plan):
        t0 = time.monotonic()
        try:
            r = run_pod_plan(plan, device=device)
        except InvariantViolation as e:
            return e
        r["wall_s"] = time.monotonic() - t0
        return r

    plan = S.generate_pod(seed)
    plans = [plan] * runs + [S.falsification_pod_plan(seed, broken=True),
                             S.falsification_pod_plan(seed, broken=False)]
    # The broken run's violation is EXPECTED: flight bundles go to a
    # temporary dir, not the cwd.
    prev = os.environ.get("RAFTSQL_FLIGHT_DIR")
    try:
        with tempfile.TemporaryDirectory(
                prefix="raftsql-falsification-") as fd:
            os.environ["RAFTSQL_FLIGHT_DIR"] = fd
            with ThreadPoolExecutor(max_workers=workers) as ex:
                results = list(ex.map(timed, plans))
    finally:
        if prev is None:
            os.environ.pop("RAFTSQL_FLIGHT_DIR", None)
        else:
            os.environ["RAFTSQL_FLIGHT_DIR"] = prev
    ok = True
    reports = []
    for run, r in enumerate(results[:runs]):
        if isinstance(r, InvariantViolation):
            ok = _check(False, f"pod: run {run} tripped an invariant: {r}")
            continue
        r["run"] = run
        reports.append(r)
        print(json.dumps(r, sort_keys=True))
        ok &= _check(r["noncoord_kills"] >= 1 and r["coord_kills"] >= 1
                     and r["pod_lost_exits"] >= 1
                     and r["cut_deferred"] > 0,
                     f"pod: a scripted fault family never fired ({r})")
        ok &= _check(r["unexpected_exits"] == 0,
                     f"pod: a child died of something unscripted ({r})")
        ok &= _check(r["acked"] > 0 and r["folded_keys"] > 0,
                     f"pod: the workload never acked anything ({r})")
    digests = {(r["plan_digest"], r["result_digest"]) for r in reports}
    ok &= _check(len(digests) == 1,
                 f"pod: non-reproducible verdicts: {digests}")
    broken, control = results[runs:]
    caught = isinstance(broken, InvariantViolation) \
        and "DURABILITY" in str(broken)
    if caught:
        print(json.dumps({"falsification": "caught",
                          "violation": str(broken)}))
    ok &= _check(caught, "falsification: the PREMATURE pod ack was NOT "
                         "caught by the durability invariant")
    if isinstance(control, InvariantViolation):
        ok = _check(False, f"falsification control: honest acks tripped "
                           f"the invariant: {control}")
    else:
        ok &= _check(control["crash_exits"] >= 1 and control["acked"] > 0,
                     "falsification control: the crash point never "
                     "fired (or nothing acked)")
        print(json.dumps({"falsification_control": "passed",
                          "acked": control["acked"],
                          "crash_exits": control["crash_exits"]}))
    return ok, reports


def run_pod(seed: int, runs: int = 2, device="cuda") -> int:
    """`--pod`: the multi-host pod gauntlet (pod_gauntlet)."""
    ok, reports = pod_gauntlet(seed, runs=runs, device=device)
    if ok:
        print(f"chaos pod ok: seed={seed} "
              f"plan={reports[0]['plan_digest']} "
              f"verdict={reports[0]['result_digest']} (x{runs} "
              f"identical) falsification=caught")
    return 0 if ok else 1


def run_replica_plan(plan, device="cuda") -> dict:
    """One run of ReplicaChaosPlan `plan` (chaos/replica.py
    ReplicaChaosRunner, its engine on `device`) in a fresh temporary
    work dir."""
    from raftsql_tpu_torch.chaos.replica import ReplicaChaosRunner
    with tempfile.TemporaryDirectory(prefix="raftsql-replica-") as d:
        return ReplicaChaosRunner(plan, d, device=device).run()


def replica_gauntlet(seed: int, runs: int = 2, device="cuda",
                     workers: int = 1):
    """The read-replica tier gauntlet.

    1. The replica nemesis (schedule.py generate_replica), `runs` times:
       every scripted fault fires, the workload acks writes and the
       replicas serve session and linear reads, the cut forces at least
       one refusal, and plan + verdict digests reproduce.
    2. The FALSIFICATION pair (schedule.py falsification_replica_plan):
       a replica booted with --unsafe-serve under a never-healed cut
       MUST be caught serving below an acked watermark by
       StaleReadNever, and the SAME schedule with the gates on must
       pass by refusing.

    The runs go in this order, one at a time, as the reference runs
    them; `workers` > 1 runs that many at once, one thread each (each
    run has its own ports and work dir).  Returns (ok, reports, walls):
    the nemesis runs' reports and the wall seconds of every run, the
    pair's two last."""
    from concurrent.futures import ThreadPoolExecutor

    from raftsql_tpu_torch.chaos import schedule as S
    from raftsql_tpu_torch.chaos.invariants import InvariantViolation

    def timed(plan):
        t0 = time.monotonic()
        try:
            r = run_replica_plan(plan, device=device)
        except InvariantViolation as e:
            r = e
        return r, time.monotonic() - t0

    plan = S.generate_replica(seed)
    plans = [plan] * runs + [
        S.falsification_replica_plan(seed, broken=True),
        S.falsification_replica_plan(seed, broken=False)]
    # The broken run's violation is EXPECTED: flight bundles go to a
    # temporary dir, not the cwd.
    prev = os.environ.get("RAFTSQL_FLIGHT_DIR")
    try:
        with tempfile.TemporaryDirectory(
                prefix="raftsql-falsification-") as fd:
            os.environ["RAFTSQL_FLIGHT_DIR"] = fd
            with ThreadPoolExecutor(max_workers=workers) as ex:
                timed_results = list(ex.map(timed, plans))
    finally:
        if prev is None:
            os.environ.pop("RAFTSQL_FLIGHT_DIR", None)
        else:
            os.environ["RAFTSQL_FLIGHT_DIR"] = prev
    results = [r for r, _ in timed_results]
    walls = [w for _, w in timed_results]
    ok = True
    reports = []
    for run, r in enumerate(results[:runs]):
        if isinstance(r, InvariantViolation):
            ok = _check(False, f"replica: run {run} tripped an invariant: "
                               f"{r}")
            continue
        r["run"] = run
        reports.append(r)
        print(json.dumps(r, sort_keys=True))
        ok &= _check(r["cuts"] >= 1 and r["heals"] >= 1
                     and r["kills"] >= 1 and r["restarts"] >= 1
                     and r["corrupts"] >= 1,
                     f"replica: a scripted fault family never fired ({r})")
        ok &= _check(r["acked"] > 0
                     and r["served_session"] > 0
                     and r["served_linear"] > 0,
                     f"replica: the workload never served a read ({r})")
        ok &= _check(r["refusals"] > 0,
                     f"replica: the cut never forced a refusal ({r})")
    digests = {(r["plan_digest"], r["result_digest"]) for r in reports}
    ok &= _check(len(digests) == 1,
                 f"replica: non-reproducible verdicts: {digests}")
    broken, control = results[runs:]
    caught = isinstance(broken, InvariantViolation) \
        and "STALE" in str(broken)
    if caught:
        print(json.dumps({"falsification": "caught",
                          "violation": str(broken)}))
    ok &= _check(caught, "falsification: the gate-less replica was "
                         "NOT caught by StaleReadNever")
    if isinstance(control, InvariantViolation):
        ok = _check(False, f"falsification control: the fail-closed "
                           f"ladder tripped the invariant: {control}")
    else:
        ok &= _check(control["refusals"] > 0 and control["acked"] > 0,
                     "falsification control: the cut never forced a "
                     "refusal (or nothing acked)")
        print(json.dumps({"falsification_control": "passed",
                          "acked": control["acked"],
                          "refusals": control["refusals"]}))
    return ok, reports, walls


def run_replica(seed: int, runs: int = 2, device="cuda") -> int:
    """`--replica`: the read-replica tier gauntlet (replica_gauntlet)."""
    ok, reports, _walls = replica_gauntlet(seed, runs=runs, device=device)
    if ok:
        print(f"chaos replica ok: seed={seed} "
              f"plan={reports[0]['plan_digest']} "
              f"verdict={reports[0]['result_digest']} (x{runs} "
              f"identical) falsification=caught")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int,
                    default=int(os.environ.get("SEED", "0")))
    ap.add_argument("--ticks", type=int, default=240)
    ap.add_argument("--runs", type=int, default=2,
                    help="repeat the seed and require identical digests")
    ap.add_argument("--steps", type=int, default=1,
                    help="fused steps per dispatch (epoch-framed when >1)")
    ap.add_argument("--matrix", action="store_true",
                    help="sweep one seed through every ported family")
    ap.add_argument("--family", action="append", default=None,
                    help="run only this family (repeatable; implies "
                         "--matrix)")
    ap.add_argument("--reads", action="store_true",
                    help="read-plane gauntlet: the read nemesis twice + "
                         "the lease-falsification pair")
    ap.add_argument("--transfers", action="store_true",
                    help="transfer-plane gauntlet: the transfer nemesis "
                         "twice + the broken-kernel falsification pair")
    ap.add_argument("--quorum", action="store_true",
                    help="quorum-geometry gauntlet: the witness-cluster "
                         "family twice + the non-intersecting-geometry "
                         "and witness-lease falsification pairs")
    ap.add_argument("--procs", action="store_true",
                    help="process-plane nemesis over real server "
                         "processes (SIGKILL, SIGSTOP, restart storms, "
                         "env disk faults), run twice")
    ap.add_argument("--overload", action="store_true",
                    help="overload-control nemesis: open-loop 2x "
                         "offered load with bursts, hot-group skew, "
                         "deadlines and slow-fsync stalls against the "
                         "bounded admission controller, run twice + the "
                         "no-admission falsification pair")
    ap.add_argument("--reshard", action="store_true",
                    help="the elastic-keyspace gauntlet: the reshard "
                         "nemesis twice, then its falsification pair")
    ap.add_argument("--pod", action="store_true",
                    help="multi-host pod nemesis: host SIGKILLs "
                         "(non-coordinator + coordinator) and a "
                         "propose-plane cut over a real 2-process pod, "
                         "run twice + the premature-ack falsification "
                         "pair")
    ap.add_argument("--replica", action="store_true",
                    help="read-replica tier nemesis: subscription "
                         "cut/heal, replica SIGKILL/respawn and stream "
                         "corruption over real replica processes, run "
                         "twice + the gate-less-replica falsification "
                         "pair")
    ap.add_argument("--no-procs", action="store_true",
                    help="with --reads/--transfers: skip the "
                         "process-plane leg")
    ap.add_argument("--proc-ticks", type=int,
                    default=int(os.environ.get("PROC_TICKS", "80")),
                    help="host ticks for the --procs script phase")
    ap.add_argument("--device", default="cuda",
                    help="torch device the consensus state steps on "
                         "(default cuda; 'cpu' runs the plain versions)")
    ap.add_argument("--commit-rule", default=None,
                    choices=("point", "windowed", "pallas"),
                    help="Phase-7 commit rule (default: the config's)")
    args = ap.parse_args(argv)

    from raftsql_tpu_torch.core.state import resolve_device
    resolve_device(args.device)              # raises without the card
    kw = dict(device=args.device, commit_rule=args.commit_rule)
    if args.reads:
        return run_reads(args.seed, runs=args.runs,
                         with_procs=not args.no_procs, **kw)
    if args.transfers:
        return run_transfers(args.seed, runs=args.runs,
                             with_procs=not args.no_procs, **kw)
    if args.quorum:
        return run_quorum(args.seed, runs=args.runs, **kw)
    if args.overload:
        return run_overload(args.seed, runs=args.runs, **kw)
    if args.reshard:
        return run_reshard(args.seed, runs=args.runs, **kw)
    if args.procs:
        return run_procs(args.seed, args.proc_ticks, runs=args.runs,
                         device=args.device)
    if args.pod:
        return run_pod(args.seed, runs=args.runs, device=args.device)
    if args.replica:
        return run_replica(args.seed, runs=args.runs, device=args.device)
    if args.matrix or args.family:
        return run_matrix(args.seed, only=args.family, **kw)

    from raftsql_tpu_torch.analysis.tripwire import SignatureTripwire
    from raftsql_tpu_torch.chaos.schedule import generate

    sched = generate(args.seed, ticks=args.ticks)
    # Armed before the first dispatch; the verdict prints OUTSIDE the
    # digested reports (call signatures are host-side facts, and the
    # result digests must stay comparable across tripwire changes).
    reports = []
    with SignatureTripwire() as tripwire:
        for run in range(args.runs):
            r = run_fused(sched, steps=args.steps, **kw)
            r["run"] = run
            reports.append(r)
            print(json.dumps(r, sort_keys=True))
    ok = _check(all(r["fsync_faults"] >= 1 and r["torn_writes"] >= 1
                    for r in reports),
                "a scheduled storage fault never fired")
    digests = {(r["schedule_digest"], r["result_digest"])
               for r in reports}
    ok &= _check(len(digests) == 1, f"non-deterministic run: {digests}")
    sigs = {k: v for k, v in tripwire.compiles().items() if v > 0}
    print(f"signature-tripwire: {json.dumps(sigs, sort_keys=True)}")
    ok &= _check(not tripwire.offenders(limit=1),
                 f"a step entry point saw a second call signature "
                 f"mid-run: {tripwire.offenders(limit=1)}")
    if ok:
        print(f"chaos ok: seed={args.seed} ticks={args.ticks} "
              f"schedule={reports[0]['schedule_digest']} "
              f"result={reports[0]['result_digest']} "
              f"(x{args.runs} identical)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
