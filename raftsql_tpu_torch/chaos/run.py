"""Run seeded chaos scenarios on the port and prove they reproduce.

    python -m raftsql_tpu_torch.chaos.run --seed 0 --ticks 240 --runs 2
    python -m raftsql_tpu_torch.chaos.run --matrix --seed 0
    python -m raftsql_tpu_torch.chaos.run --family reads --seed 3
    python -m raftsql_tpu_torch.chaos.run --reads --no-procs
    python -m raftsql_tpu_torch.chaos.run --device cpu      # no card

Port of the fused and node-plane parts of raftsql_tpu/chaos/run.py.  Default mode
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
is not bit-reproducible, so they run once.  The JAX package's other
families (mesh_skew, procs, pod, replica, reshard, overload) need
planes this port has not reached yet.

--reads, --transfers and --quorum are the gauntlets: the family twice,
then its falsification pairs (a deliberately broken lease bound,
transfer kernel or quorum geometry must be CAUGHT by the invariants,
and the same schedule with the correct setting must pass).  The
process-plane arms of --reads and --transfers (the JAX package's
process chaos runners, the remainder of ROADMAP Queue 1 item 8) are not
ported yet: without --no-procs they raise NotImplementedError.

`--device` picks where the consensus state steps (default cuda; a
missing card is an error) and `--commit-rule` the Phase-7 commit rule
("pallas" runs the quorum kernels).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def runner_class(plan):
    """The fused runner that drives `plan`, by the plan's type."""
    from raftsql_tpu_torch.chaos import scenarios as C
    from raftsql_tpu_torch.chaos import schedule as S
    return {S.ChaosSchedule: C.FusedChaosRunner,
            S.ReadNemesisPlan: C.ReadNemesisRunner,
            S.QuorumNemesisPlan: C.QuorumChaosRunner,
            S.TransferNemesisPlan: C.TransferChaosRunner}[type(plan)]


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
    kw = dict(device=device, commit_rule=commit_rule)
    specs = {name: (lambda gen=gen: run_fused(gen(seed), **kw), True,
                    fired)
             for name, (gen, fired) in family_specs().items()}
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


def _procs_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"the process-plane {what} nemesis (the JAX package's "
        "chaos/proc.py ProcReadChaosRunner/ProcTransferChaosRunner) is "
        "not ported yet (ROADMAP Queue 1 item 8, its remainder: the "
        "process chaos runners); "
        "pass --no-procs (with_procs=False) to run the fused arms")


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


def run_reads(seed: int, runs: int = 2, with_procs: bool = True,
              device="cuda", commit_rule=None) -> int:
    """The read-plane gauntlet: the fused read nemesis (family `reads`)
    `runs` times, then the lease falsification pair — the mis-sized
    lease bound under 4x skew must be caught as a stale lease read, and
    the same schedule with a correctly sized bound must pass."""
    if with_procs:
        raise _procs_not_ported("read")
    kw = dict(device=device, commit_rule=commit_rule)
    ok, reports = _family_twice("reads", seed, runs, "schedule_digest",
                                **kw)
    ok &= run_falsification("reads", seed, **kw)
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
    with the transfer completed."""
    if with_procs:
        raise _procs_not_ported("transfer")
    kw = dict(device=device, commit_rule=commit_rule)
    ok, reports = _family_twice("transfers", seed, runs,
                                "schedule_digest", **kw)
    ok &= run_falsification("transfers", seed, **kw)
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
    ap.add_argument("--no-procs", action="store_true",
                    help="with --reads/--transfers: leave out the "
                         "process-plane leg (not ported yet: without "
                         "this flag those gauntlets raise)")
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
    if args.matrix or args.family:
        return run_matrix(args.seed, only=args.family, **kw)

    from raftsql_tpu_torch.chaos.schedule import generate

    sched = generate(args.seed, ticks=args.ticks)
    reports = []
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
    if ok:
        print(f"chaos ok: seed={args.seed} ticks={args.ticks} "
              f"schedule={reports[0]['schedule_digest']} "
              f"result={reports[0]['result_digest']} "
              f"(x{args.runs} identical)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
