"""Run seeded chaos scenarios on the port and prove they reproduce.

    python -m raftsql_tpu_torch.chaos.run --seed 0 --ticks 240 --runs 2
    python -m raftsql_tpu_torch.chaos.run --matrix --seed 0
    python -m raftsql_tpu_torch.chaos.run --family enospc --seed 3
    python -m raftsql_tpu_torch.chaos.run --device cpu      # no card

Port of the fused part of raftsql_tpu/chaos/run.py.  Default mode
generates the seed's full ChaosSchedule (>= 2 partitions, >= 2
crash/restart events, >= 1 injected fsync fault, plus a torn-write
power loss), runs it against a fresh FusedClusterNode data dir per run,
and prints one JSON line per run.  With --runs > 1 the runs must
produce IDENTICAL schedule and result digests.  The node boots from the
JAX package's threefry draws, so the digests equal the JAX package's
runner's for the same seed.

--matrix sweeps ONE seed through the fused scenario FAMILIES:

    asym             one-directional partitions
    skew             per-peer clock skew
    enospc           disk-full on WAL append
    fsync_stall      slow-disk fsync latency
    compact          compaction + crash interleaving

Each family runs twice and must reproduce identical schedule + result
digests, and its signature faults must have fired.  The JAX package's
other families (mesh_skew, corrupt, snapshot, tcp, membership,
tcp_rebind, reads, quorum, transfers, ...) need planes this port has
not reached yet.

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


def run_fused(sched, steps: int = 1, device="cuda",
              commit_rule=None) -> dict:
    """One FusedChaosRunner run of `sched` in a fresh temporary data
    dir; returns its report."""
    from raftsql_tpu_torch.chaos.scenarios import FusedChaosRunner
    with tempfile.TemporaryDirectory(prefix="raftsql-chaos-") as d:
        return FusedChaosRunner(sched, d, steps=steps, device=device,
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
    }


def _digests(r: dict):
    return r["schedule_digest"], r["result_digest"]


def run_matrix(seed: int, only=None, device="cuda",
               commit_rule=None) -> int:
    specs = family_specs()
    unknown = sorted(set(only or ()) - set(specs))
    if unknown:
        print(f"CHAOS FAIL: families not ported: {unknown} (ported: "
              f"{sorted(specs)})", file=sys.stderr)
        return 2
    ok = True
    for name, (gen, fired) in specs.items():
        if only and name not in only:
            continue
        reports = [run_fused(gen(seed), device=device,
                             commit_rule=commit_rule) for _ in range(2)]
        ok &= _check(
            _digests(reports[0]) == _digests(reports[1]),
            f"family {name}: non-deterministic "
            f"({_digests(reports[0])} != {_digests(reports[1])})")
        ok &= _check(fired(reports[0]),
                     f"family {name}: signature fault never fired "
                     f"({reports[0]})")
        out = {"family": name, "seed": seed, "deterministic": True,
               **reports[0]}
        print(json.dumps(out, sort_keys=True))
    if ok:
        print(f"chaos matrix ok: seed={seed} families="
              f"{','.join(only or specs)}")
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
                    help="sweep one seed through every fused family")
    ap.add_argument("--family", action="append", default=None,
                    help="run only this family (repeatable; implies "
                         "--matrix)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the consensus state steps on "
                         "(default cuda; 'cpu' runs the plain versions)")
    ap.add_argument("--commit-rule", default=None,
                    choices=("point", "windowed", "pallas"),
                    help="Phase-7 commit rule (default: the config's)")
    args = ap.parse_args(argv)

    from raftsql_tpu_torch.core.state import resolve_device
    resolve_device(args.device)              # raises without the card
    if args.matrix or args.family:
        return run_matrix(args.seed, only=args.family, device=args.device,
                          commit_rule=args.commit_rule)

    from raftsql_tpu_torch.chaos.schedule import generate

    sched = generate(args.seed, ticks=args.ticks)
    reports = []
    for run in range(args.runs):
        r = run_fused(sched, steps=args.steps, device=args.device,
                      commit_rule=args.commit_rule)
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
