"""The port's read-replica chaos plane (chaos/schedule.py replica plans,
chaos/replica.py ReplicaChaosRunner, chaos/run.py --replica) beside the
JAX package's.

The plans are pure functions of the seed: their digests must equal the
JAX package's.  The runner's verdict digest is a pure function of the
plan when every invariant passes and every scripted fault fired, so the
port's must equal the JAX runner's `_verdict_digest` over an all-pass
report (the JAX package's engine cannot be the live reference on a CPU
host: it dies at boot in parity mode, see
tests/test_torch_shm.py::test_empty_group_snapshot).  The gauntlet runs
here with its engine on the CPU and its replica processes off the card:
the nemesis once, then the falsification pair (the gate-less replica
caught, its control passing).
"""
import dataclasses

import pytest
import torch

from raftsql_tpu.chaos import schedule as JS
from raftsql_tpu_torch.chaos import schedule as TS

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_replica_plans_match_jax(seed):
    j, t = JS.generate_replica(seed), TS.generate_replica(seed)
    assert t.digest() == j.digest()
    assert t.describe() == dataclasses.asdict(j)
    for broken in (True, False):
        j = JS.falsification_replica_plan(seed, broken=broken)
        t = TS.falsification_replica_plan(seed, broken=broken)
        assert t.digest() == j.digest()
        assert t.describe() == dataclasses.asdict(j)


def _jax_all_pass_verdict(plan, tmp_path):
    """The JAX runner's _verdict_digest for an all-pass run of `plan`:
    every invariant passed and every scripted fault fired once."""
    from raftsql_tpu.chaos.replica import ReplicaChaosRunner as JRunner
    r = JRunner(plan, str(tmp_path / "jax"))
    r.verdicts = {"stale_read_never": "pass", "converges": "pass"}
    if any(f.kind == "corrupt" for f in plan.faults):
        r.verdicts["corruption_detected"] = "pass"
    for f in plan.faults:
        r.report[f.kind + "s"] += 1
    return r._verdict_digest()


def test_replica_gauntlet_on_cpu(tmp_path):
    """replica_gauntlet at seed 0 (the nemesis once, then the
    falsification pair): every scripted fault fired, the replicas served
    session and linear reads, the cut forced refusals, the gate-less
    replica was caught and its control passed; and the verdict digest
    equals the JAX runner's all-pass digest."""
    from raftsql_tpu_torch.chaos.run import replica_gauntlet

    ok, reports, walls = replica_gauntlet(0, runs=1, device="cpu")
    assert ok
    assert len(reports) == 1 and len(walls) == 3
    r = reports[0]
    plan = JS.generate_replica(0)
    assert r["plan_digest"] == plan.digest()
    assert r["result_digest"] == _jax_all_pass_verdict(plan, tmp_path)


def test_replica_runner_refuses_missing_card(tmp_path):
    from raftsql_tpu_torch.chaos.replica import ReplicaChaosRunner
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        ReplicaChaosRunner(TS.generate_replica(0), str(tmp_path))
