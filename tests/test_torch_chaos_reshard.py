"""The reshard chaos family on the port (chaos/scenarios.py
ReshardChaosRunner, chaos/schedule.py generate_reshard and
falsification_reshard_plan, chaos/run.py --reshard) against the JAX
package's.

At seed 0 the JAX package's ReshardChaosRunner runs once and the port's
twice (the point rule, and the pallas rule, whose kernel takes its plain
version here): the reports must be equal key for key, and the digests
equal the constants chip_smoke.py holds the card to.  The JAX package's
own falsification pair, unrepaired, gives the JAX outcome on the port
too: under the partitionable threefry draws its broken coordinator is
NOT caught.  The port's repaired plan (falsification_reshard_plan's
default) catches the broken flip and passes the control at seeds 0-3.
"""
import os
import tempfile

import pytest
import torch

import chip_smoke
from raftsql_tpu.chaos import schedule as JS
from raftsql_tpu.chaos.scenarios import ReshardChaosRunner as JRunner
from raftsql_tpu_torch.chaos import run as trun
from raftsql_tpu_torch.chaos import schedule as TS
from raftsql_tpu_torch.chaos.invariants import (InvariantViolation,
                                                NoAckedWriteLost,
                                                NoAvailabilityLoss)

torch.set_num_threads(1)


def _jax(plan):
    with tempfile.TemporaryDirectory() as d:
        return JRunner(plan, d).run()


@pytest.fixture(scope="module")
def jax_nemesis():
    return _jax(JS.generate_reshard(0))


@pytest.mark.parametrize("seed", range(4))
def test_plan_digests_equal_jax(seed):
    assert TS.generate_reshard(seed).digest() \
        == JS.generate_reshard(seed).digest()
    assert TS.generate_reshard(seed).describe() \
        == JS.generate_reshard(seed).describe()
    for broken in (True, False):
        unrepaired = TS.falsification_reshard_plan(seed, broken,
                                                   repaired=False)
        ref = JS.falsification_reshard_plan(seed, broken)
        assert unrepaired.digest() == ref.digest()
        assert TS.falsification_reshard_plan(seed, broken).digest() \
            != ref.digest()


@pytest.mark.parametrize("rule", [None, "pallas"])
def test_reshard_nemesis_equals_jax(jax_nemesis, rule):
    got = trun.run_fused(TS.generate_reshard(0), device="cpu",
                         commit_rule=rule)
    assert got == jax_nemesis
    plan, sched, result = chip_smoke.RESHARD_DIGESTS["nemesis"]
    assert (got["plan_digest"], got["schedule_digest"],
            got["result_digest"]) == (plan, sched, result)
    # What the verbs did at seed 0 (PERF.md records it): one split, the
    # merge and the clean migrate completed; split 1 (its coordinator
    # killed before the copy fence) and the disk-faulted migrate
    # aborted; both coordinator kills resumed from the journal fold.
    assert (got["reshard_splits"], got["reshard_merges"],
            got["reshard_migrations"], got["reshard_aborted"],
            got["reshard_resumed"], got["coordinator_kills"],
            got["fork_faults"]) == (1, 1, 1, 2, 2, 2, 1)


def _outcome(run, plan):
    with tempfile.TemporaryDirectory() as fd:
        prev = os.environ.get("RAFTSQL_FLIGHT_DIR")
        os.environ["RAFTSQL_FLIGHT_DIR"] = fd
        try:
            r = run(plan)
        except InvariantViolation as e:
            return ("caught", str(e))
        finally:
            if prev is None:
                os.environ.pop("RAFTSQL_FLIGHT_DIR", None)
            else:
                os.environ["RAFTSQL_FLIGHT_DIR"] = prev
    return ("passed", r)


@pytest.mark.parametrize("broken", [True, False])
def test_unrepaired_falsification_pair_gives_the_jax_outcome(broken):
    """The JAX package's directed plan on the port: the same report as a
    live JAX run, key for key.  The broken coordinator passes (is NOT
    caught) under these draws: the fault ROADMAP Queue 3 records."""
    plan = TS.falsification_reshard_plan(0, broken, repaired=False)
    got = _outcome(lambda p: trun.run_fused(p, device="cpu"), plan)
    want = _outcome(_jax, JS.falsification_reshard_plan(0, broken))
    assert got == want
    assert got[0] == "passed"
    digests = chip_smoke.RESHARD_DIGESTS["unrepaired"]
    assert got[1]["result_digest"] == digests["broken" if broken
                                              else "control"]


@pytest.mark.parametrize("seed", range(4))
def test_repaired_falsification_pair(seed):
    """The port's directed plan: the premature router flip is caught by
    NoAckedWriteLost, and the same schedule with the correct
    coordinator completes the split."""
    kind, err = _outcome(lambda p: trun.run_fused(p, device="cpu"),
                         TS.falsification_reshard_plan(seed, True))
    assert kind == "caught" and "NO-ACKED-WRITE-LOST" in err, err
    assert "the flip outran the copy fence" in err
    kind, r = _outcome(lambda p: trun.run_fused(p, device="cpu"),
                       TS.falsification_reshard_plan(seed, False))
    assert kind == "passed"
    assert r["reshard_splits"] == 1 and r["moved_checks"] > 0
    if seed == 0:
        assert r["result_digest"] == \
            chip_smoke.RESHARD_DIGESTS["control"]


def test_reshard_cli_gauntlet():
    assert trun.main(["--reshard", "--runs", "1", "--device", "cpu",
                      "--commit-rule", "pallas"]) == 0


def test_no_acked_write_lost_units():
    inv = NoAckedWriteLost()
    inv.note_ack("a", "1")
    inv.check_moved(["a", "b"], 2, {"a": "1"})
    with pytest.raises(InvariantViolation, match="NO-ACKED-WRITE-LOST"):
        inv.check_moved(["a"], 2, {})

    class _KM:
        def group_of(self, k):
            return 0
    inv.check_exclusive(_KM(), {0: {"a": "1"}, 1: {}})
    with pytest.raises(InvariantViolation, match="duplicate shard"):
        inv.check_exclusive(_KM(), {0: {"a": "1"}, 1: {"a": "1"}})
    assert inv.moved_checks == 2 and inv.exclusive_checks == 2


def test_no_availability_loss_units():
    av = NoAvailabilityLoss(probe_ticks=5, verb_deadline_ticks=10)
    av.verb_started(0, 1)
    av.arm_probe(0, "k", "v1")
    av.check(5)
    av.probe_committed("v1")
    assert av.probes_confirmed == 1
    av.note_crash(8)                 # restarts the verb's clock
    av.check(17)
    with pytest.raises(InvariantViolation, match="NO-AVAILABILITY-LOSS"):
        av.check(19)
    av.verb_resolved()
    av.final_check(30)
    av.arm_probe(30, "k", "v2")
    with pytest.raises(InvariantViolation, match="did not commit"):
        av.check(36)
