"""The port's fused chaos harness (raftsql_tpu_torch/chaos/) against the
JAX package's, on the CPU.

Each test runs one schedule through both packages' FusedChaosRunner in
the same process, each booted from its own seed: the crashes, torn
writes, fsync faults, partitions, drops and delays, the WAL replays and
the invariants all run on both sides, and the schedule and result
digests must be equal.  The default family at SEED=0 must also give the
constants chip_smoke.py holds the card to (it has no JAX to compare
with).  The fused families and the multi-step dispatch are in
test_torch_chaos_families.py (one file each keeps either well under a
minute on one core).
"""
import dataclasses
import json

import pytest
import torch

import chip_smoke
from raftsql_tpu.chaos import schedule as JS
from raftsql_tpu.chaos.scenarios import FusedChaosRunner as JRunner
from raftsql_tpu_torch.chaos import run as trun
from raftsql_tpu_torch.chaos import schedule as TS
from raftsql_tpu_torch.chaos.scenarios import FusedChaosRunner as TRunner

torch.set_num_threads(1)


def jax_report(sched, path, commit_rule=None):
    runner = JRunner(sched, str(path))
    if commit_rule is not None:
        runner.cfg = dataclasses.replace(runner.cfg,
                                         commit_rule=commit_rule)
    return runner.run()


def port_runner(sched, path, commit_rule=None):
    return TRunner(sched, str(path), device="cpu", commit_rule=commit_rule)


@pytest.fixture(scope="module")
def port_default(tmp_path_factory):
    """The port's default family at SEED=0, 240 ticks, per rule."""
    out = {}
    for rule in ("point", "pallas"):
        d = tmp_path_factory.mktemp(f"port-{rule}")
        out[rule] = port_runner(TS.generate(0, ticks=240), d, rule).run()
    return out


@pytest.mark.parametrize("rule", ["point", "pallas"])
def test_default_family_seed0_equals_jax(port_default, tmp_path, rule):
    sched = JS.generate(0, ticks=240)
    want = jax_report(sched, tmp_path, rule)
    got = port_default[rule]
    assert got == want
    # The run exercised what the gate is about.
    assert got["crashes"] >= 2 and got["fsync_faults"] >= 1
    assert got["torn_writes"] >= 1 and got["partitions"] >= 2
    assert got["dropped_slots"] > 0 and got["delayed_slots"] > 0


def test_default_family_seed0_equals_chip_smoke_constant(port_default):
    want = chip_smoke.CHAOS_DIGESTS["default"]
    for rule, r in port_default.items():
        assert (r["schedule_digest"], r["result_digest"]) == want, rule


def test_seed0_families_equal_chip_smoke_constants(tmp_path):
    """Schedules are pure numpy: every family's seed-0 schedule digest
    (a nemesis plan's: the digest of the schedule its runner projects it
    into) must be the constant the chip run checks (its result digest
    is checked there and, at the tests' tick counts, above)."""
    for name, (gen, _) in trun.family_specs().items():
        plan = gen(0)
        sched = trun.runner_class(plan)(plan, str(tmp_path),
                                        device="cpu").sched
        assert sched.digest() == chip_smoke.CHAOS_DIGESTS[name][0], name
    assert TS.generate(0).digest() == chip_smoke.CHAOS_DIGESTS[
        "default"][0]


def test_cli_default_family_cpu(capsys):
    assert trun.main(["--device", "cpu", "--runs", "2"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == ("chaos ok: seed=0 ticks=240 "
                       "schedule=622b22c59545816b "
                       "result=3bcaa6784fc0a2d8 (x2 identical)")
    # The signature tripwire's verdict, outside the digested reports.
    assert out[-2] == 'signature-tripwire: {"cluster_step_host": 1}'
    assert [json.loads(line)["run"] for line in out[:-2]] == [0, 1]


def test_entry_points_default_to_the_card(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        TRunner(TS.generate(0), str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        trun.main(["--runs", "1"])
    assert trun.main(["--family", "replica", "--device", "cpu"]) == 2
    assert "not ported" in capsys.readouterr().err
