"""The port's fused chaos families and its multi-step dispatch against
the JAX package's, on the CPU.

Each test runs one schedule through both packages' FusedChaosRunner in
the same process, each booted from its own seed; the reports (schedule
and result digests, every fault counter) must be equal.  The families
run at the seeds and tick counts of the JAX package's own family tests
(tests/test_chaos.py).
"""
import pytest
import torch

from raftsql_tpu.chaos import schedule as JS
from raftsql_tpu.chaos.scenarios import FusedChaosRunner as JRunner
from raftsql_tpu_torch.chaos import run as trun
from raftsql_tpu_torch.chaos import schedule as TS
from raftsql_tpu_torch.chaos.scenarios import FusedChaosRunner as TRunner

torch.set_num_threads(1)


def test_multistep_dispatch_equals_jax(tmp_path):
    """Epoch-framed multi-step dispatch (4 steps per tick): crashes land
    mid-epoch and recovery drops uncommitted dispatches on both sides."""
    sched = TS.generate(3, ticks=90)
    got = TRunner(sched, str(tmp_path / "port"), steps=4,
                  device="cpu").run()
    want = JRunner(JS.generate(3, ticks=90), str(tmp_path / "jax"),
                   steps=4).run()
    assert got == want and got["crashes"] >= 2


FAMILIES = [("asym", 2, 110), ("skew", 0, 120), ("skew", 4, 100),
            ("enospc", 1, 110), ("fsync_stall", 1, 100),
            ("compact", 3, 160)]
GEN = {"asym": "generate_asym", "skew": "generate_skew",
       "enospc": "generate_enospc", "fsync_stall": "generate_stall",
       "compact": "generate_compact"}


@pytest.mark.parametrize("family,seed,ticks", FAMILIES)
def test_fused_family_equals_jax(tmp_path, family, seed, ticks):
    sched = getattr(TS, GEN[family])(seed, ticks=ticks)
    jsched = getattr(JS, GEN[family])(seed, ticks=ticks)
    assert sched.digest() == jsched.digest()
    runner = TRunner(sched, str(tmp_path / "port"), device="cpu")
    got = runner.run()
    assert got == JRunner(jsched, str(tmp_path / "jax")).run()
    fired = trun.family_specs()[family][1]
    assert fired(got), got
    m = runner.final_metrics
    assert m.faults_enospc == got["enospc_hits"]
    assert m.faults_fsync_stalls == got["fsync_stalls"]
    assert m.faults_skew_ticks == got["skew_ticks"]
