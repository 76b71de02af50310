"""The port's pod chaos plane (chaos/schedule.py pod plans, chaos/pod.py
PodChaosRunner) beside the JAX package's.

The plans are pure functions of the seed: their digests must equal the
JAX package's.  The nemesis runs real 2-process pods (each child a
process of the port on the CPU here, over 8 shard slots); its verdict
digest is a pure function of the plan when every invariant passes, so
the port's all-pass verdict must equal a live JAX run's.
"""
import dataclasses

import pytest

from raftsql_tpu.chaos import schedule as JS
from raftsql_tpu_torch.chaos import schedule as TS


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_pod_plans_match_jax(seed):
    for name in ("generate_pod",):
        j, t = getattr(JS, name)(seed), getattr(TS, name)(seed)
        assert t.digest() == j.digest()
        assert t.describe() == dataclasses.asdict(j)
    for broken in (True, False):
        j = JS.falsification_pod_plan(seed, broken=broken)
        t = TS.falsification_pod_plan(seed, broken=broken)
        assert t.digest() == j.digest()


def test_pod_runner_matches_jax_verdict(tmp_path):
    """One run of the seed-0 pod nemesis on each package: every scripted
    fault fires, no child dies of anything unscripted, writes are acked,
    and the port's verdict digest equals the JAX package's."""
    from raftsql_tpu.chaos.pod import PodChaosRunner as JRunner
    from raftsql_tpu_torch.chaos.pod import PodChaosRunner

    plan = TS.generate_pod(0)
    r = PodChaosRunner(plan, str(tmp_path / "torch"), device="cpu").run()
    assert r["noncoord_kills"] >= 1 and r["coord_kills"] >= 1
    assert r["pod_lost_exits"] >= 1 and r["cut_deferred"] > 0
    assert r["unexpected_exits"] == 0
    assert r["acked"] > 0 and r["folded_keys"] > 0
    j = JRunner(JS.generate_pod(0), str(tmp_path / "jax")).run()
    assert (r["plan_digest"], r["result_digest"]) \
        == (j["plan_digest"], j["result_digest"])


def test_pod_runner_refuses_missing_card(tmp_path):
    import torch

    from raftsql_tpu_torch.chaos.pod import PodChaosRunner
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        PodChaosRunner(TS.generate_pod(0), str(tmp_path))
