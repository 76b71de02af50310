"""The port's device helpers for the bench against the JAX package.

`core/cluster.py` `cluster_run` (T fused steps, every StepInfo leaf
stacked [T, P, G, ...]) must equal `raftsql_tpu.core.cluster.cluster_run`
leaf for leaf on every tick, both sides booted from the same seed and
fed the same seeded proposals, under the point rule and under the
pallas rule (the JAX side reaches its Pallas kernel as its own tests
run it on the CPU; the port's wrapper takes the plain version for CPU
tensors).  `running_commit` and `commit_latency_ticks` (ROADMAP K8) must
equal the JAX functions exactly, groups that never reach their target
and targets at 0 included.  Consensus state is int32/bool: tolerance 0.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raftsql_tpu.config import RaftConfig as JConfig
from raftsql_tpu.core import cluster as jcl
from raftsql_tpu.ops import commit_scan as jcs
from raftsql_tpu_torch import convert
from raftsql_tpu_torch.config import RaftConfig as TConfig
from raftsql_tpu_torch.core import cluster as tcl
from raftsql_tpu_torch.ops import commit_scan as tcs
from raftsql_tpu_torch.ops import pallas_quorum

torch.set_num_threads(1)
G, P, T = 64, 3, 40


def np_tree(tup):
    return {k: np.asarray(v) for k, v in tup._asdict().items()}


def assert_tree_equal(jt, tt, where):
    a, b = np_tree(jt), convert.to_numpy(tt)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, (where, k, a[k].dtype, b[k].dtype)
        assert a[k].shape == b[k].shape, (where, k, a[k].shape, b[k].shape)
        bad = np.argwhere(a[k] != b[k])
        assert not bad.size, (where, k, bad[:4].tolist())


def boot(rule):
    kw = dict(num_groups=G, num_peers=P, log_window=32,
              max_entries_per_msg=4, commit_rule=rule)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    js, ji = jcl.init_cluster_state(jcfg, 7), jcl.empty_cluster_inbox(jcfg)
    ts = tcl.init_cluster_state(tcfg, 7, device="cpu")
    ti = tcl.empty_cluster_inbox(tcfg, device="cpu")
    return jcfg, tcfg, js, ji, ts, ti


@pytest.mark.parametrize("rule", ["point", "pallas"])
def test_cluster_run_matches_jax(rule):
    jcfg, tcfg, js, ji, ts, ti = boot(rule)
    rng = np.random.default_rng(11)
    pallas_quorum.reset_launches()
    # Two runs of T ticks: the first elects, the second commits under
    # load; the second starts from the first's final states.
    for run in range(2):
        prop = rng.integers(0, 5 * run, (T, P, G)).astype(np.int32) \
            if run else np.zeros((T, P, G), np.int32)
        js, ji, jinfo = jcl.cluster_run(jcfg, js, ji, T, jnp.asarray(prop))
        ts, ti, tinfo = tcl.cluster_run(tcfg, ts, ti, T,
                                        torch.from_numpy(prop))
        assert tinfo.commit.shape == (T, P, G)
        assert tinfo.next_idx.shape == (T, P, G, P)
        assert_tree_equal(jinfo, tinfo, f"infos of run {run}")
        assert_tree_equal(js, ts, f"states after run {run}")
        assert_tree_equal(ji, ti, f"inboxes after run {run}")
    # The run elected and committed.
    assert (np.asarray(js.role) == 2).sum(0).min() == 1
    assert int(ts.commit.min()) > 10
    # K8 over the stacked infos, as the bench reduces them.
    jtraj = jcs.running_commit(jnp.max(jinfo.commit, axis=1))
    ttraj = tcs.running_commit(tinfo.commit.amax(1))
    np.testing.assert_array_equal(ttraj.numpy(), np.asarray(jtraj))
    jfirst = jcs.commit_latency_ticks(jtraj, jnp.max(jinfo.new_log_len[0],
                                                     axis=0))
    tfirst = tcs.commit_latency_ticks(ttraj, tinfo.new_log_len[0].amax(0))
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))
    assert (tfirst.numpy() < T).all()
    # The CPU wrapper takes the plain version: no kernel launch.
    assert sum(pallas_quorum.launches.values()) == 0


def test_cluster_run_equals_the_step_loop():
    """cluster_run is T calls of the fused step: the same final state
    and the step's info on every tick."""
    _, tcfg, _, _, ts, ti = boot("pallas")
    prop = torch.from_numpy(np.random.default_rng(2).integers(
        0, 4, (T, P, G)).astype(np.int32))
    rs, ri, infos = tcl.cluster_run(tcfg, ts, ti, T, prop)
    for t in range(T):
        ts, ti, info = tcl.cluster_step(tcfg, ts, ti, prop[t])
        for name, x in info._asdict().items():
            assert torch.equal(getattr(infos, name)[t], x), (t, name)
    for x, y in zip(rs + ri, ts + ti):
        assert torch.equal(x, y)


@pytest.mark.parametrize("seed", range(4))
def test_running_commit_matches_jax(seed):
    rng = np.random.default_rng(seed)
    shape = [(40, 64), (7, 3, 5), (1, 9), (33,)][seed]
    c = rng.integers(-3, 100, shape).astype(np.int32)
    for axis in range(len(shape)):
        want = np.asarray(jcs.running_commit(jnp.asarray(c), axis=axis))
        got = tcs.running_commit(torch.from_numpy(c), axis=axis)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(4))
def test_commit_latency_ticks_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    Tn, Gn = [(40, 64), (1, 8), (12, 3), (64, 200)][seed]
    traj = np.maximum.accumulate(
        rng.integers(0, 30, (Tn, Gn)).astype(np.int32), axis=0)
    targets = rng.integers(0, 40, Gn).astype(np.int32)
    targets[:2] = 0                          # hit at tick 0
    targets[2:4] = 10_000                    # never hit: T
    want = np.asarray(jcs.commit_latency_ticks(jnp.asarray(traj),
                                               jnp.asarray(targets)))
    got = tcs.commit_latency_ticks(torch.from_numpy(traj),
                                   torch.from_numpy(targets))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[:2] == 0).all()
    assert (got.numpy()[2:4] == Tn).all()
