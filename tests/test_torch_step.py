"""The port's fused cluster tick against the JAX package, tick by tick.

Both sides boot from the same seed (the port draws the JAX package's
threefry draws, so the boot states are equal leaf for leaf) and take
the same seeded proposals every tick.  Every leaf of the state,
every leaf of the delivered inbox, the packed [P, G, 16] info and the
busy bit must be equal on every tick: consensus state is int32/bool, so
the tolerance is zero.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raftsql_tpu.config import RaftConfig as JConfig
from raftsql_tpu.core import cluster as jcl
from raftsql_tpu_torch import convert
from raftsql_tpu_torch.config import RaftConfig as TConfig
from raftsql_tpu_torch.core import cluster as tcl
from raftsql_tpu_torch.ops import pallas_quorum

torch.set_num_threads(1)
TICKS = 200


def np_tree(tup):
    return {k: np.asarray(v) for k, v in tup._asdict().items()}


def boot(**kw):
    args = dict(num_groups=16, num_peers=3, log_window=32,
                max_entries_per_msg=4)
    args.update(kw)
    jcfg, tcfg = JConfig(**args), TConfig(**args)
    js, ji = jcl.init_cluster_state(jcfg), jcl.empty_cluster_inbox(jcfg)
    ts = tcl.init_cluster_state(tcfg, device="cpu")
    ti = tcl.empty_cluster_inbox(tcfg, device="cpu")
    assert_tree_equal(js, ts, "boot state")
    assert_tree_equal(ji, ti, "boot inbox")
    return jcfg, tcfg, js, ji, ts, ti


def assert_tree_equal(jt, tt, where):
    a, b = np_tree(jt), convert.to_numpy(tt)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, (where, k, a[k].dtype, b[k].dtype)
        assert a[k].shape == b[k].shape, (where, k)
        bad = np.argwhere(a[k] != b[k])
        assert not bad.size, (where, k, bad[:4].tolist())


CONFIGS = [
    pytest.param(dict(commit_rule=r, dynamic_membership=d),
                 id=f"{r}-{'dynamic' if d else 'static'}")
    for r in ("point", "windowed", "pallas") for d in (False, True)
] + [
    pytest.param(dict(lease_ticks=3), id="lease3"),
    pytest.param(dict(prevote=False), id="noprevote"),
    pytest.param(dict(num_peers=5, initial_voters=(0, 1, 2),
                      commit_rule="pallas"), id="pallas-reduced-voters"),
    pytest.param(dict(witnesses=(2,), lease_ticks=2), id="witness-lease"),
]


@pytest.mark.parametrize("kw", CONFIGS)
def test_cluster_step_host_matches_jax(kw):
    jcfg, tcfg, js, ji, ts, ti = boot(**kw)
    P, G = jcfg.num_peers, jcfg.num_groups
    rng = np.random.default_rng(17)
    pallas_quorum.reset_launches()
    for t in range(TICKS):
        prop = rng.integers(0, 4, (P, G)).astype(np.int32)
        js, ji, jpinfo, jbusy = jcl.cluster_step_host(
            jcfg, js, ji, jnp.asarray(prop))
        ts, ti, tpinfo, tbusy = tcl.cluster_step_host(
            tcfg, ts, ti, torch.from_numpy(prop))
        assert_tree_equal(js, ts, f"state@{t}")
        assert_tree_equal(ji, ti, f"inbox@{t}")
        a = np.asarray(jpinfo)
        assert tpinfo.dtype == torch.int32
        np.testing.assert_array_equal(tpinfo.numpy(), a, err_msg=str(t))
        assert bool(jbusy) == bool(tbusy), t
    # The run made progress: leaders everywhere, commits past the noops.
    assert (np.asarray(js.role) == 2).sum(0).min() == 1
    assert np.asarray(js.commit).min() > 10
    # The CPU wrappers take the plain versions: no kernel launches.
    assert sum(pallas_quorum.launches.values()) == 0


def test_multistep_equals_single_steps():
    jcfg, tcfg, _, _, ts, ti = boot(commit_rule="pallas")
    P, G, S = tcfg.num_peers, tcfg.num_groups, 4
    rng = np.random.default_rng(3)
    a_st, a_ib, b_st, b_ib = ts, ti, ts, ti
    for _ in range(30):
        prop = torch.from_numpy(
            rng.integers(0, 3, (S, P, G)).astype(np.int32))
        ti_vec = torch.from_numpy(rng.integers(0, 2, P).astype(np.int32))
        a_st, a_ib, a_info, a_busy = tcl.cluster_multistep_host(
            tcfg, a_st, a_ib, S, prop, ti_vec)
        infos, busy = [], False
        for s in range(S):
            b_st, b_ib, info, bb = tcl.cluster_step_host(
                tcfg, b_st, b_ib, prop[s], ti_vec)
            infos.append(info)
            busy = busy or bool(bb)
        np.testing.assert_array_equal(a_info.numpy(),
                                      torch.stack(infos).numpy())
        assert bool(a_busy) == busy
        for x, y in zip(a_st + a_ib, b_st + b_ib):
            assert torch.equal(x, y)


def test_skewed_timer_inc_matches_jax():
    """Per-peer [P] timer advance (the chaos clock-skew seam)."""
    jcfg, tcfg, js, ji, ts, ti = boot(commit_rule="pallas")
    rng = np.random.default_rng(23)
    for t in range(120):
        prop = rng.integers(0, 3, (3, 16)).astype(np.int32)
        inc = rng.integers(0, 3, 3).astype(np.int32)
        js, ji, jp, _ = jcl.cluster_step_host(
            jcfg, js, ji, jnp.asarray(prop), jnp.asarray(inc))
        ts, ti, tp, _ = tcl.cluster_step_host(
            tcfg, ts, ti, torch.from_numpy(prop), torch.from_numpy(inc))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp),
                                      err_msg=str(t))
    assert_tree_equal(js, ts, "final")


def test_single_peer_step_matches_jax():
    """peer_step with no batch axis (one peer's [G] view, as the
    distributed runtime will call it) against the JAX package's jitted
    peer step, on states taken from a running cluster."""
    from raftsql_tpu.core.step import peer_step_jit
    from raftsql_tpu_torch.core.step import peer_step
    from raftsql_tpu_torch.core.state import Inbox, PeerState

    jcfg, tcfg, js, ji, ts, ti = boot(commit_rule="pallas",
                                      dynamic_membership=True)
    rng = np.random.default_rng(29)
    for t in range(40):
        prop = rng.integers(0, 3, (3, 16)).astype(np.int32)
        for p in range(3):
            jst = type(js)(*[x[p] for x in js])
            jib = type(ji)(*[x[p] for x in ji])
            a_st, a_ob, a_info = peer_step_jit(
                jcfg, jst, jib, jnp.asarray(prop[p]), jnp.int32(p))
            b_st, b_ob, b_info = peer_step(
                tcfg, PeerState(*[x[p] for x in ts]),
                Inbox(*[x[p] for x in ti]), torch.from_numpy(prop[p]),
                torch.tensor(p, dtype=torch.int32))
            assert_tree_equal(a_st, b_st, f"state@{t}/{p}")
            assert_tree_equal(a_ob, b_ob, f"outbox@{t}/{p}")
            assert_tree_equal(a_info, b_info, f"info@{t}/{p}")
        js, ji, _, _ = jcl.cluster_step_host(jcfg, js, ji, jnp.asarray(prop))
        ts, ti, _, _ = tcl.cluster_step_host(tcfg, ts, ti,
                                             torch.from_numpy(prop))
