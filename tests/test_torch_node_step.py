"""The distributed runtime's device step (core/step.py peer_step_packed)
and its state patches, JAX package against the port, on the CPU.

P peers each run peer_step_packed on their own [G] rows, and their
packed outboxes are routed to each other's packed inboxes (src -> dst
becomes dst <- src), so every step sees a real trajectory: elections,
appends, rejections, commits.  Each tick takes a timer advance of 0, 1
or 3 and a force-broadcast mask that is all False, all True or random.
Every output (the new state leaf for leaf, the packed outbox, the
packed info, next_idx, timer_margin) must be equal: consensus state is
int32/bool, the tolerance is zero.  The JAX side's "pallas" rule runs
its Pallas kernel as the JAX package's tests run it on the CPU; the
port's takes the kernel's plain version.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raftsql_tpu.config import RaftConfig as JConfig
from raftsql_tpu.core import state as jstate
from raftsql_tpu.core import step as jstep
from raftsql_tpu_torch import convert
from raftsql_tpu_torch.config import RaftConfig as TConfig
from raftsql_tpu_torch.core import state as tstate
from raftsql_tpu_torch.core import step as tstep

torch.set_num_threads(1)
TICKS = 40


def _jnp(d):
    return {k: np.asarray(v) for k, v in d._asdict().items()}


def _assert_state(js, ts, where):
    a, b = _jnp(js), convert.to_numpy(ts)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, (where, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k} {where}")


def _route(obs, P):
    """Packed outboxes [src][G, dst, C] -> packed inboxes [dst][G, src, C]."""
    stack = np.stack(obs)                       # [src, G, dst, C]
    return [np.ascontiguousarray(stack[:, :, d].transpose(1, 0, 2))
            for d in range(P)]


def _run(G, P, rule, seed=3):
    kw = dict(num_groups=G, num_peers=P, log_window=16,
              max_entries_per_msg=4, election_ticks=6, heartbeat_ticks=1,
              commit_rule=rule)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    js = [jstate.init_peer_state(jcfg, p, seed) for p in range(P)]
    ts = [tstate.init_peer_state(tcfg, p, seed, "cpu") for p in range(P)]
    C = tstep.IB_NCOLS + kw["max_entries_per_msg"]
    inboxes = [np.zeros((G, P, C), np.int32) for _ in range(P)]
    rng = np.random.default_rng(seed)
    for t in range(TICKS):
        ti = (0, 1, 3)[t % 3] if t > 10 else 1
        kind = t % 3
        obs = []
        for p in range(P):
            fb = np.zeros(G, bool) if kind == 0 else (
                np.ones(G, bool) if kind == 1 else rng.random(G) < 0.3)
            prop = rng.integers(0, 3, G).astype(np.int32)
            jout = jstep.peer_step_packed(
                jcfg, js[p], jnp.asarray(inboxes[p]), jnp.asarray(prop),
                jnp.asarray(p, jnp.int32), jnp.asarray(ti, jnp.int32),
                jnp.asarray(fb))
            tout = tstep.peer_step_packed(
                tcfg, ts[p], torch.from_numpy(inboxes[p].copy()),
                torch.from_numpy(prop), torch.tensor(p, dtype=torch.int32),
                torch.tensor(ti, dtype=torch.int32), torch.from_numpy(fb))
            js[p], ts[p] = jout[0], tout[0]
            where = f"tick {t} peer {p}"
            _assert_state(js[p], ts[p], where)
            for i, name in enumerate(("outbox", "info", "next_idx",
                                      "timer_margin"), 1):
                a, b = np.asarray(jout[i]), tout[i].numpy()
                assert a.dtype == b.dtype and a.shape == b.shape, \
                    (name, where)
                np.testing.assert_array_equal(a, b,
                                              err_msg=f"{name} {where}")
            obs.append(np.asarray(jout[1]))
        inboxes = _route(obs, P)
    return jcfg, tcfg, js, ts


@pytest.mark.parametrize("rule", ["point", "windowed", "pallas"])
@pytest.mark.parametrize("G,P", [(8, 3), (8, 5), (64, 3), (64, 5)])
def test_peer_step_packed_matches_jax(G, P, rule):
    _, _, js, ts = _run(G, P, rule)
    roles = np.stack([np.asarray(s.role) for s in js])
    assert (roles == 2).any(), "no leader elected: the run proves little"


def test_install_snapshot_and_peer_progress_match_jax():
    """The two receiver/leader patches of the InstallSnapshot path on a
    mid-run state: a higher sender term (adopted, vote cleared), an
    equal one, a boundary at the ring's edge, and set_peer_progress."""
    jcfg, tcfg, js, ts = _run(8, 3, "point", seed=5)
    j, t = js[0], ts[0]
    cases = [(1, 57, 7, int(np.asarray(j.term)[1]) + 2),
             (2, 16, 3, int(np.asarray(j.term)[2])),
             (5, 1, 1, 0)]
    for (g, last_idx, last_term, sender) in cases:
        j = jstate.install_snapshot_state(j, g, last_idx, last_term, sender)
        got = tstate.install_snapshot_state(t, g, last_idx, last_term,
                                            sender)
        assert got is t                          # written in place
        _assert_state(j, t, f"install g{g}")
    for (g, d, ni) in [(0, 1, 9), (3, 2, 40), (7, 0, 1)]:
        j = jstate.set_peer_progress(j, g, d, ni)
        tstate.set_peer_progress(t, g, d, ni)
        _assert_state(j, t, f"progress g{g} d{d}")
