"""The port's quorum kernels and dense helpers against the JAX package.

raftsql_tpu_torch/ops/pallas_quorum.py carries two CUDA kernels; on the
CPU their wrappers take the plain PyTorch versions, which this file
holds — with zero tolerance, all state being int32/bool — to the JAX
Pallas kernels run in interpret mode (as tests/test_ops.py runs them)
and to the sort-based rules of raftsql_tpu/ops/quorum.py.  The dense
helpers of ops/dense.py, the ring/table term reads of core/state.py and
the point/mask/windowed rules are held to their JAX counterparts the
same way.  Inputs come from numpy seeds.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raftsql_tpu.core import state as jstate
from raftsql_tpu.ops import commit_scan as jscan
from raftsql_tpu.ops import dense as jdense
from raftsql_tpu.ops import pallas_quorum as jpq
from raftsql_tpu.ops import quorum as jq
from raftsql_tpu_torch.core import state as tstate
from raftsql_tpu_torch.ops import commit_scan as tscan
from raftsql_tpu_torch.ops import dense as tdense
from raftsql_tpu_torch.ops import pallas_quorum as tpq
from raftsql_tpu_torch.ops import quorum as tq

torch.set_num_threads(1)
W = 32


def case(seed, G, P):
    """A commit-advance case with the edge rows up front: cand 0, a
    non-leader, commit >= cand, a stale-term ring, cand above log_len."""
    rng = np.random.default_rng(seed)
    log_len = rng.integers(0, 3 * W, G).astype(np.int32)
    match = (rng.random((G, P)) * (log_len[:, None] + 1)).astype(np.int32)
    commit = (rng.random(G) * (log_len + 1)).astype(np.int32)
    term = rng.integers(1, 4, G).astype(np.int32)
    log_term = rng.integers(0, 4, (G, W)).astype(np.int32)
    is_leader = rng.random(G) < 0.75
    match[0] = 0
    is_leader[1] = False
    commit[2] = log_len[2]
    log_term[3] = term[3] - 1
    match[4] = log_len[4] + 7
    is_leader[:5] = [True, False, True, True, True]
    return match, log_term, log_len, commit, term, is_leader


def masks(seed, G, P, kind):
    rng = np.random.default_rng(seed + 1000)
    full = np.ones((G, P), bool)
    if kind == "full":
        return full, full
    if kind == "reduced":
        v = rng.random((G, P)) < 0.7
        v[:, 0] = True
        return v, v
    if kind == "joint":
        v = rng.random((G, P)) < 0.7
        j = rng.random((G, P)) < 0.7
        return v, j
    empty = np.zeros((G, P), bool)
    v = rng.random((G, P)) < 0.6
    v[::3] = False                      # every third group all-learner
    return v, np.where(np.arange(G)[:, None] % 2 == 0, v, empty)


def J(*xs):
    return [jnp.asarray(x) for x in xs]


def T(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("P", [3, 5, 15, 33, 64])
def test_k1_plain_matches_pallas_and_point_rule(seed, P):
    args = case(seed, 64, P)
    q = P // 2 + 1
    want = np.asarray(jpq.pallas_quorum_commit_index(
        *J(*args), quorum=q, window=W, block_g=32, interpret=True))
    point = np.asarray(jq.quorum_commit_index(*J(*args), quorum=q,
                                              window=W))
    np.testing.assert_array_equal(want, point)
    got = tpq.pallas_quorum_commit_index(*T(*args), quorum=q, window=W)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    plain = tpq.quorum_commit_index_plain(*T(*args), quorum=q, window=W)
    np.testing.assert_array_equal(plain.numpy(), want)
    port_point = tq.quorum_commit_index(*T(*args), quorum=q, window=W)
    np.testing.assert_array_equal(port_point.numpy(), want)


@pytest.mark.parametrize("size", [None, "write"])
@pytest.mark.parametrize("kind", ["full", "reduced", "joint", "empty"])
@pytest.mark.parametrize("P", [3, 5, 15, 33, 64])
def test_k2_plain_matches_masked_pallas(P, kind, size):
    seed = P * 7 + len(kind)
    args = case(seed, 64, P)
    v, j = masks(seed, 64, P, kind)
    sz = None if size is None else P - 1 if P > 3 else 2
    want = np.asarray(jpq.pallas_masked_quorum_commit_index(
        *J(*args), voters=jnp.asarray(v), voters_joint=jnp.asarray(j),
        window=W, size=sz, block_g=32, interpret=True))
    ref = np.asarray(jq.masked_quorum_commit_index(
        *J(*args), voters=jnp.asarray(v), voters_joint=jnp.asarray(j),
        window=W, size=sz))
    np.testing.assert_array_equal(want, ref)
    tv, tj = T(v, j)
    got = tpq.pallas_masked_quorum_commit_index(
        *T(*args), voters=tv, voters_joint=tj, window=W, size=sz)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    port_ref = tq.masked_quorum_commit_index(
        *T(*args), voters=tv, voters_joint=tj, window=W, size=sz)
    np.testing.assert_array_equal(port_ref.numpy(), want)


def main_case(seed, G, P):
    """Inputs built like the fused tick's Phase 7: R = P*G rows, row
    p*G + g is peer p's view of group g, exactly one peer leads each
    group, and a leader's own match column holds its log_len."""
    rng = np.random.default_rng(seed)
    lead_peer = rng.integers(0, P, G)
    is_leader = (np.arange(P)[:, None] == lead_peer[None, :]).reshape(-1)
    gterm = rng.integers(0, 4, G).astype(np.int32)
    term = np.tile(gterm, P)
    log_len = rng.integers(0, 3 * W, P * G).astype(np.int32)
    commit = (rng.random(P * G) * (log_len + 1)).astype(np.int32)
    match = (rng.random((P * G, P)) * (log_len[:, None] + 2)).astype(np.int32)
    rows = np.arange(P * G)
    match[rows, rows // G] = np.where(is_leader, log_len,
                                      match[rows, rows // G])
    log_term = np.maximum(term[:, None] - rng.integers(0, 2, (P * G, W)),
                          0).astype(np.int32)
    return match, log_term, log_len, commit, term, is_leader


@pytest.mark.parametrize("P", [3, 5, 15, 33, 64])
def test_k1_k2_main_path_shape(P):
    """K1 and K2 (full and joint masks) on main-path-shaped inputs, the
    port's wrappers against the JAX kernels in interpret mode."""
    G = 12
    args = main_case(P + 50, G, P)
    assert args[5].sum() == G
    q = P // 2 + 1
    want = np.asarray(jpq.pallas_quorum_commit_index(
        *J(*args), quorum=q, window=W, block_g=32, interpret=True))
    got = tpq.pallas_quorum_commit_index(*T(*args), quorum=q, window=W)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != args[3]).any()          # some leader advanced
    full = np.ones((P * G, P), bool)
    for v, j in ((full, full), masks(P, P * G, P, "joint")):
        want = np.asarray(jpq.pallas_masked_quorum_commit_index(
            *J(*args), voters=jnp.asarray(v), voters_joint=jnp.asarray(j),
            window=W, block_g=32, interpret=True))
        got = tpq.pallas_masked_quorum_commit_index(
            *T(*args), voters=T(v)[0], voters_joint=T(j)[0], window=W)
        np.testing.assert_array_equal(got.numpy(), want)


def test_k2_degenerate_configs():
    """tests/test_membership.py's single voter / even joint / all-learner
    rows, through the port's K2 plain version."""
    ring = torch.ones((3, 8), dtype=torch.int32)
    log_len = torch.tensor([5, 5, 5], dtype=torch.int32)
    commit = torch.zeros(3, dtype=torch.int32)
    term = torch.ones(3, dtype=torch.int32)
    leader = torch.tensor([True, True, True])
    match = torch.tensor([[5, 0, 0, 0], [5, 4, 1, 0], [5, 5, 5, 5]],
                         dtype=torch.int32)
    voters = torch.tensor([[1, 0, 0, 0], [1, 1, 1, 1], [0, 0, 0, 0]],
                          dtype=torch.bool)
    jvot = torch.tensor([[1, 0, 0, 0], [1, 1, 1, 0], [0, 0, 0, 0]],
                        dtype=torch.bool)
    got = tpq.pallas_masked_quorum_commit_index(
        match, ring, log_len, commit, term, leader, voters=voters,
        voters_joint=jvot, window=8)
    assert got.tolist() == [5, 1, 0]


@pytest.mark.parametrize("P", [3, 5, 15])
def test_full_mask_k2_equals_k1(P):
    args = case(P, 64, P)
    full = torch.ones((64, P), dtype=torch.bool)
    a = tpq.pallas_quorum_commit_index(*T(*args), quorum=P // 2 + 1,
                                       window=W)
    b = tpq.pallas_masked_quorum_commit_index(
        *T(*args), voters=full, voters_joint=full, window=W)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_kernel_wrappers_reject_unsupported_devices():
    args = T(*case(0, 8, 3))
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError):
        tpq.pallas_quorum_commit_index(*meta, quorum=2, window=W)


@pytest.mark.parametrize("kind", ["full", "reduced", "joint", "empty"])
def test_quorum_and_windowed_rules(kind):
    P, G = 5, 48
    args = case(11, G, P)
    v, j = masks(11, G, P, kind)
    match = args[0]
    for q in (1, 3, 5):
        np.testing.assert_array_equal(
            tq.quorum_match_index(*T(match), q).numpy(),
            np.asarray(jq.quorum_match_index(jnp.asarray(match), q)))
    for sz in (None, 4):
        np.testing.assert_array_equal(
            tq.mask_threshold(*T(v), sz).numpy(),
            np.asarray(jq.mask_threshold(jnp.asarray(v), sz)))
        np.testing.assert_array_equal(
            tq.masked_quorum_match_index(*T(match, v), sz).numpy(),
            np.asarray(jq.masked_quorum_match_index(*J(match, v), sz)))
        votes = np.random.default_rng(3).random((G, P)) < 0.5
        np.testing.assert_array_equal(
            tq.masked_vote_win(*T(votes, v, j), sz).numpy(),
            np.asarray(jq.masked_vote_win(*J(votes, v, j), sz)))
        np.testing.assert_array_equal(
            tscan.masked_windowed_commit_index(
                *T(*args), voters=T(v)[0], voters_joint=T(j)[0],
                window=W, size=sz).numpy(),
            np.asarray(jscan.masked_windowed_commit_index(
                *J(*args), voters=jnp.asarray(v),
                voters_joint=jnp.asarray(j), window=W, size=sz)))
    np.testing.assert_array_equal(
        tq.mask_majority(*T(v)).numpy(),
        np.asarray(jq.mask_majority(jnp.asarray(v))))
    np.testing.assert_array_equal(
        tscan.windowed_commit_index(*T(*args), quorum=3, window=W).numpy(),
        np.asarray(jscan.windowed_commit_index(*J(*args), quorum=3,
                                               window=W)))


@pytest.mark.parametrize("dense_env", ["0", "1"])
def test_dense_helpers(monkeypatch, dense_env):
    """take_last / ring_gather_values gather in the port; both JAX forms
    (one-hot and gather, RAFTSQL_DENSE) must give the same values."""
    monkeypatch.setenv("RAFTSQL_DENSE", dense_env)
    rng = np.random.default_rng(5)
    G, P, E = 24, 5, 6
    x = rng.integers(-9, 99, (G, W)).astype(np.int32)
    idx = rng.integers(0, W, (G, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        tdense.take_last(*T(x, idx)).numpy(),
        np.asarray(jdense.take_last(*J(x, idx))))
    np.testing.assert_array_equal(
        tdense.onehot_take(*T(x, idx)).numpy(),
        np.asarray(jdense.onehot_take(*J(x, idx))))
    src = rng.integers(0, P, G).astype(np.int32)
    for shape in ((G, P), (G, P, E)):
        v = rng.integers(-9, 99, shape).astype(np.int32)
        np.testing.assert_array_equal(
            tdense.pick_peer(*T(v, src)).numpy(),
            np.asarray(jdense.pick_peer(*J(v, src))))
    vals = rng.integers(0, 9, (G, E)).astype(np.int32)
    bi = rng.integers(0, E, G).astype(np.int32)
    np.testing.assert_array_equal(
        tdense.pick_batch(*T(vals, bi)).numpy(),
        np.asarray(jdense.pick_batch(*J(vals, bi))))
    rel = rng.integers(0, W, (G, W)).astype(np.int32)
    n = rng.integers(0, E + 1, G).astype(np.int32)
    np.testing.assert_array_equal(
        tdense.ring_gather_values(*T(vals, rel, n)).numpy(),
        np.asarray(jdense.ring_gather_values(*J(vals, rel, n))))


@pytest.mark.parametrize("words", [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF),
                                   (0x80000000, 0x7FFFFFFF),
                                   (0x9E3779B1, 1), (123456789, 0xDEADBEEF)])
def test_election_jitter_uint32_extremes(words):
    gids = np.array([0, 1, 2, 65535, 99999, 2 ** 31 - 1, 2 ** 30 + 7],
                    np.int32)
    kd = np.array(words, np.uint32)
    ticks = [0, 1, 12345, 2 ** 31 - 1]
    got = tdense.election_jitter(
        torch.from_numpy(np.tile(kd.view(np.int32), (len(ticks), 1))),
        torch.tensor(ticks, dtype=torch.int32), torch.from_numpy(gids),
        10, 20)
    assert got.dtype == torch.int32 and tuple(got.shape) == (4, len(gids))
    for i, t in enumerate(ticks):
        want = np.asarray(jdense.election_jitter(
            jnp.asarray(kd), jnp.int32(t), jnp.asarray(gids), 10, 20))
        np.testing.assert_array_equal(got[i].numpy(), want)


def test_term_reads_and_floor():
    rng = np.random.default_rng(9)
    G, K = 32, 8
    pos = np.sort(rng.integers(0, 60, (G, K)), axis=-1).astype(np.int32)
    pos[rng.random((G, K)) < 0.3] = 0
    pos = np.sort(pos, axis=-1).astype(np.int32)
    term = np.cumsum(rng.integers(0, 3, (G, K)), axis=-1).astype(np.int32)
    log_len = rng.integers(0, 70, G).astype(np.int32)
    for idx in (rng.integers(-2, 75, G).astype(np.int32),
                rng.integers(-2, 75, (G, 5)).astype(np.int32)):
        np.testing.assert_array_equal(
            tstate.term_at_tbl(*T(pos, term, log_len, idx)).numpy(),
            np.asarray(jstate.term_at_tbl(*J(pos, term, log_len, idx))))
        ring = rng.integers(0, 5, (G, W)).astype(np.int32)
        np.testing.assert_array_equal(
            tstate.term_at(*T(ring, log_len, idx), W).numpy(),
            np.asarray(jstate.term_at(*J(ring, log_len, idx), W)))
    got = tstate.tbl_floor(*T(pos, log_len))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jstate.tbl_floor(*J(pos, log_len))))
