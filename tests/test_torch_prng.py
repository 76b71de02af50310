"""The port's threefry draws (raftsql_tpu_torch/core/threefry.py) against
`jax.random`, and the boot state they give against the JAX package's.

The port draws its boot state on the host with a numpy threefry-2x32;
each function must equal its `jax.random` counterpart bit for bit (JAX
as installed: partitionable threefry).  Then `init_cluster_state(cfg,
seed)` and `restore_peer_state(...)` must equal the JAX package's leaf
for leaf with no conversion of the JAX state: both sides draw from
their own seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raftsql_tpu.config import RaftConfig as JConfig
from raftsql_tpu.core import cluster as jcl
from raftsql_tpu.core import state as jst
from raftsql_tpu_torch.config import RaftConfig as TConfig
from raftsql_tpu_torch.core import cluster as tcl
from raftsql_tpu_torch.core import state as tst
from raftsql_tpu_torch.core import threefry

torch.set_num_threads(1)

SEEDS = [0, 1, 5, 123456, 2 ** 31 - 1, -1, -987654]
SHAPES = [(1,), (7,), (4, 3), (3, 5, 3), (2, 3, 3, 4)]


def np_key(k) -> np.ndarray:
    return np.asarray(k).astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_equal_jax(seed):
    jk = jax.random.PRNGKey(seed)
    tk = threefry.prng_key(seed)
    np.testing.assert_array_equal(tk, np_key(jk))
    for data in (0, 1, 4, 2 ** 31 - 1, 2 ** 32 - 1):
        jf = jax.random.fold_in(jk, jnp.uint32(data))
        tf = threefry.fold_in(tk, data)
        np.testing.assert_array_equal(tf, np_key(jf))
        for num in (2, 3, 5):
            np.testing.assert_array_equal(
                threefry.split(tf, num), np_key(jax.random.split(jf, num)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_equals_jax(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    for lo, hi in ((10, 20), (0, 7), (-5, 2 ** 31 - 1), (3, 3), (9, 4),
                   (-2 ** 31, 2 ** 31 - 1)):
        j = jax.random.randint(key, shape, lo, hi, dtype=jnp.int32)
        t = threefry.randint(np_key(key), shape, lo, hi)
        assert t.dtype == np.int32
        np.testing.assert_array_equal(t, np.asarray(j), err_msg=(lo, hi))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_bernoulli_and_uniform_equal_jax(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    np.testing.assert_array_equal(
        threefry.uniform(np_key(key), shape),
        np.asarray(jax.random.uniform(key, shape, jnp.float32)))
    for p in (0.0, 0.05, 0.17, 0.5, 0.9, 1.0):
        np.testing.assert_array_equal(
            threefry.bernoulli(np_key(key), p, shape),
            np.asarray(jax.random.bernoulli(key, p, shape)), err_msg=p)


def assert_state_equal(j, t, ctx=""):
    assert type(j)._fields == type(t)._fields
    for name in j._fields:
        a = np.asarray(getattr(j, name))
        b = getattr(t, name).numpy()
        if name == "rng":
            b = b.view(np.uint32)
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, name)
        np.testing.assert_array_equal(b, a, err_msg=f"{ctx} {name}")


CFGS = [dict(num_groups=4, num_peers=3),
        dict(num_groups=6, num_peers=5, election_ticks=7, log_window=16,
             max_entries_per_msg=4),
        dict(num_groups=100, num_peers=3, keep_ring=False),
        dict(num_groups=8, num_peers=4, initial_voters=(0, 1, 2))]


@pytest.mark.parametrize("seed", [None, 0, 3, 2 ** 31 - 1, -2])
@pytest.mark.parametrize("kw", CFGS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_init_cluster_state_equals_jax(kw, seed):
    """Both sides boot from their own seed: no convert.py in between."""
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    assert_state_equal(jcl.init_cluster_state(jcfg, seed),
                       tcl.init_cluster_state(tcfg, seed, "cpu"),
                       f"{kw} seed={seed}")


@pytest.mark.parametrize("seed", [0, 9, -3])
@pytest.mark.parametrize("self_id", [0, 2])
def test_restore_peer_state_equals_jax(self_id, seed):
    """The restart path redraws timeouts and the key from the seed, then
    rebuilds the log window, the term table and the hard state from a
    replayed WAL (with a compaction floor on one group)."""
    kw = dict(num_groups=5, num_peers=3, log_window=8,
              max_entries_per_msg=2)
    rng = np.random.default_rng(seed + 100)
    log_terms, hard, starts = {}, {}, {}
    for g in range(4):
        n = int(rng.integers(0, 20))
        terms = np.sort(rng.integers(1, 5, n)).tolist()
        log_terms[g] = terms
        hard[g] = (max(terms, default=0) + int(rng.integers(0, 2)),
                   int(rng.integers(-1, 3)), int(rng.integers(0, n + 3)))
    starts[1] = (3, 1)
    j = jst.restore_peer_state(JConfig(**kw), self_id, log_terms, hard,
                               seed, starts=starts)
    t = tst.restore_peer_state(TConfig(**kw), self_id, log_terms, hard,
                               seed, starts=starts, device="cpu")
    assert_state_equal(j, t, f"self_id={self_id} seed={seed}")
