"""The port's fault masks (raftsql_tpu_torch/transport/faults.py) against
the JAX package's transport/faults.py on seeded inboxes.

Each of the six functions takes the same numpy-seeded stacked inbox
(and mask, peer or key) on both sides; every output leaf must be equal.
`random_drop` takes the same JAX key on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raftsql_tpu.core.state import Inbox as JInbox
from raftsql_tpu.transport import faults as jf
from raftsql_tpu_torch.core.state import Inbox as TInbox
from raftsql_tpu_torch.transport import faults as tf

torch.set_num_threads(1)

SHAPES = [(3, 4, 2), (5, 7, 3), (4, 1, 1)]     # (P, G, E)


def seeded_inbox(seed, P, G, E):
    """Leaves [P_dst, G, P_src] (+ [E] for a_ents): about half the slots
    carry a message; the rest are empty (type 0) with junk payload."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in JInbox._fields:
        shape = (P, G, P, E) if name == "a_ents" else (P, G, P)
        if name in ("v_granted", "a_success"):
            out[name] = rng.random(shape) < 0.5
        elif name in ("v_type", "a_type"):
            out[name] = (rng.integers(0, 3, shape)
                         * (rng.random(shape) < 0.5)).astype(np.int32)
        else:
            out[name] = rng.integers(-3, 50, shape).astype(np.int32)
    return out


def both(d):
    return (JInbox(**{k: jnp.asarray(v) for k, v in d.items()}),
            TInbox(**{k: torch.from_numpy(v.copy()) for k, v in d.items()}))


def assert_inbox_equal(j, t, ctx=""):
    for name in JInbox._fields:
        a = np.asarray(getattr(j, name))
        b = getattr(t, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, name)
        np.testing.assert_array_equal(b, a, err_msg=f"{ctx} {name}")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_drop_messages(shape, seed):
    P, G, E = shape
    ji, ti = both(seeded_inbox(seed, P, G, E))
    mask = np.random.default_rng(seed + 9).random((P, G, P)) < 0.4
    assert_inbox_equal(jf.drop_messages(ji, jnp.asarray(mask)),
                       tf.drop_messages(ti, mask))
    # A broadcastable mask (one row per destination) and a tensor mask.
    row = np.random.default_rng(seed + 5).random((P, 1, 1)) < 0.5
    assert_inbox_equal(jf.drop_messages(ji, jnp.asarray(row)),
                       tf.drop_messages(ti, torch.from_numpy(row)))


@pytest.mark.parametrize("p_drop", [0.0, 0.1, 0.35, 1.0])
@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 - 1, -4])
def test_random_drop_same_key(seed, p_drop):
    ji, ti = both(seeded_inbox(seed & 0xFF, 3, 6, 2))
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    assert_inbox_equal(jf.random_drop(ji, key, p_drop),
                       tf.random_drop(ti, np.asarray(key), p_drop))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_hold_and_release(shape, seed):
    P, G, E = shape
    ji, ti = both(seeded_inbox(seed, P, G, E))
    hold = np.random.default_rng(seed + 2).random((P, G, P)) < 0.3
    jd, jh = jf.hold_messages(ji, jnp.asarray(hold))
    td, th = tf.hold_messages(ti, hold)
    assert_inbox_equal(jd, td, "delivered")
    assert_inbox_equal(jh, th, "held")
    # Release the held slots into a later tick's (different) inbox.
    jl, tl = both(seeded_inbox(seed + 50, P, G, E))
    assert_inbox_equal(jf.release_messages(jl, jh),
                       tf.release_messages(tl, th), "released")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_asym_partition(shape):
    P, G, E = shape
    ji, ti = both(seeded_inbox(4, P, G, E))
    for src in range(P):
        for dst in range(P):
            assert_inbox_equal(jf.asym_partition(ji, src, dst),
                               tf.asym_partition(ti, src, dst),
                               f"src={src} dst={dst}")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_partition_peer(shape):
    P, G, E = shape
    ji, ti = both(seeded_inbox(6, P, G, E))
    for peer in range(P):
        assert_inbox_equal(jf.partition_peer(ji, peer),
                           tf.partition_peer(ti, peer), f"peer={peer}")
