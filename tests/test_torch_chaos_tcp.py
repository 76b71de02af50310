"""The port's node-plane chaos families over real TCP sockets, on the
CPU.

tcp (seeded send-side drops, frame corruption, delays and a
one-directional block) and tcp_rebind (leader-targeted and random
stop/restart with the same ports rebound) cross kernel-scheduled
sockets, so their histories are not bit-reproducible: their plans must
equal the JAX package's, their invariants (election safety, commit
monotonicity, log matching of the published streams, catch-up after
rebinding) must hold, and their signature faults must have fired.
"""
import pytest
import torch

from raftsql_tpu.chaos import schedule as JS
from raftsql_tpu_torch.chaos import run as trun

torch.set_num_threads(1)


@pytest.mark.parametrize("family", ["tcp", "tcp_rebind"])
def test_tcp_family_invariants_hold(family):
    _, gen, det, fired = trun.node_family_specs()[family]
    assert not det
    r = trun.run_node(family, 0, device="cpu")
    assert r["plan_digest"] == getattr(JS, gen.__name__)(0).digest()
    assert fired(r), r


def test_matrix_runs_the_node_families():
    assert trun.run_matrix(0, only=["corrupt"], device="cpu") == 0
    assert trun.run_matrix(0, only=["nosuch"], device="cpu") == 2
