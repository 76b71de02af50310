"""The port's lockstep node-plane chaos families against the JAX
package's, on the CPU.

corrupt, snapshot and membership run RaftNode clusters over the
loopback transport, ticked in lockstep, so a seed's history is
reproducible bit for bit.  At seed 0 each family runs once through the
JAX package's runner and twice through the port's (under the point rule
and the pallas rule, whose kernels take their plain versions here): the
reports — plan and result digests and every fault counter — must all be
equal, the family's signature faults must have fired, and the digests
must equal the constants chip_smoke.py holds the card to.
"""
import pytest
import torch

import chip_smoke
from raftsql_tpu.chaos import scenarios as JC
from raftsql_tpu.chaos import schedule as JS
from raftsql_tpu_torch.chaos import run as trun

torch.set_num_threads(1)


@pytest.mark.parametrize("family", ["corrupt", "snapshot", "membership"])
def test_node_family_seed0_equals_jax(tmp_path, family):
    cls, gen, det, fired = trun.node_family_specs()[family]
    assert det
    jcls = getattr(JC, cls.__name__)
    want = jcls(getattr(JS, gen.__name__)(0), str(tmp_path / "jax")).run()
    runs = [trun.run_node(family, 0, device="cpu", commit_rule=rule)
            for rule in ("point", "pallas")]
    assert runs[0] == want and runs[1] == want
    assert fired(want), want
    assert (want["plan_digest"], want["result_digest"]) \
        == chip_smoke.CHAOS_DIGESTS[family]
