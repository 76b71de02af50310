"""The process arms of the read and transfer gauntlets on the port:
tests/test_read_plane.py::test_proc_read_nemesis, and a process test of
ProcTransferChaosRunner beside it (every server child a
`raftsql_tpu_torch.server.main` process stepping on the CPU).  Both are
slow, as the reference's is: each spawns three server processes and
restarts them through a seeded nemesis script.
"""
import pytest
import torch

from raftsql_tpu_torch.chaos.proc import (ProcReadChaosRunner,
                                          ProcTransferChaosRunner)
from raftsql_tpu_torch.chaos.schedule import generate_procs

torch.set_num_threads(1)


@pytest.mark.slow
def test_proc_read_nemesis(tmp_path):
    """Process-plane read nemesis: linear/session/follower HTTP reads
    race real SIGKILLs/stalls/storms; no stale session read, no
    unscripted death."""
    plan = generate_procs(3, ticks=40)
    r = ProcReadChaosRunner(plan, str(tmp_path), device="cpu").run()
    assert r["linear_reads"] > 0
    assert r["session_reads"] > 0
    assert r["follower_reads"] > 0
    assert r["stale_session"] == 0
    assert r["unexpected_exits"] == 0


@pytest.mark.slow
def test_proc_transfer_nemesis(tmp_path):
    """Process-plane transfer nemesis: POST /transfer at the group-0
    leader under the same seeded script; a transfer must complete over
    the public surface, and no child may die of anything unscripted."""
    plan = generate_procs(3, ticks=40)
    r = ProcTransferChaosRunner(plan, str(tmp_path), device="cpu").run()
    assert r["transfers_requested"] > 0
    assert r["transfers_completed"] > 0
    assert r["unexpected_exits"] == 0
