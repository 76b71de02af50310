"""The port's read, quorum and transfer nemesis families beside the JAX
package's, on the CPU.

Each family runs at seed 0 through both packages' runners in the same
process (the JAX package under the point rule, the port under point and
pallas): the reports — schedule and result digests, every read, lease,
witness and transfer counter — must be equal, and the digests must be
the constants chip_smoke.py holds the card to.  Then each gauntlet's
falsification pairs run on the port: the broken lease bound, the
unsafe transfer kernel and both quorum arms must be caught by the
invariants, and their controls must pass.  The read and transfer
gauntlets end with their process legs.
"""
import json

import pytest
import torch

import chip_smoke
from raftsql_tpu.chaos import run as jrun
from raftsql_tpu.chaos import schedule as JS
from raftsql_tpu_torch.chaos import run as trun

torch.set_num_threads(1)

JAX_RUN = {"reads": jrun._run_reads, "quorum": jrun._run_quorum,
           "transfers": jrun._run_transfers}
JAX_GEN = {"reads": JS.generate_reads, "quorum": JS.generate_quorum,
           "transfers": JS.generate_transfers}


@pytest.mark.parametrize("family", ["reads", "quorum", "transfers"])
def test_family_seed0_equals_jax_and_chip_smoke(family):
    gen, fired = trun.family_specs()[family]
    assert gen(0).digest() == JAX_GEN[family](0).digest()
    got = {rule: trun.run_fused(gen(0), device="cpu", commit_rule=rule)
           for rule in ("point", "pallas")}
    want = JAX_RUN[family](JAX_GEN[family](0))
    assert got["point"] == want
    assert got["pallas"] == got["point"]
    assert (want["schedule_digest"], want["result_digest"]) \
        == chip_smoke.CHAOS_DIGESTS[family]
    assert fired(got["pallas"]), got["pallas"]


@pytest.mark.parametrize("gauntlet,marks", [
    ("reads", ["lease-bound"]),
    ("transfers", ["unsafe-transfer"]),
    ("quorum", ["non-intersecting", "witness-lease"])])
def test_gauntlet_falsification_pairs_on_port(gauntlet, marks, capsys):
    """One family run, then every falsification arm: each broken arm
    caught, each control passed (the CLI exits 0 only then)."""
    rc = trun.main([f"--{gauntlet}", "--no-procs", "--runs", "1",
                    "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0, out
    assert out[-1].startswith(f"chaos {gauntlet} ok: seed=0 ")
    docs = [json.loads(line) for line in out if line.startswith("{")]
    caught = [d["arm"] for d in docs if d.get("falsification") == "caught"]
    passed = [d["arm"] for d in docs
              if d.get("falsification_control") == "passed"]
    assert caught == marks and passed == marks


@pytest.mark.parametrize("fn", [trun.run_reads, trun.run_transfers])
def test_process_arms_raise_until_the_distributed_runtime(fn, capsys):
    """The process arms are ported: without --no-procs the gauntlet
    ends with its process leg (three server processes under the seeded
    nemesis), whose verdict is the reference's all-pass verdict on
    generate_procs(0, ticks=60) (chip_smoke.PROC_VERDICTS)."""
    family = fn.__name__[4:]
    assert trun.main([f"--{family}", "--runs", "1", "--device",
                      "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith(f"chaos {family} ok: seed=0 ")
    leg = [json.loads(line) for line in out if line.startswith("{")
           and '"boot_s"' in line]             # a process runner's report
    assert len(leg) == 1 and leg[0]["unexpected_exits"] == 0
    assert (leg[0]["schedule_digest"], leg[0]["result_digest"]) \
        == chip_smoke.PROC_VERDICTS[family]
