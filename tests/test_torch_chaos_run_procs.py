"""`python -m raftsql_tpu_torch.chaos.run --procs` on the CPU: the
process-plane gauntlet through the CLI, one run of the 48-tick plan
over three `raftsql_tpu_torch.server.main` processes.  Every fault
family must fire with no unscripted death, and the verdict digest must
be the JAX package's all-pass verdict for the plan (its
`_verdict_digest` over the schedule digest, every invariant "pass" and
every family true)."""
import torch

from raftsql_tpu_torch.chaos import run as trun

torch.set_num_threads(1)


def test_procs_cli_runs_the_process_gauntlet(capsys):
    assert trun.main(["--procs", "--runs", "1", "--proc-ticks", "48",
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == ("chaos procs ok: seed=0 schedule=e63215988e74a0bb "
                       "verdict=c1cdf7b29d0a8a84 (x1 identical)")
