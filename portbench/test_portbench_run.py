"""Whole runs of the harness on the CPU against a tiny fused server: a
sound run is correct, each planted fault and the control are not, no
run prints a result without a card, and nothing loads JAX."""
import json
import os
import subprocess
import sys

import pytest

from portbench import control, run

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
# YCSB-A with linearizable reads on the 199-group deployment, kept for
# its return (PERF.md, Open questions), runs here too: it drives the
# read checks and the faults that only reads show.
BENCH["configs"].append({"name": "fused-g199",
                         "file": "portbench/configs/fused-g199.json"})
BENCH["workloads"].append({"name": "ycsb-a.g199", "config": "fused-g199",
                           "traffic": "ycsb-a", "chips": 1})
CELLS = [w["name"] for w in BENCH["workloads"]]


def mix_of(workload):
    w = next(w for w in BENCH["workloads"] if w["name"] == workload)
    return json.load(open(os.path.join(HERE, "traffic",
                                       f"{w['traffic']}.json")))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """BENCHMARK.json's cells, with their names, traffic kinds and table
    shapes, at a size the CPU runs in seconds: at most 2 groups, 300
    records, 16 connections and 50 keys."""
    d = tmp_path_factory.mktemp("bench")
    (d / "portbench" / "configs").mkdir(parents=True)
    (d / "portbench" / "traffic").mkdir()
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        for k, most in (("groups", 2), ("recordcount", 300),
                        ("load_batch", 20)):
            cfg[k] = min(cfg[k], most)
        (d / c["file"]).write_text(json.dumps(cfg))
    for w in BENCH["workloads"]:
        mix = mix_of(w["name"])
        mix["connections"] = min(mix["connections"], 16)
        mix["warmup_s"] = 1
        if mix["key_space"] != "recordcount":
            mix["key_space"] = min(mix["key_space"], 50)
        (d / "portbench" / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(mix))
    (d / "BENCHMARK.json").write_text(json.dumps(BENCH))
    return str(d / "BENCHMARK.json")


def one_run(tiny, capsys, workload, patch=None, seed=2**31 + 11):
    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", "3", "--trace", "0", "--bench", tiny],
                  device="cpu", patch=patch, drain_s=5)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and out
    return json.loads(out[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny, capsys, workload):
    line = one_run(tiny, capsys, workload)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"ops_per_s", "setup_s"}
    assert list(line)[-1] == "checks"
    assert all(c == {"value": 0, "limit": 0}
               for c in line["checks"].values())


READ_FAULTS = ("answer_altered", "stale_read")
FAULTS = [(w, f) for w in CELLS for f in sorted(control.FAULTS)
          if mix_of(w)["read"] > 0 or f not in READ_FAULTS]


@pytest.mark.parametrize("workload, fault", FAULTS)
def test_fault_is_caught(tiny, capsys, workload, fault):
    line = one_run(tiny, capsys, workload, patch=control.FAULTS[fault])
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_no_card_no_result(tiny, capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                   "1", "--bench", tiny])
    assert rc != 0 and capsys.readouterr().out == ""


def test_imports_leave_out_jax_and_the_jax_package():
    mods = ["portbench.run", "portbench.check_line", "portbench.device",
            "portbench.control", "portbench.reference.check"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            "from portbench import run\n"
            "for n in sorted(os.listdir(os.path.join(run.HERE, 'metrics'))):\n"
            "    if n.endswith('.py') and not n.startswith('_'):\n"
            "        run.load_metric(n[:-3])\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", "import os\n" + code],
                         cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout.split()
    assert not set(out) & {"jax", "jaxlib", "flax", "raftsql_tpu"}
    assert "raftsql_tpu_torch" not in out   # the program loads at run time


def test_reference_imports_nothing_of_the_program():
    out = subprocess.run(
        [sys.executable, "-c", "import sys, portbench.reference.check\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True).stdout.split()
    assert not set(out) & {"jax", "raftsql_tpu", "raftsql_tpu_torch",
                           "torch"}
