"""The `ycsb-a.g199` cell of BENCHMARK.json run whole on the CPU.

portbench/run.py serves the port's fused server to its load generator and
holds the run against the plain reference (portbench/reference/check.py).
Here the cell runs from a copy of BENCHMARK.json at a tiny size, with the
cell's names, traffic kinds and table shapes: 8 groups, 300 records, 32
connections and a window of 3 s.  A sound run reads `correct` with every
check 0; the read faults of portbench/control.py read not correct.
Each run is a process of its own, as the harness refuses to run in one
that has loaded JAX.
"""
import json
import os
import subprocess
import sys

import pytest

from portbench import control

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "ycsb-a.g199"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    d = tmp_path_factory.mktemp("bench")
    (d / "portbench" / "configs").mkdir(parents=True)
    (d / "portbench" / "traffic").mkdir()
    c = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.load(open(os.path.join(ROOT, c["file"])))
    cfg.update(groups=8, recordcount=300, load_batch=20)
    (d / c["file"]).write_text(json.dumps(cfg))
    mix = json.load(open(os.path.join(ROOT, "portbench", "traffic",
                                      f"{cell['traffic']}.json")))
    mix.update(connections=32, warmup_s=1)
    (d / "portbench" / "traffic" / f"{cell['traffic']}.json").write_text(
        json.dumps(mix))
    (d / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(d / "BENCHMARK.json")


def _run(tiny, trace=0, fault=None, seed=2**31 + 29):
    """One run in a process of its own: the harness refuses a process
    that has loaded JAX, as this one has (tests/conftest.py)."""
    code = ("import sys\n"
            "from portbench import control, run\n"
            f"sys.exit(run.main(sys.argv[1:], device='cpu', drain_s=5, "
            f"patch={'None' if fault is None else f'control.{fault}'}))\n")
    got = subprocess.run(
        [sys.executable, "-c", code, "--workload", CELL, "--seed",
         str(seed), "--seconds", "3", "--trace", str(trace), "--bench",
         tiny], cwd=ROOT, capture_output=True, text=True, timeout=300)
    out = got.stdout.strip().splitlines()
    assert got.returncode == 0 and out, got.stderr[-4000:]
    return json.loads(out[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(tiny, trace):
    line = _run(tiny, trace)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert all(c == {"value": 0, "limit": 0}
               for c in line["checks"].values())
    want = ({"ops_per_s", "setup_s"} if not trace
            else {"get_p95_ms", "update_p95_ms"})
    assert set(line["metrics"]) == want
    assert all(m["value"] > 0 for m in line["metrics"].values())


@pytest.mark.parametrize("fault", ["stale_read", "answer_altered"])
def test_read_fault_is_caught(tiny, fault):
    assert fault in control.FAULTS
    line = _run(tiny, fault=fault)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
