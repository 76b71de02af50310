"""`portbench.inside` on the CPU against a tiny etcd-put cell: the span
stages of the window's PUTs and the apply and launch sums come out, and
the harness's own run stays correct."""
import json
import os

from portbench import inside

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_inside_reads_the_spans_and_sums(tmp_path, capsys):
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    (tmp_path / "portbench" / "traffic").mkdir()
    for sub in ("configs/fused-g1.json", "traffic/etcd-put.json"):
        doc = json.load(open(os.path.join(ROOT, "portbench", sub)))
        if "connections" in doc:
            doc.update(connections=16, warmup_s=1, key_space=50)
        (tmp_path / "portbench" / sub).write_text(json.dumps(doc))
    bench = tmp_path / "BENCHMARK.json"
    bench.write_text(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    out = tmp_path / "inside.json"
    rc = inside.main(["--workload", "etcd-put.g1", "--seed", str(2**31 + 5),
                      "--seconds", "3", "--trace", "0", "--bench",
                      str(bench), "--out", str(out)], device_name="cpu")
    harness, mine = [json.loads(x) for x in
                     capsys.readouterr().out.strip().splitlines()[-2:]]
    assert rc == 0 and harness["correct"] is True
    assert json.loads(out.read_text()) == mine
    assert mine["spans_in_window"] > 0 and mine["spans_without_parse"] == 0
    for stage in ("queue", "commit", "apply", "reply"):
        assert mine[f"put_{stage}_p95_ms"] >= mine[f"put_{stage}_p50_ms"] > 0
    assert mine["apply_ms_per_tick"] > 0
    assert 0 <= mine["launch_offcpu_ms_per_tick"] < mine["launch_ms_per_tick"]
