"""The metric readers' window arithmetic, the line validator and the
plain copy of K1's rule."""
import copy
import json
import os

import pytest
import torch

from portbench import check_line, device, run
from portbench.reference import check as ref

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = check_line.load_bench()
CELL = BENCH["workloads"][0]["name"]


def snap():
    return {
        "setup_s": 41.5, "window_s": 30.0, "window_ok": 45_000,
        "requests": [ref.Rec(ref.OP_UPSERT, 2, 204, 0, 0, i * 1_000_000,
                             "", "", b"") for i in range(1, 101)] + [
            ref.Rec(ref.OP_UPSERT, 2, 503, 0, 0, 10**12, "", "", b""),
            ref.Rec(ref.OP_READ, 2, 200, 0, 0, 10**12, "", "", b"")],
        "node_open": {"ticks": 1000, "commits": 20_000, "t_wal_ms": 4000.0,
                      "t_device_ms": 19_000.0},
        "node_close": {"ticks": 2200, "commits": 44_000,
                       "t_wal_ms": 10_000.0, "t_device_ms": 43_000.0},
        "profile": {"busy_s": 0.25, "window_s": 2.5},
    }


@pytest.mark.parametrize("name, want", [
    ("ops_per_s", 1500.0), ("setup_s", 41.5), ("put_p95_ms", 95.0),
    ("commits_per_tick", 20.0), ("tick_ms", 25.0),
    ("wal_ms_per_tick", 5.0), ("device_ms_per_tick", 20.0),
    ("device_idle_pct", 90.0)])
def test_reader_window_arithmetic(name, want):
    assert run.load_metric(name).read(snap()) == pytest.approx(want)


def traced_snap():
    """snap() with a 6-s capture of 100 slow ticks inside the window."""
    s = snap()
    s["capture"] = {
        "open": {"ticks": 1500, "commits": 30_000, "t_wal_ms": 6000.0,
                 "t_device_ms": 25_000.0},
        "close": {"ticks": 1600, "commits": 31_000, "t_wal_ms": 7000.0,
                  "t_device_ms": 30_000.0},
        "s": 6.0}
    return s


@pytest.mark.parametrize("name, want", [
    ("commits_per_tick", 23_000 / 1100), ("tick_ms", 24_000 / 1100),
    ("wal_ms_per_tick", 5000 / 1100), ("device_ms_per_tick", 19_000 / 1100),
    ("ops_per_s", 1500.0)])
def test_reader_leaves_out_the_profiled_ticks(name, want):
    assert run.load_metric(name).read(traced_snap()) == pytest.approx(want)


@pytest.mark.parametrize("name, key", [
    ("put_p95_ms", "requests"), ("device_idle_pct", "profile")])
def test_reader_finds_nothing_returns_nothing(name, key):
    s = snap()
    s[key] = [] if key == "requests" else None
    assert run.load_metric(name).read(s) is None


@pytest.mark.parametrize("name", ["commits_per_tick", "tick_ms",
                                  "wal_ms_per_tick", "device_ms_per_tick"])
def test_reader_without_a_tick_returns_nothing(name):
    s = snap()
    s["node_close"] = dict(s["node_open"])
    assert run.load_metric(name).read(s) is None


def test_every_declared_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(run.load_metric(m["name"]).read), m["name"]


def good_line(workload, trace):
    ms = {m["name"]: {"value": 1.0, "unit": m["unit"]}
          for m in check_line.declared(BENCH, workload, trace)}
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "memory_peak_bytes": 1 << 20}
    if trace:
        dev.update(busy_s=0.1, window_s=2.0)
    return {"correct": True, "attempted": 10, "failed": 0, "metrics": ms,
            "device": dev, "checks": {"unserved": {"value": 0, "limit": 0}}}


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_validator_passes_a_whole_line(workload, trace):
    assert check_line.problems(good_line(workload, trace), BENCH, workload,
                               trace) == []


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_validator_names_each_missing_metric(workload, trace):
    for m in check_line.declared(BENCH, workload, trace):
        line = good_line(workload, trace)
        del line["metrics"][m["name"]]
        assert check_line.problems(line, BENCH, workload, trace) == [
            f"metric {m['name']} missing or not a number"]


@pytest.mark.parametrize("edit, want", [
    (lambda ln: ln.pop("failed"), "key failed missing"),
    (lambda ln: ln["device"].pop("kind"), "device.kind missing"),
    (lambda ln: ln["device"].update(busy_s=0.0), "device.busy_s 0.0 not"),
    (lambda ln: ln["device"].update(busy_s=3.0), "device.busy_s 3.0 not"),
    (lambda ln: ln["device"].pop("window_s"), "device.busy_s or"),
    (lambda ln: ln["metrics"]["tick_ms"].update(unit="s"),
     "metric tick_ms: unit 's'"),
    (lambda ln: ln["metrics"]["tick_ms"].update(value=float("nan")),
     "metric tick_ms missing"),
    (lambda ln: ln.update(correct="yes"), "correct is not"),
])
def test_validator_refuses(edit, want):
    line = good_line(CELL, True)
    edit(line)
    got = check_line.problems(line, BENCH, CELL, True)
    assert any(p.startswith(want) for p in got), got


def test_validator_reads_the_last_json_line():
    line = good_line(CELL, False)
    text = "warming\n" + json.dumps({"x": 1}) + "\n" + json.dumps(line)
    assert check_line.last_json(text) == line


def k1_inputs(R, device=None):
    g = torch.Generator(device=device).manual_seed(5)
    P, W = 3, 256
    kw = {"generator": g, "device": device, "dtype": torch.int32}
    match = torch.randint(0, 500, (R, P), **kw)
    return [match, torch.randint(1, 4, (R, W), **kw),
            (match.amax(1) + torch.randint(0, 3, (R,), **kw)).contiguous(),
            torch.randint(0, 400, (R,), **kw),
            torch.randint(1, 4, (R,), **kw),
            torch.rand(R, generator=g, device=device) < 0.3]


def test_k1_plain_matches_the_programs_plain_rule():
    pq = pytest.importorskip("raftsql_tpu_torch.ops.pallas_quorum")
    args = k1_inputs(4099)
    assert torch.equal(
        device.k1_plain(*args, quorum=2, window=256),
        pq.quorum_commit_index_plain(*args, quorum=2, window=256))


def test_k1_wrong_counts_rows_off_the_rule():
    args = k1_inputs(1000)

    def off_by_one(*a, **kw):
        out = device.k1_plain(*a, **kw).clone()
        out[:3] += 1
        return out
    assert device.k1_wrong(device.k1_plain, args, quorum=2, window=256) == 0
    assert device.k1_wrong(off_by_one, args, quorum=2, window=256,
                           reps=4) == 12


@pytest.mark.cuda
def test_k1_on_the_card(card):
    from raftsql_tpu_torch.ops import pallas_quorum as pq
    args = k1_inputs(30_000, card)
    assert device.k1_wrong(pq.pallas_quorum_commit_index, args, quorum=2,
                           window=256) == 0


class Ev:
    def __init__(self, name, start, end):
        self._n, self._s, self._e = name, start, end

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def duration_ns(self):
        return self._e - self._s


def test_summarize_names_the_busiest_ops_and_longest_gaps():
    ev = [Ev("k1", 0, 100), Ev("fill", 150, 160), Ev("k1", 1_000, 1_100),
          Ev("copy", 1_050, 1_300), Ev("fill", 5_300, 5_310)]
    got = device.summarize({"busy_s": 4.7e-7, "window_s": 1e-5,
                            "events": ev})
    assert got["busy_s"] == 4.7e-7 and got["window_s"] == 1e-5
    assert [k for k, _s in got["device_ops"]] == ["copy", "k1", "fill"]
    assert [s for _k, s in got["device_ops"]] == pytest.approx(
        [2.5e-7, 2e-7, 2e-8])
    assert [g[1] for g in got["idle_gaps"]] == pytest.approx(
        [4e-6, 8.4e-7, 5e-8])
    assert got["idle_gaps"][0][0] == "after copy, before fill"
