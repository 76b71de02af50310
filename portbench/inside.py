"""One traced run of a cell, read from inside the program.

    python3 -m portbench.inside --workload etcd-put.g1 --seed 7 \
        --seconds 51 --spans 1 --out inside-7.json

Runs `portbench.run` as a traced run (`--trace 1`: its own line comes
first) and adds what the program records itself (raftsql_tpu_torch/obs/):

- with `--spans 1`, the host span tracer alone (no device ring) from the
  window's open, keeping 65,536 finished spans: the p95 of each PUT
  stage (obs/spans.py STAGES), and its median, over the PUTs parsed and
  answered inside the window and clear of the capture, as the harness
  leaves requests out;
- NodeMetrics' apply and launch sums as window deltas per tick, less
  the capture (portbench/metrics/_common.py): the apply's ms a tick and,
  with spans on, the device step's enqueue off the CPU, ms a tick;
- the capture's device activities put on time.monotonic()
  (obs/timeline.py): the idle seconds by the tick thread's phase against
  the capture's idle seconds, the idle share inside the device step and
  the ten longest idle gaps named by phase.

Then one JSON line of these numbers, also written to `--out`.  None of
them is in BENCHMARK.json: the harness hands its metric readers no node,
span store or device events (PERF.md §7).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import types

import numpy as np

from portbench import device
from portbench import run
from portbench.metrics._common import delta, p95, per_tick

SPANS = 65536
SUMS = ("t_apply_ms", "t_launch_ms", "t_launch_cpu_ms")


def capture(node, launches: dict, ticks: int, log) -> dict:
    """`portbench.device.capture`'s capture, its loop unchanged, that
    also keeps its window's edges on time.monotonic(), the clock pairs
    that convert the profiler's stamps, and a copy of the tick-phase
    rings taken at its close."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raftsql_tpu_torch.obs.timeline import clock_pair
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            k0, n0 = launches[device.K1_NAME], node.metrics.ticks
            pairs = [clock_pair()]
            w0 = time.monotonic()
            while node.metrics.ticks - n0 < ticks:
                time.sleep(0.002)
            torch.cuda.synchronize()
            w1 = time.monotonic()
            pairs.append(clock_pair())
            raw = node.prof.raw()
            k1 = launches[device.K1_NAME] - k0
        ev = device._device_events(prof)
        busy = sum(e.duration_ns() for e in ev) * 1e-9
        log(f"profiler capture {attempt + 1}: {len(ev)} device "
            f"activities, {busy:.6f} s busy in {w1 - w0:.6f} s; {k1} K1 "
            "launches")
        if busy > 0:
            return {"busy_s": busy, "window_s": w1 - w0, "prof": prof,
                    "events": ev, "w": (w0, w1), "pairs": pairs,
                    "raw": raw}
    raise RuntimeError("torch.profiler recorded no device time in three "
                       "captures of the window")


def card_numbers(cap: dict) -> dict:
    """The capture read against the tick thread's phases."""
    from raftsql_tpu_torch.obs import timeline as tl
    evs = [(e.start_ns(), e.end_ns(), e.name()) for e in cap["events"]]
    off = tl.profiler_offset_ns(evs[0][0], cap["pairs"])
    phases = tl.tick_phases(cap["raw"])
    w0, w1 = cap["w"]
    split = tl.idle_split(evs, phases, off, w0, w1)
    lo, hi = (w0 * 1e9, w1 * 1e9)
    return {
        "capture_s": w1 - w0, "busy_s": cap["busy_s"],
        "idle_s": cap["window_s"] - cap["busy_s"],
        "idle_split_s": split, "idle_split_sum_s": sum(split.values()),
        "idle_in_step_pct": 100.0 * sum(split[p] for p in tl.IN_STEP)
        / (w1 - w0),
        "activities_outside": sum(1 for s, t, _ in evs
                                  if s + off < lo or t + off > hi),
        "idle_gaps": tl.idle_gaps(evs, phases, off),
    }


def span_numbers(tracer, snap: dict, t_open: float, skip) -> dict:
    from raftsql_tpu_torch.obs.spans import STAMPS, stage_seconds
    stamps = tracer.finished()
    st = stage_seconds(stamps, t_open, t_open + snap["window_s"], skip)
    out = {f"put_{k}_p95_ms": p95((v * 1e3).tolist())
           for k, v in st.items()}
    out.update({f"put_{k}_p50_ms": float(np.median(v)) * 1e3
                for k, v in st.items() if len(v)})
    total = sum(st.values())
    parsed = stamps[:, STAMPS.index("parsed")]
    out.update({"spans_in_window": len(total), "spans_folded": tracer.folded,
                "spans_dropped": tracer.dropped,
                "spans_without_parse": int((parsed != parsed).sum())})
    ticks = delta(snap, "ticks")
    out["launch_offcpu_ms_per_tick"] = (
        delta(snap, "t_launch_ms") - delta(snap, "t_launch_cpu_ms")) \
        / ticks if ticks > 0 else None
    return out


def main(argv=None, *, device_name: str | None = None) -> int:
    """`device_name` is for a CPU rehearsal (run.main's `device`)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out")
    ap.add_argument("--bench", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    box: dict = {}
    base_counters, base_load = run.counters, run.load_metric

    def counters(node):
        c = base_counters(node)
        c.update({k: getattr(node.metrics, k) for k in SUMS})
        return c

    def load_metric(name):
        mod = base_load(name)

        def read(snap):
            box["snap"] = snap
            return mod.read(snap)
        return types.SimpleNamespace(read=read)

    def wrapped_capture(*a):
        box["cap_edges"] = [time.monotonic()]
        cap = capture(*a)
        box["cap_edges"].append(time.monotonic())
        box["cap"] = cap
        return cap

    def patch(rdb):
        box["node"] = node = rdb.pipe.node
        if args.spans:
            node.enable_tracing(device_ring=False, spans=SPANS)

    base_capture = device.capture
    run.counters, run.load_metric = counters, load_metric
    device.capture = wrapped_capture
    try:
        rc = run.main(["--workload", args.workload, "--seed",
                       str(args.seed), "--seconds", str(args.seconds),
                       "--trace", str(args.trace)]
                      + (["--bench", args.bench] if args.bench else []),
                      device=device_name, patch=patch)
    finally:
        run.counters, run.load_metric = base_counters, base_load
        device.capture = base_capture
    snap, node = box.get("snap"), box.get("node")
    if snap is None or node is None:
        return rc or 1
    t_open = run.process_start() + snap["setup_s"]
    out = {"workload": args.workload, "seed": args.seed,
           "spans": bool(args.spans), "harness_rc": rc,
           "tick_ms": base_load("tick_ms").read(snap),
           "put_p95_ms": base_load("put_p95_ms").read(snap),
           "apply_ms_per_tick": per_tick(snap, "t_apply_ms"),
           "launch_ms_per_tick": per_tick(snap, "t_launch_ms"),
           "device_ms_per_tick": per_tick(snap, "t_device_ms")}
    if args.spans:
        out.update(span_numbers(node.tracer, snap, t_open,
                                box.get("cap_edges")))
    if "cap" in box:
        out.update(card_numbers(box["cap"]))
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
