"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload etcd-put.g1 --seed 7 --seconds 30 \
        --trace 0

The system under test is raftsql_tpu_torch's fused durable SQL server
(`server.main.build_fused_node` behind `api.aio.AioSQLServer`), built in
this process on the card; the load comes from a separate process, the
benchmark's own epoll client (portbench/loadgen), so this process's
Python only serves.  A run:

  1. reads the cell from BENCHMARK.json, its configuration from
     portbench/configs/ and its traffic mix from portbench/traffic/;
  2. refuses to run (exit 3, no result) without as many CUDA cards as
     the cell asks for;
  3. set-up: builds the server (WAL and SQLite files in a fresh directory
     under TMPDIR), waits for every group's leader, and starts the load
     generator, which runs the DDL and load phases and a warm-up;
  4. measures for --seconds: the window opens and closes on the load
     generator's clock, and the program's NodeMetrics are read at both
     edges; with --trace 1 also a torch.profiler capture of a fixed
     number of ticks inside the window (whose ticks and requests the
     per-layer metrics leave out) and, after it, K1 checked on a copy of
     the consensus state taken at the close;
  5. waits up to a minute for the answers still due, stops the server,
     and holds everything the run produced against the plain reference
     (portbench/reference/check.py); standard error gets what the host
     did over the window (answers in each second, ticks, CPU, garbage
     collection);
  6. prints one JSON line: correct, attempted, failed, the cell's
     metrics for the role (end-to-end with --trace 0, per-layer with
     --trace 1, each read by portbench/metrics/<name>.py), the device,
     and last the checks, each with its limit; the checks also end
     standard error.  The line is checked against BENCHMARK.json first
     (portbench/check_line.py): a missing metric ends the run with exit
     1 and no result.

Caches stay inside the checkout: the program's kernels in build/kernels/
and its WAL library in build/native/ (the program's own fixed paths), the
load generator in portbench/loadgen/bin/, TORCH_EXTENSIONS_DIR and
TRITON_CACHE_DIR under build/.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "raftsql_tpu")
DRAIN_S = 60.0          # how long answers still due are waited for
RUN_LIMIT_S = 330.0     # the load generator is ended past this


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def process_start() -> float:
    """This process's start on the time.monotonic() clock."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.monotonic() - (time.clock_gettime(time.CLOCK_BOOTTIME)
                               - started)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_metric(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def raise_nofile(need: int) -> None:
    """Raise this process's soft RLIMIT_NOFILE to its hard limit (the
    load generator inherits it); fail when even that cannot hold
    `need` descriptors."""
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < hard:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    soft = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
    if soft != resource.RLIM_INFINITY and soft < need:
        raise RuntimeError(f"RLIMIT_NOFILE {soft} cannot hold the {need} "
                           "descriptors this cell opens")


def cpu_probe_ms() -> float:
    """A fixed piece of pure Python, timed: how fast this host ran it."""
    t = time.perf_counter()
    sum(i * i for i in range(1_000_000))
    return (time.perf_counter() - t) * 1e3


class HostWatch:
    """What the host did over the window: this process's CPU seconds and
    the interpreter's garbage collections (seconds, longest pause)."""

    def __init__(self):
        self.on = False
        self.gc_s = self.gc_max = self.t = 0.0
        gc.callbacks.append(self._gc)

    def _gc(self, phase, _info):
        if not self.on:
            return
        if phase == "start":
            self.t = time.perf_counter()
        else:
            d = time.perf_counter() - self.t
            self.gc_s += d
            self.gc_max = max(self.gc_max, d)

    def start(self):
        self.on = True
        self.cpu = sum(os.times()[:2])

    def stop(self) -> str:
        self.on = False
        gc.callbacks.remove(self._gc)
        return (f"this process's CPU {sum(os.times()[:2]) - self.cpu:.2f} s,"
                f" garbage collection {self.gc_s:.3f} s (longest "
                f"{self.gc_max * 1e3:.1f} ms)")


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")


def params(cfg: dict, mix: dict, port: int, seed: int, seconds: float,
           drain_s: float, records: str) -> str:
    space = mix["key_space"]
    if space == "recordcount":
        space = cfg["recordcount"]
    ps = {"seed": seed, "groups": cfg["groups"], "port": port,
          "conns": mix["connections"], "table": cfg["table"],
          "key_column": cfg["key_column"], "fields": ",".join(cfg["fields"]),
          "field_length": cfg["fieldlength"], "key_kind": cfg["key_kind"],
          "record_count": cfg["recordcount"], "load_batch": cfg["load_batch"],
          "ddl": ";".join(cfg["ddl"]), "key_dist": mix["key_dist"],
          "zipf_constant": mix.get("zipf_constant", 0), "key_space": space,
          "read": mix["read"], "update": mix["update"],
          "upsert": mix["upsert"], "warmup_s": mix["warmup_s"],
          "seconds": seconds, "drain_s": drain_s, "records": records}
    return "".join(f"{k} {v}\n" for k, v in ps.items())


def counters(node) -> dict:
    m = node.metrics
    return {"ticks": m.ticks, "commits": m.commits, "t_wal_ms": m.t_wal_ms,
            "t_device_ms": m.t_device_ms}


def wait_leaders(node, groups: int, limit_s: float) -> None:
    t0 = time.monotonic()
    said = t0
    while time.monotonic() < t0 + limit_s:
        led = sum(1 for g in range(groups) if node.leader_of(g) >= 0)
        if led == groups:
            return
        if time.monotonic() - said > 10:
            said = time.monotonic()
            m = node.metrics
            log(f"{led} of {groups} groups led after {said - t0:.0f} s, "
                f"{m.ticks} ticks")
        time.sleep(0.2)
    raise RuntimeError(f"not every group elected a leader in {limit_s} s")


def main(argv=None, *, device: str | None = None, patch=None,
         drain_s: float = DRAIN_S) -> int:
    """Run one cell; returns the exit code.  `device`, `patch` and
    `drain_s` are for the benchmark's own tests: a CPU device skips the
    look for a card, `patch(rdb)` breaks the program under test as the
    window opens."""
    t_start = process_start()
    probe = cpu_probe_ms()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--bench", default=os.path.join(ROOT, "BENCHMARK.json"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    trace = bool(args.trace)
    with open(args.bench) as f:
        bench = json.load(f)
    cell = cell_of(bench, args.workload)
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == cell["config"])
    base = os.path.dirname(os.path.abspath(args.bench))
    cfg = load_json(base, cfg_entry["file"])
    mix = load_json(base, "portbench", "traffic", f"{cell['traffic']}.json")

    import torch
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            log(f"{cell['chips']} CUDA card(s) needed, "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                " visible: no run")
            return 3
        device = "cuda"
    on_card = device == "cuda"
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    raise_nofile(cfg["groups"] + 2 * mix["connections"] + 512)
    sys.setswitchinterval(0.001)      # as server/main.py sets it

    from portbench.loadgen import build as loadgen_build
    exe = loadgen_build.build()
    from raftsql_tpu_torch.api.aio import AioSQLServer
    from raftsql_tpu_torch.ops import pallas_quorum as pq
    from raftsql_tpu_torch.server.main import build_fused_node

    data = tempfile.mkdtemp(prefix="portbench-")
    rdb = srv = gen = None
    try:
        prefix = os.path.join(data, "raftsql")
        rdb = build_fused_node(
            groups=cfg["groups"], peers=cfg["peers"], tick=cfg["tick_s"],
            data_prefix=prefix, wal_group_commit=cfg["wal_group_commit"],
            wal_segment_bytes=cfg["wal_segment_bytes"],
            lease_ticks=cfg["lease_ticks"], commit_rule=cfg["commit_rule"],
            device=device)
        node = rdb.pipe.node
        log(f"server built {time.monotonic() - t_start:.1f} s after the "
            f"process started, {node.metrics.ticks} ticks; the host ran "
            f"the CPU probe in {probe:.1f} ms")
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        srv = AioSQLServer(0, rdb, host="127.0.0.1")
        srv.start()
        wait_leaders(node, cfg["groups"], 240.0)
        log(f"{cfg['groups']} groups led {time.monotonic() - t_start:.1f}"
            " s after the process started")
        if trace and on_card:
            from portbench.device import warm_profiler
            warm_profiler()
            log(f"profiler warmed {time.monotonic() - t_start:.1f} s after "
                "the process started")
        records = os.path.join(data, "records.bin")
        ppath = os.path.join(data, "loadgen.params")
        with open(ppath, "w") as f:
            f.write(params(cfg, mix, srv.port, args.seed, args.seconds,
                           drain_s, records))
        gen = subprocess.Popen([exe, ppath], stdout=subprocess.PIPE,
                               text=True)
        killer = threading.Timer(RUN_LIMIT_S - (time.monotonic() - t_start),
                                 gen.kill)
        killer.daemon = True
        killer.start()
        snap: dict = {}
        prof_box: dict = {}
        prof_thread = None
        sample = None
        summary = None
        watch = HostWatch()
        for line in gen.stdout:
            word = line.split(" ", 1)[0]
            if word == "OPEN":
                watch.start()
                snap["node_open"] = counters(node)
                lead = [node.leader_of(g) for g in range(cfg["groups"])]
                log(f"the window opens; peer 0 leads {lead.count(0)} of "
                    f"{len(lead)} groups")
                if patch is not None:
                    patch(rdb)
                if trace and on_card:
                    prof_thread = threading.Thread(
                        target=_profile, daemon=True,
                        args=(node, pq, cfg["profile_ticks"],
                              args.seconds, prof_box))
                    prof_thread.start()
            elif word == "CLOSE":
                snap["node_close"] = counters(node)
                t_close = time.monotonic()
                log(f"the window closes; {watch.stop()}")
                at_close = (round(float(line.split()[1]) * 1e9) - 1_000_000,
                            {g: rdb.watermark(g)
                             for g in range(cfg["groups"])})
                if trace and on_card:
                    from portbench.device import k1_sample
                    sample = k1_sample(node.states)
            elif word == "PHASE":
                log(f"load generator: {line.split()[1]} at "
                    f"{float(line.split()[2]) - t_start:.1f} s, "
                    f"{node.metrics.ticks} ticks")
            elif line.startswith("{"):
                summary = json.loads(line)
        rc = gen.wait()
        killer.cancel()
        if rc != 0 or summary is None or "node_close" not in snap:
            log(f"the load generator ended with {rc} before its summary")
            return 1
        if prof_thread is not None:
            prof_thread.join(120)
            if "error" in prof_box or "result" not in prof_box:
                log(f"no device capture: "
                    f"{prof_box.get('error', 'the capture did not end')}")
                return 1
            # The profiled ticks are left out of the per-layer deltas:
            # the capture's counters, cut at the window's close.
            c0, t0 = prof_box["open"]
            c1, t1 = prof_box["close"]
            if t1 > t_close:
                c1, t1 = snap["node_close"], t_close
            snap["capture"] = {"open": c0, "close": c1,
                               "s": max(0.0, t1 - t0)}
            cap_ns = (t0 * 1e9, t1 * 1e9)
        else:
            cap_ns = (0, 0)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        k1 = None
        srv.stop()
        srv = None
        err = rdb.close()
        applied = {g: rdb.watermark(g) for g in range(cfg["groups"])}
        rdb = None
        if err is not None:
            log(f"the server closed with {err!r}")
        if sample is not None:
            from portbench.device import k1_wrong
            k1 = k1_wrong(pq.pallas_quorum_commit_index, sample,
                          quorum=cfg["peers"] // 2 + 1,
                          window=node.cfg.log_window)
            log(f"K1 on the state at the close, {sample[0].shape[0]} rows:"
                f" {k1} rows wrong")
        del sample, node

        from portbench.device import summarize
        from portbench.reference import check as ref
        t_ref = time.monotonic()
        recs = ref.read_records(records)
        gpath = (lambda g: f"{prefix}-fused.db" if g == 0
                 else f"{prefix}-fused-g{g}.db")
        chk = ref.Checker(recs, os.path.join(f"{prefix}-fused", "gc"),
                          cfg["groups"], cfg["peers"], cfg["table"],
                          cfg["key_column"], gpath, applied, at_close)
        chk.run()
        log(f"reference: {len(recs)} requests, "
            f"{time.monotonic() - t_ref:.1f} s")
        for note in chk.notes:
            log(note)
        checks = dict(chk.n)
        if k1 is not None:
            checks["k1_rows_wrong"] = k1

        window_s = summary["close"] - summary["open"]
        sent = [r for r in recs if r.phase == 2]
        done = sorted(r.t1 for r in recs if r.t1 >= 0)
        t_open = summary["open"] * 1e9
        per_s = [0] * max(1, int(window_s))
        for t in done:
            if 0 <= t - t_open < len(per_s) * 1e9:
                per_s[int((t - t_open) // 1e9)] += 1
        gap = max((b - a for a, b in zip(done, done[1:])
                   if t_open <= a < t_open + window_s * 1e9), default=0)
        log(f"answers a second in the window: least {min(per_s)}, most "
            f"{max(per_s)}; longest stretch without one {gap / 1e6:.1f} ms")
        log(f"answers in each second of the window: {per_s}")
        ticks = snap["node_close"]["ticks"] - snap["node_open"]["ticks"]
        log(f"{ticks} ticks in the window, "
            f"{window_s * 1e3 / max(ticks, 1):.2f} ms a tick, "
            f"{summary['window_ok'] / max(ticks, 1):.2f} answers a tick")
        ok_status = {ref.OP_READ: 200}
        snap.update({
            "setup_s": summary["open"] - t_start, "window_s": window_s,
            "window_ok": summary["window_ok"],
            # The requests sent in the window, less those in flight
            # under the profiler.
            "requests": [r for r in sent
                         if r.t1 < cap_ns[0] or r.t0 > cap_ns[1]],
            "profile": summarize(prof_box["result"])
            if "result" in prof_box else None})
        failed = sum(1 for r in sent
                     if r.t1 < 0 or r.status != ok_status.get(r.op, 204))
        metrics = {}
        from portbench.check_line import declared, problems
        for m in declared(bench, args.workload, trace):
            v = load_metric(m["name"]).read(snap)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev = {"platform": "gpu" if on_card else device,
               "kind": torch.cuda.get_device_name(0) if on_card else device,
               "count": cell["chips"], "memory_peak_bytes": int(peak)}
        out = {"correct": all(v == 0 for v in checks.values()),
               "attempted": len(sent), "failed": failed,
               "metrics": metrics, "device": dev}
        if snap["profile"] is not None:
            prof = snap["profile"]
            dev["busy_s"], dev["window_s"] = prof["busy_s"], prof["window_s"]
            out["breakdown"] = {"device_ops": prof["device_ops"],
                                "idle_gaps": prof["idle_gaps"]}
        out["checks"] = {k: {"value": v, "limit": 0}
                         for k, v in checks.items()}
        bad = problems(out, bench, args.workload, trace) if on_card else [
            p for p in problems(out, bench, args.workload, trace)
            if not p.startswith("device.")]
        if bad:
            for p in bad:
                log(f"line incomplete: {p}")
            return 1
        found = forbidden_modules()
        if found:
            log(f"modules loaded that the port must not load: {found}")
            return 1
        for k, v in checks.items():
            print(f"check {k} {v} limit 0", file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(out), flush=True)
        return 0
    finally:
        if gen is not None and gen.poll() is None:
            gen.kill()
            gen.wait()
        if srv is not None:
            srv.stop()
        if rdb is not None:
            rdb.close()
        shutil.rmtree(data, ignore_errors=True)


def _profile(node, pq, ticks: int, seconds: float, box: dict) -> None:
    """The traced run's capture, a third of the way into the window,
    with the program's counters at its edges."""
    from portbench.device import capture
    try:
        time.sleep(seconds / 3)
        box["open"] = (counters(node), time.monotonic())
        box["result"] = capture(node, pq.launches, ticks, log)
        box["close"] = (counters(node), time.monotonic())
    except Exception as e:                              # noqa: BLE001
        box["error"] = repr(e)


if __name__ == "__main__":
    sys.exit(main())
