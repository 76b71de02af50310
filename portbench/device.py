"""What the benchmark measures on the card itself.

- `k1_sample`: a copy of the consensus state's K1 inputs at the window's
  end (one row per peer and group), taken from the live cluster.
- `k1_wrong`: K1 launched on that copy, each launch's result held
  against the plain version below.
- `warm_profiler`: the profiler's first start, in set-up.
- `capture`: torch.profiler over a fixed number of ticks inside the
  window: the card's busy seconds against the capture's length.  A
  capture that records no device time is taken again, twice, and then
  fails.  `summarize`, after the window: the ops that took most device
  time and the longest idle gaps.
"""
from __future__ import annotations

import time

import torch

LEADER = 2
K1_NAME = "pallas_quorum_commit_index"


def k1_plain(match, log_term, log_len, commit, term, is_leader, *,
             quorum: int, window: int):
    """K1's rule in plain torch: a leader row's commit advances to the
    largest match index that `quorum` peers reach, when the ring holds
    that entry at the leader's term."""
    cand = k1_cand(match, quorum)
    slot = torch.remainder(cand - 1, window)
    ct = torch.gather(log_term, -1, slot.long()[..., None])[..., 0]
    ct = torch.where((cand >= 1) & (cand <= log_len), ct, 0)
    ok = is_leader & (ct == term) & (cand > commit)
    return torch.where(ok, cand, commit)


def k1_cand(match, quorum: int):
    cnt = (match[..., None, :] >= match[..., :, None]).sum(
        -1, dtype=torch.int32)
    return torch.where(cnt >= quorum, match, 0).amax(-1)


def k1_sample(states) -> tuple:
    """K1's six inputs from a stacked [P, G, ...] cluster state, copied."""
    P, G = states.term.shape
    rows = P * G
    return (states.match.reshape(rows, -1).clone().contiguous(),
            states.log_term.reshape(rows, -1).clone().contiguous(),
            states.log_len.reshape(rows).clone(),
            states.commit.reshape(rows).clone(),
            states.term.reshape(rows).clone(),
            (states.role.reshape(rows) == LEADER).contiguous())


def k1_wrong(kernel, args, quorum: int, window: int, reps: int = 20):
    """Rows, over `reps` launches, whose result differs from the plain
    rule."""
    want = k1_plain(*args, quorum=quorum, window=window)
    outs = [kernel(*args, quorum=quorum, window=window)
            for _ in range(reps)]
    return sum(int((o != want).sum()) for o in outs)


def _device_events(prof) -> list:
    """The capture's device activities (kernels, copies, fills), read
    from the profiler's raw results: no per-event Python parsing."""
    from torch._C._autograd import DeviceType
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]


def warm_profiler() -> None:
    """Start and stop torch.profiler once in set-up: its first start
    loads and initialises CUPTI, which stalls the process for seconds."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    _device_events(prof)


def capture(node, launches: dict, ticks: int, log) -> dict:
    """Profile `ticks` ticks of the running node.  Only the busy seconds
    are summed here, inside the window; `summarize` reads the rest once
    the server has stopped, since reading a profile holds the
    interpreter lock for seconds and would stall the server."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            k0, n0 = launches[K1_NAME], node.metrics.ticks
            w0 = time.monotonic()
            while node.metrics.ticks - n0 < ticks:
                time.sleep(0.002)
            torch.cuda.synchronize()
            w1 = time.monotonic()
            k1 = launches[K1_NAME] - k0
        ev = _device_events(prof)
        busy = sum(e.duration_ns() for e in ev) * 1e-9
        seen = sum(1 for e in ev if "quorum_commit" in e.name())
        log(f"profiler capture {attempt + 1}: {len(ev)} device "
            f"activities, {busy:.6f} s busy in {w1 - w0:.6f} s; recorded "
            f"{seen} of the {k1} K1 launches of the sub-window")
        if busy > 0:
            return {"busy_s": busy, "window_s": w1 - w0, "prof": prof,
                    "events": ev}
    raise RuntimeError("torch.profiler recorded no device time in three "
                       "captures of the window")


def summarize(cap: dict) -> dict:
    """busy_s and window_s, the ten device ops that took most time and
    the ten longest stretches with no device activity, named by the ops
    on either side."""
    by_name: dict = {}
    spans = []
    for e in cap["events"]:
        by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns()
        spans.append((e.start_ns(), e.end_ns(), e.name()))
    ops = sorted(([k, ns * 1e-9] for k, ns in by_name.items()),
                 key=lambda x: -x[1])
    spans.sort()
    gaps, end, prev = [], None, None
    for s, t, name in spans:
        if end is not None and s > end:
            gaps.append([f"after {prev[:60]}, before {name[:60]}",
                         (s - end) * 1e-9])
        if end is None or t > end:
            end, prev = t, name
    gaps.sort(key=lambda g: -g[1])
    return {"busy_s": cap["busy_s"], "window_s": cap["window_s"],
            "device_ops": ops[:10], "idle_gaps": gaps[:10]}
