"""Time this checkout's quorum kernels in turns with another build's.

    python3 chip_compare.py DIR

DIR holds another build's `ops/pallas_quorum.py` and `csrc/quorum.cu` in
this package's layout, for example an earlier commit's:

    mkdir -p build/prev/ops build/prev/csrc
    git show REV:raftsql_tpu_torch/ops/pallas_quorum.py \
        > build/prev/ops/pallas_quorum.py
    git show REV:raftsql_tpu_torch/csrc/quorum.cu > build/prev/csrc/quorum.cu

(its kernels build under DIR/../build/).  One fused tick at G = 100,000,
P = 3, W = 256 hands K1 and K2 their inputs, copied as `chip_smoke.py`
phase 4 copies them; each build's wrapper is held to the plain version
on those tensors and timed in turns (other, this, this, other): per
call by CUDA events, host time, and the kernel's device time by
torch.profiler.  Needs one CUDA card.
"""
from __future__ import annotations

import importlib.util
import os
import sys

import chip_smoke as cs
from raftsql_tpu_torch.config import RaftConfig
from raftsql_tpu_torch.core import cluster
from raftsql_tpu_torch.ops import pallas_quorum as pq


def load(path: str):
    spec = importlib.util.spec_from_file_location(
        "quorum_other", os.path.join(path, "ops", "pallas_quorum.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cs.log(f"other build: {path} in {mod.build():.1f} s")
    return mod


def main(path: str) -> int:
    card = cs.environment()
    cs.log(f"this build: csrc/quorum.cu in {pq.build():.1f} s")
    other = load(path)
    G, P, W, E = 100_000, 3, 256, 32
    cfg = RaftConfig(num_groups=G, num_peers=P, log_window=W,
                     max_entries_per_msg=E, commit_rule="pallas")
    st = cluster.init_cluster_state(cfg, device="cuda")
    ib = cluster.empty_cluster_inbox(cfg, device="cuda")
    st, ib, _, _ = cs.run_ticks(cfg, st, ib, 32, seed=1)   # elect leaders
    captured = {}
    st, ib = cs.capture_tick(cfg, st, ib, "pallas_quorum_commit_index",
                             captured)
    dcfg = RaftConfig(num_groups=G, num_peers=P, log_window=W,
                      max_entries_per_msg=E, commit_rule="pallas",
                      dynamic_membership=True)
    cs.capture_tick(dcfg, st, ib, "pallas_masked_quorum_commit_index",
                    captured)
    for name, (args, kw) in captured.items():
        masks = (kw["voters"], kw["voters_joint"]) if "voters" in kw \
            else None
        size = kw.get("size") if masks is not None else kw["quorum"]
        kern, plain, _ = cs._calls(args, masks, P, size)
        k_other = cs._calls(args, masks, P, size, other)[0]
        cs._equal(kern, plain, f"{name}, this build")
        cs._equal(k_other, plain, f"{name}, other build")
        turns = []
        for label, k in (("other", k_other), ("this", kern),
                         ("this", kern), ("other", k_other)):
            turns.append(f"{label} {cs.time_ms(k, reps=100) * 1e3:.1f} us "
                         f"per call / host {cs.host_us(k):.1f} us / device "
                         f"{cs._us(cs.kernel_device_us(k))}")
        cs.log(f"{name} R={args[0].shape[0]} P={P} W={W} in turns: "
               + "; ".join(turns) + f" on {card}")
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    sys.exit(main(sys.argv[1]))
