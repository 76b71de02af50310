"""Build and run the native WAL stress harness under sanitizers.

    python -m raftsql_tpu_torch.native.sanitize            # asan, ubsan, tsan
    python -m raftsql_tpu_torch.native.sanitize --san tsan --iters 500

The port's counterpart of the JAX package's scripts/native_sanitize.py
(which builds the JAX package's copy of wal.cc).  native/wal_stress.cc
drives four threads of appends, hardstates, compaction and snapshot
markers and syncs on one WAL handle of the port's native/wal.cc: the
surface the serving stack hits from its tick, apply and HTTP threads.
Each variant is compiled with g++ at first use into build/native/
(native/build.py build_wal_stress).

Exit 0: every requested sanitizer built, ran and reported nothing.
Unlike the JAX script there is no skip: a failed build, a sanitizer
report or a failed stress run raises (exit 1 with the output).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

from raftsql_tpu_torch.native.build import SANITIZERS, build_wal_stress


def run_one(san: str, iters: int = 2000) -> float:
    """Build (if needed) and run the stress harness under `san`; returns
    the run's wall seconds.  Raises RuntimeError on a failed build, a
    nonzero exit or any sanitizer report on stderr."""
    exe = build_wal_stress(san)
    env = dict(os.environ)
    # halt_on_error makes asan's exit code authoritative; ubsan's
    # -fno-sanitize-recover already aborts on the first diagnostic, and
    # tsan exits nonzero on a report with halt_on_error.
    env.setdefault("ASAN_OPTIONS", "halt_on_error=1")
    env.setdefault("TSAN_OPTIONS", "halt_on_error=1")
    with tempfile.TemporaryDirectory(prefix=f"wal-{san}-") as d:
        t0 = time.monotonic()
        proc = subprocess.run([exe, d, str(iters)], env=env,
                              capture_output=True, text=True, timeout=600)
        wall = time.monotonic() - t0
    if proc.returncode != 0 or "Sanitizer" in proc.stderr \
            or "runtime error" in proc.stderr:
        raise RuntimeError(f"native-sanitize[{san}]: rc={proc.returncode}\n"
                           f"{proc.stdout}{proc.stderr}")
    return wall


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="run the WAL stress harness under sanitizers")
    ap.add_argument("--san", action="append", default=None,
                    choices=sorted(SANITIZERS),
                    help="sanitizer to run (repeatable; default all three)")
    ap.add_argument("--iters", type=int, default=2000,
                    help="stress iterations per thread (default 2000)")
    args = ap.parse_args(argv)
    for san in args.san or ["asan", "ubsan", "tsan"]:
        try:
            wall = run_one(san, args.iters)
        except RuntimeError as e:
            print(e, file=sys.stderr)
            return 1
        print(f"native-sanitize[{san}]: ok ({args.iters} iters x 4 "
              f"threads, {wall:.2f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
