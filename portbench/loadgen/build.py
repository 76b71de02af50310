"""Build the benchmark's load generator (loadgen.cc) with g++.

The binary goes to portbench/loadgen/bin/loadgen_<digest of the source
and flags>, a fixed path inside the checkout: only the first run in a
checkout compiles it.  A failed build raises with the compiler's output.
"""
from __future__ import annotations

import hashlib
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "loadgen.cc")
BIN_DIR = os.path.join(_DIR, "bin")
FLAGS = ("-O2", "-std=c++17")


def build() -> str:
    """The path of the built load generator, compiling it if missing."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode()
                                ).hexdigest()[:16]
    exe = os.path.join(BIN_DIR, f"loadgen_{digest}")
    if os.path.exists(exe):
        return exe
    os.makedirs(BIN_DIR, exist_ok=True)
    tmp = f"{exe}.{os.getpid()}.tmp"
    res = subprocess.run(["g++", *FLAGS, "-o", tmp, SOURCE],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}) on {SOURCE}:\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, exe)
    return exe
