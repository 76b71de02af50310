"""raftsql_tpu_torch stands alone: every module imports in a fresh
interpreter with neither jax nor raftsql_tpu loaded, and neither the
kernels nor the native storage plane are built at import time."""
import json
import os
import pkgutil
import subprocess
import sys

import pytest

import raftsql_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = sorted(m.name for m in pkgutil.walk_packages(
    raftsql_tpu_torch.__path__, "raftsql_tpu_torch."))
# The scripts at the repo's root that drive the port on the card.
SCRIPTS = ["chip_smoke", "chip_compare"]

# One fresh interpreter imports the modules one by one and records, per
# module, any jax / raftsql_tpu / triton module that appeared with it.
PROBE = """
import importlib, json, sys
def foreign():
    return {m for m in sys.modules
            if m.split(".")[0] in ("jax", "raftsql_tpu", "triton")}
out = {"preloaded": sorted(foreign()), "modules": {}}
for name in sys.argv[1:]:
    seen = foreign()
    importlib.import_module(name)
    out["modules"][name] = sorted(foreign() - seen)
from raftsql_tpu_torch.ops import pallas_quorum
from raftsql_tpu_torch.native import build as native_build
out["built_at_import"] = pallas_quorum._lib is not None
out["native_built_at_import"] = bool(native_build._libs)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def probe():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", PROBE, *MODULES, *SCRIPTS],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["preloaded"] == [], got["preloaded"]
    assert not got["built_at_import"]
    assert not got["native_built_at_import"]
    return got["modules"]


def test_module_list_covers_the_slice():
    for m in ("config", "convert", "core.state", "core.step",
              "core.cluster", "ops.dense", "ops.quorum", "ops.commit_scan",
              "ops.pallas_quorum", "runtime.hostplane", "runtime.fused",
              "runtime.db", "storage.wal", "api.aio", "api.http",
              "server.main", "core.threefry", "transport.faults",
              "obs.device_ring", "obs.spans", "obs.export", "obs.flight",
              "chaos.invariants", "chaos.schedule", "chaos.scenarios",
              "chaos.run", "membership", "membership.manager",
              "placement", "placement.controller",
              "transport.base", "transport.codec", "transport.loopback",
              "transport.tcp", "runtime.node", "runtime.pipe",
              "models.witness", "api.client", "chaos.proc",
              "overload", "overload.admission", "native", "native.build",
              "storage.log", "models.kv_sm", "models.kv_native"):
        assert f"raftsql_tpu_torch.{m}" in MODULES, m


@pytest.mark.parametrize("mod", MODULES + SCRIPTS)
def test_imports_without_jax(probe, mod):
    assert probe[mod] == [], probe[mod]
