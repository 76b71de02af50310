"""The port's tooling: the trace demo (obs/trace_demo.py, the JAX
package's `make trace`) and the native WAL's sanitizer runner
(native/wal_stress.cc, native/build.py build_wal_stress,
native/sanitize.py, the counterpart of scripts/native_sanitize.py)."""
import json

import pytest
import torch

from raftsql_tpu_torch.native import build as native_build
from raftsql_tpu_torch.native import sanitize
from raftsql_tpu_torch.obs.export import validate_chrome_trace
from raftsql_tpu_torch.obs.trace_demo import main as trace_main
from raftsql_tpu_torch.obs.trace_demo import run_demo

torch.set_num_threads(1)


def test_trace_demo_document_validates(tmp_path, capsys):
    out = tmp_path / "trace.json"
    assert trace_main(["--out", str(out), "--groups", "2", "--ticks", "60",
                       "--device", "cpu"]) == 0
    assert "trace ok" in capsys.readouterr().out
    doc = json.loads(out.read_text())
    validate_chrome_trace(doc)
    phases = {e.get("ph") for e in doc["traceEvents"]}
    assert "C" in phases                  # the device ring's counters
    assert phases & {"X", "B", "E"}       # the proposal spans
    names = {e.get("name") for e in doc["traceEvents"]}
    assert any("commit" in str(n) for n in names), sorted(map(str, names))


def test_trace_demo_needs_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        run_demo(str(tmp_path / "t.json"), groups=1, ticks=2)


@pytest.mark.parametrize("san", ["asan", "ubsan", "tsan"])
def test_wal_stress_under_sanitizer(san, tmp_path):
    exe = native_build.build_wal_stress(san, str(tmp_path))
    assert exe.startswith(str(tmp_path)) and f"wal_stress_{san}_" in exe
    assert native_build.build_wal_stress(san, str(tmp_path)) == exe
    wall = sanitize.run_one(san, iters=300)
    assert wall > 0


def test_sanitize_cli(capsys):
    assert sanitize.main(["--san", "ubsan", "--iters", "200"]) == 0
    assert "native-sanitize[ubsan]: ok" in capsys.readouterr().out


def test_failed_wal_stress_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "wal_stress.cc"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native_build, "STRESS_SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_build.build_wal_stress("asan", str(tmp_path / "b"))
