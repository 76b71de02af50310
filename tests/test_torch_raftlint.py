"""raftlint for the port (raftsql_tpu_torch/analysis/) against the JAX
package's suite, on the CPU.

Every checker fixture of tests/test_raftlint.py runs through both
suites (each against the same stub config): they must give the same
(path, line, rule) findings, rule by rule and with every rule on, and
the findings the JAX tests expect.  Then the two checks PyTorch's idiom
adds (draws from torch's global generator; a CUDA graph, torch.compile
or TorchScript callable built in a loop), each with a must-flag and a
must-pass fixture; the port's live tree is clean; every allowlist entry
has a why; deleting a pinned annotation from a copy of a real module is
a finding.  Last the runtime falsifier: the signature tripwire sees one
call signature per exercised step entry point across chaos runs, and a
direct scalar-then-vector timer_inc flip is an offender.
"""
import ast
import dataclasses
import os
import re
import subprocess
import sys
import tempfile

import pytest
import torch

from raftsql_tpu.analysis import core as jcore
from raftsql_tpu_torch.analysis import config as live_config
from raftsql_tpu_torch.analysis import core as tcore
from raftsql_tpu_torch.analysis.tripwire import SignatureTripwire
from raftsql_tpu_torch.config import RaftConfig
from raftsql_tpu_torch.core import cluster, signature

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULES = ["unused-import", "duplicate-def", "mutable-default",
         "assert-tuple", "bare-except", "wall-clock", "unseeded-random",
         "jit-stability", "thread-ownership", "fail-closed",
         "memory-model"]


class StubConfig:
    """tests/test_raftlint.py's stub: every scope empty unless a test
    opts in."""
    DEFAULT_PATHS = []
    DETERMINISM_PATHS = ["src/"]
    JIT_ENTRY_POINTS = {"step_jit"}
    JIT_STATIC_ARGS = {"step_jit": {0, "cfg"}}
    JIT_SKIP_MIXING_PREFIXES = ()
    OWNERSHIP_REQUIRED = {}
    FAILCLOSED_REQUIRED = {}
    ALLOWLIST = []
    allowlist = ALLOWLIST


def allowlisting_stub():
    cfg = StubConfig()
    cfg.allowlist = [{"rule": "wall-clock", "path": "src/mod.py",
                      "why": "test"}]
    return cfg


def ownership_pinning_stub():
    cfg = StubConfig()
    cfg.OWNERSHIP_REQUIRED = {("mod.py", "Plane"): {"_props": "_lock"}}
    return cfg


def lint(core, src, relpath="src/mod.py", rules=None, config=None):
    unit = core.unit_from_source(src, relpath)
    return core.run_units([unit], config or StubConfig(), rules=rules)


def keys(findings):
    return sorted((f.path, f.line, f.rule) for f in findings)


# The fixtures of tests/test_raftlint.py, verbatim.
DTYPE_SWITCH = """\
def tick(self, timer_inc=None):
    ti = 1 if timer_inc is None else jnp.asarray(timer_inc)
    return step_jit(cfg, state, ti)
"""

BOOT_FIXED = """\
def tick(self, timer_inc=None):
    ti = self._ti_ones if timer_inc is None else jnp.asarray(timer_inc)
    return step_jit(cfg, state, ti)
"""

LOCKFREE_WRITE = """\
import threading

class Plane:
    def __init__(self):
        self._lock = threading.Lock()
        self._props = []  # raftlint: guarded-by=_lock

    def propose(self, item):
        self._props.append(item)
"""

LOCKED_WRITE = """\
import threading

class Plane:
    def __init__(self):
        self._lock = threading.Lock()
        self._props = []  # raftlint: guarded-by=_lock

    def propose(self, item):
        with self._lock:
            self._props.append(item)

    def peek(self):
        return len(self._props)   # lock-free READ: sanctioned idiom
"""

OWNER_OPT_OUT = """\
import threading

class Plane:
    def __init__(self):
        self._lock = threading.Lock()
        self._props = []  # raftlint: guarded-by=_lock

    def drain(self):  # raftlint: owner=tick-thread -- close() joins first
        self._props = []
"""

FALLS_OFF_END = """\
def try_read(mode):  # raftlint: fail-closed
    if mode == "local":
        return 1
    elif mode == "linear":
        return 2
"""

EXPLICIT_FALLBACK = """\
def try_read(mode):  # raftlint: fail-closed
    if mode == "local":
        return 1
    elif mode == "linear":
        return 2
    return None
"""

SWALLOWING_HANDLER = """\
def try_read(q):  # raftlint: fail-closed
    try:
        out = run(q)
    except Exception:
        out = None
    return out
"""

# (id, source, relpath, rules, config factory, the rules the JAX test
# expects to find: [] for a must-pass fixture)
FIXTURES = [
    ("suppressed", "import time\ntime.time()  # raftlint: disable="
     "wall-clock -- test\n", "src/mod.py", ["wall-clock"], None, []),
    ("unsuppressed", "import time\ntime.time()\n", "src/mod.py",
     ["wall-clock"], None, ["wall-clock"]),
    ("skip-file", "# raftlint: skip-file\nimport time\ntime.time()\n",
     "src/mod.py", None, None, []),
    ("allowlisted", "import time\ntime.time()\n", "src/mod.py",
     ["wall-clock"], allowlisting_stub, []),
    ("unused-import-bad", "import os\n", "src/mod.py",
     ["unused-import"], None, ["unused-import"]),
    ("unused-import-good", "import os\nos.getcwd()\n", "src/mod.py",
     ["unused-import"], None, []),
    ("duplicate-def-bad", "def f():\n    pass\ndef f():\n    pass\n",
     "src/mod.py", ["duplicate-def"], None, ["duplicate-def"]),
    ("duplicate-def-good", "def f():\n    pass\ndef g():\n    pass\n",
     "src/mod.py", ["duplicate-def"], None, []),
    ("mutable-default-bad", "def f(x=[]):\n    pass\n", "src/mod.py",
     ["mutable-default"], None, ["mutable-default"]),
    ("mutable-default-good", "def f(x=None):\n    pass\n", "src/mod.py",
     ["mutable-default"], None, []),
    ("assert-tuple-bad", "assert (1 == 1, 'msg')\n", "src/mod.py",
     ["assert-tuple"], None, ["assert-tuple"]),
    ("assert-tuple-good", "assert 1 == 1, 'msg'\n", "src/mod.py",
     ["assert-tuple"], None, []),
    ("bare-except-bad", "try:\n    pass\nexcept:\n    pass\n",
     "src/mod.py", ["bare-except"], None, ["bare-except"]),
    ("bare-except-good", "try:\n    pass\nexcept ValueError:\n    pass\n",
     "src/mod.py", ["bare-except"], None, []),
    ("wall-clock-in-scope", "import time\nt = time.time()\n",
     "src/mod.py", ["wall-clock"], None, ["wall-clock"]),
    ("wall-clock-out-of-scope", "import time\nt = time.time()\n",
     "tools/x.py", ["wall-clock"], None, []),
    ("monotonic", "import time\nt = time.monotonic()\n", "src/mod.py",
     ["wall-clock"], None, []),
    ("random-global", "import random\nx = random.random()\n",
     "src/mod.py", ["unseeded-random"], None, ["unseeded-random"]),
    ("random-unseeded", "import random\nr = random.Random()\n",
     "src/mod.py", ["unseeded-random"], None, ["unseeded-random"]),
    ("random-seeded", "import random\nr = random.Random(42)\n",
     "src/mod.py", ["unseeded-random"], None, []),
    ("jax-random-keyed",
     "import jax\nx = jax.random.randint(key, (), 0, 9)\n", "src/mod.py",
     ["unseeded-random"], None, []),
    ("numpy-seeded", "import numpy as np\nr = np.random.default_rng(7)\n",
     "src/mod.py", ["unseeded-random"], None, []),
    ("numpy-unseeded", "import numpy as np\nr = np.random.default_rng()\n",
     "src/mod.py", ["unseeded-random"], None, ["unseeded-random"]),
    ("dtype-switch", DTYPE_SWITCH, "src/mod.py", ["jit-stability"], None,
     ["jit-stability"]),
    ("boot-fixed", BOOT_FIXED, "src/mod.py", ["jit-stability"], None, []),
    ("cross-site-mixing",
     "def a():\n    return step_jit(cfg, state, 1)\n"
     "def b(arr):\n    return step_jit(cfg, state, arr)\n", "src/mod.py",
     ["jit-stability"], None, ["jit-stability"]),
    ("same-literal",
     "def a():\n    return step_jit(cfg, state, 1)\n"
     "def b():\n    return step_jit(cfg, state, 1)\n", "src/mod.py",
     ["jit-stability"], None, []),
    ("static-args-exempt",
     "def a(c1, c2, x):\n    step_jit(c1, state, x)\n"
     "    step_jit(2, state, x)\n", "src/mod.py", ["jit-stability"], None,
     []),
    ("jax-jit-in-loop",
     "import jax\ndef f(xs):\n    for x in xs:\n"
     "        g = jax.jit(lambda y: y)\n        g(x)\n", "src/mod.py",
     ["jit-stability"], None, ["jit-stability"]),
    ("lockfree-write", LOCKFREE_WRITE, "src/mod.py", ["thread-ownership"],
     None, ["thread-ownership"]),
    ("locked-write", LOCKED_WRITE, "src/mod.py", ["thread-ownership"],
     None, []),
    ("owner-opt-out", OWNER_OPT_OUT, "src/mod.py", ["thread-ownership"],
     None, []),
    ("ownership-registry-pin",
     "class Plane:\n    def __init__(self):\n        self._props = []\n",
     "src/mod.py", ["thread-ownership"], ownership_pinning_stub,
     ["thread-ownership"]),
    ("falls-off-end", FALLS_OFF_END, "src/mod.py", ["fail-closed"], None,
     ["fail-closed"]),
    ("explicit-fallback", EXPLICIT_FALLBACK, "src/mod.py",
     ["fail-closed"], None, []),
    ("swallowing-handler", SWALLOWING_HANDLER, "src/mod.py",
     ["fail-closed"], None, ["fail-closed"]),
    ("fail-closed-unannotated",
     "def f(mode):\n    if mode:\n        return 1\n", "src/mod.py",
     ["fail-closed"], None, []),
    ("seqlock-bare", "def read():  # raftlint: seqlock\n    return 1\n",
     "src/mod.py", ["memory-model"], None, ["memory-model"]),
    ("seqlock-declared", "# raftlint: assumes=x86-tso\n"
     "def read():  # raftlint: seqlock\n    return 1\n", "src/mod.py",
     ["memory-model"], None, []),
]


def test_registered_rule_set_is_the_jax_suites():
    assert {c.name for c in tcore.all_checkers()} \
        == {c.name for c in jcore.all_checkers()} == set(RULES)


def test_cli_list_names_the_jax_rule_ids():
    out = {}
    for pkg in ("raftsql_tpu.analysis", "raftsql_tpu_torch.analysis"):
        r = subprocess.run([sys.executable, "-m", pkg, "--list"],
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == 0, r.stderr
        out[pkg] = sorted(line.split()[0]
                          for line in r.stdout.splitlines())
    assert out["raftsql_tpu_torch.analysis"] \
        == out["raftsql_tpu.analysis"] == sorted(RULES)


@pytest.mark.parametrize("fid,src,relpath,rules,mkcfg,want",
                         FIXTURES, ids=[f[0] for f in FIXTURES])
def test_fixture_parity(fid, src, relpath, rules, mkcfg, want):
    """The fixture's findings, under its own rule filter and with every
    rule on, are the same in both suites and the ones the JAX test
    expects."""
    for sel in (rules, None):
        j = lint(jcore, src, relpath, sel, mkcfg() if mkcfg else None)
        t = lint(tcore, src, relpath, sel, mkcfg() if mkcfg else None)
        assert keys(t) == keys(j), (sel, [f.render() for f in t],
                                    [f.render() for f in j])
    got = lint(tcore, src, relpath, rules, mkcfg() if mkcfg else None)
    assert sorted({f.rule for f in got}) == want


def test_ownership_finding_names_attr_and_lock():
    got = lint(tcore, LOCKFREE_WRITE, rules=["thread-ownership"])
    assert "_props" in got[0].message and "_lock" in got[0].message


# -- what PyTorch's idiom adds ----------------------------------------

TORCH_DRAWS = ["torch.rand(3)", "torch.randn(2, 2)",
               "torch.randint(0, 9, (3,))", "torch.randperm(5)",
               "torch.normal(0.0, 1.0, (3,))", "torch.bernoulli(p)"]


@pytest.mark.parametrize("draw", TORCH_DRAWS)
def test_torch_global_generator_draw_is_unseeded(draw):
    src = f"import torch\nx = {draw}\n"
    got = lint(tcore, src, rules=["unseeded-random"])
    assert [(f.line, f.rule) for f in got] == [(2, "unseeded-random")]
    assert "generator" in got[0].message
    # The JAX suite leaves it alone: it is the port's addition.
    assert lint(jcore, src, rules=["unseeded-random"]) == []
    # Out of DETERMINISM_PATHS scope: clean.
    assert lint(tcore, src, relpath="tools/x.py",
                rules=["unseeded-random"]) == []


@pytest.mark.parametrize("draw", TORCH_DRAWS)
def test_torch_draw_from_an_explicit_generator_passes(draw):
    seeded = draw[:-1] + (", " if draw[-2] != "(" else "") \
        + "generator=g)"
    src = ("import torch\ng = torch.Generator().manual_seed(3)\n"
           f"x = {seeded}\n")
    assert lint(tcore, src, rules=["unseeded-random"]) == []


BUILT_IN_LOOP = {
    "cuda-graph": ("import torch\ndef f(xs):\n    for x in xs:\n"
                   "        g = torch.cuda.CUDAGraph()\n"
                   "        with torch.cuda.graph(g):\n"
                   "            step(x)\n        g.replay()\n", [4, 5]),
    "compile": ("import torch\ndef f(xs):\n    while xs:\n"
                "        fn = torch.compile(step)\n"
                "        fn(xs.pop())\n", [4]),
    "jit-script": ("import torch\ndef f(xs):\n    for x in xs:\n"
                   "        torch.jit.script(step)(x)\n", [4]),
    "jit-trace": ("import torch\ndef f(xs):\n    for x in xs:\n"
                  "        torch.jit.trace(step, x)(x)\n", [4]),
    "partial-compile": ("import functools\nimport torch\ndef f(xs):\n"
                        "    for x in xs:\n"
                        "        functools.partial(torch.compile, "
                        "mode='max-autotune')(step)(x)\n", [5]),
}

BUILT_ONCE = {
    "cuda-graph": ("import torch\ndef f(xs, x0):\n"
                   "    g = torch.cuda.CUDAGraph()\n"
                   "    with torch.cuda.graph(g):\n        step(x0)\n"
                   "    for x in xs:\n        x0.copy_(x)\n"
                   "        g.replay()\n"),
    "compile": ("import torch\ndef f(xs):\n    fn = torch.compile(step)\n"
                "    while xs:\n        fn(xs.pop())\n"),
    "jit-script": ("import torch\ndef f(xs):\n"
                   "    fn = torch.jit.script(step)\n"
                   "    for x in xs:\n        fn(x)\n"),
    "jit-trace": ("import torch\ndef f(xs):\n"
                  "    fn = torch.jit.trace(step, xs[0])\n"
                  "    for x in xs:\n        fn(x)\n"),
    "partial-compile": ("import functools\nimport torch\ndef f(xs):\n"
                        "    fn = functools.partial(torch.compile)(step)\n"
                        "    for x in xs:\n        fn(x)\n"),
}


@pytest.mark.parametrize("kind", sorted(BUILT_IN_LOOP))
def test_graph_or_compile_built_in_a_loop_is_flagged(kind):
    src, lines = BUILT_IN_LOOP[kind]
    got = lint(tcore, src, rules=["jit-stability"])
    assert [(f.line, f.rule) for f in got] \
        == [(ln, "jit-stability") for ln in lines]


@pytest.mark.parametrize("kind", sorted(BUILT_ONCE))
def test_graph_or_compile_built_once_passes(kind):
    assert lint(tcore, BUILT_ONCE[kind], rules=["jit-stability"]) == []


# -- the teeth ----------------------------------------------------------

def test_live_tree_is_raftlint_clean(monkeypatch):
    """The port's tree passes its full suite, as `python -m
    raftsql_tpu_torch.analysis` checks it."""
    monkeypatch.chdir(ROOT)
    units = list(tcore.iter_py(live_config.DEFAULT_PATHS))
    assert "chip_smoke.py" in units
    assert "tests/test_torch_raftlint.py" in units
    assert any(u.startswith("raftsql_tpu_torch/") for u in units)
    findings = tcore.run_suite(live_config.DEFAULT_PATHS)
    assert findings == [], "\n" + "\n".join(f.render() for f in findings)


def test_cli_exits_zero_on_the_port():
    r = subprocess.run([sys.executable, "-m", "raftsql_tpu_torch.analysis"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-2000:]
    assert r.stdout.strip().endswith("raftlint: ok")


def test_live_tree_findings_without_the_allowlist_are_its_two_entries(
        monkeypatch):
    """Each allowlist entry covers a living call site, and nothing else
    in the tree needs one."""
    monkeypatch.chdir(ROOT)

    class Bare:
        pass

    cfg = Bare()
    for k in dir(live_config):
        if k.isupper():
            setattr(cfg, k, getattr(live_config, k))
    cfg.allowlist = []
    found = tcore.run_suite(live_config.DEFAULT_PATHS, config=cfg)
    assert sorted((f.rule, f.path) for f in found) == sorted(
        (e["rule"], e["path"]) for e in live_config.ALLOWLIST)
    for f, e in zip(sorted(found, key=lambda f: f.rule),
                    sorted(live_config.ALLOWLIST, key=lambda e: e["rule"])):
        assert e["contains"] in f.message


def test_allowlist_entries_carry_justifications():
    for entry in live_config.ALLOWLIST:
        assert entry.get("why"), f"allowlist entry without why: {entry}"
        assert entry.get("rule") and entry.get("path")
        assert entry["path"].startswith("raftsql_tpu_torch/")


def _pinned():
    out = []
    for (suffix, cls), attrs in live_config.OWNERSHIP_REQUIRED.items():
        for attr in attrs:
            out.append(("guarded-by", suffix, cls, attr))
    for suffix, req in live_config.FAILCLOSED_REQUIRED.items():
        for flag in ("fail-closed", "seqlock"):
            for fname in req.get(flag, ()):
                out.append((flag, suffix, None, fname))
    return out


def _strip(src: str, flag: str, cls, name: str) -> str:
    """`src` with the pinned annotation of `name` deleted: the
    guarded-by on `self.<name> = ...` in class `cls`, or `flag` on the
    def of `name`."""
    tree = ast.parse(src)
    lines = src.splitlines()
    if flag == "guarded-by":
        klass = next(n for n in ast.walk(tree)
                     if isinstance(n, ast.ClassDef) and n.name == cls)
        at = [n.lineno for n in ast.walk(klass)
              if isinstance(n, (ast.Assign, ast.AnnAssign))
              and any(isinstance(t, ast.Attribute) and t.attr == name
                      for t in (n.targets if isinstance(n, ast.Assign)
                                else [n.target]))]
        spots = [ln for a in at for ln in (a, a - 1)]
        pat = re.compile(r"\s*# raftlint: guarded-by=\S+.*$")
    else:
        node = next(n for n in ast.walk(tree)
                    if isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))
                    and n.name == name)
        spots = [node.lineno, node.lineno - 1] \
            + [d.lineno for d in node.decorator_list]
        pat = re.compile(rf"(# raftlint:.*?)\b{flag}\b")
    hit = False
    for ln in spots:
        text = lines[ln - 1]
        new = pat.sub(r"\1" if flag != "guarded-by" else "", text)
        if new != text:
            lines[ln - 1] = new
            hit = True
    assert hit, (flag, cls, name)
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("flag,suffix,cls,name", _pinned(),
                         ids=lambda v: str(v))
def test_deleting_a_pinned_annotation_is_a_finding(flag, suffix, cls,
                                                    name):
    relpath = f"raftsql_tpu_torch/{suffix}"
    with open(os.path.join(ROOT, relpath)) as f:
        src = f.read()
    rule = "thread-ownership" if flag == "guarded-by" else "fail-closed"
    # The live module passes its registry pin ...
    assert lint(tcore, src, relpath, [rule], live_config) == []
    # ... and a copy without the annotation does not.
    got = lint(tcore, _strip(src, flag, cls, name), relpath, [rule],
               live_config)
    assert any(name in f.message and f.rule == rule for f in got), \
        [f.render() for f in got]


# -- the runtime falsifier ------------------------------------------------

def _skew(d):
    from raftsql_tpu_torch.chaos.scenarios import FusedChaosRunner
    from raftsql_tpu_torch.chaos.schedule import generate_skew
    sched = generate_skew(3)
    return FusedChaosRunner(
        dataclasses.replace(sched, ticks=min(sched.ticks, 120)), d,
        device="cpu")


def _quorum(d):
    from raftsql_tpu_torch.chaos.scenarios import QuorumChaosRunner
    from raftsql_tpu_torch.chaos.schedule import generate_quorum
    return QuorumChaosRunner(dataclasses.replace(generate_quorum(3),
                                                 ticks=120), d,
                             device="cpu")


def _multistep(d):
    from raftsql_tpu_torch.chaos.scenarios import FusedChaosRunner
    from raftsql_tpu_torch.chaos.schedule import generate
    return FusedChaosRunner(generate(0, ticks=120), d, device="cpu",
                            steps=4)


def _node(d):
    from raftsql_tpu_torch.chaos.scenarios import NodeClusterChaosRunner
    from raftsql_tpu_torch.chaos.schedule import generate_corrupt_plan
    return NodeClusterChaosRunner(generate_corrupt_plan(3, ticks=60), d,
                                  device="cpu")


@pytest.mark.parametrize("mk,entry", [
    (_skew, "cluster_step_host"), (_quorum, "cluster_step_host"),
    (_multistep, "cluster_multistep_host"), (_node, "peer_step_packed")],
    ids=["skew", "quorum", "multistep", "node"])
def test_tripwire_one_signature_per_entry_point(mk, entry):
    """The skew family flips timer_inc between None and a [P] vector
    mid-run (the JAX package's historical recompile schedule), the
    quorum family adds witness gates and masked thresholds, and every
    run crashes and restarts its nodes: each exercised entry point must
    still see exactly one call signature."""
    with tempfile.TemporaryDirectory(prefix="raftlint-tw-") as d, \
            SignatureTripwire() as tw:
        mk(d).run()
    compiles = tw.compiles()
    assert compiles[entry] == 1, compiles
    assert set(compiles.values()) <= {0, 1}, compiles
    assert tw.offenders(limit=1) == {}, compiles
    tw.check()
    assert tw.baseline(entry) == 0


def _small():
    cfg = RaftConfig(num_groups=4, num_peers=3, log_window=16,
                     max_entries_per_msg=2, commit_rule="pallas")
    st = cluster.init_cluster_state(cfg, 1, device="cpu")
    return cfg, st, cluster.empty_cluster_inbox(cfg, device="cpu")


def test_tripwire_catches_a_scalar_then_vector_timer_inc():
    cfg, st, ib = _small()
    pn = torch.zeros((3, 4), dtype=torch.int32)
    with SignatureTripwire() as tw:
        st, ib, _, _ = cluster.cluster_step_host(cfg, st, ib, pn)
        st, ib, _, _ = cluster.cluster_step_host(cfg, st, ib, pn)
        assert tw.offenders(limit=1) == {}
        st, ib, _, _ = cluster.cluster_step_host(
            cfg, st, ib, pn, torch.ones(3, dtype=torch.int32))
    assert tw.offenders(limit=1) == {"cluster_step_host": 2}
    with pytest.raises(AssertionError, match="cluster_step_host"):
        tw.check()


def test_signature_key_tells_none_scalar_and_tensor_apart():
    ti = torch.ones(3, dtype=torch.int32)
    forms = [None, 1, 1.0, True, ti, ti.to(torch.int64),
             torch.ones(4, dtype=torch.int32)]
    assert len({signature.signature_key((), (f,)) for f in forms}) \
        == len(forms)
    # Same shape, dtype and device: one key, whatever the values.
    assert signature.signature_key((), (ti,)) \
        == signature.signature_key((), (torch.zeros(3, dtype=torch.int32),))


def test_static_arguments_count_by_value():
    """A new step count is a new program (the JAX package's static
    argument); the same one is not."""
    cfg, st, ib = _small()
    with SignatureTripwire() as tw:
        for T in (3, 3, 5):
            st, ib, _ = cluster.cluster_run(
                cfg, st, ib, T, torch.zeros((T, 3, 4), dtype=torch.int32))
    assert tw.compiles()["cluster_run"] == 2


def test_disarmed_entry_points_record_nothing():
    cfg, st, ib = _small()
    pn = torch.zeros((3, 4), dtype=torch.int32)
    tw = SignatureTripwire()
    tw.disarm()
    assert signature.ARMED == []
    cluster.cluster_step_host(cfg, st, ib, pn)
    assert tw.compiles()["cluster_step_host"] == 0
