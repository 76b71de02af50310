"""determinism — no wall clock / unseeded RNG in digest-relevant code.

The chaos plane's contract is that a seed reproduces bit-for-bit
(`make chaos` runs every seed twice and digest-compares), and the
bench harness compares runs across rounds.  Both break silently the
moment a digest-relevant module reads `time.time()`, an argless
`datetime.now()`, or an unseeded RNG — the run still "passes", it just
stops being evidence.  Scope is config.DETERMINISM_PATHS; the
sanctioned clocks (`time.monotonic*`, `time.perf_counter*`), keyed
`jax.random` and torch draws from an explicit `generator=` are
untouched.  Wall-clock planes (placement timestamps, client jitter) live
in config.ALLOWLIST with justifications.

The port's copy of raftsql_tpu/analysis/checkers/determinism.py, with
one addition PyTorch's idiom needs: torch's draws default to the
process-global generator (where every `jax.random` draw takes a key), so
`torch.rand/randn/randint/randperm/normal/bernoulli` without
`generator=` are unseeded-random too.

Rules:
  wall-clock       time.time(), datetime.now()/utcnow() with no tz arg
  unseeded-random  random.<fn>() module globals, random.Random() /
                   numpy default_rng()/RandomState()/seed-free legacy
                   globals with no seed argument, torch draws from the
                   global generator
"""
from __future__ import annotations

import ast
from typing import List, Optional

from raftsql_tpu_torch.analysis.core import Checker, Finding, SourceUnit, register

# Module-global `random.<fn>` calls that draw from the process RNG.
_RANDOM_GLOBALS = {
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "random_sample", "getrandbits",
    "betavariate", "expovariate", "normalvariate", "triangular",
}
# numpy legacy global-state draws (np.random.<fn>).
_NP_GLOBALS = {
    "rand", "randn", "randint", "random", "random_sample", "choice",
    "shuffle", "permutation", "uniform", "normal", "standard_normal",
}
# torch draws that take the process-global generator unless given one.
_TORCH_GLOBALS = {"rand", "randn", "randint", "randperm", "normal",
                  "bernoulli"}


def _dotted(node: ast.AST) -> Optional[str]:
    """`a.b.c` -> "a.b.c", else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def in_scope(relpath: str, prefixes) -> bool:
    return any(relpath == p or relpath.startswith(p) for p in prefixes)


@register
class DeterminismChecker(Checker):
    name = "wall-clock"
    doc = ("time.time()/argless datetime.now() in digest-relevant "
           "modules (use time.monotonic or a schedule-derived clock)")

    def check(self, unit: SourceUnit, config) -> List[Finding]:
        if not in_scope(unit.relpath,
                        getattr(config, "DETERMINISM_PATHS", [])):
            return []
        out: List[Finding] = []
        for node in ast.walk(unit.tree):
            if not isinstance(node, ast.Call):
                continue
            dn = _dotted(node.func)
            if dn is None:
                continue
            if dn == "time.time":
                out.append(Finding(
                    unit.relpath, node.lineno, self.name,
                    "time.time() in digest-relevant code — use "
                    "time.monotonic() or the schedule clock"))
            elif dn in ("datetime.now", "datetime.datetime.now",
                        "datetime.utcnow", "datetime.datetime.utcnow") \
                    and not node.args and not node.keywords:
                out.append(Finding(
                    unit.relpath, node.lineno, self.name,
                    f"argless {dn}() in digest-relevant code"))
        return out


@register
class UnseededRandomChecker(Checker):
    name = "unseeded-random"
    doc = ("process-global / unseeded RNG in digest-relevant modules "
           "(derive every stream from the schedule seed)")

    def check(self, unit: SourceUnit, config) -> List[Finding]:
        if not in_scope(unit.relpath,
                        getattr(config, "DETERMINISM_PATHS", [])):
            return []
        out: List[Finding] = []
        for node in ast.walk(unit.tree):
            if not isinstance(node, ast.Call):
                continue
            dn = _dotted(node.func)
            if dn is None:
                continue
            seeded = bool(node.args) or bool(node.keywords)
            if dn.startswith("random.") \
                    and dn.split(".", 1)[1] in _RANDOM_GLOBALS:
                out.append(Finding(
                    unit.relpath, node.lineno, self.name,
                    f"{dn}() draws from the process-global RNG"))
            elif dn == "random.Random" and not seeded:
                out.append(Finding(
                    unit.relpath, node.lineno, self.name,
                    "random.Random() without a seed"))
            elif dn in ("np.random.default_rng",
                        "numpy.random.default_rng") and not seeded:
                out.append(Finding(
                    unit.relpath, node.lineno, self.name,
                    f"{dn}() without a seed"))
            elif dn in ("np.random.RandomState",
                        "numpy.random.RandomState") and not seeded:
                out.append(Finding(
                    unit.relpath, node.lineno, self.name,
                    f"{dn}() without a seed"))
            elif (dn.startswith("np.random.")
                  or dn.startswith("numpy.random.")) \
                    and dn.rsplit(".", 1)[1] in _NP_GLOBALS:
                out.append(Finding(
                    unit.relpath, node.lineno, self.name,
                    f"{dn}() draws from numpy's global state"))
            elif dn.startswith("torch.") \
                    and dn.split(".", 1)[1] in _TORCH_GLOBALS \
                    and not any(k.arg == "generator"
                                for k in node.keywords):
                out.append(Finding(
                    unit.relpath, node.lineno, self.name,
                    f"{dn}() without generator= draws from torch's "
                    f"global generator"))
        return out
