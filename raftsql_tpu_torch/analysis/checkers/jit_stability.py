"""jit-stability — step entry points must keep ONE signature after boot.

The defect class (the JAX package's batched ReadIndex): a jitted step
that is fed a Python scalar on one call and an array on the next
RETRACES — and the recompile pause lands under the leader's election
timer, deposing a healthy leader.  The port runs eager, but a CUDA graph
of the step is captured for one signature just as a jit trace is, so the
invariant carries over.  The cure is structural: decide the argument's
dtype/shape at boot and ship the same form every call (the `[G]`
force-broadcast mask, runtime/node.py's `_ti_arr` constants, the fused
runtimes' `_ti_ones`).

The port's copy of raftsql_tpu/analysis/checkers/jit_stability.py.
Rules (a) and (b) are unchanged; rule (c) also flags what stands in
PyTorch where `jax.jit` stood: `torch.cuda.CUDAGraph()`,
`torch.cuda.graph(...)`, `torch.compile(...)` and
`torch.jit.script/trace(...)` built inside a loop body.

Static heuristics over config.JIT_ENTRY_POINTS call sites:

  (a) cross-site mixing — one call site passes a Python numeric/bool
      literal where another passes a non-literal for the same
      parameter position: two trace signatures by construction;
  (b) conditional literals — an argument (or a local assigned just
      above) of the form `<literal> if c else <expr>`: the scalar/
      array switch inlined;
  (c) `jax.jit(...)` / `functools.partial(jax.jit, ...)`, a CUDA
      graph, `torch.compile` or a TorchScript callable built inside a
      loop body: a fresh cache (and a fresh compile or capture) per
      iteration.

A flagged site that is a deliberate boot-time choice gets a
`# raftlint: disable=jit-stability -- why` with its justification.
The static rule is falsifiable at runtime by the signature tripwire
(analysis/tripwire.py): one call signature per entry point across a
chaos fast-tier run, asserted by `python -m raftsql_tpu_torch.chaos.run`
and tier-1.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Tuple

from raftsql_tpu_torch.analysis.checkers.determinism import _dotted
from raftsql_tpu_torch.analysis.core import Checker, Finding, SourceUnit, register


def _is_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float, bool)) \
            and node.value is not None
    if isinstance(node, ast.UnaryOp) \
            and isinstance(node.op, (ast.USub, ast.UAdd)):
        return _is_literal(node.operand)
    return False


def _entry_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _mixed_ifexp(node: ast.AST) -> bool:
    """`1 if c else arr` / `arr if c else 1` — a literal on exactly one
    branch is the scalar/array dtype switch inlined."""
    return (isinstance(node, ast.IfExp)
            and _is_literal(node.body) != _is_literal(node.orelse))


# Callables that capture or compile a step in PyTorch (rule (c)).
_TORCH_BUILDERS = {"torch.cuda.CUDAGraph", "torch.cuda.graph",
                   "torch.compile", "torch.jit.script", "torch.jit.trace"}


def _is_builder(func: ast.AST) -> bool:
    return _entry_name(func) == "jit" or _dotted(func) in _TORCH_BUILDERS


def _is_jax_jit(node: ast.AST) -> bool:
    """`jax.jit(...)`, a torch graph/compile builder (_TORCH_BUILDERS),
    or `functools.partial(<either>, ...)`."""
    if not isinstance(node, ast.Call):
        return False
    if _is_builder(node.func):
        return True
    if _entry_name(node.func) == "partial":
        return any(_is_builder(a) for a in node.args
                   if isinstance(a, (ast.Name, ast.Attribute)))
    return False


class _SiteVisitor(ast.NodeVisitor):
    """Collects entry-point call sites + per-function IfExp-literal
    locals + jax.jit-in-loop occurrences for one file."""

    def __init__(self, unit: SourceUnit, entries, static_args,
                 collect_sites: bool):
        self.unit = unit
        self.entries = entries
        self.static_args = static_args
        self.collect_sites = collect_sites
        # (entry, argpos|kwname) -> [(relpath, line, is_literal, repr)]
        self.sites: Dict[Tuple[str, object], list] = {}
        self.findings: List[Finding] = []
        self._loop_depth = 0
        # name -> line of `name = <lit> if c else <expr>` in the
        # innermost enclosing function
        self._condlit_stack: List[Dict[str, int]] = [{}]

    # -- loops: jax.jit inside is a fresh compile per iteration --------

    def _visit_loop(self, node):
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_For = visit_While = visit_AsyncFor = _visit_loop

    def _visit_func(self, node):
        self._condlit_stack.append({})
        self.generic_visit(node)
        self._condlit_stack.pop()

    visit_FunctionDef = visit_AsyncFunctionDef = _visit_func

    def visit_Assign(self, node):
        if _mixed_ifexp(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self._condlit_stack[-1][t.id] = node.lineno
        self.generic_visit(node)

    def visit_Call(self, node):
        if self._loop_depth and _is_jax_jit(node):
            self.findings.append(Finding(
                self.unit.relpath, node.lineno, "jit-stability",
                f"{ast.unparse(node.func)} invoked inside a loop — a "
                f"fresh trace cache (and compile or capture) per "
                f"iteration; build it once at boot"))
        name = _entry_name(node.func)
        if name in self.entries:
            self._record_site(name, node)
        self.generic_visit(node)

    def _record_site(self, name: str, node: ast.Call) -> None:
        condlits = self._condlit_stack[-1]
        static = self.static_args.get(name, set())

        def classify(key, arg):
            if key in static:
                return                   # deliberate-recompile params
            if _mixed_ifexp(arg):
                self.findings.append(Finding(
                    self.unit.relpath, arg.lineno, "jit-stability",
                    f"{name}() arg {key}: conditional mixes a Python "
                    f"literal with a non-literal — two trace "
                    f"signatures; ship one dtype/shape from boot"))
                return
            if isinstance(arg, ast.Name) and arg.id in condlits:
                self.findings.append(Finding(
                    self.unit.relpath, node.lineno, "jit-stability",
                    f"{name}() arg {key}: `{arg.id}` (line "
                    f"{condlits[arg.id]}) mixes a Python literal with "
                    f"a non-literal — two trace signatures; ship one "
                    f"dtype/shape from boot"))
                return
            if self.collect_sites:
                self.sites.setdefault((name, key), []).append(
                    (self.unit.relpath, node.lineno, _is_literal(arg),
                     ast.unparse(arg) if hasattr(ast, "unparse")
                     else "<arg>"))

        for i, arg in enumerate(node.args):
            classify(i, arg)
        for kw in node.keywords:
            if kw.arg is not None:
                classify(kw.arg, kw.value)


@register
class JitStabilityChecker(Checker):
    name = "jit-stability"
    doc = ("jit entry points fed varying Python-literal/array forms "
           "after boot retrace mid-flight (recompile deposes leaders)")

    def finish(self, units: Sequence[SourceUnit],
               config) -> List[Finding]:
        entries = getattr(config, "JIT_ENTRY_POINTS", set())
        if not entries:
            return []
        static_args = getattr(config, "JIT_STATIC_ARGS", {})
        skip_mix = tuple(getattr(config, "JIT_SKIP_MIXING_PREFIXES",
                                 ()))
        findings: List[Finding] = []
        sites: Dict[Tuple[str, object], list] = {}
        for unit in units:
            v = _SiteVisitor(unit, entries, static_args,
                             collect_sites=not
                             unit.relpath.startswith(skip_mix))
            v.visit(unit.tree)
            findings.extend(v.findings)
            for k, lst in v.sites.items():
                sites.setdefault(k, []).extend(lst)
        for (entry, key), lst in sorted(sites.items(),
                                        key=lambda kv: str(kv[0])):
            lits = [s for s in lst if s[2]]
            dyns = [s for s in lst if not s[2]]
            if lits and dyns:
                other = dyns[0]
                for (relpath, line, _lit, rep) in lits:
                    findings.append(Finding(
                        relpath, line, self.name,
                        f"{entry}() arg {key}: literal `{rep}` here "
                        f"but non-literal `{other[3]}` at "
                        f"{other[0]}:{other[1]} — two trace "
                        f"signatures for one jit entry point"))
        return findings
