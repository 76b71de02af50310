"""fail-closed — annotated read paths end in an explicit return/raise.

The shm fast path's whole safety argument (runtime/shm.py) is that a
read the mapping cannot PROVE fresh falls back to the ring: every
branch of the reader ends in `return None` (ring fallback), a real
result, or a raise.  The failure mode this guards is structural decay:
someone adds an `elif` for a new mode and forgets the final fallback,
and the function falls off the end — which in Python is ALSO
`return None`, so the bug is invisible at the call site and shows up
as a silently widened contract.

`# raftlint: fail-closed` on a def makes the pass prove:

  * the body cannot fall off the end — its final statement chain
    terminates in Return/Raise (If needs both arms, Try needs its
    handlers covered or a terminating finally);
  * no bare `return` — the fallback is spelled `return None` so a
    reviewer can see the branch chose to fail closed;
  * every except handler in the function itself returns or raises —
    a swallowed exception inside a fail-closed path is a silent serve.

`# raftlint: seqlock` marks torn-read-retry protocol code; it requires
the FILE to declare its hardware ordering dependence with a
`# raftlint: assumes=<memory-model>` annotation (rule "memory-model")
— runtime/shm.py's x86-TSO store-order reliance, machine-checked
instead of buried in docstring prose.

config.FAILCLOSED_REQUIRED pins both registries: the listed functions
must carry the listed annotations, so deleting one is a finding, not a
silent scope shrink.
"""
from __future__ import annotations

import ast
from typing import List

from raftsql_tpu_torch.analysis.core import Checker, Finding, SourceUnit, register


def _terminates(stmts) -> bool:
    """True when a statement list cannot fall off its end."""
    if not stmts:
        return False
    last = stmts[-1]
    if isinstance(last, (ast.Return, ast.Raise)):
        return True
    if isinstance(last, ast.If):
        return bool(last.orelse) and _terminates(last.body) \
            and _terminates(last.orelse)
    if isinstance(last, (ast.With, ast.AsyncWith)):
        return _terminates(last.body)
    if isinstance(last, ast.Try):
        if _terminates(last.finalbody):
            return True
        tail = last.orelse if last.orelse else last.body
        return _terminates(tail) \
            and all(_terminates(h.body) for h in last.handlers)
    if isinstance(last, ast.Match):
        has_catchall = any(
            isinstance(c.pattern, ast.MatchAs) and c.pattern.pattern
            is None and c.guard is None for c in last.cases)
        return has_catchall and all(_terminates(c.body)
                                    for c in last.cases)
    # Loops may execute zero times; conservatively non-terminating.
    return False


class _BodyScan(ast.NodeVisitor):
    """Bare returns + swallowing handlers inside ONE function (nested
    defs excluded — they have their own annotation scope)."""

    def __init__(self, unit: SourceUnit, fname: str):
        self.unit = unit
        self.fname = fname
        self.findings: List[Finding] = []

    def visit_FunctionDef(self, node):    # do not descend
        pass

    visit_AsyncFunctionDef = visit_Lambda = visit_FunctionDef

    def visit_Return(self, node):
        if node.value is None:
            self.findings.append(Finding(
                self.unit.relpath, node.lineno, "fail-closed",
                f"{self.fname}: bare `return` — spell the fallback "
                f"(`return None`) so the branch visibly fails closed"))

    def visit_ExceptHandler(self, node):
        if not _terminates(node.body):
            self.findings.append(Finding(
                self.unit.relpath, node.lineno, "fail-closed",
                f"{self.fname}: except handler neither returns nor "
                f"raises — a swallowed exception here is a silent "
                f"serve"))
        self.generic_visit(node)


@register
class FailClosedChecker(Checker):
    name = "fail-closed"
    doc = ("annotated read-serving functions must terminate every "
           "path in an explicit return or raise (ring fallback)")

    def check(self, unit: SourceUnit, config) -> List[Finding]:
        out: List[Finding] = []
        funcs = {}
        for node in ast.walk(unit.tree):
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                funcs.setdefault(node.name, node)
                if not unit.node_has_flag(node, "fail-closed"):
                    continue
                if not _terminates(node.body):
                    out.append(Finding(
                        unit.relpath, node.lineno, self.name,
                        f"{node.name}: body can fall off the end — "
                        f"an implicit `return None` that no reviewer "
                        f"chose; end in explicit return/raise"))
                scan = _BodyScan(unit, node.name)
                for st in node.body:
                    scan.visit(st)
                out.extend(scan.findings)
        # Registry pin: erasing an annotation is a finding.
        for suffix, req in getattr(config, "FAILCLOSED_REQUIRED",
                                   {}).items():
            if not unit.relpath.endswith(suffix):
                continue
            for flag in ("fail-closed", "seqlock"):
                for fname in req.get(flag, ()):
                    node = funcs.get(fname)
                    if node is None:
                        out.append(Finding(
                            unit.relpath, 1, self.name,
                            f"registry names {fname} but no such def "
                            f"exists — update FAILCLOSED_REQUIRED"))
                    elif not unit.node_has_flag(node, flag):
                        out.append(Finding(
                            unit.relpath, node.lineno, self.name,
                            f"{fname} must carry `# raftlint: {flag}` "
                            f"(pinned by FAILCLOSED_REQUIRED)"))
        return out


@register
class MemoryModelChecker(Checker):
    name = "memory-model"
    doc = ("seqlock-annotated protocol code requires a file-level "
           "`assumes=<memory-model>` hardware-ordering declaration")

    def check(self, unit: SourceUnit, config) -> List[Finding]:
        out: List[Finding] = []
        assumed = unit.file_value("assumes")
        for node in ast.walk(unit.tree):
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)) \
                    and unit.node_has_flag(node, "seqlock") \
                    and assumed is None:
                out.append(Finding(
                    unit.relpath, node.lineno, self.name,
                    f"{node.name} is seqlock protocol code but the "
                    f"file declares no `# raftlint: "
                    f"assumes=<memory-model>` — barrier-free seqlocks "
                    f"are only sound under a declared store order "
                    f"(x86-tso here)"))
        return out
