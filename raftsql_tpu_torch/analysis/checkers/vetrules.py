"""The five classic rules (the JAX package's scripts/vet.py), in the framework.

Same defect classes the original `go vet` stand-in caught — unused
imports (symbol drift after refactors), duplicate defs in one scope
(silent shadowing), mutable default arguments, `assert (cond, msg)`
tuples (always true), bare `except:` — now individually suppressible
with `# raftlint: disable=<rule>`.
"""
from __future__ import annotations

import ast
from typing import List

from raftsql_tpu_torch.analysis.core import Checker, Finding, SourceUnit, register


@register
class UnusedImportChecker(Checker):
    name = "unused-import"
    doc = "imported name never referenced (symbol drift after refactors)"

    def check(self, unit: SourceUnit, config) -> List[Finding]:
        if unit.relpath.endswith("__init__.py"):
            return []                    # __init__ imports re-export
        imported = {}                    # name -> (lineno, qualified)
        for node in ast.walk(unit.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    name = a.asname or a.name.split(".")[0]
                    imported[name] = (node.lineno, a.name)
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                for a in node.names:
                    if a.name == "*":
                        continue
                    name = a.asname or a.name
                    imported[name] = (node.lineno, a.name)
        used = set()
        for node in ast.walk(unit.tree):
            if isinstance(node, ast.Name):
                used.add(node.id)
            elif isinstance(node, ast.Constant) \
                    and isinstance(node.value, str) \
                    and node.value in imported:
                used.add(node.value)     # __all__ / re-export strings
        return [Finding(unit.relpath, lineno, self.name,
                        f"unused import: {qual}")
                for name, (lineno, qual) in sorted(imported.items())
                if name not in used]


@register
class DuplicateDefChecker(Checker):
    name = "duplicate-def"
    doc = "duplicate def in one scope silently shadows the first"

    def check(self, unit: SourceUnit, config) -> List[Finding]:
        out: List[Finding] = []

        def scan(body):
            seen = {}
            for st in body:
                if isinstance(st, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                    decorated = any(
                        (isinstance(d, ast.Name)
                         and d.id in ("property", "overload", "setter"))
                        or isinstance(d, ast.Attribute)
                        for d in st.decorator_list)
                    if st.name in seen and not decorated:
                        out.append(Finding(
                            unit.relpath, st.lineno, self.name,
                            f"duplicate def {st.name} (first at line "
                            f"{seen[st.name]})"))
                    seen.setdefault(st.name, st.lineno)

        for node in ast.walk(unit.tree):
            if isinstance(node, (ast.Module, ast.ClassDef)):
                scan(node.body)
        return out


@register
class MutableDefaultChecker(Checker):
    name = "mutable-default"
    doc = "mutable default argument shared across calls"

    def check(self, unit: SourceUnit, config) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(unit.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for d in node.args.defaults + node.args.kw_defaults:
                    if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                        out.append(Finding(
                            unit.relpath, node.lineno, self.name,
                            f"mutable default arg in {node.name}"))
        return out


@register
class AssertTupleChecker(Checker):
    name = "assert-tuple"
    doc = "assert on a non-empty tuple is always true"

    def check(self, unit: SourceUnit, config) -> List[Finding]:
        return [Finding(unit.relpath, node.lineno, self.name,
                        "assert on a tuple is always true")
                for node in ast.walk(unit.tree)
                if isinstance(node, ast.Assert)
                and isinstance(node.test, ast.Tuple) and node.test.elts]


@register
class BareExceptChecker(Checker):
    name = "bare-except"
    doc = "bare except: catches SystemExit/KeyboardInterrupt too"

    def check(self, unit: SourceUnit, config) -> List[Finding]:
        return [Finding(unit.relpath, node.lineno, self.name,
                        "bare except:")
                for node in ast.walk(unit.tree)
                if isinstance(node, ast.ExceptHandler)
                and node.type is None]
