"""raftlint framework: source model, annotations, suppression, registry.

The port's copy of raftsql_tpu/analysis/core.py (stdlib `ast` only);
its one change: a target path holding `*` is a glob pattern.

Everything here is checker-agnostic.  A checker is a class with

    name        unique rule id (kebab-case; what suppressions name)
    doc         one-line invariant statement (``--list`` output)
    check(unit, config)         -> [Finding] for one file
    finish(units, config)       -> [Finding] needing the whole tree
                                   (cross-file call-site analysis)

registered via ``@register``.  ``run_suite`` parses every target file
once into a SourceUnit (AST + raftlint annotations + suppression
table), fans the units through every selected checker, then filters
the findings through per-line suppressions and the project ALLOWLIST.

Annotations are structured comments the passes consume:

    # raftlint: disable=<rule>[,<rule>] [-- why]   suppress on this or
                                                   the next line
    # raftlint: skip-file                          whole file opt-out
    # raftlint: fail-closed                        mark a def for the
                                                   fail-closed pass
    # raftlint: seqlock                            mark a def as seqlock
                                                   protocol code
    # raftlint: assumes=<memory-model>             declare the hardware
                                                   ordering assumption
    # raftlint: owner=<thread>                     declare a method's
                                                   owning thread
    # raftlint: guarded-by=<lock>                  declare the lock an
                                                   attribute write needs

Text after ``--`` is a human justification and is ignored by parsing
but required by review convention for every disable/allowlist entry.
"""
from __future__ import annotations

import ast
import glob
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

_ANN_RE = re.compile(r"#\s*raftlint:\s*(.+?)\s*$")


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class Annotation:
    """Parsed directives of one ``# raftlint:`` comment."""
    line: int
    flags: set = field(default_factory=set)      # bare words
    values: dict = field(default_factory=dict)   # key=value pairs
    disabled: set = field(default_factory=set)   # disable= rule ids


def _parse_annotations(src: str) -> Dict[int, Annotation]:
    out: Dict[int, Annotation] = {}
    for i, text in enumerate(src.splitlines(), start=1):
        m = _ANN_RE.search(text)
        if not m:
            continue
        body = m.group(1).split("--", 1)[0].strip()
        ann = Annotation(line=i)
        for tok in body.replace(",", " , ").split():
            if tok == ",":
                continue
            if "=" in tok:
                k, v = tok.split("=", 1)
                if k == "disable":
                    ann.disabled.update(
                        r for r in v.split(",") if r)
                else:
                    ann.values[k] = v
            else:
                ann.flags.add(tok)
        # disable=a,b with spaces after commas arrives as extra bare
        # tokens following a disable= — treat trailing bare tokens of a
        # disable annotation as rule ids too.
        if ann.disabled and ann.flags:
            ann.disabled.update(ann.flags)
            ann.flags = set()
        out[i] = ann
    return out


class SourceUnit:
    """One parsed target file."""

    def __init__(self, path: str, relpath: str, src: str,
                 tree: ast.AST):
        self.path = path
        self.relpath = relpath
        self.src = src
        self.tree = tree
        self.lines = src.splitlines()
        self.annotations = _parse_annotations(src)

    # -- annotation helpers ---------------------------------------------

    def skip_file(self) -> bool:
        return any("skip-file" in a.flags
                   for a in self.annotations.values())

    def ann_at(self, line: int) -> Optional[Annotation]:
        return self.annotations.get(line)

    def node_annotation_lines(self, node: ast.AST) -> List[int]:
        """Lines where an annotation may attach to `node`: its own
        line, each decorator's line, and the line above the first."""
        lines = [node.lineno]
        first = node.lineno
        for d in getattr(node, "decorator_list", []):
            lines.append(d.lineno)
            first = min(first, d.lineno)
        lines.append(first - 1)
        return lines

    def node_has_flag(self, node: ast.AST, flag: str) -> bool:
        for ln in self.node_annotation_lines(node):
            a = self.annotations.get(ln)
            if a and flag in a.flags:
                return True
        return False

    def node_value(self, node: ast.AST, key: str) -> Optional[str]:
        for ln in self.node_annotation_lines(node):
            a = self.annotations.get(ln)
            if a and key in a.values:
                return a.values[key]
        return None

    def file_value(self, key: str) -> Optional[str]:
        for a in self.annotations.values():
            if key in a.values:
                return a.values[key]
        return None

    def suppressed(self, f: Finding) -> bool:
        for ln in (f.line, f.line - 1):
            a = self.annotations.get(ln)
            if a and (f.rule in a.disabled or "all" in a.disabled):
                return True
        return False


# -- checker registry ----------------------------------------------------

_CHECKERS: List[type] = []


def register(cls):
    _CHECKERS.append(cls)
    return cls


def all_checkers() -> List[type]:
    # Import for side effect: each module registers its classes.
    from raftsql_tpu_torch.analysis.checkers import (determinism,  # noqa: F401
                                               failclosed,
                                               jit_stability,
                                               ownership, vetrules)
    return list(_CHECKERS)


class Checker:
    """Base class; subclasses override check and/or finish."""

    name = "checker"
    doc = ""
    motivation = ""

    def check(self, unit: SourceUnit, config) -> List[Finding]:
        return []

    def finish(self, units: Sequence[SourceUnit],
               config) -> List[Finding]:
        return []


# -- suite driver --------------------------------------------------------

def iter_py(paths: Iterable[str]) -> Iterable[str]:
    for p in paths:
        if "*" in p:
            yield from iter_py(sorted(glob.glob(p)))
        elif os.path.isfile(p) and p.endswith(".py"):
            yield p
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs if d != "__pycache__"]
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def _relpath(path: str) -> str:
    rel = os.path.relpath(path)
    if rel.startswith(".."):
        rel = path
    return rel.replace(os.sep, "/")


def load_unit(path: str) -> SourceUnit:
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    tree = ast.parse(src, filename=path)
    return SourceUnit(path, _relpath(path), src, tree)


def unit_from_source(src: str, relpath: str = "<fixture>.py"
                     ) -> SourceUnit:
    """Build a unit from an in-memory snippet (checker fixture tests)."""
    return SourceUnit(relpath, relpath, src, ast.parse(src))


def _allowlisted(f: Finding, config) -> Optional[str]:
    for entry in getattr(config, "allowlist", ()):
        if entry.get("rule") not in (None, f.rule):
            continue
        if entry.get("path") and entry["path"] not in f.path:
            continue
        if entry.get("contains") and entry["contains"] not in f.message:
            continue
        return entry.get("why", "allowlisted")
    return None


def run_units(units: Sequence[SourceUnit], config,
              rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the (selected) checkers over pre-built units; returns the
    surviving findings, sorted by location."""
    checkers = [c() for c in all_checkers()
                if rules is None or c.name in rules]
    findings: List[Finding] = []
    by_path: Dict[str, SourceUnit] = {}
    for u in units:
        by_path[u.path] = u
        by_path[u.relpath] = u
    live_units = [u for u in units if not u.skip_file()]
    for chk in checkers:
        for u in live_units:
            findings.extend(chk.check(u, config))
        findings.extend(chk.finish(live_units, config))
    out = []
    for f in findings:
        u = by_path.get(f.path)
        if u is not None and u.suppressed(f):
            continue
        if _allowlisted(f, config) is not None:
            continue
        out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return out


def run_suite(paths: Sequence[str], config=None,
              rules: Optional[Sequence[str]] = None) -> List[Finding]:
    if config is None:
        from raftsql_tpu_torch.analysis import config as config_mod
        config = config_mod
    units = []
    findings: List[Finding] = []
    for p in iter_py(paths):
        try:
            units.append(load_unit(p))
        except SyntaxError as e:
            findings.append(Finding(_relpath(p), e.lineno or 0,
                                    "syntax", f"syntax error: {e.msg}"))
    findings.extend(run_units(units, config, rules=rules))
    return findings
