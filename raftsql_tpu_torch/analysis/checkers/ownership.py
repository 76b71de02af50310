"""thread-ownership — shared attributes are written under their lock.

The serving stack runs three thread populations through one object
graph: the tick thread (ClusterHostPlane.tick), the ring drain / HTTP
worker threads, and the RaftDB apply thread.  Attributes they share
(`_props`/`_queued` proposal queues, `_xfers` transfer latches,
`_q2cb` ack routing, `_tokens` retry LRU) are guarded by a specific
lock; an unguarded write compiles fine and corrupts state only under
load.

The registry is IN the source: an attribute's `__init__` assignment
carries `# raftlint: guarded-by=<lock>`, and every later write to
`self.<attr>` anywhere in the class must be lexically inside
`with self.<lock>:`.  Methods that run strictly on one thread before
or after concurrency exists (boot, close) opt out with
`# raftlint: owner=<thread> -- why`.  config.OWNERSHIP_REQUIRED pins
the registry for the three serving-plane classes so deleting an
annotation is itself a finding.

Writes counted: `self.a = ...`, `self.a[k] = ...`, `self.a += ...`,
`del self.a[k]`, and mutator calls (`self.a.append/extend/add/pop/
update/...`).  Reads are not flagged (racy reads are the lock-free
fast-path idiom this codebase uses deliberately — e.g. `if
self._xfer_req:` before taking the lock).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from raftsql_tpu_torch.analysis.core import Checker, Finding, SourceUnit, register

_MUTATORS = {
    "append", "extend", "add", "insert", "remove", "discard", "pop",
    "popleft", "popitem", "appendleft", "clear", "update",
    "setdefault", "move_to_end", "sort", "reverse",
}


def _self_attr_base(node: ast.AST) -> Optional[str]:
    """Peel Subscript/Attribute chains down to `self.<attr>`; returns
    attr or None.  `self.a[k]` -> a; `self.a.b` -> a (writing through
    a sub-object of a guarded attr still mutates shared state)."""
    seen_deeper = False
    while True:
        if isinstance(node, ast.Subscript):
            node = node.value
            seen_deeper = True
        elif isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) \
                    and node.value.id == "self":
                return node.attr
            node = node.value
            seen_deeper = True
        else:
            return None


def _guarded_map(unit: SourceUnit, cls: ast.ClassDef) -> Dict[str, str]:
    """attr -> lock, from guarded-by annotations on __init__ (or any
    method's) `self.<attr> = ...` assignment lines."""
    out: Dict[str, str] = {}
    for node in ast.walk(cls):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        lock = None
        for ln in (node.lineno, node.lineno - 1):
            a = unit.ann_at(ln)
            if a and "guarded-by" in a.values:
                lock = a.values["guarded-by"]
        if lock is None:
            continue
        for t in targets:
            if isinstance(t, ast.Attribute) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id == "self":
                out[t.attr] = lock
    return out


class _MethodScan(ast.NodeVisitor):
    def __init__(self, unit: SourceUnit, cls_name: str, method: str,
                 guarded: Dict[str, str]):
        self.unit = unit
        self.cls_name = cls_name
        self.method = method
        self.guarded = guarded
        self.held: List[str] = []
        self.findings: List[Finding] = []

    def visit_With(self, node):
        locks = []
        for item in node.items:
            e = item.context_expr
            if isinstance(e, ast.Attribute) \
                    and isinstance(e.value, ast.Name) \
                    and e.value.id == "self":
                locks.append(e.attr)
        self.held.extend(locks)
        for st in node.body:
            self.visit(st)
        for _ in locks:
            self.held.pop()
        # items' context expressions need no scan (no writes there)

    def _flag(self, attr: str, line: int) -> None:
        lock = self.guarded[attr]
        self.findings.append(Finding(
            self.unit.relpath, line, "thread-ownership",
            f"{self.cls_name}.{self.method} writes shared attribute "
            f"`{attr}` outside `with self.{lock}` (declared "
            f"guarded-by={lock})"))

    def _check_write(self, target: ast.AST, line: int) -> None:
        attr = _self_attr_base(target)
        if attr in self.guarded \
                and self.guarded[attr] not in self.held:
            self._flag(attr, line)

    def visit_Assign(self, node):
        for t in node.targets:
            self._check_write(t, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        self._check_write(node.target, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self._check_write(node.target, node.lineno)
        self.generic_visit(node)

    def visit_Delete(self, node):
        for t in node.targets:
            self._check_write(t, node.lineno)
        self.generic_visit(node)

    def visit_Call(self, node):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _MUTATORS:
            attr = _self_attr_base(f.value)
            if attr in self.guarded \
                    and self.guarded[attr] not in self.held:
                self._flag(attr, node.lineno)
        self.generic_visit(node)


@register
class OwnershipChecker(Checker):
    name = "thread-ownership"
    doc = ("writes to guarded-by annotated attributes must hold the "
           "declared lock (cross-thread write corruption)")

    def check(self, unit: SourceUnit, config) -> List[Finding]:
        out: List[Finding] = []
        required = getattr(config, "OWNERSHIP_REQUIRED", {})
        for node in ast.walk(unit.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            guarded = _guarded_map(unit, node)
            # Registry pin: the named classes must declare (at least)
            # the attrs the config lists — erasing the source
            # annotation is a finding, not a silent scope shrink.
            for (suffix, cls), attrs in required.items():
                if node.name != cls \
                        or not unit.relpath.endswith(suffix):
                    continue
                for attr, lock in attrs.items():
                    if guarded.get(attr) != lock:
                        out.append(Finding(
                            unit.relpath, node.lineno, self.name,
                            f"{cls}.{attr} must carry `# raftlint: "
                            f"guarded-by={lock}` on its __init__ "
                            f"assignment (ownership registry)"))
            if not guarded:
                continue
            for st in node.body:
                if not isinstance(st, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                if st.name == "__init__":
                    continue             # boot: threads don't exist yet
                if unit.node_value(st, "owner") is not None:
                    continue             # declared single-thread method
                scan = _MethodScan(unit, node.name, st.name, guarded)
                for inner in st.body:
                    scan.visit(inner)
                out.extend(scan.findings)
        return out
