"""Concurrency lint: class attributes written from two threads, caught.

The port's serving stack runs these threads beside the Router's caller
(serving/backend.py): ``ThreadBackend``'s step executor (one
``engine.step`` per active container per ``poll()``), its ``drain()``
workers (one ``engine.run()`` per container), and ``ProcessBackend``'s
weight sender (one per spawned child, which blocks until the child
reads its weights). The safety argument is structural — ``poll`` joins
every step before touching shared state and rebuilds a failed engine
(the supervised rebuild) on the caller's thread after that join,
``drain`` joins its workers, a sender only writes to its pipe — and
nothing enforces it: moving a ``self._alive[cid] = False`` into a worker
would be a silent data race that no test reliably catches.

A copy of ``repro.analysis.concurrency`` over the port's modules. It
rebuilds that argument from the AST, per class:

* **thread roots** — targets of ``threading.Thread(target=...)`` and
  ``<executor>.submit(...)`` that name ``self.<method>`` or a function
  nested in the spawning method. Each non-joined root is its own
  execution context; roots whose spawning method also calls ``.join()``
  / ``.result()`` are *fork-join scoped* but still concurrent with
  their sibling workers.
* **context propagation** — ``self.X()`` edges carry a root's context
  into helper methods; methods never reached from a root run in the
  single ``main`` context (the backend contract: one router thread
  drives the public API).
* **write sites** — ``self.attr = ...``, ``self.attr += ...`` and
  ``self.attr[i] = ...`` (method calls like ``deque.append`` are
  GIL-atomic and deliberately out of scope), with the enclosing
  ``with self.<...lock...>:`` blocks recorded as the site's lock set.

Findings:

* ``CON001`` — an attribute written from ≥2 distinct contexts with no
  common lock.
* ``CON002`` — a read-modify-write (``+=`` or ``self.a[i] += ...``)
  inside a root spawned in a loop/comprehension (parallel siblings
  race each other even though ``main`` is parked at the join) without
  a lock.

Suppress a deliberate site with ``# analysis: allow(concurrency)``.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib

from repro_torch.analysis.report import Finding, line_suppressed

_PORT = pathlib.Path(__file__).resolve().parents[1]

DEFAULT_TARGETS = ("serving/backend.py", "serving/router.py",
                   "serving/engine.py", "serving/process_pool.py",
                   "workload/replay.py")

MAIN = "main"


def _self_attr(node: ast.AST) -> str | None:
    """``self.X`` -> ``"X"``; anything else -> None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _write_target_attr(target: ast.AST) -> str | None:
    """The self-attribute a write target mutates: ``self.a``,
    ``self.a[i]`` and ``self.a.b`` all mutate object state reachable
    through ``self.a``."""
    node = target
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        attr = _self_attr(node)
        if attr is not None:
            return attr
        node = node.value
    return None


@dataclasses.dataclass
class _Write:
    attr: str
    lineno: int
    locks: frozenset[str]
    aug: bool                      # read-modify-write


@dataclasses.dataclass
class _Root:
    func: str                      # method or nested-function name
    spawner: str                   # method that spawned it
    lineno: int
    joined: bool                   # spawner also joins/results
    fanout: bool                   # spawned inside a loop/comprehension


class _MethodScan(ast.NodeVisitor):
    """One method body: write sites (with lock sets), self-call edges,
    thread-root spawns, and nested function definitions."""

    def __init__(self, lines: list[str]):
        self.lines = lines
        self.writes: list[_Write] = []
        self.calls: set[str] = set()
        self.spawn_targets: list[tuple[str, int, bool]] = []  # fanout flag
        self.nested: dict[str, ast.FunctionDef] = {}
        self.joins = False
        self._locks: list[str] = []
        self._loop_depth = 0

    # -- lock tracking --------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        held = [a for item in node.items
                if (a := _self_attr(item.context_expr)) is not None
                and "lock" in a.lower()]
        self._locks.extend(held)
        self.generic_visit(node)
        for _ in held:
            self._locks.pop()

    # -- write sites ----------------------------------------------------
    def _record(self, target: ast.AST, lineno: int, aug: bool) -> None:
        attr = _write_target_attr(target)
        if attr is None:
            return
        if line_suppressed(self.lines, lineno, "concurrency"):
            return
        self.writes.append(_Write(attr, lineno,
                                  frozenset(self._locks), aug))

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._record(t, node.lineno, aug=False)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record(node.target, node.lineno, aug=True)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record(node.target, node.lineno, aug=False)
        self.generic_visit(node)

    # -- calls, spawns, joins -------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr in ("join", "result"):
                self.joins = True
            target = None
            if f.attr == "Thread":                      # threading.Thread
                for kw in node.keywords:
                    if kw.arg == "target":
                        target = kw.value
            elif f.attr == "submit" and node.args:      # executor.submit
                # backend.submit(cid, req) takes an int first — executor
                # submits take a callable; only attribute/name callables
                # that are not plain data args are roots
                cand = node.args[0]
                if isinstance(cand, (ast.Attribute, ast.Name,
                                     ast.Lambda)):
                    target = cand
            if target is not None:
                name = None
                if (a := _self_attr(target)) is not None:
                    name = a
                elif isinstance(target, ast.Name):
                    name = target.id
                if name is not None:
                    self.spawn_targets.append(
                        (name, node.lineno, self._loop_depth > 0))
            if isinstance(f.value, ast.Name) and f.value.id == "self":
                self.calls.add(f.attr)
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    def visit_While(self, node: ast.While) -> None:
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    def visit_ListComp(self, node: ast.ListComp) -> None:
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_SetComp = visit_ListComp
    visit_GeneratorExp = visit_ListComp

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # nested def: scanned separately as a potential thread root
        self.nested[node.name] = node
        # do NOT recurse — its body is not part of this method's context


def _scan_body(fn: ast.FunctionDef, lines: list[str]) -> _MethodScan:
    scan = _MethodScan(lines)
    for stmt in fn.body:
        scan.visit(stmt)
    return scan


class _ClassAudit:
    def __init__(self, cls: ast.ClassDef, path: pathlib.Path,
                 lines: list[str]):
        self.name = cls.name
        self.path = path
        self.methods = {n.name: n for n in cls.body
                        if isinstance(n, ast.FunctionDef)}
        self.scans = {name: _scan_body(fn, lines)
                      for name, fn in self.methods.items()}
        # nested thread-root functions get their own scans
        self.roots: list[_Root] = []
        for meth, scan in list(self.scans.items()):
            for target, lineno, fanout in scan.spawn_targets:
                fn = scan.nested.get(target) or self.methods.get(target)
                if fn is None:
                    continue            # cross-object (eng.step): the
                                        # fork-join in poll() is the
                                        # engine's safety story
                if target in scan.nested and target not in self.scans:
                    self.scans[target] = _scan_body(fn, lines)
                self.roots.append(_Root(target, meth, lineno,
                                        scan.joins, fanout))

    def contexts(self) -> dict[str, set[str]]:
        """method/function name -> set of execution contexts. A root's
        context flows through ``self.X()`` edges; everything else is
        ``main``. ``__init__`` is construction-time and excluded."""
        ctx: dict[str, set[str]] = {
            name: set() for name in self.scans if name != "__init__"}
        for root in self.roots:
            label = f"thread:{root.func}"
            work = [root.func]
            while work:
                m = work.pop()
                if m not in ctx or label in ctx[m]:
                    continue
                ctx[m].add(label)
                work.extend(self.scans[m].calls)
        for name, c in ctx.items():
            is_pure_root = any(r.func == name for r in self.roots)
            if not c or not is_pure_root:
                c.add(MAIN)
        return ctx

    def audit(self) -> list[Finding]:
        findings: list[Finding] = []
        ctx = self.contexts()
        # attr -> list of (context, write)
        sites: dict[str, list[tuple[str, _Write, str]]] = {}
        for meth, contexts in ctx.items():
            for w in self.scans[meth].writes:
                for c in contexts:
                    sites.setdefault(w.attr, []).append((c, w, meth))
        for attr, entries in sites.items():
            by_ctx = {c for c, _, _ in entries}
            if len(by_ctx) > 1:
                common = frozenset.intersection(
                    *[w.locks for _, w, _ in entries])
                if not common:
                    locs = sorted({w.lineno for _, w, _ in entries})
                    findings.append(Finding(
                        "concurrency", "CON001",
                        f"{self.path.name}:{locs[0]}",
                        f"{self.name}.{attr} is written from contexts "
                        f"{sorted(by_ctx)} (lines {locs}) with no "
                        "common lock — serialise the writes or move "
                        "them into one context"))
        # sibling races inside fan-out roots
        for root in self.roots:
            if not root.fanout:
                continue
            label = f"thread:{root.func}"
            for meth, contexts in ctx.items():
                if label not in contexts:
                    continue
                for w in self.scans[meth].writes:
                    if w.aug and not w.locks:
                        findings.append(Finding(
                            "concurrency", "CON002",
                            f"{self.path.name}:{w.lineno}",
                            f"{self.name}.{w.attr} read-modify-write "
                            f"inside fan-out thread root "
                            f"{root.func}() — parallel workers race "
                            "each other; guard with a lock"))
        return findings


def run(paths: tuple[pathlib.Path, ...] | None = None) -> list[Finding]:
    if paths is None:
        paths = tuple(_PORT / n for n in DEFAULT_TARGETS)
    findings: list[Finding] = []
    for path in paths:
        src = path.read_text()
        tree = ast.parse(src)
        lines = src.splitlines()
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                findings += _ClassAudit(node, path, lines).audit()
    return findings
