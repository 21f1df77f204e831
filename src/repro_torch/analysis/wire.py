"""Wire auditor: the process-pipe payloads and the pre-affinity closure.

Two invariants keep the port's process backend honest:

1. **Import-light pre-affinity closure.** ``spawn_pinned`` promises the
   child applies its cpuset before torch initialises (torch sizes its
   intra-op thread pool from the cores the process may use) — but spawn
   pickles the child target *by reference*, and unpickling it at
   bootstrap imports its module (and every module-scope import
   underneath, package ``__init__``s included) BEFORE
   ``sched_setaffinity`` runs. Every module a spawn payload can reference
   pre-affinity — ``serving/child.py`` (the child body),
   ``core/testbed.py`` (the pinned entry point), the wire dataclasses
   (``events.py``, ``faults.py``), and ``configs/base.py`` (the model
   config crossing the pipe) — must therefore not reach a module-scope
   ``import torch`` (or ``jax``) transitively. This auditor walks that
   closure statically through the AST (following ``repro_torch.*``
   imports only; function-local imports and ``if TYPE_CHECKING:``
   blocks don't run at import time and are skipped).

2. **Picklable, primitive payloads.** Everything crossing a process
   pipe (the event/fault dataclasses, the workload's wire types, the
   ``_engine_config_wire`` dict) must pickle round-trip and must not
   smuggle tensors or module-bound callables: every dataclass in those
   modules is instantiated with dummy field values and round-tripped,
   and the wire dict of a default ``EngineConfig`` (``chunk_tokens=None``
   included) is checked to contain primitives only.

Findings: ``WIR001`` module-scope torch or jax import in the pre-affinity
closure; ``WIR002`` unpicklable wire dataclass; ``WIR003`` non-primitive
value in the engine-config wire dict.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import pickle
import typing

from repro_torch.analysis.report import Finding

_SRC = pathlib.Path(__file__).resolve().parents[2]   # .../src

# modules a spawn payload references before the cpuset exists
PRE_AFFINITY_MODULES = (
    "repro_torch.serving.child",
    "repro_torch.core.testbed",
    "repro_torch.serving.events",
    "repro_torch.serving.faults",
    "repro_torch.configs.base",
)

HEAVY = ("torch", "jax", "jaxlib")

WIRE_DATACLASS_MODULES = ("repro_torch.serving.events",
                          "repro_torch.serving.faults",
                          "repro_torch.workload.traces",
                          "repro_torch.workload.slo",
                          "repro_torch.workload.replay")


def _module_path(modname: str) -> pathlib.Path | None:
    rel = pathlib.Path(*modname.split("."))
    for cand in (_SRC / rel / "__init__.py", _SRC / rel.with_suffix(".py")):
        if cand.is_file():
            return cand
    return None


def _module_scope_imports(path: pathlib.Path) -> list[tuple[str, int]]:
    """(imported module, lineno) for every import executed AT IMPORT
    TIME — module scope plus class bodies; function bodies are deferred
    and skipped."""
    tree = ast.parse(path.read_text())
    out: list[tuple[str, int]] = []
    work: list[ast.AST] = list(tree.body)
    while work:
        node = work.pop()
        if isinstance(node, ast.Import):
            out.extend((a.name, node.lineno) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.module and node.level == 0:
                out.append((node.module, node.lineno))
                # ``from pkg import name`` imports pkg.name when name is
                # a submodule; emit the candidate and let the closure
                # walk drop it if no such module file exists
                out.extend((f"{node.module}.{a.name}", node.lineno)
                           for a in node.names)
        elif isinstance(node, ast.If) and ast.unparse(node.test) in (
                "TYPE_CHECKING", "typing.TYPE_CHECKING"):
            work.extend(node.orelse)      # the guarded body never runs
        elif isinstance(node, (ast.If, ast.Try, ast.ClassDef, ast.With)):
            # function/lambda bodies are deferred and deliberately NOT
            # descended into; these compound statements run at import
            work.extend(ast.iter_child_nodes(node))
    return out


def _closure_findings(root: str) -> list[Finding]:
    """Walk ``root``'s import-time closure (repro_torch.* edges and their
    package ``__init__``s) and flag any module-scope torch or jax
    import."""
    findings: list[Finding] = []
    seen: set[str] = set()
    work = [root]
    while work:
        mod = work.pop()
        if mod in seen:
            continue
        seen.add(mod)
        # importing a.b.c first imports packages a and a.b
        parts = mod.split(".")
        for i in range(1, len(parts)):
            work.append(".".join(parts[:i]))
        path = _module_path(mod)
        if path is None:
            continue                      # namespace package / stdlib
        for imported, lineno in _module_scope_imports(path):
            top = imported.split(".")[0]
            if top in HEAVY:
                findings.append(Finding(
                    "wire", "WIR001",
                    f"{path.relative_to(_SRC)}:{lineno}",
                    f"module-scope import of {imported!r} is reachable "
                    f"from pre-affinity module {root!r} (via {mod}) — "
                    f"the process child would initialise {top} before "
                    "its cpuset is applied; defer the import into the "
                    "function that needs it"))
            elif top == "repro_torch":
                work.append(imported)
    return findings


def _dummy_for(tp) -> object:
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        return _dummy_for(args[0]) if args else None
    if dataclasses.is_dataclass(tp):
        return _dummy_instance(tp)
    table = {int: 0, float: 0.0, str: "x", bool: False, bytes: b"",
             tuple: (), list: [], dict: {}, typing.Any: None}
    return table.get(tp, None)


def _dummy_instance(cls):
    hints = typing.get_type_hints(cls)
    kw = {f.name: (f.default if f.default is not dataclasses.MISSING
                   else _dummy_for(hints.get(f.name)))
          for f in dataclasses.fields(cls)}
    # validated enum-ish str fields (Fault.kind checks against _KINDS):
    # a constructor rejection is not a pickling failure — use a legal
    # value when the class advertises one
    kinds = getattr(cls, "_KINDS", None)
    if kinds and "kind" in kw and kw["kind"] not in kinds:
        kw["kind"] = kinds[0]
    return cls(**kw)


def _pickle_findings() -> list[Finding]:
    import importlib
    findings: list[Finding] = []
    for modname in WIRE_DATACLASS_MODULES:
        mod = importlib.import_module(modname)
        for name in dir(mod):
            cls = getattr(mod, name)
            if not (isinstance(cls, type) and dataclasses.is_dataclass(cls)
                    and cls.__module__ == modname):
                continue
            try:
                inst = _dummy_instance(cls)
                back = pickle.loads(pickle.dumps(inst))
                if back != inst:
                    raise ValueError("round-trip changed the value")
            except Exception as e:
                findings.append(Finding(
                    "wire", "WIR002", f"{modname}.{name}",
                    f"wire dataclass does not pickle round-trip: {e}"))
    return findings


_PRIMITIVE = (int, float, str, bool, bytes, type(None))


def _wire_dict_findings() -> list[Finding]:
    from repro_torch.serving.backend import _engine_config_wire
    from repro_torch.serving.engine import EngineConfig
    findings: list[Finding] = []
    for key, val in _engine_config_wire(EngineConfig()).items():
        ok = isinstance(val, _PRIMITIVE) or (
            isinstance(val, tuple)
            and all(isinstance(v, _PRIMITIVE) for v in val))
        if not ok:
            findings.append(Finding(
                "wire", "WIR003", f"_engine_config_wire()[{key!r}]",
                f"engine-config wire value is {type(val).__name__}, not "
                "a picklable primitive — the child would unpickle a "
                "module-bound object (hence import it) pre-affinity"))
    return findings


def run(roots: tuple[str, ...] = PRE_AFFINITY_MODULES) -> list[Finding]:
    findings: list[Finding] = []
    for root in roots:
        findings += _closure_findings(root)
    findings += _pickle_findings()
    findings += _wire_dict_findings()
    return findings
