"""Host-sync auditor: one host-to-device and one device-to-host copy per
decode chunk, enforced.

The chunk contract (serving/engine.py): a chunk writes the slot state to
the device in ONE host-to-device copy and reads the token block and the
emitted counts back in ONE device-to-host copy (``_run_chunk``: on the
card the pinned ``copy_`` into the chunk buffers and the ``.cpu()`` of
their tail; on the CPU ``torch.from_numpy(state).to(device)`` and the
``.cpu()`` of the block). Everything else reachable from ``step()`` must
stay on the host or on the device: a stray ``.item()``, ``.cpu()`` or
``float(<tensor>)`` waits for the stream once per step and erodes the
divide-and-save win.

Static AST walk, no execution: build the ``self.*()`` call graph from
``ServingEngine.step``, follow ``self.cache_backend.*()`` edges (or a
local name bound to ``self.cache_backend``) into both cache backends
(serving/cache.py), and count sync sites per method and per control-flow
path (each ``if`` branch is its own path, a ``return`` ends one, a site
in a loop or a comprehension counts twice: it may run any number of
times):

* per chunk (reachable from ``step()`` without passing ``_admit``):
  ``_run_chunk`` — one H2D and one D2H on every path (the CPU branch and
  the card's branch each do one of each); every other method — none.
* per admission (reachable only through ``_admit``, which runs once per
  batch of admitted requests): H2D copies are free (the prompts, their
  positions, the request extras and block-table rows go to the device
  there); D2H: ``_pick`` — one (the prefill sample), every other method
  — none.
* ``_decode_token`` is exempt: the per-token baseline exists to be
  measurably worse.

Sites recognised. D2H: ``X.item()``, ``X.cpu()``, ``X.numpy()`` and
``X.tolist()`` where ``X`` is not a host value, ``X.to("cpu")``,
``torch.cuda.synchronize()`` / ``X.synchronize()``, and ``float`` /
``int`` / ``bool`` of a device tensor expression. H2D: ``X.copy_(H)``,
``H.to(device)`` and ``torch.tensor`` / ``torch.as_tensor(..,
device=D)`` where ``H`` is a host value.

How a host value is told from a tensor (in source order through each
method): numpy calls, displays and constants, ``torch.from_numpy``, a
``torch`` factory without ``device=``, a call to a port function whose
``device`` parameter defaults to ``"cpu"`` made without one (``new_key``
of the sampler), the result of ``.cpu()`` / ``.numpy()`` / ``.tolist()``
/ ``.item()``, a parameter annotated ``np.ndarray`` or a builtin (a container
of builtins: a bare ``list`` may hold tensors), the
return of a method annotated so (``_run_chunk``'s token block,
``_pick``'s tokens), a ``self`` attribute every assignment of which is
such a value, and names, items and slices of host values. So
``block[i, :c].tolist()`` (a numpy block from ``_run_chunk``) and
``new_key(..).numpy()`` (a CPU tensor) are no sites, while a ``.cpu()``
of anything not known to be on the host counts.
"""
from __future__ import annotations

import ast
import collections
import pathlib

from repro_torch.analysis.report import Finding, line_suppressed

_PORT = pathlib.Path(__file__).resolve().parents[1]
_SERVING = _PORT / "serving"
_SRC = _PORT.parent

ENTRY = "step"
ADMISSION = "_admit"

# per-chunk methods: kind -> allowed sites on any one path
CHUNK_ALLOWANCES: dict[str, dict[str, int]] = {
    "_run_chunk": {"h2d": 1, "d2h": 1},
}
# per-admission methods: D2H sites allowed on any one path (H2D is free)
ADMISSION_D2H: dict[str, int] = {"_pick": 1}
EXEMPT = ("_decode_token",)

HOST, DEVICE, UNKNOWN = "host", "device", "unknown"

_TO_HOST = ("item", "cpu", "numpy", "tolist")
_FACTORIES = ("tensor", "as_tensor", "zeros", "ones", "empty", "full",
              "arange", "zeros_like", "ones_like", "empty_like",
              "full_like", "rand", "randn", "randint")
_BUILTINS = ("len", "int", "float", "bool", "str", "min", "max", "sum",
             "range", "list", "tuple", "dict", "set", "sorted", "zip",
             "enumerate", "any", "all", "abs", "round", "divmod")
_CONTAINERS = ("list", "tuple", "dict", "set")
_HOST_ANN = ("int", "float", "bool", "str", "bytes", "None", *_CONTAINERS)


def _merge(*cls: str) -> str:
    s = set(cls)
    if len(s) == 1:
        return s.pop()
    return DEVICE if DEVICE in s else UNKNOWN


def _chain(node: ast.AST) -> list[str] | None:
    """``a.b.c`` -> ["a", "b", "c"]; None for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return parts[::-1]


def _ann_class(ann: ast.AST | None) -> str:
    if ann is None:
        return UNKNOWN
    text = ast.unparse(ann)
    if "Tensor" in text:
        return DEVICE
    if "ndarray" in text:
        return HOST
    words = {w for w in
             text.replace("[", " ").replace("]", " ").replace(",", " ")
             .replace("|", " ").split()}
    if text in _CONTAINERS:
        return UNKNOWN        # a bare list or dict may hold tensors
    return HOST if words and words <= set(_HOST_ANN) else UNKNOWN


def _is_cpu(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call) and _chain(node.func)
            == ["torch", "device"] and bool(node.args)
            and _is_cpu(node.args[0]))


def _to_target(call: ast.Call) -> ast.AST | None:
    """What ``X.to(..)`` moves or casts to: its first argument, or its
    ``device`` / ``dtype`` keyword."""
    if call.args:
        return call.args[0]
    return next((k.value for k in call.keywords
                 if k.arg in ("device", "dtype")), None)


def _is_dtype(node: ast.AST) -> bool:
    """``torch.<dtype>`` or ``X.dtype``: a cast, no transfer."""
    c = _chain(node)
    return c is not None and (c[-1] == "dtype" or (
        len(c) == 2 and c[0] == "torch"))


class _Functions:
    """Module-level functions a source file imports from the port: which
    make their tensor on the CPU unless given a device, and which return
    host values by annotation."""

    def __init__(self, tree: ast.Module):
        # imported name -> (index of the ``device`` parameter or None,
        # its default is "cpu", return class)
        self.info: dict[str, tuple[int | None, bool, str]] = {}
        for node in tree.body:
            if not (isinstance(node, ast.ImportFrom) and node.module
                    and node.module.split(".")[0] == "repro_torch"):
                continue
            path = _SRC / pathlib.Path(*node.module.split("."))
            path = path.with_suffix(".py")
            if not path.is_file():
                continue
            defs = {n.name: n for n in ast.parse(path.read_text()).body
                    if isinstance(n, ast.FunctionDef)}
            for alias in node.names:
                fn = defs.get(alias.name)
                if fn is None:
                    continue
                args = fn.args.args
                defaults = [None] * (len(args) - len(fn.args.defaults)) + \
                    list(fn.args.defaults)
                idx, cpu = None, False
                for i, (a, d) in enumerate(zip(args, defaults)):
                    if a.arg == "device":
                        idx, cpu = i, d is not None and _is_cpu(d)
                self.info[alias.asname or alias.name] = (
                    idx, cpu, _ann_class(fn.returns))

    def call_class(self, call: ast.Call) -> str | None:
        if not isinstance(call.func, ast.Name):
            return None
        got = self.info.get(call.func.id)
        if got is None:
            return None
        idx, cpu, ret = got
        if cpu and not any(k.arg == "device" for k in call.keywords) \
                and len(call.args) <= idx:
            return HOST
        return ret


class _Method:
    """One pass over a method in source order: each name's class where it
    is used, the sync sites (call node id -> (kind, line)), and the
    class of every value assigned to a ``self`` attribute."""

    def __init__(self, fn: ast.FunctionDef, owner: "_ClassIndex"):
        self.owner = owner
        self.env: dict[str, str] = {}
        for a in fn.args.args + fn.args.kwonlyargs:
            self.env[a.arg] = _ann_class(a.annotation)
        self.env.pop("self", None)
        self.backend_names: set[str] = set()
        self.sites: dict[int, tuple[str, int]] = {}
        self.attr_writes: list[tuple[str, str]] = []
        for st in fn.body:
            self.stmt(st)

    # -- classes -----------------------------------------------------------
    def cls(self, node: ast.AST) -> str:
        if isinstance(node, (ast.Constant, ast.JoinedStr, ast.List,
                             ast.Tuple, ast.Dict, ast.Set, ast.Compare,
                             ast.BoolOp)):
            return HOST
        if isinstance(node, ast.Name):
            return self.env.get(node.id, UNKNOWN)
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return self.owner.attr_cls.get(node.attr, UNKNOWN)
            if node.attr in ("shape", "dtype", "device", "ndim"):
                return HOST
            return self.cls(node.value)
        if isinstance(node, ast.Subscript):
            return self.cls(node.value)
        if isinstance(node, ast.UnaryOp):
            return self.cls(node.operand)
        if isinstance(node, ast.BinOp):
            return _merge(self.cls(node.left), self.cls(node.right))
        if isinstance(node, ast.IfExp):
            return _merge(self.cls(node.body), self.cls(node.orelse))
        if isinstance(node, ast.Call):
            return self.call_cls(node)
        return UNKNOWN

    def call_cls(self, call: ast.Call) -> str:
        f = call.func
        c = _chain(f)
        if c is not None and c[0] in ("np", "numpy"):
            return HOST
        if c is not None and c[0] == "torch":
            if c[-1] == "from_numpy":
                return HOST
            if len(c) == 2 and c[1] in _FACTORIES:
                dev = [k.value for k in call.keywords if k.arg == "device"]
                return HOST if not dev or _is_cpu(dev[0]) else DEVICE
            return DEVICE
        if c is not None and len(c) == 1 and c[0] in _BUILTINS:
            return HOST
        if c is not None and c[:2] == ["self", "model"]:
            return DEVICE
        if c is not None and len(c) == 2 and c[0] == "self":
            fn = self.owner.methods.get(c[1])
            return _ann_class(fn.returns) if fn is not None else UNKNOWN
        got = self.owner.functions.call_class(call)
        if got is not None:
            return got
        if isinstance(f, ast.Attribute):
            if f.attr in _TO_HOST:
                return HOST
            if f.attr == "to":
                arg = _to_target(call)
                if arg is not None and _is_cpu(arg):
                    return HOST
                if arg is not None and not _is_dtype(arg):
                    return DEVICE
            return self.cls(f.value)
        return UNKNOWN

    # -- sites -------------------------------------------------------------
    def site(self, call: ast.Call) -> str | None:
        f = call.func
        c = _chain(f)
        if isinstance(f, ast.Attribute):
            recv = self.cls(f.value)
            if f.attr in _TO_HOST:
                return "d2h" if recv != HOST else None
            if f.attr == "synchronize":
                return "d2h"
            if f.attr == "copy_" and call.args:
                return "h2d" if self.cls(call.args[0]) == HOST else None
            if f.attr == "to":
                arg = _to_target(call)
                if arg is None or _is_dtype(arg):
                    return None
                if _is_cpu(arg):
                    return "d2h" if recv != HOST else None
                return "h2d" if recv == HOST else None
        if c is not None and len(c) == 2 and c[0] == "torch" \
                and c[1] in ("tensor", "as_tensor"):
            dev = [k.value for k in call.keywords if k.arg == "device"]
            return "h2d" if dev and not _is_cpu(dev[0]) else None
        if isinstance(f, ast.Name) and f.id in ("float", "int", "bool") \
                and call.args and self.cls(call.args[0]) == DEVICE:
            return "d2h"
        return None

    def expr(self, node: ast.AST | None) -> None:
        """Record the sites of an expression (comprehension targets
        bound while their bodies are read; lambdas skipped)."""
        if node is None or isinstance(node, ast.Lambda):
            return
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            saved = dict(self.env)
            for gen in node.generators:
                self.expr(gen.iter)
                self.bind(gen.target, HOST if self.cls(gen.iter) == HOST
                          else UNKNOWN)
                for cond in gen.ifs:
                    self.expr(cond)
            if isinstance(node, ast.DictComp):
                self.expr(node.key)
                self.expr(node.value)
            else:
                self.expr(node.elt)
            self.env = saved
            return
        if isinstance(node, ast.Call):
            kind = self.site(node)
            if kind is not None and not line_suppressed(
                    self.owner.lines, node.lineno, "host-sync"):
                self.sites[id(node)] = (kind, node.lineno)
        for child in ast.iter_child_nodes(node):
            self.expr(child)

    # -- bindings ----------------------------------------------------------
    def bind(self, target: ast.AST, cls: str,
             value: ast.AST | None = None) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = cls
            if value is not None and _chain(value) == ["self",
                                                      "cache_backend"]:
                self.backend_names.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            vals = (value.elts if isinstance(value, (ast.Tuple, ast.List))
                    and len(value.elts) == len(target.elts) else None)
            for i, t in enumerate(target.elts):
                if vals is not None:
                    self.bind(t, self.cls(vals[i]), vals[i])
                else:
                    self.bind(t, cls)
        elif isinstance(target, ast.Attribute) and isinstance(
                target.value, ast.Name) and target.value.id == "self":
            self.attr_writes.append((target.attr, cls))

    def stmt(self, st: ast.stmt) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return
        if isinstance(st, ast.Assign):
            self.expr(st.value)
            for t in st.targets:
                self.expr(t)
                self.bind(t, self.cls(st.value), st.value)
            return
        if isinstance(st, ast.AnnAssign):
            self.expr(st.value)
            self.expr(st.target)
            if st.value is not None:
                self.bind(st.target, self.cls(st.value), st.value)
            return
        if isinstance(st, ast.AugAssign):
            self.expr(st.value)
            self.expr(st.target)
            return
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self.expr(st.iter)
            self.bind(st.target, HOST if self.cls(st.iter) == HOST
                      else UNKNOWN)
            for s in st.body + st.orelse:
                self.stmt(s)
            return
        if isinstance(st, (ast.If, ast.While)):
            self.expr(st.test)
            for s in st.body + st.orelse:
                self.stmt(s)
            return
        if isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                self.expr(item.context_expr)
            for s in st.body:
                self.stmt(s)
            return
        if isinstance(st, ast.Try):
            for s in st.body + [x for h in st.handlers for x in h.body] \
                    + st.orelse + st.finalbody:
                self.stmt(s)
            return
        for child in ast.iter_child_nodes(st):
            self.expr(child)


def _expr_sites(node: ast.AST, sites: dict, loop: int = 1) -> list:
    """The sites of an expression, a site in a comprehension twice."""
    out = []
    if node is None or isinstance(node, ast.Lambda):
        return out
    inner = loop
    if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                         ast.DictComp)):
        inner = 2
    if id(node) in sites:
        out += [sites[id(node)]] * loop
    for child in ast.iter_child_nodes(node):
        out += _expr_sites(child, sites, inner)
    return out


def _cap(seq) -> tuple:
    """A path's sites as a multiset, each site counted at most twice."""
    c = collections.Counter(seq)
    return tuple(sorted((s, min(n, 2)) for s, n in c.items()))


def _join(a: tuple, b: tuple) -> tuple:
    c = collections.Counter(dict(a))
    c.update(dict(b))
    return tuple(sorted((s, min(n, 2)) for s, n in c.items()))


def _paths(stmts: list, sites: dict) -> set:
    """Every path through ``stmts``: (sites multiset, ended) pairs."""
    alts = {((), False)}
    for st in stmts:
        nxt = set()
        for seq, ended in alts:
            if ended:
                nxt.add((seq, True))
                continue
            for s2, e2 in _stmt_paths(st, sites):
                nxt.add((_join(seq, s2), e2))
        alts = nxt
    return alts


def _stmt_paths(st: ast.stmt, sites: dict) -> set:
    if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return {((), False)}
    if isinstance(st, ast.If):
        head = _cap(_expr_sites(st.test, sites))
        return {(_join(head, s), e) for s, e in
                _paths(st.body, sites) | _paths(st.orelse, sites)}
    if isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
        head = _cap(_expr_sites(getattr(st, "iter", None)
                                or getattr(st, "test", None), sites))
        body = [s for s, _ in _paths(st.body, sites)]
        out = {(head, False)}
        for s in body:
            out.add((_join(head, _join(s, s)), False))
        return {(_join(s, o), False) for s, _ in
                _paths(st.orelse, sites) for o, _ in out}
    if isinstance(st, (ast.With, ast.AsyncWith)):
        head = ()
        for item in st.items:
            head = _join(head, _cap(_expr_sites(item.context_expr, sites)))
        return {(_join(head, s), e) for s, e in _paths(st.body, sites)}
    if isinstance(st, ast.Try):
        alts = _paths(st.body + st.orelse, sites)
        for h in st.handlers:
            alts |= _paths(h.body, sites)
        fin = _paths(st.finalbody, sites)
        return {(_join(s, f), e or fe) for s, e in alts for f, fe in fin}
    ends = isinstance(st, (ast.Return, ast.Raise))
    return {(_cap(_expr_sites(st, sites)), ends)}


class _ClassIndex:
    """Methods of one class: sync sites and the call edges out of each."""

    def __init__(self, cls: ast.ClassDef, path: pathlib.Path,
                 lines: list[str], functions: _Functions):
        self.name = cls.name
        self.path = path
        self.lines = lines
        self.functions = functions
        self.methods: dict[str, ast.FunctionDef] = {
            n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        # a self attribute's class: the merge of every value assigned to
        # it in the class (two passes, so attributes read attributes)
        self.attr_cls: dict[str, str] = {}
        for _ in range(2):
            writes: dict[str, list[str]] = collections.defaultdict(list)
            for fn in self.methods.values():
                for attr, c in _Method(fn, self).attr_writes:
                    writes[attr].append(c)
            self.attr_cls = {a: _merge(*cs) for a, cs in writes.items()}
        self.scans = {name: _Method(fn, self)
                      for name, fn in self.methods.items()}

    def calls(self, meth: str) -> tuple[set[str], set[str]]:
        """(self.X() targets, cache-backend X() targets)."""
        own: set[str] = set()
        backend: set[str] = set()
        fn = self.methods.get(meth)
        if fn is None:
            return own, backend
        aliases = self.scans[meth].backend_names
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            c = _chain(node.func.value)
            if c == ["self"]:
                own.add(node.func.attr)
            elif c == ["self", "cache_backend"] or (
                    c is not None and len(c) == 1 and c[0] in aliases):
                backend.add(node.func.attr)
        return own, backend

    def path_counts(self, meth: str) -> list[dict[str, list[int]]]:
        """Per path of ``meth``: kind -> the lines of its sites (a site in
        a loop listed twice)."""
        fn = self.methods[meth]
        out = []
        for seq, _ in _paths(fn.body, self.scans[meth].sites):
            by_kind: dict[str, list[int]] = collections.defaultdict(list)
            for (kind, line), n in seq:
                by_kind[kind] += [line] * n
            out.append(by_kind)
        return out


def _load(path: pathlib.Path) -> dict[str, _ClassIndex]:
    src = path.read_text()
    tree = ast.parse(src)
    lines = src.splitlines()
    functions = _Functions(tree)
    return {n.name: _ClassIndex(n, path, lines, functions)
            for n in tree.body if isinstance(n, ast.ClassDef)}


def _reach(engine: _ClassIndex, backends: list, roots: list[str],
           stop: set[str]) -> list[tuple[_ClassIndex, str]]:
    seen: set[tuple[int, str]] = set()
    out = []
    work = [(engine, r) for r in roots]
    while work:
        idx, meth = work.pop()
        key = (id(idx), meth)
        if key in seen or meth not in idx.methods:
            continue
        seen.add(key)
        out.append((idx, meth))
        if idx is engine and meth in stop:
            continue
        own, backend = idx.calls(meth)
        work += [(idx, m) for m in own]
        work += [(b, m) for m in backend for b in backends]
    return out


def run(engine_path: pathlib.Path | None = None,
        cache_path: pathlib.Path | None = None) -> list[Finding]:
    engine_path = engine_path or _SERVING / "engine.py"
    cache_path = cache_path or _SERVING / "cache.py"
    engine = _load(engine_path).get("ServingEngine")
    if engine is None:
        return [Finding("host-sync", "SYN000", str(engine_path),
                        "ServingEngine class not found — auditor is "
                        "looking at the wrong module")]
    backends = [c for n, c in _load(cache_path).items()
                if n in ("DenseCache", "PagedCache")]

    # per chunk: from step(), not into admission or the exempt baseline;
    # per admission: from _admit(), what the chunk does not also reach
    chunk = [(i, m) for i, m in _reach(engine, backends, [ENTRY],
                                       {ADMISSION, *EXEMPT})
             if not (i is engine and m in (ADMISSION, *EXEMPT))]
    in_chunk = {(id(i), m) for i, m in chunk}
    admission = [(i, m) for i, m in _reach(engine, backends, [ADMISSION],
                                           set(EXEMPT))
                 if (id(i), m) not in in_chunk
                 and not (i is engine and m in EXEMPT)]

    findings: list[Finding] = []
    flagged: set[tuple[str, int]] = set()

    def check(idx: _ClassIndex, meth: str, allow: dict, where: str):
        for by_kind in idx.path_counts(meth):
            for kind, lines in by_kind.items():
                limit = allow.get(kind, 0)
                if limit is None or len(lines) <= limit:
                    continue
                for line in sorted(lines)[limit:]:
                    if (str(idx.path), line) in flagged:
                        continue
                    flagged.add((str(idx.path), line))
                    what = ("device-to-host read or sync" if kind == "d2h"
                            else "host-to-device copy")
                    findings.append(Finding(
                        "host-sync", "SYN001" if kind == "d2h" else "SYN002",
                        f"{idx.path.name}:{line}",
                        f"{what} in {idx.name}.{meth}() {where} beyond its "
                        f"allowance of {limit} on one path"))

    for idx, meth in chunk:
        allow = (CHUNK_ALLOWANCES.get(meth, {}) if idx is engine else {})
        check(idx, meth, allow, "reachable from step() in every chunk")
    for idx, meth in admission:
        allow = {"h2d": None,
                 "d2h": ADMISSION_D2H.get(meth, 0) if idx is engine else 0}
        check(idx, meth, allow, "reachable from step() at each admission")
    return findings
