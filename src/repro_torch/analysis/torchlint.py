"""repro-lint for the port: a dependency-free, CUDA-graph-aware AST lint.

The counterpart of the reference's ``repro.analysis.jaxlint``, with its
codes, API and suppression syntax.  Where the reference guards the bodies
that ``jax.jit`` traces, this lint guards the bodies that a CUDA graph
captures: code that runs once at capture time and then never again, so a
host value it reads is baked in and a host effect it has happens once.

=======  ===========================================================
code     meaning
=======  ===========================================================
RL101    host-module call (``np.``/``numpy.``/``time.``/``random.``/
         ``os.``/``io.``/``print``) inside a graph body: it runs at
         capture only, and a value it returns is baked into the graph.
RL102    host sync inside a graph body: ``.item()``, ``.tolist()``,
         ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize()``, or
         ``float()``/``int()``/``bool()`` of a tensor argument.  A
         capture cannot read the card, and what it read would be baked
         in.
RL103    python ``if``/``while``/conditional expression on a tensor
         argument inside a graph body: the branch is taken once, at
         capture; use ``torch.where``.  ``.shape``/``.dtype``/
         ``.device``-style attributes and ``.dim()``/``.numel()`` are
         exempt.
RL104    rebinding an attribute that a captured graph reads
         (``self._ring = ...``) in a method that does not drop the
         graph: the graph keeps the old tensor's address (or the old
         host value), so the rebinding silently never reaches a replay.
         ``__init__`` and methods that drop a graph (set its holder to
         ``None``, or ``clear``/``pop``/``del`` it) are the allocation
         and growth sites where a rebinding is right.  A graph may read
         and hold through a record the instance keeps (the engine's slot
         shards: ``shard._ring`` in a capture block, ``shard._graph =
         graph``): such attributes are read and held by name, as
         ``self.X`` is.
RL105    a donated argument read after the donating call bound its
         result, before being rebound: the port donates by updating in
         place, so the name now holds the call's new value, not the one
         passed in.  A donating call whose result is not bound (an
         in-place update) leaves its arguments live: they are its
         output.  Host reads (``.cpu()``/``.numpy()``/``.tolist()``/
         ``.item()``) of such a name are reported as such.
RL106    float64 in device code (``torch.float64``, ``torch.double``,
         ``.double()``, ``dtype="float64"``): the port is strictly
         f32/int on the card; host ``np.float64`` bookkeeping is exempt.
RL201    unused import (``__init__.py`` re-exports exempt).
RL202    unreachable code after ``return``/``raise``/``break``/
         ``continue``.
RL000    file failed to parse (syntax error).
=======  ===========================================================

The reference's RL107 (``pl.BlockSpec`` without a block shape) has no
counterpart: the port's kernels are CUDA C++ launched with the geometry
of their wrappers' ``plan``, which ``kernel_budget`` checks instead.

Suppression: put ``# repro-lint: disable=RL101,RL105 -- reason`` on (any
line of) the flagged statement.  A file-level ``# repro-lint:
disable-file=RL106 -- reason`` in the first ten lines suppresses a code
for the whole file.  Suppressed findings are counted and reported
separately; they never fail the run.

The lint is conservative in the reference's way: a function is a graph
body only when the lint can *see* it called inside a ``with
torch.cuda.graph(...)`` block, as ``name(...)`` (a function of the
module) or ``self.name(...)`` (a method of the enclosing class), one
level deep; the block's own statements are checked too.  Positional
parameters of a graph body are its tensors; keyword-only parameters are
static configuration.  A callable donates the argnums it declares as
``name.donate_argnums = (...)`` (the engine's ``_chunk`` and ``_stage``),
and a ``StaticStep(...)`` bound to a name or attribute donates argnum 0
unless built with ``donate=False``.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Iterable, Sequence

RULES: dict[str, str] = {
    "RL000": "file failed to parse",
    "RL101": "host-module call inside a CUDA graph body",
    "RL102": "host sync inside a CUDA graph body",
    "RL103": "python if/while on a tensor inside a CUDA graph body",
    "RL104": "rebinding an attribute a captured graph reads, graph kept",
    "RL105": "donated buffer reused after the donating call",
    "RL106": "float64 in device code (the port is strictly f32/int)",
    "RL201": "unused import",
    "RL202": "unreachable code",
}

#: modules whose *calls* are host-side effects at capture.
_HOST_MODULES = frozenset({"np", "numpy", "time", "os", "random", "io"})
#: tensor attributes that are static at capture.
_STATIC_ATTRS = frozenset({"shape", "dtype", "device", "ndim", "is_cuda",
                           "layout", "requires_grad"})
#: tensor methods that return static values at capture.
_STATIC_METHODS = frozenset({"dim", "numel", "size", "element_size",
                             "is_contiguous", "stride", "data_ptr"})
#: builtins that return static values even on tensors.
_STATIC_CALLS = frozenset({"len", "isinstance", "type", "getattr", "hasattr",
                           "range", "callable", "id"})
#: methods that read the card from the host.
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_GRAPH_CTX = ("torch.cuda.graph", "cuda.graph")
_GRAPH_CTOR = ("torch.cuda.CUDAGraph", "cuda.CUDAGraph", "CUDAGraph")
_STATIC_STEP = ("StaticStep", "loop.StaticStep")

_SUPPRESS_RE = re.compile(
    r"#\s*repro-lint:\s*(disable(?:-file)?)\s*=\s*([A-Za-z0-9_,\s]+?)(?:\s*--.*)?$"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    code: str
    message: str

    @property
    def key(self) -> str:
        """Line-number-free identity used for baseline matching."""
        return f"{self.path}::{self.code}::{self.message}"

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.code} {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class LintResult:
    findings: list[Finding] = dataclasses.field(default_factory=list)
    suppressed: list[Finding] = dataclasses.field(default_factory=list)
    #: ``path::Class.method`` (or ``path::function``) of every graph body
    graph_bodies: list[str] = dataclasses.field(default_factory=list)

    def merge(self, other: "LintResult") -> None:
        self.findings.extend(other.findings)
        self.suppressed.extend(other.suppressed)
        self.graph_bodies.extend(other.graph_bodies)


# ---------------------------------------------------------------------------
# suppression comments
# ---------------------------------------------------------------------------


def _parse_suppressions(src: str) -> tuple[dict[int, set[str]], set[str]]:
    """Return (line -> suppressed codes, file-level suppressed codes)."""
    per_line: dict[int, set[str]] = {}
    file_level: set[str] = set()
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            codes = {c.strip().upper() for c in m.group(2).split(",") if c.strip()}
            if m.group(1) == "disable-file":
                if tok.start[0] <= 10:
                    file_level |= codes
            else:
                per_line.setdefault(tok.start[0], set()).update(codes)
    except tokenize.TokenError:
        pass
    return per_line, file_level


# ---------------------------------------------------------------------------
# small AST helpers
# ---------------------------------------------------------------------------


def _dotted(node: ast.AST) -> str | None:
    """``self._ring`` -> "self._ring"; ``torch.cuda.graph`` -> itself."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _self_attr(node: ast.AST) -> str | None:
    """``self.X`` (or ``self.X.y...``) -> "X"; else None."""
    while isinstance(node, ast.Attribute):
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            return node.attr
        node = node.value
    return None


def _held_attr(node: ast.AST) -> str | None:
    """``self.X`` or ``obj.X`` (or ``....y``) -> "X": an attribute of the
    class's instance or of a record it keeps (a serving engine's slot
    shard holds buffers and graphs as ``shard._ring``, ``shard._graph``);
    else None."""
    while isinstance(node, ast.Attribute):
        if isinstance(node.value, ast.Name):
            return node.attr
        node = node.value
    return None


def _is_graph_ctx(item: ast.withitem) -> bool:
    e = item.context_expr
    return isinstance(e, ast.Call) and _dotted(e.func) in _GRAPH_CTX


def _walk_local(node: ast.AST) -> Iterable[ast.AST]:
    """``ast.walk`` that does not enter nested function or class defs."""
    todo = [node]
    while todo:
        n = todo.pop()
        yield n
        for c in ast.iter_child_nodes(n):
            if not isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                todo.append(c)


def _positional(fn) -> set[str]:
    a = fn.args
    names = {x.arg for x in (*a.posonlyargs, *a.args)}
    if a.vararg is not None:
        names.add(a.vararg.arg)
    names.discard("self")
    return names


def _stores(stmt: ast.AST) -> list[ast.AST]:
    if isinstance(stmt, ast.Assign):
        return list(stmt.targets)
    if isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        return [stmt.target]
    return []


def _flat_targets(targets: Sequence[ast.AST]) -> list[ast.AST]:
    out: list[ast.AST] = []
    for t in targets:
        if isinstance(t, (ast.Tuple, ast.List)):
            out.extend(_flat_targets(t.elts))
        elif isinstance(t, ast.Starred):
            out.extend(_flat_targets([t.value]))
        else:
            out.append(t)
    return out


@dataclasses.dataclass
class _Scope:
    """A class (or the module) and the graph facts the lint reads in it."""

    name: str | None  # class name; None for the module
    methods: dict[str, ast.FunctionDef]
    bodies: dict[int, ast.FunctionDef] = dataclasses.field(default_factory=dict)
    blocks: list[tuple[ast.With, ast.FunctionDef]] = dataclasses.field(
        default_factory=list)


# ---------------------------------------------------------------------------
# the linter
# ---------------------------------------------------------------------------


class _Linter:
    def __init__(self, tree: ast.Module, src: str, path: str):
        self.tree = tree
        self.path = path
        self.result = LintResult()
        self.per_line, self.file_level = _parse_suppressions(src)
        self.functions: dict[str, list[ast.FunctionDef]] = {}
        self.donating: dict[str, tuple[int, ...]] = {}

    # -- emission ----------------------------------------------------------

    def emit(self, node: ast.AST, code: str, message: str) -> None:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        end = getattr(node, "end_lineno", None) or line
        f = Finding(self.path, line, col, code, message)
        if code in self.file_level:
            self.result.suppressed.append(f)
            return
        for ln in range(line, end + 1):
            if code in self.per_line.get(ln, ()):  # any line of the node
                self.result.suppressed.append(f)
                return
        self.result.findings.append(f)

    # -- pass 1: scopes, graph bodies, donating callables ------------------

    def _scopes(self) -> list[_Scope]:
        scopes = []
        module_fns: dict[str, ast.FunctionDef] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions.setdefault(node.name, []).append(node)
                module_fns.setdefault(node.name, node)
            if isinstance(node, ast.ClassDef):
                methods = {
                    n.name: n for n in node.body
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                }
                scopes.append(_Scope(node.name, methods))
        scopes.append(_Scope(None, module_fns))
        return scopes

    def _owner(self, fn: ast.FunctionDef, scopes: list[_Scope]) -> _Scope:
        for sc in scopes:
            if sc.name is not None and sc.methods.get(fn.name) is fn:
                return sc
        return scopes[-1]

    def collect(self, scopes: list[_Scope]) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                sc = self._owner(node, scopes)
                for w in _walk_local(node):
                    if isinstance(w, ast.With) and any(
                            _is_graph_ctx(i) for i in w.items):
                        sc.blocks.append((w, node))
                        self._collect_bodies(w, sc)
            elif isinstance(node, ast.Assign):
                self._collect_donating(node)
        for sc in scopes:
            for fn in sc.bodies.values():
                name = fn.name if sc.name is None else f"{sc.name}.{fn.name}"
                self.result.graph_bodies.append(f"{self.path}::{name}")

    def _collect_bodies(self, block: ast.With, sc: _Scope) -> None:
        for stmt in block.body:
            for n in ast.walk(stmt):
                if not isinstance(n, ast.Call):
                    continue
                f = n.func
                if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                        and f.value.id == "self" and f.attr in sc.methods):
                    fn = sc.methods[f.attr]
                    sc.bodies[id(fn)] = fn
                elif isinstance(f, ast.Name):
                    for fn in self.functions.get(f.id, ()):
                        sc.bodies[id(fn)] = fn

    def _collect_donating(self, node: ast.Assign) -> None:
        # name.donate_argnums = (1, 3): the method or function donates
        for tgt in node.targets:
            if (isinstance(tgt, ast.Attribute) and tgt.attr == "donate_argnums"
                    and isinstance(tgt.value, ast.Name)
                    and isinstance(node.value, (ast.Tuple, ast.List))):
                nums = tuple(e.value for e in node.value.elts
                             if isinstance(e, ast.Constant)
                             and isinstance(e.value, int))
                self.donating[tgt.value.id] = nums
                self.donating[f"self.{tgt.value.id}"] = nums
        # x = StaticStep(..., donate=...): donates its state unless False
        v = node.value
        if isinstance(v, ast.Call) and _dotted(v.func) in _STATIC_STEP:
            off = any(kw.arg == "donate" and isinstance(kw.value, ast.Constant)
                      and kw.value.value is False for kw in v.keywords)
            if not off:
                for tgt in node.targets:
                    nm = _dotted(tgt)
                    if nm:
                        self.donating[nm] = (0,)

    # -- pass 2: rules -----------------------------------------------------

    def run(self) -> LintResult:
        scopes = self._scopes()
        self.collect(scopes)
        for sc in scopes:
            for fn in sc.bodies.values():
                self._check_graph_code(fn.body, _positional(fn), fn.name)
            for block, fn in sc.blocks:
                self._check_graph_code(block.body, _positional(fn),
                                       f"{fn.name} (capture block)")
            if sc.name is not None:
                self._check_rebinding(sc)
        self._check_f64()
        self._check_donation_flow()
        self._check_unused_imports()
        self._check_unreachable()
        return self.result

    # RL101/RL102/RL103 ----------------------------------------------------

    def _refs_tensor(self, node: ast.AST, tensors: set[str]) -> bool:
        """Does ``node`` read a tensor argument, past static attributes?"""
        if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
            return False
        if isinstance(node, ast.Call):
            f = node.func
            if _dotted(f) in _STATIC_CALLS:
                return False
            if isinstance(f, ast.Attribute) and f.attr in _STATIC_METHODS:
                return False
        if isinstance(node, ast.Name):
            return node.id in tensors
        return any(self._refs_tensor(c, tensors)
                   for c in ast.iter_child_nodes(node))

    def _tensor_locals(self, stmts, tensors: set[str]) -> set[str]:
        """``tensors`` and the local names bound from them (``train = x if
        ... else rate_code(x, u)``), in source order, loops twice."""
        out = set(tensors)
        binds = sorted(
            (n for stmt in stmts for n in _walk_local(stmt)
             if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                               ast.For))),
            key=lambda n: (n.lineno, n.col_offset))
        for _ in range(2):
            for n in binds:
                value = n.iter if isinstance(n, ast.For) else n.value
                if value is None or not self._refs_tensor(value, out):
                    continue
                targets = [n.target] if isinstance(n, ast.For) else _stores(n)
                out.update(t.id for t in _flat_targets(targets)
                           if isinstance(t, ast.Name))
        return out

    def _check_graph_code(self, stmts, tensors: set[str], where: str) -> None:
        tensors = self._tensor_locals(stmts, tensors)
        for stmt in stmts:
            for node in _walk_local(stmt):
                if isinstance(node, ast.Call):
                    self._check_host_call(node, where)
                    self._check_sync(node, tensors, where)
                elif isinstance(node, (ast.If, ast.While, ast.IfExp)):
                    if self._refs_tensor(node.test, tensors):
                        kw = {ast.While: "while", ast.IfExp: "if-expression"}
                        self.emit(
                            node, "RL103",
                            f"python `{kw.get(type(node), 'if')}` on a tensor "
                            f"inside graph body `{where}` — taken once, at "
                            "capture; use torch.where",
                        )

    def _check_host_call(self, call: ast.Call, where: str) -> None:
        d = _dotted(call.func)
        if d is None:
            return
        if d.split(".", 1)[0] in _HOST_MODULES:
            self.emit(
                call, "RL101",
                f"host call `{d}(...)` inside graph body `{where}` — runs at "
                "capture only (use torch ops on the card, or hoist it out)",
            )
        elif d == "print":
            self.emit(call, "RL101",
                      f"`print(...)` inside graph body `{where}` — prints at "
                      "capture only")

    def _check_sync(self, call: ast.Call, tensors: set[str], where: str) -> None:
        f = call.func
        if (isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS
                and not call.args and not call.keywords):
            self.emit(call, "RL102",
                      f".{f.attr}() inside graph body `{where}` — a host "
                      "read of the card, illegal while capturing")
            return
        d = _dotted(f)
        if d in ("torch.cuda.synchronize", "cuda.synchronize"):
            self.emit(call, "RL102",
                      f"`{d}()` inside graph body `{where}` — illegal while "
                      "capturing")
        elif d in ("float", "int", "bool") and len(call.args) == 1:
            arg = call.args[0]
            if not isinstance(arg, ast.Constant) and self._refs_tensor(
                    arg, tensors):
                self.emit(call, "RL102",
                          f"`{d}()` of a tensor inside graph body `{where}` — "
                          "a host read, baked into the graph")

    # RL104 ----------------------------------------------------------------

    def _graph_factories(self, sc: _Scope) -> set[str]:
        """Methods that build a CUDA graph, directly or through another."""
        out: set[str] = set()
        changed = True
        while changed:
            changed = False
            for name, fn in sc.methods.items():
                if name in out:
                    continue
                for n in _walk_local(fn):
                    if isinstance(n, ast.Call) and (
                            _dotted(n.func) in _GRAPH_CTOR
                            or (_self_attr(n.func) in out
                                and isinstance(n.func, ast.Attribute))):
                        out.add(name)
                        changed = True
                        break
        return out

    def _holders(self, sc: _Scope, factories: set[str]) -> set[str]:
        """Attributes that hold a captured graph (``self._graph``, a dict
        of graphs)."""
        holders: set[str] = set()

        def makes_graph(expr, local):
            for n in ast.walk(expr):
                if isinstance(n, ast.Name) and n.id in local:
                    return True
                if isinstance(n, ast.Call) and (
                        _dotted(n.func) in _GRAPH_CTOR
                        or (isinstance(n.func, ast.Attribute)
                            and _self_attr(n.func) in factories)):
                    return True
            return False

        for fn in sc.methods.values():
            local: set[str] = set()
            assigns = [n for n in _walk_local(fn) if isinstance(n, ast.Assign)]
            for _ in range(2):  # locals bound in any order
                for n in assigns:
                    if makes_graph(n.value, local):
                        local.update(t.id for t in _flat_targets(n.targets)
                                     if isinstance(t, ast.Name))
            for n in _walk_local(fn):
                if isinstance(n, ast.AnnAssign) and _self_attr(n.target):
                    if any(isinstance(a, ast.Attribute) and a.attr == "CUDAGraph"
                           for a in ast.walk(n.annotation)):
                        holders.add(_self_attr(n.target))
                if not isinstance(n, ast.Assign) or not makes_graph(n.value, local):
                    continue
                for t in _flat_targets(n.targets):
                    if isinstance(t, ast.Name):
                        local.add(t.id)
                    elif isinstance(t, ast.Subscript):
                        if _held_attr(t.value):
                            holders.add(_held_attr(t.value))
                    elif _held_attr(t):
                        holders.add(_held_attr(t))
        return holders

    @staticmethod
    def _drops(fn: ast.FunctionDef, holders: set[str]) -> bool:
        for n in _walk_local(fn):
            # self._graph = None, self._graphs = {} (annotated or not)
            value = getattr(n, "value", None)
            empty = isinstance(value, ast.Dict) and not value.keys or (
                isinstance(value, ast.Constant) and value.value is None)
            if empty and any(
                    isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                    and t.attr in holders
                    for t in _flat_targets(_stores(n))):
                return True
            if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                    and n.func.attr in ("clear", "pop")
                    and _held_attr(n.func.value) in holders):
                return True
            if isinstance(n, ast.Delete) and any(
                    _held_attr(t) in holders for t in n.targets):
                return True
        return False

    def _check_rebinding(self, sc: _Scope) -> None:
        if not sc.blocks:
            return
        read: set[str] = set()
        for block, _ in sc.blocks:
            for stmt in block.body:
                for n in ast.walk(stmt):
                    # self.X, or X of a record the instance keeps (a shard)
                    if (isinstance(n, ast.Attribute)
                            and isinstance(n.value, ast.Name)):
                        read.add(n.attr)
        for fn in sc.bodies.values():
            if sc.methods.get(fn.name) is not fn:
                continue
            for n in _walk_local(fn):
                if (isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
                        and n.value.id == "self"
                        and isinstance(n.ctx, ast.Load)):
                    read.add(n.attr)
        read -= set(sc.methods)
        factories = self._graph_factories(sc)
        holders = self._holders(sc, factories)
        read -= holders
        for name, fn in sc.methods.items():
            if name == "__init__" or self._drops(fn, holders):
                continue
            for n in _walk_local(fn):
                for t in _flat_targets(_stores(n)):
                    if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                            and t.value.id == "self" and t.attr in read):
                        self.emit(
                            n, "RL104",
                            f"`self.{t.attr}` rebound in `{sc.name}.{name}`, "
                            "which a captured graph reads, without dropping "
                            "the graph — replays keep the old value",
                        )

    # RL106 ----------------------------------------------------------------

    def _check_f64(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Attribute) and node.attr in ("float64", "double"):
                if _dotted(node) in ("torch.float64", "torch.double"):
                    self.emit(node, "RL106",
                              f"{_dotted(node)} — the port is strictly f32/int "
                              "on the card")
            elif isinstance(node, ast.Call):
                f = node.func
                if (isinstance(f, ast.Attribute) and f.attr == "double"
                        and not node.args and _dotted(f) != "torch.double"):
                    self.emit(node, "RL106",
                              ".double() — the port is strictly f32/int on "
                              "the card")
            elif isinstance(node, ast.keyword) and node.arg == "dtype":
                v = node.value
                if isinstance(v, ast.Constant) and v.value == "float64":
                    self.emit(v, "RL106",
                              'dtype="float64" — the port is strictly f32/int')

    # RL105 ----------------------------------------------------------------

    _COMPOUND = (ast.For, ast.AsyncFor, ast.While, ast.If, ast.With,
                 ast.AsyncWith, ast.Try)

    def _check_donation_flow(self) -> None:
        if not self.donating:
            return
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_block(node.body, set())

    def _donating_calls(self, node: ast.AST) -> list[ast.Call]:
        return [n for n in ast.walk(node) if isinstance(n, ast.Call)
                and _dotted(n.func) in self.donating]

    def _scan_block(self, stmts: list[ast.stmt], dead: set[str]) -> set[str]:
        """Flow the donated-and-stale set through a statement list; a
        compound statement's exit set is the union of its branches'."""
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested defs get their own fresh scan
            if isinstance(stmt, self._COMPOUND):
                headers: list[ast.AST] = []
                if isinstance(stmt, (ast.For, ast.AsyncFor)):
                    headers = [stmt.iter]
                elif isinstance(stmt, (ast.While, ast.If)):
                    headers = [stmt.test]
                elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                    headers = [i.context_expr for i in stmt.items]
                for h in headers:
                    if dead:
                        self._flag_dead_uses(h, dead, set())
                exits = [set(dead)]
                for blk in self._sub_blocks(stmt):
                    exits.append(self._scan_block(list(blk), set(dead)))
                dead = set().union(*exits)
                continue
            self._apply_simple(stmt, dead)
        return dead

    @staticmethod
    def _sub_blocks(stmt: ast.stmt):
        for field in ("body", "orelse", "finalbody"):
            blk = getattr(stmt, field, None)
            if isinstance(blk, list) and blk:
                yield blk
        for h in getattr(stmt, "handlers", ()) or ():
            yield h.body

    def _apply_simple(self, stmt: ast.stmt, dead: set[str]) -> None:
        """One straight-line statement: flag stale uses, then mark the
        donated arguments of a call whose result it binds, then revive
        what it rebinds."""
        bound = isinstance(stmt, (ast.Assign, ast.AnnAssign)) and stmt.value
        calls = self._donating_calls(stmt.value) if bound else []
        donated_here = {id(a) for c in calls for a in c.args}
        if dead:
            self._flag_dead_uses(stmt, dead, donated_here)
        for call in calls:
            for pos in self.donating[_dotted(call.func)]:
                if pos < len(call.args):
                    nm = _dotted(call.args[pos])
                    if nm:
                        dead.add(nm)
        for tgt in _stores(stmt):
            for t in ast.walk(tgt):
                nm = _dotted(t)
                if nm is not None:
                    dead.discard(nm)

    def _flag_dead_uses(self, stmt: ast.AST, dead: set[str],
                        donated_here: set[int]) -> None:
        for node in ast.walk(stmt):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SYNC_METHODS):
                nm = _dotted(node.func.value)
                if nm in dead:
                    self.emit(
                        node, "RL105",
                        f"host read `{nm}.{node.func.attr}()` after `{nm}` was "
                        "donated — it holds the donating call's new value; "
                        "read it before the call, or from the call's result",
                    )
                    dead.discard(nm)
                    return
        for node in ast.walk(stmt):
            if id(node) in donated_here:
                continue
            if isinstance(node, (ast.Name, ast.Attribute)) and isinstance(
                    getattr(node, "ctx", None), ast.Load):
                nm = _dotted(node)
                if nm in dead:
                    self.emit(
                        node, "RL105",
                        f"`{nm}` reused after being donated — the call updated "
                        "it in place; rebind it from the call's result first",
                    )
                    dead.discard(nm)  # one finding per buffer per block
                    return

    # RL201 ----------------------------------------------------------------

    def _check_unused_imports(self) -> None:
        if Path(self.path).name == "__init__.py":
            return
        imported: dict[str, ast.stmt] = {}
        for node in self.tree.body:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    imported[alias.asname or alias.name.split(".")[0]] = node
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                for alias in node.names:
                    if alias.name != "*":
                        imported[alias.asname or alias.name] = node
        if not imported:
            return
        used: set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Name):
                used.add(node.id)
            elif isinstance(node, ast.Constant) and isinstance(node.value, str):
                # __all__ entries, string annotations
                if node.value.isidentifier():
                    used.add(node.value)
        for name, node in imported.items():
            if name not in used:
                self.emit(node, "RL201", f"unused import `{name}`")

    # RL202 ----------------------------------------------------------------

    def _check_unreachable(self) -> None:
        terminal = (ast.Return, ast.Raise, ast.Break, ast.Continue)
        for node in ast.walk(self.tree):
            for field in ("body", "orelse", "finalbody"):
                blk = getattr(node, field, None)
                if not isinstance(blk, list):
                    continue
                for i, stmt in enumerate(blk[:-1]):
                    if isinstance(stmt, terminal):
                        self.emit(
                            blk[i + 1], "RL202",
                            f"unreachable code after `{type(stmt).__name__.lower()}`",
                        )
                        break


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def lint_source(src: str, path: str = "<string>") -> LintResult:
    """Lint one python source string; returns findings, suppressed
    findings and the graph bodies the lint saw."""
    result = LintResult()
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        result.findings.append(
            Finding(path, e.lineno or 1, e.offset or 0, "RL000",
                    f"syntax error: {e.msg}")
        )
        return result
    return _Linter(tree, src, path).run()


def iter_py_files(paths: Sequence[Path | str]) -> Iterable[Path]:
    for p in paths:
        p = Path(p)
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p


def lint_paths(paths: Sequence[Path | str],
               rel_to: Path | str | None = None) -> LintResult:
    """Lint every ``*.py`` under ``paths``; paths in findings are relative
    to ``rel_to`` when given (so baselines are location-independent)."""
    agg = LintResult()
    root = Path(rel_to) if rel_to is not None else None
    for f in iter_py_files(paths):
        try:
            src = f.read_text()
        except OSError as e:  # an unreadable file is itself a finding
            agg.findings.append(Finding(str(f), 1, 0, "RL000", f"unreadable: {e}"))
            continue
        shown = str(f)
        if root is not None:
            try:
                shown = str(f.resolve().relative_to(root.resolve()))
            except ValueError:
                pass
        agg.merge(lint_source(src, shown))
    return agg
