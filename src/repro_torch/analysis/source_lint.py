"""Source lint: AST rules over the port's engine, core and kernel
packages, and a lexical rule over its CUDA sources.

The dispatch and launch-contract lints prove properties of the runs a
plan makes; this layer catches the bug *patterns* in the source itself,
including code paths no CI plan exercises.  It builds a light call graph
per run:

1. parse every module under the scan roots, recording import aliases,
   function definitions (methods and nested defs included), per function
   the local bindings of callables (``fn = helper``, ``tick =
   partial(_tick, ...)``), and per class the callables its methods bind to
   ``self`` attributes (``self._launch = launch if f is None else f``);
2. start from the *loop roots*, the functions that run once a tick or once
   a chunk (`LOOP_ROOTS`: there is no ``lax.scan`` to find them by, so they
   are declared);
3. BFS the call graph from the roots: everything reached is
   *loop-reachable*.

Rules:

* ``src/host-sync-in-loop`` (loop-reachable code): ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``float()/int()/bool()`` of a
  tensor, and ``if``/``while``/conditional expressions on one.  Values
  count as tensors when they derive from the function's tensor
  parameters (annotated ``Tensor``, or a field annotated ``Tensor`` of a
  parameter whose annotated class declares it) or from ``torch.*`` calls;
  static attributes (``.shape``, ``.dtype``, ``.numel()``, ...) and
  ``is None`` tests do not count.  ``engine.py`` claims "the tick never
  reads a tensor back to the host"; this rule checks it.
* ``src/f64-literal``: ``torch.float64``, ``torch.double`` or
  ``.double()`` anywhere; ``np.float64`` or ``"float64"`` in
  loop-reachable code (host-side config plumbing uses ``np.float64``
  legitimately).
* ``src/unit-suffix`` (everywhere): add/subtract/compare across the
  ``_bytes`` / ``_s`` / ``_bps`` / ``_ticks`` suffixes.
* ``src/cu-double`` (``kernels/csrc/*.cu`` and ``*.cuh``, comments and
  strings skipped): the ``double`` type, and a floating literal without an
  ``f`` suffix, unless it sits in a constant expression of literals
  directly under an explicit ``(float)`` cast, which the compiler folds to
  one float32 constant.  The lexical pass cannot tell host from device
  code in a ``.cu`` file, so it holds the whole file; host code that
  wants a double says so with the pragma.

False-positive escape hatch: an inline pragma on the offending line,
``# lint: allow(host-sync-in-loop)`` (``// lint: allow(cu-double)`` in a
CUDA source), suppresses that rule for that line; the line says why.
Pragmas are audited in turn: after every rule pass has run, a pragma
naming an unknown rule, or one that suppressed nothing on its line,
raises ``src/stale-pragma``.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Optional

from repro_torch.analysis.findings import Finding, make_finding

__all__ = ["lint_paths", "lint_sources", "DEFAULT_SCAN_DIRS", "LOOP_ROOTS",
           "CU_DIR"]

# Packages whose sources the default lint run scans, under src/.
DEFAULT_SCAN_DIRS = ("repro_torch/core", "repro_torch/netsim",
                     "repro_torch/kernels", "repro_torch/figures",
                     "repro_torch/examples")
# The CUDA sources the lexical rule scans, under src/.
CU_DIR = "repro_torch/kernels/csrc"

# The functions that run once a tick or once a chunk ("module:qualname").
LOOP_ROOTS = (
    "repro_torch.netsim.engine:_tick",
    "repro_torch.netsim.engine:chunk_inputs",
    "repro_torch.netsim.engine:run_chunk_reference",
    "repro_torch.kernels.netsim_chunk:ChunkRun.step",
    "repro_torch.netsim.tick_graph:TickGraph.step",
)

_PRAGMA = re.compile(
    r"(?:#|//)\s*lint:\s*allow\(([a-z0-9/_-]+(?:\s*,\s*[a-z0-9/_-]+)*)\)")

_TORCH_MODULES = ("torch",)
_NUMPY_MODULES = ("numpy",)

# method calls that read a tensor back to the host
_READBACK_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
# attributes and methods of a tensor whose values are host-side Python
# already (no read-back)
_STATIC_ATTRS = frozenset({
    "shape", "ndim", "dtype", "device", "is_cuda", "layout", "size", "dim",
    "numel", "stride", "is_contiguous", "data_ptr", "element_size",
    "requires_grad", "_fields"})

_UNIT_SUFFIXES = (("_bytes_per_s", "bps"), ("_bps", "bps"),
                  ("_bytes", "bytes"), ("_ticks", "ticks"), ("_s", "s"))


def _unit_of(name: str) -> Optional[str]:
    for suf, unit in _UNIT_SUFFIXES:
        if name.endswith(suf):
            return unit
    return None


@dataclasses.dataclass
class _Module:
    name: str                                 # dotted, e.g. repro_torch.core.mltcp
    filename: str                             # display path for findings
    tree: ast.Module
    lines: list[str]
    imports: dict = dataclasses.field(default_factory=dict)       # alias -> module
    from_imports: dict = dataclasses.field(default_factory=dict)  # name -> (mod, orig)
    functions: dict = dataclasses.field(default_factory=dict)     # qual -> node
    classes: dict = dataclasses.field(default_factory=dict)       # qual -> node
    pragma_hits: set = dataclasses.field(default_factory=set)     # (lineno, token)


def _module_name(path: Path) -> str:
    parts = list(path.with_suffix("").parts)
    if "src" in parts:
        parts = parts[parts.index("src") + 1:]
    if "repro_torch" in parts:
        parts = parts[parts.index("repro_torch"):]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) or path.stem


def _collect_module(name: str, filename: str, source: str) -> _Module:
    mod = _Module(name=name, filename=filename,
                  tree=ast.parse(source), lines=source.splitlines())
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                mod.imports[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                mod.from_imports[a.asname or a.name] = (node.module, a.name)

    def visit(node, qual):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{qual}.{child.name}" if qual else child.name
                mod.functions[q] = child
                visit(child, q)
            elif isinstance(child, ast.ClassDef):
                q = f"{qual}.{child.name}" if qual else child.name
                mod.classes[q] = child
                visit(child, q)
            else:
                visit(child, qual)

    visit(mod.tree, "")
    return mod


def _annotation_names(node) -> set:
    """The bare type names an annotation mentions (``Optional[Tensor]`` ->
    {"Optional", "Tensor"}; ``torch.Tensor`` -> {"Tensor"}; string
    annotations parsed)."""
    if node is None:
        return set()
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return set()
    out = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
    return out


class _Index:
    """Cross-module function index and best-effort call resolution."""

    def __init__(self, modules: list[_Module]):
        self.modules = {m.name: m for m in modules}
        # global key "modname:qual" -> function node
        self.table = {}
        for m in modules:
            for q, node in m.functions.items():
                self.table[f"{m.name}:{q}"] = node
        # class name -> the fields it annotates as tensors (NamedTuples and
        # dataclasses of the scanned packages)
        self.tensor_fields: dict[str, set] = {}
        for m in modules:
            for q, cls in m.classes.items():
                fields = {st.target.id for st in cls.body
                          if isinstance(st, ast.AnnAssign)
                          and isinstance(st.target, ast.Name)
                          and "Tensor" in _annotation_names(st.annotation)}
                if fields:
                    self.tensor_fields.setdefault(
                        q.rpartition(".")[2], set()).update(fields)
        # (module, class qual) -> attr -> set of callable keys bound to
        # self.<attr> in the class's methods
        self.self_bindings: dict = {}
        for m in modules:
            for q, cls in m.classes.items():
                binds: dict = {}
                for fq, fn in m.functions.items():
                    if fq.rpartition(".")[0] != q:
                        continue
                    for node in ast.walk(fn):
                        if not isinstance(node, ast.Assign):
                            continue
                        for tgt in node.targets:
                            if (isinstance(tgt, ast.Attribute)
                                    and isinstance(tgt.value, ast.Name)
                                    and tgt.value.id == "self"):
                                keys = self.resolve_callable(m, fq,
                                                             node.value, {})
                                if keys:
                                    binds.setdefault(tgt.attr,
                                                     set()).update(keys)
                self.self_bindings[(m.name, q)] = binds

    def _project_key(self, modname: str, fn: str) -> Optional[str]:
        """Resolve (module-ish name, function) to a table key, following
        package re-exports (repro_torch.core:cc_tick ->
        repro_torch.core.mltcp:cc_tick)."""
        key = f"{modname}:{fn}"
        if key in self.table:
            return key
        prefix = modname + "."
        for m in self.modules.values():
            if m.name.startswith(prefix) and fn in m.functions:
                return f"{m.name}:{fn}"
        return None

    def root_module(self, mod: _Module, alias: str) -> Optional[str]:
        if alias in mod.imports:
            return mod.imports[alias]
        if alias in mod.from_imports:
            src, orig = mod.from_imports[alias]
            return f"{src}.{orig}"      # `from repro_torch.netsim import telemetry`
        return None

    def is_module(self, mod: _Module, alias: str, names) -> bool:
        tgt = self.root_module(mod, alias)
        return tgt is not None and any(tgt == n or tgt.startswith(n + ".")
                                       for n in names)

    def resolve_callable(self, mod: _Module, qual: str, expr,
                         bindings: dict) -> set:
        """Project-function keys an expression may denote (empty if none).

        Handles: bare names (local bindings -> enclosing nested defs ->
        module functions -> from-imports), ``mod.attr`` on imported project
        modules, ``self.attr`` inside a method (the class's method of that
        name, or the callables its methods bind to ``self.attr``),
        ``partial(f, ...)`` and ``a if c else b``.
        """
        if isinstance(expr, ast.Name):
            n = expr.id
            if n in bindings:
                return set(bindings[n])
            # nested def in the enclosing function chain
            scope = qual
            while scope:
                q = f"{scope}.{n}"
                if q in mod.functions:
                    return {f"{mod.name}:{q}"}
                scope = scope.rpartition(".")[0]
            if n in mod.functions:
                return {f"{mod.name}:{n}"}
            if n in mod.from_imports:
                src, orig = mod.from_imports[n]
                key = self._project_key(src, orig)
                return {key} if key else set()
            return set()
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
            if expr.value.id == "self":
                cls = self._enclosing_class(mod, qual)
                if cls is None:
                    return set()
                if f"{cls}.{expr.attr}" in mod.functions:
                    return {f"{mod.name}:{cls}.{expr.attr}"}
                binds = getattr(self, "self_bindings", {})
                return set(binds.get((mod.name, cls), {}).get(expr.attr, ()))
            tgt = self.root_module(mod, expr.value.id)
            if tgt is not None:
                key = self._project_key(tgt, expr.attr)
                return {key} if key else set()
            return set()
        if isinstance(expr, ast.IfExp):
            return (self.resolve_callable(mod, qual, expr.body, bindings)
                    | self.resolve_callable(mod, qual, expr.orelse, bindings))
        if isinstance(expr, ast.Call):
            fn = expr.func
            is_partial = (
                (isinstance(fn, ast.Name) and fn.id == "partial")
                or (isinstance(fn, ast.Attribute) and fn.attr == "partial"))
            if is_partial and expr.args:
                return self.resolve_callable(mod, qual, expr.args[0], bindings)
        return set()

    @staticmethod
    def _enclosing_class(mod: _Module, qual: str) -> Optional[str]:
        scope = qual.rpartition(".")[0]
        while scope:
            if scope in mod.classes:
                return scope
            scope = scope.rpartition(".")[0]
        return None


def _local_bindings(index: _Index, mod: _Module, qual: str,
                    fn: ast.FunctionDef) -> dict:
    """name -> set of project-function keys it may be bound to (union over
    reassignments, so ``fn = core.cc_tick`` / ``fn = ops.mltcp_cc_tick``
    yields both)."""
    bindings: dict = {}
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        keys = index.resolve_callable(mod, qual, node.value, bindings)
        if not keys:
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                bindings.setdefault(tgt.id, set()).update(keys)
    return bindings


def _call_edges(index: _Index, mod: _Module, qual: str,
                fn: ast.FunctionDef) -> set:
    bindings = _local_bindings(index, mod, qual, fn)
    edges: set = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            edges |= index.resolve_callable(mod, qual, node.func, bindings)
    # bound callables count as edges even when only called indirectly
    for keys in bindings.values():
        edges |= keys
    return edges


def _allowed(mod, lineno: int, rule: str) -> bool:
    if 1 <= lineno <= len(mod.lines):
        m = _PRAGMA.search(mod.lines[lineno - 1])
        if m:
            allowed = {r.strip() for r in m.group(1).split(",")}
            short = rule.split("/", 1)[-1]
            for token in (rule, short):
                if token in allowed:
                    mod.pragma_hits.add((lineno, token))
                    return True
    return False


def _lint_pragmas(modules: list, findings: list) -> int:
    """Post-pass (runs after every rule pass has recorded its
    suppressions): flag pragmas that name an unknown rule or suppressed
    nothing on their line.  Returns the pragma count."""
    from repro_torch.analysis.findings import RULES

    known = set(RULES) | {r.split("/", 1)[-1] for r in RULES}
    n_pragmas = 0
    for mod in modules:
        for lineno, line in enumerate(mod.lines, start=1):
            m = _PRAGMA.search(line)
            if m is None:
                continue
            n_pragmas += 1
            for token in (t.strip() for t in m.group(1).split(",")):
                where = f"{mod.filename}:{lineno}"
                if token not in known:
                    findings.append(make_finding(
                        "src/stale-pragma", where,
                        f"pragma allows unknown rule {token!r}: no "
                        f"registered rule has that id or short name"))
                elif (lineno, token) not in mod.pragma_hits:
                    findings.append(make_finding(
                        "src/stale-pragma", where,
                        f"pragma allows {token!r} but no such finding "
                        f"fires on this line: the suppression has "
                        f"outlived the code it excused"))
    return n_pragmas


def _where(mod, node) -> str:
    return f"{mod.filename}:{node.lineno}"


# ---------------------------------------------------------------------------
# per-function rule passes
# ---------------------------------------------------------------------------

def _root_name(expr) -> Optional[str]:
    root = expr
    while isinstance(root, ast.Attribute):
        root = root.value
    return root.id if isinstance(root, ast.Name) else None


# torch functions whose result is not a tensor
_TORCH_NON_TENSOR = frozenset({
    "device", "Size", "finfo", "iinfo", "promote_types", "result_type",
    "get_default_dtype", "is_grad_enabled", "is_tensor", "is_floating_point",
    "numel", "Generator"})


class _TensorScope:
    """Which expressions of one function hold tensors.

    Values count as tensors when they derive from the function's tensor
    parameters (annotated ``Tensor``, or a field of a parameter whose
    annotated class declares the field ``Tensor``) or from ``torch.*``
    calls; through arithmetic, comparisons, indexing, tensor methods and
    calls of project functions annotated to return a ``Tensor``.  Static
    attributes and methods (``.shape``, ``.device``, ``.numel()``, ...),
    ``is``/``is not`` tests and other calls do not carry a tensor."""

    def __init__(self, index: _Index, mod: _Module, qual: str,
                 fn: ast.FunctionDef):
        self.index, self.mod, self.qual = index, mod, qual
        self.bindings = _local_bindings(index, mod, qual, fn)
        args = fn.args
        params = args.posonlyargs + args.args + args.kwonlyargs
        self.names = {a.arg for a in params
                      if "Tensor" in _annotation_names(a.annotation)}
        # parameter -> the tensor fields of its annotated class
        self.holders = {}
        for a in params:
            fields = set()
            for name in _annotation_names(a.annotation):
                fields |= index.tensor_fields.get(name, set())
            if fields:
                self.holders[a.arg] = fields
        # two passes over the assignments in textual order pick up simple
        # forward chains without a full fixpoint
        for _ in range(2):
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and self.is_tensor(node.value):
                    for tgt in node.targets:
                        self._bind(tgt)
                elif (isinstance(node, (ast.AugAssign, ast.AnnAssign))
                      and node.value is not None
                      and self.is_tensor(node.value)):
                    self._bind(node.target)

    def _bind(self, tgt) -> None:
        # only plain name targets (and tuple/list unpacks of them) become
        # tensors; subscript/attribute targets would leak index names
        if isinstance(tgt, ast.Name):
            self.names.add(tgt.id)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._bind(el)

    def _returns_tensor(self, func) -> bool:
        for key in self.index.resolve_callable(self.mod, self.qual, func,
                                               self.bindings):
            node = self.index.table.get(key)
            if node is not None and "Tensor" in _annotation_names(
                    node.returns):
                return True
        return False

    def is_tensor(self, n) -> bool:
        if isinstance(n, ast.Name):
            return n.id in self.names
        if isinstance(n, ast.Attribute):
            if n.attr in _STATIC_ATTRS:
                return False
            if (isinstance(n.value, ast.Name)
                    and n.attr in self.holders.get(n.value.id, ())):
                return True
            return self.is_tensor(n.value)
        if isinstance(n, (ast.Subscript, ast.Starred)):
            return self.is_tensor(n.value)
        if isinstance(n, ast.BinOp):
            return self.is_tensor(n.left) or self.is_tensor(n.right)
        if isinstance(n, ast.UnaryOp):
            return self.is_tensor(n.operand)
        if isinstance(n, ast.BoolOp):
            return any(self.is_tensor(v) for v in n.values)
        if isinstance(n, ast.Compare):
            if all(isinstance(o, (ast.Is, ast.IsNot)) for o in n.ops):
                return False
            return any(self.is_tensor(v) for v in [n.left, *n.comparators])
        if isinstance(n, ast.IfExp):
            return self.is_tensor(n.body) or self.is_tensor(n.orelse)
        if isinstance(n, (ast.Tuple, ast.List)):
            return any(self.is_tensor(v) for v in n.elts)
        if isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Attribute):
                root = _root_name(f)
                if root is not None and self.index.is_module(
                        self.mod, root, _TORCH_MODULES):
                    return f.attr not in _TORCH_NON_TENSOR and not (
                        isinstance(f.value, ast.Attribute)
                        and f.value.attr == "cuda")
                if self.is_tensor(f.value):      # a tensor's method
                    return (f.attr not in _STATIC_ATTRS
                            and f.attr not in _READBACK_METHODS)
            return self._returns_tensor(f)
        return False


def _lint_function(index: _Index, mod: _Module, qual: str,
                   fn: ast.FunctionDef, reachable: bool,
                   findings: list) -> None:
    scope = _TensorScope(index, mod, qual, fn)

    def emit(rule, node, msg):
        if not _allowed(mod, node.lineno, rule):
            findings.append(make_finding(rule, _where(mod, node), msg))

    def sync(node, what):
        emit("src/host-sync-in-loop", node,
             f"{what} in loop-reachable `{mod.name}:{qual}` reads a tensor "
             f"back to the host once a tick or chunk")

    def rooted_in(expr, names) -> bool:
        root = _root_name(expr)
        return root is not None and (index.is_module(mod, root, names)
                                     or (root == "np" and "numpy" in names))

    own_defs = {n for n in ast.walk(fn)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef))
                and n is not fn}
    skip = set()
    for d in own_defs:       # nested defs are linted as their own qualnames
        skip.update(ast.walk(d))

    for node in ast.walk(fn):
        if node in skip:
            continue
        if isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute) and f.attr == "double"
                    and not node.args):
                emit("src/f64-literal", node,
                     f"`.double()` in `{mod.name}:{qual}`: the pipeline is "
                     f"pinned float32")
            if not reachable:
                continue
            if isinstance(f, ast.Attribute) and f.attr in _READBACK_METHODS:
                sync(node, f"`{ast.unparse(f)}()`")
            if (isinstance(f, ast.Name) and f.id in ("float", "int", "bool")
                    and len(node.args) == 1
                    and scope.is_tensor(node.args[0])):
                sync(node, f"`{f.id}({ast.unparse(node.args[0])})`")
        elif isinstance(node, (ast.If, ast.While, ast.IfExp)):
            if reachable and scope.is_tensor(node.test):
                kind = {ast.If: "if", ast.While: "while",
                        ast.IfExp: "... if ... else"}[type(node)]
                sync(node, f"`{kind} {ast.unparse(node.test)}`")
        elif isinstance(node, ast.Attribute) and node.attr in ("float64",
                                                               "double"):
            if rooted_in(node, _TORCH_MODULES):
                emit("src/f64-literal", node,
                     f"`{ast.unparse(node)}` in `{mod.name}:{qual}`: the "
                     f"pipeline is pinned float32")
            elif (reachable and node.attr == "float64"
                  and rooted_in(node, _NUMPY_MODULES)):
                emit("src/f64-literal", node,
                     f"np.float64 in loop-reachable `{mod.name}:{qual}` "
                     f"(numpy-side plumbing only)")
        elif (reachable and isinstance(node, ast.Constant)
                and node.value == "float64"):
            emit("src/f64-literal", node,
                 f'"float64" dtype string in loop-reachable '
                 f"`{mod.name}:{qual}`")


def _lint_module_level(index: _Index, mod: _Module, findings: list) -> None:
    """torch.float64 / .double() outside any function."""
    inside = set()
    for fn in mod.functions.values():
        inside.update(ast.walk(fn))
    for node in ast.walk(mod.tree):
        if node in inside:
            continue
        if (isinstance(node, ast.Attribute)
                and node.attr in ("float64", "double")
                and _root_name(node) is not None
                and index.is_module(mod, _root_name(node), _TORCH_MODULES)):
            if not _allowed(mod, node.lineno, "src/f64-literal"):
                findings.append(make_finding(
                    "src/f64-literal", _where(mod, node),
                    f"`{ast.unparse(node)}` at module level of `{mod.name}`: "
                    f"the pipeline is pinned float32"))


def _operand_unit(expr) -> Optional[str]:
    if isinstance(expr, ast.Name):
        return _unit_of(expr.id)
    if isinstance(expr, ast.Attribute):
        return _unit_of(expr.attr)
    return None


def _lint_units(mod: _Module, findings: list) -> None:
    for node in ast.walk(mod.tree):
        pairs = []
        if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                      (ast.Add, ast.Sub)):
            pairs = [(node.left, node.right)]
        elif isinstance(node, ast.Compare):
            operands = [node.left] + list(node.comparators)
            pairs = list(zip(operands, operands[1:]))
        for a, b in pairs:
            ua, ub = _operand_unit(a), _operand_unit(b)
            if ua and ub and ua != ub:
                if not _allowed(mod, node.lineno, "src/unit-suffix"):
                    findings.append(make_finding(
                        "src/unit-suffix", _where(mod, node),
                        f"`{ast.unparse(a)}` [{ua}] "
                        f"{'+/-' if isinstance(node, ast.BinOp) else 'vs'} "
                        f"`{ast.unparse(b)}` [{ub}] mixes units"))


# ---------------------------------------------------------------------------
# the CUDA sources (lexical)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _CuFile:
    filename: str
    lines: list[str]
    pragma_hits: set = dataclasses.field(default_factory=set)


_CU_FLOAT = re.compile(
    r"(?<![\w.])(?:\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?"
    r"|\d+[eE][+-]?\d+)([fFlL]?)(?![\w.])")
_CU_DOUBLE = re.compile(r"\bdouble\b")
_CU_CAST = re.compile(r"\(\s*float\s*\)\s*")
# what a constant expression of literals may hold
_CU_CONST_EXPR = re.compile(r"[\d.eE+\-*/()\sfF]*")


def _blank_comments_and_strings(text: str) -> str:
    """``text`` with comments, string and character literals replaced by
    spaces (newlines kept, so offsets and line numbers stay)."""
    out = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
        elif c in "\"'":
            j = i + 1
            while j < n and text[j] != c:
                j += 2 if text[j] == "\\" else 1
            j = min(j + 1, n)
        else:
            out.append(c)
            i += 1
            continue
        out.append(re.sub(r"[^\n]", " ", text[i:j]))
        i = j
    return "".join(out)


def _cast_spans(code: str) -> list[tuple[int, int]]:
    """Character spans of the constant expressions directly under a
    ``(float)`` cast: one literal, or a parenthesized expression of
    literals and arithmetic operators."""
    spans = []
    for m in _CU_CAST.finditer(code):
        start = m.end()
        lit = _CU_FLOAT.match(code, start)
        if lit:
            spans.append((start, lit.end()))
            continue
        if start < len(code) and code[start] == "(":
            depth, j = 0, start
            while j < len(code):
                depth += {"(": 1, ")": -1}.get(code[j], 0)
                if depth == 0:
                    break
                j += 1
            inner = code[start:j + 1]
            if _CU_CONST_EXPR.fullmatch(inner):
                spans.append((start, j + 1))
    return spans


def _lint_cu(cu: _CuFile, findings: list) -> None:
    code = _blank_comments_and_strings("\n".join(cu.lines))
    starts = [0]
    for line in code.split("\n"):
        starts.append(starts[-1] + len(line) + 1)

    def line_of(offset: int) -> int:
        lo, hi = 0, len(starts) - 1
        while lo < hi - 1:
            mid = (lo + hi) // 2
            if starts[mid] <= offset:
                lo = mid
            else:
                hi = mid
        return lo + 1

    spans = _cast_spans(code)

    def emit(offset, msg):
        lineno = line_of(offset)
        if not _allowed(cu, lineno, "src/cu-double"):
            findings.append(make_finding(
                "src/cu-double", f"{cu.filename}:{lineno}", msg))

    for m in _CU_DOUBLE.finditer(code):
        emit(m.start(), "`double` type: the kernels compute in float32")
    for m in _CU_FLOAT.finditer(code):
        if m.group(1) in ("f", "F"):
            continue
        if any(a <= m.start() and m.end() <= b for a, b in spans):
            continue
        emit(m.start(), f"floating literal `{m.group(0)}` without an `f` "
                        f"suffix promotes its expression to FP64")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _lint_modules(modules: list[_Module], cu_files: list[_CuFile],
                  loop_roots) -> tuple[list[Finding], dict]:
    index = _Index(modules)
    roots = {r for r in loop_roots if r in index.table}

    # BFS the call graph from the loop roots
    reachable = set(roots)
    frontier = list(roots)
    while frontier:
        key = frontier.pop()
        node = index.table.get(key)
        if node is None:
            continue
        modname, qual = key.split(":", 1)
        for callee in _call_edges(index, index.modules[modname], qual, node):
            if callee not in reachable:
                reachable.add(callee)
                frontier.append(callee)

    findings: list[Finding] = []
    for m in modules:
        for qual, fn in m.functions.items():
            _lint_function(index, m, qual, fn,
                           reachable=f"{m.name}:{qual}" in reachable,
                           findings=findings)
        _lint_module_level(index, m, findings)
        _lint_units(m, findings)
    for cu in cu_files:
        _lint_cu(cu, findings)
    n_pragmas = _lint_pragmas(modules + cu_files, findings)

    facts = {"modules": len(modules),
             "cu_files": len(cu_files),
             "functions": len(index.table),
             "loop_roots": len(roots),
             "loop_reachable": len(reachable),
             "pragmas": n_pragmas}
    return findings, facts


def _is_cu(fname: str) -> bool:
    return fname.endswith((".cu", ".cuh"))


def lint_sources(sources: dict, loop_roots=()) -> tuple[list[Finding], dict]:
    """Lint in-memory sources: {filename: text}, Python or (``.cu`` /
    ``.cuh``) CUDA.  Module names derive from the filenames (`a/b.py` ->
    `a.b`), so fixtures can fake cross-module imports; ``loop_roots`` are
    "module:qualname" keys.  This is the test surface."""
    modules = [_collect_module(_module_name(Path(fname)), fname, text)
               for fname, text in sorted(sources.items())
               if not _is_cu(fname)]
    cu_files = [_CuFile(fname, text.splitlines())
                for fname, text in sorted(sources.items()) if _is_cu(fname)]
    return _lint_modules(modules, cu_files, loop_roots)


def lint_paths(paths=None) -> tuple[list[Finding], dict]:
    """Lint the port's sources (default: its core, netsim, kernels and
    figures packages) and the kernels' CUDA sources, from `LOOP_ROOTS`."""
    src_root = Path(__file__).resolve().parents[2]
    if paths is None:
        paths = [src_root / d for d in DEFAULT_SCAN_DIRS]

    def files(roots, patterns):
        out: list[Path] = []
        for p in map(Path, roots):
            if p.is_dir():
                for pat in patterns:
                    out.extend(sorted(p.rglob(pat)))
            else:
                out.append(p)
        return out

    def shown(f: Path) -> str:
        try:
            return str(f.resolve().relative_to(Path.cwd()))
        except ValueError:
            return str(f)

    modules = [_collect_module(_module_name(f), shown(f), f.read_text())
               for f in files(paths, ("*.py",))]
    cu_files = [_CuFile(shown(f), f.read_text().splitlines())
                for f in files([src_root / CU_DIR], ("*.cu", "*.cuh"))]
    return _lint_modules(modules, cu_files, LOOP_ROOTS)
