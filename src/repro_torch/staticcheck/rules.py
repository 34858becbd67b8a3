"""AST rules encoding the port's execution-discipline invariants.

Every rule works on a plain ``ast`` parse of one module — no imports are
executed — plus a small amount of repo knowledge (which packages run on
the card, which modules are threaded).  The analyses are deliberately
conservative: a rule only fires where the hazard is structural (a
``.item()`` in a device module, an ``if`` on a value a ``torch`` call
made, an attribute written under ``self._lock`` in one method and read
bare in another), so a finding is actionable rather than noise.

The port runs eagerly: there is no trace, so a device function is just a
function of a device package, and a value counts as a tensor when it is
the result of a ``torch.*`` call (``torch.cuda.*``, ``torch.device``,
``torch.is_*`` and the like excepted), of a tensor's method, attribute
(but ``shape``, ``dtype``, ``device`` and the other static ones) or
index, of arithmetic or a comparison with a tensor, or a name bound to
one.  Parameters are not tensors to the rules: what a caller passes is
not known here.

Rules
-----
VIEM001   host-sync hazard in a device package (``engine``, ``kernels``,
          ``multilevel``, ``portfolio``): ``.item()``, ``.cpu()``,
          ``.numpy()``, ``.tolist()`` of a tensor, ``bool()``/``int()``/
          ``float()`` of a tensor, boolean-mask indexing (a data-dependent
          shape), ``torch.nonzero``/``torch.argwhere``/``.nonzero()`` and
          one-argument ``torch.where``, and host timing
          (``time.perf_counter``) in a function that makes tensors — each
          one a silent device->host sync on the hot path.  The one
          counted readback is exempt: the body of ``Boundary.read``
          (``runtime/boundary.py``) and the argument of a ``.read(x)``
          call (device packages read no files, so a one-argument
          ``.read`` there is the boundary's).
VIEM002   reserved, not checked here: the JAX package's retrace hazard
          (a per-call ``jax.jit`` over a closure).  The port has no
          ``torch.compile`` or ``torch.jit`` site, so nothing it runs is
          traced or compiled per call, and the id stays reserved for the
          day one appears.
VIEM003   Python ``if``/``while``/``assert`` on a tensor expression in a
          device package: the branch reads the value back to the host
          (a sync per evaluation).
VIEM004   lock discipline: an attribute of a threaded class written
          under ``with self._lock`` in one method and accessed bare in
          another is a data race waiting for a free-threaded build.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

# packages whose modules run on the card
DEVICE_PACKAGES = ("engine", "kernels", "multilevel", "portfolio")
PACKAGE = "repro_torch"

# modules whose classes serve concurrent threads; VIEM004 scope.  The JAX
# package's list, and core/pinned.py (its PinnedPool keeps self._lock).
# runtime/boundary.py guards module globals with a module lock, which
# VIEM004 (a rule about classes) does not see.
LOCK_MODULES = (
    "launch/serve.py",
    "obs/metrics.py",
    "obs/trace.py",
    "monitor/",
    "runtime/fault_tolerance.py",
    "core/mapping.py",
    "core/pinned.py",
)

# dotted call prefixes under torch. whose results are not tensors
_NOT_TENSOR_CALLS = (
    "torch.cuda.", "torch.backends.", "torch.utils.", "torch.testing.",
    "torch.autograd.", "torch.distributed.", "torch.profiler.",
    "torch.device", "torch.Generator", "torch.finfo", "torch.iinfo",
    "torch.is_", "torch.get_", "torch.set_", "torch.no_grad",
    "torch.enable_grad", "torch.inference_mode", "torch.Size",
    "torch.promote_types", "torch.result_type", "torch.can_cast",
    "torch.manual_seed", "torch.equal",
)

# tensor methods whose results are host values without a sync (the
# reads themselves are VIEM001's)
_HOST_METHODS = {
    "size", "dim", "ndimension", "numel", "nelement", "element_size",
    "stride", "data_ptr", "is_contiguous", "get_device", "item", "tolist",
    "numpy", "is_floating_point", "is_complex", "untyped_storage",
}

# attribute reads that are static Python values of a tensor
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "requires_grad", "is_leaf", "names", "itemsize",
                 "nbytes"}

# calls and methods whose results are boolean tensors (masks)
_MASK_CALLS = {
    "torch.isnan", "torch.isfinite", "torch.isinf", "torch.isin",
    "torch.logical_and", "torch.logical_or", "torch.logical_not",
    "torch.logical_xor", "torch.eq", "torch.ne", "torch.lt", "torch.le",
    "torch.gt", "torch.ge",
}
_MASK_METHODS = {"bool", "isnan", "isfinite", "isinf", "logical_and",
                 "logical_or", "logical_not", "logical_xor", "eq", "ne",
                 "lt", "le", "gt", "ge"}

# methods that read a tensor back to the host
_READ_METHODS = ("item", "cpu", "numpy", "tolist")

_HOST_TIMING = {
    "time.perf_counter", "time.perf_counter_ns", "time.time",
    "time.monotonic", "time.process_time",
}

_LOCK_FACTORIES = {"threading.Lock", "threading.RLock", "threading.Condition"}


@dataclass
class Finding:
    rule: str
    path: str            # repo-relative, forward slashes
    line: int
    col: int
    message: str
    snippet: str = ""
    suppressed: bool = False
    justification: str = ""

    def fingerprint(self) -> str:
        # line numbers churn; the (rule, path, snippet) triple is stable
        # across unrelated edits, which is what a baseline needs
        return f"{self.rule}:{self.path}:{self.snippet.strip()}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "snippet": self.snippet,
            "suppressed": self.suppressed,
            "justification": self.justification,
        }


def _dotted(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """Resolve an attribute chain to a dotted name, expanding import
    aliases at the root (``F.relu`` -> ``torch.nn.functional.relu``)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    root = aliases.get(node.id, node.id)
    parts.append(root)
    return ".".join(reversed(parts))


def _collect_aliases(tree: ast.Module) -> dict[str, str]:
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


class _ModuleIndex:
    """Parent links and the enclosing-scope lookup."""

    def __init__(self, tree: ast.Module, aliases: dict[str, str]):
        self.tree = tree
        self.aliases = aliases
        self.parent: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parent[child] = node

    def enclosing_scope(self, node: ast.AST) -> ast.AST:
        """Nearest enclosing function/lambda, else the module."""
        cur = self.parent.get(node)
        while cur is not None and not isinstance(cur, _FUNC_NODES):
            cur = self.parent.get(cur)
        return cur if cur is not None else self.tree

    def enclosing_function(self, node: ast.AST):
        scope = self.enclosing_scope(node)
        return None if isinstance(scope, ast.Module) else scope


# ------------------------------------------------------------ tensors


class _Tensors:
    """Which expressions of one function are tensors, and which are
    boolean masks: names bound to either, to a fixpoint over the
    function's assignments (device code is near straight-line)."""

    def __init__(self, fn: ast.AST | None, aliases: dict[str, str]):
        self.aliases = aliases
        self.names: set[str] = set()
        self.masks: set[str] = set()
        if fn is None:
            return
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        changed = True
        while changed:
            before = (len(self.names), len(self.masks))
            for node in ast.walk(ast.Module(body=body, type_ignores=[])):
                if isinstance(node, _FUNC_NODES):
                    continue
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        self._bind(t, node.value)
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) \
                        and node.value is not None:
                    self._bind(node.target, node.value)
                elif isinstance(node, ast.For) and self.tensor(node.iter):
                    self._bind(node.target, node.iter)
            changed = (len(self.names), len(self.masks)) != before

    def _bind(self, target: ast.AST, value: ast.AST) -> None:
        # `x = ...` and `x, y = ...` bind x/y; `obj.attr = ...` and
        # `obj[i] = ...` do not bind obj
        if isinstance(target, ast.Name):
            if self.tensor(value):
                self.names.add(target.id)
            if self.mask(value):
                self.masks.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, value)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, value)

    def torch_call(self, node: ast.AST) -> str | None:
        """The dotted name of a call of ``torch.*`` that makes a
        tensor, else None."""
        if not isinstance(node, ast.Call):
            return None
        name = _dotted(node.func, self.aliases)
        if name is None or not name.startswith("torch.") \
                or name.startswith(_NOT_TENSOR_CALLS):
            return None
        return name

    def tensor(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Call):
            if self.torch_call(node) is not None:
                return True
            f = node.func
            return (isinstance(f, ast.Attribute)
                    and f.attr not in _HOST_METHODS
                    and self.tensor(f.value))
        if isinstance(node, ast.Attribute):
            return node.attr not in _STATIC_ATTRS and self.tensor(node.value)
        if isinstance(node, ast.Subscript):
            return self.tensor(node.value)
        if isinstance(node, ast.BinOp):
            return self.tensor(node.left) or self.tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.tensor(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.tensor(v) for v in node.values)
        if isinstance(node, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return any(self.tensor(o) for o in [node.left, *node.comparators])
        if isinstance(node, ast.IfExp):
            return self.tensor(node.body) or self.tensor(node.orelse)
        return False

    def mask(self, node: ast.AST) -> bool:
        """A boolean tensor: a comparison with a tensor, ~, &, |, ^ of
        masks, a mask-making call or method, or a name bound to one."""
        if isinstance(node, ast.Name):
            return node.id in self.masks
        if isinstance(node, ast.Compare):
            return self.tensor(node)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self.mask(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.mask(node.left) or self.mask(node.right)
        if isinstance(node, ast.Call):
            name = self.torch_call(node)
            if name is not None:
                return name in _MASK_CALLS
            f = node.func
            return (isinstance(f, ast.Attribute) and f.attr in _MASK_METHODS
                    and self.tensor(f.value))
        return False


def _first_line(source_lines: list[str], node: ast.AST) -> str:
    try:
        return source_lines[node.lineno - 1].strip()
    except (IndexError, AttributeError):
        return ""


def _in_device_package(relpath: str) -> bool:
    return any(f"/{pkg}/" in f"/{relpath}" or relpath.startswith(f"{pkg}/")
               for pkg in (f"{PACKAGE}/{p}" for p in DEVICE_PACKAGES))


def _in_lock_module(relpath: str) -> bool:
    return any(relpath.endswith(m) or (m.endswith("/") and f"/{m}" in
               f"/{relpath}") for m in LOCK_MODULES)


def _exempt_nodes(idx: _ModuleIndex) -> set[ast.AST]:
    """Nodes of the counted readback: the body of ``Boundary.read`` and
    the argument of every one-argument ``.read(x)`` call."""
    exempt: set[ast.AST] = set()
    for node in ast.walk(idx.tree):
        if isinstance(node, ast.ClassDef) and node.name == "Boundary":
            for fn in node.body:
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and fn.name == "read":
                    exempt.update(ast.walk(fn))
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "read" and len(node.args) == 1 \
                and not node.keywords:
            exempt.update(ast.walk(node.args[0]))
    return exempt


class _FunctionTensors:
    """Per-function :class:`_Tensors`, built on first use."""

    def __init__(self, idx: _ModuleIndex):
        self.idx = idx
        self.cache: dict[ast.AST | None, _Tensors] = {}

    def __call__(self, node: ast.AST) -> _Tensors:
        fn = self.idx.enclosing_function(node)
        if fn not in self.cache:
            self.cache[fn] = _Tensors(fn, self.idx.aliases)
        return self.cache[fn]


# ---------------------------------------------------------------- VIEM001


def _makes_tensors(fn: ast.AST, tensors: _Tensors) -> bool:
    return any(tensors.torch_call(n) is not None for n in ast.walk(fn))


def _check_host_sync(idx: _ModuleIndex, relpath: str,
                     lines: list[str]) -> list[Finding]:
    if not _in_device_package(relpath):
        return []
    out = []
    exempt = _exempt_nodes(idx)
    tensors_of = _FunctionTensors(idx)

    def add(node, message):
        out.append(Finding("VIEM001", relpath, node.lineno,
                           node.col_offset, message,
                           _first_line(lines, node)))

    for node in ast.walk(idx.tree):
        if node in exempt:
            continue
        if isinstance(node, ast.Subscript):
            tensors = tensors_of(node)
            index = node.slice
            parts = index.elts if isinstance(index, ast.Tuple) else [index]
            if not tensors.tensor(node.value) \
                    or not any(tensors.mask(p) for p in parts):
                continue
            parent = idx.parent.get(node)
            if isinstance(node.ctx, ast.Store) \
                    and isinstance(parent, ast.Assign) \
                    and isinstance(parent.value, ast.Constant):
                continue        # t[mask] = constant is masked_fill_
            add(node, "boolean-mask indexing has a data-dependent shape: "
                      "the host reads the mask's count — use "
                      "torch.where or a fixed-shape gather")
            continue
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func, idx.aliases)
        tensors = tensors_of(node)
        if name in _HOST_TIMING:
            fn = idx.enclosing_function(node)
            if fn is not None and _makes_tensors(fn, tensors):
                add(node, f"host timing ({name}) in a function that makes "
                          "tensors — the host clock times the enqueue, "
                          "not the card; use CUDA events or a tracer span "
                          "at the session layer")
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in _READ_METHODS and not node.args:
            attr, recv = node.func.attr, node.func.value
            if attr == "numpy" and isinstance(recv, ast.Call) \
                    and isinstance(recv.func, ast.Attribute) \
                    and recv.func.attr == "cpu":
                continue        # the .cpu() before it is the read
            if attr == "tolist" and not tensors.tensor(recv):
                continue        # numpy arrays have .tolist() too
            if isinstance(recv, ast.Call) and (
                    _dotted(recv.func, idx.aliases) or "").startswith(
                        "numpy."):
                continue        # np.float32(x).item(): a host value
            add(node, f".{attr}() reads a tensor back to the host (a "
                      "sync) — keep it on the device, or read it through "
                      "the scope's Boundary.read")
        elif name in ("float", "int", "bool") and len(node.args) == 1 \
                and tensors.tensor(node.args[0]):
            add(node, f"{name}() of a tensor reads it back to the host (a "
                      "sync) — keep it a tensor, or read it through the "
                      "scope's Boundary.read")
        elif name in ("torch.nonzero", "torch.argwhere") or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "nonzero"
                and tensors.tensor(node.func.value)):
            add(node, "nonzero has a data-dependent shape: the host reads "
                      "the count (a sync) — use a fixed-shape mask")
        elif name == "torch.where" and len(node.args) == 1 \
                and not node.keywords:
            add(node, "one-argument torch.where is nonzero: a sync for "
                      "its data-dependent shape — use the three-argument "
                      "form")
    return out


# ---------------------------------------------------------------- VIEM003


def _check_tensor_control_flow(idx: _ModuleIndex, relpath: str,
                               lines: list[str]) -> list[Finding]:
    if not _in_device_package(relpath):
        return []
    out = []
    exempt = _exempt_nodes(idx)
    tensors_of = _FunctionTensors(idx)
    for node in ast.walk(idx.tree):
        if not isinstance(node, (ast.If, ast.While, ast.Assert)) \
                or node.test in exempt:
            continue
        if not tensors_of(node).tensor(node.test):
            continue
        kind = {ast.If: "if", ast.While: "while",
                ast.Assert: "assert"}[type(node)]
        out.append(Finding(
            "VIEM003", relpath, node.lineno, node.col_offset,
            f"Python `{kind}` on a tensor expression reads it back to the "
            "host (a sync per evaluation) — keep the choice on the device "
            "(torch.where, a mask), or read it through the scope's "
            "Boundary.read",
            _first_line(lines, node)))
    return out


# ---------------------------------------------------------------- VIEM004


@dataclass
class _AttrAccess:
    node: ast.Attribute
    method: str
    guarded: bool
    is_store: bool


def _check_lock_discipline(idx: _ModuleIndex, relpath: str,
                           lines: list[str]) -> list[Finding]:
    if not _in_lock_module(relpath):
        return []
    out = []
    for cls in ast.walk(idx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        lock_attrs: set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    vname = _dotted(node.value.func, idx.aliases) \
                        if isinstance(node.value, ast.Call) else None
                    if vname in _LOCK_FACTORIES or \
                            ("lock" in t.attr.lower()
                             and not isinstance(node.value,
                                                ast.Constant)):
                        lock_attrs.add(t.attr)
        if not lock_attrs:
            continue

        # every `self.X` access in every method, tagged by whether an
        # enclosing `with self.<lock>` guards it
        accesses: dict[str, list[_AttrAccess]] = {}
        data_attrs: set[str] = set()

        def _is_lock_ctx(expr: ast.AST) -> bool:
            return (isinstance(expr, ast.Attribute)
                    and isinstance(expr.value, ast.Name)
                    and expr.value.id == "self"
                    and expr.attr in lock_attrs)

        for method in cls.body:
            if not isinstance(method, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                continue
            guarded_nodes: set[ast.AST] = set()
            for node in ast.walk(method):
                if isinstance(node, ast.With) and any(
                        _is_lock_ctx(item.context_expr)
                        for item in node.items):
                    for sub in ast.walk(node):
                        guarded_nodes.add(sub)
            for node in ast.walk(method):
                if isinstance(node, ast.Attribute) \
                        and isinstance(node.value, ast.Name) \
                        and node.value.id == "self" \
                        and node.attr not in lock_attrs:
                    is_store = isinstance(node.ctx,
                                          (ast.Store, ast.Del))
                    parent = idx.parent.get(node)
                    if isinstance(parent, ast.Call) \
                            and parent.func is node:
                        continue        # method call, not a data access
                    if is_store:
                        data_attrs.add(node.attr)
                    accesses.setdefault(node.attr, []).append(
                        _AttrAccess(node, method.name,
                                    node in guarded_nodes, is_store))

        for attr, accs in accesses.items():
            if attr not in data_attrs:
                continue                # never assigned in this class
            outside_init = [a for a in accs
                            if a.method not in ("__init__",)
                            and not a.method.endswith("_locked")]
            # lock-managed = touched under the lock AND rebound after
            # __init__; attributes only ever *called* through (Queue,
            # deque) synchronize themselves and stay exempt
            if not any(a.guarded for a in outside_init) \
                    or not any(a.is_store for a in outside_init):
                continue
            for a in outside_init:
                if not a.guarded:
                    what = "write" if a.is_store else "read"
                    out.append(Finding(
                        "VIEM004", relpath, a.node.lineno,
                        a.node.col_offset,
                        f"self.{attr} is lock-managed elsewhere in "
                        f"{cls.name} but this {what} in {a.method}() "
                        "runs outside the lock — take the lock (RLock "
                        "re-enters) or rename the method *_locked",
                        _first_line(lines, a.node)))
    return out


# ------------------------------------------------------------ entry point


# the rules this module checks (VIEM002 is reserved: see the docstring)
RULE_IDS = ("VIEM001", "VIEM003", "VIEM004")

_CHECKS = (
    _check_host_sync,
    _check_tensor_control_flow,
    _check_lock_discipline,
)


def analyze_source(source: str, relpath: str,
                   rules: tuple[str, ...] = RULE_IDS) -> list[Finding]:
    """Run every enabled rule over one module's source text."""
    try:
        tree = ast.parse(source)
    except SyntaxError as exc:
        return [Finding("VIEM000", relpath, exc.lineno or 1, 0,
                        f"syntax error: {exc.msg}")]
    aliases = _collect_aliases(tree)
    idx = _ModuleIndex(tree, aliases)
    lines = source.splitlines()
    findings: list[Finding] = []
    for check, rule in zip(_CHECKS, RULE_IDS):
        if rule in rules:
            findings.extend(check(idx, relpath, lines))
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings
