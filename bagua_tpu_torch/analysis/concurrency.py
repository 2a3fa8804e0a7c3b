"""Whole-program host-concurrency engine.

Port of ``bagua_tpu/analysis/concurrency.py``, unchanged in its model: the
port, like the JAX package, runs communication and observability off the
training loop on background threads.  Its thread roots are its own, found
structurally (``threading.Thread(target=...)``, ``signal.signal``): the hang
watchdog's monitor, the overlap scheduler's ``CommWorker``
(``core/overlap.py``), the autotune sidecar's server thread, the obs HTTP
server, the historian's and the exporter's threads, the lease heartbeat and
the flight recorder's signal path.  The hazard classes it checks:

* ``lock-order-inversion``: a cycle in the interprocedural lock-acquisition
  graph (two threads taking the same locks in opposite orders deadlock).
* ``unguarded-shared-write``: a module global or instance attribute written
  from two or more thread roots with no single lock common to every write.
* ``lock-held-io``: blocking IO (file/socket/subprocess/``time.sleep``)
  performed while holding a lock that other thread roots contend on through
  an IO-free region.
* ``signal-unsafe-lock``: a lock acquisition reachable from a signal
  handler (the handler interrupts arbitrary code, including the owner of
  that very lock: a self-deadlock no test reliably reproduces).
* ``non-reentrant-reacquire``: re-acquiring a held non-reentrant
  ``threading.Lock``, directly or through a callee (instant deadlock).

Unlike :mod:`.ast_rules` (per-module, syntactic) this engine builds a
whole-program model: module-level and ``self.*`` lock objects, module-level
singleton instances, thread roots, and a call graph with a fixpoint over
transitive lock/IO summaries, so a lock taken three calls below a ``with``
block still creates an edge, with the witness chain in the finding message.
The model is deliberately conservative where Python defeats static
resolution (attribute calls fall back to globally-unique method names behind
a stoplist); suppress the residue with
``# bagua: lint-ignore[rule-id] -- reason``.

The runtime half of this engine is :mod:`.lockdep`: an opt-in shim that
records REAL acquisition orders and is cross-checked against
:func:`static_lock_graph`.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from .ast_rules import Rule, _dotted, iter_py_files
from .findings import Finding
from .suppressions import is_suppressed, parse_suppressions

# ---- lock / thread vocabulary ---------------------------------------------

#: constructor dotted names that create a lock object
_LOCK_CTORS = {
    "threading.Lock": False,
    "threading.RLock": True,
    "Lock": False,
    "RLock": True,
    # a Condition IS a lock (it wraps an RLock by default and supports the
    # same context-manager protocol); writes under ``with self._cond:`` are
    # guarded writes.  ``.wait()`` releases the lock while blocking, and is
    # deliberately absent from _IO_CALLS, so condition waits don't surface
    # as lock-held-io false positives.
    "threading.Condition": True,
    "Condition": True,
}

#: constructor dotted names that spawn a background thread; the ``target``
#: becomes a thread root, NOT a call edge (it runs concurrently)
_THREAD_CTORS = ("threading.Thread", "Thread", "threading.Timer", "Timer")

#: dotted call names that block on IO (or block outright) — the payload of
#: ``lock-held-io``.  Logging is deliberately absent: flagging every
#: ``logger.warning`` under a lock would drown the signal.
_IO_CALLS = {
    "time.sleep",
    "open",
    "os.makedirs", "os.replace", "os.rename", "os.remove", "os.unlink",
    "os.fsync", "os.listdir", "os.scandir",
    "shutil.rmtree", "shutil.copy", "shutil.copytree", "shutil.move",
    "subprocess.run", "subprocess.Popen", "subprocess.check_call",
    "subprocess.check_output", "subprocess.call",
    "socket.socket", "socket.create_connection",
    "urllib.request.urlopen",
}

#: attribute-call suffixes that are IO on any plausible receiver here
_IO_METHOD_SUFFIXES = ("sendall", "recv", "accept", "makefile")

#: method names too common for the globally-unique-name call fallback —
#: resolving these across classes would fabricate call edges
_METHOD_STOPLIST = frozenset({
    "run", "start", "join", "get", "put", "set", "add", "pop", "append",
    "extend", "clear", "close", "open", "read", "write", "send", "recv",
    "update", "copy", "items", "keys", "values", "acquire", "release",
    "wait", "notify", "notify_all", "is_set", "fire", "reset", "stop",
    "flush", "submit", "result", "cancel", "info", "debug", "warning",
    "error", "exception", "critical", "log", "register", "encode",
    "decode", "strip", "split", "startswith", "endswith", "format",
    "lower", "upper", "setdefault", "mkdir", "exists", "dump", "load",
    "loads", "dumps", "sleep", "name", "render", "check", "match",
    "search", "sub", "group", "count", "index", "sort", "reverse",
    "insert", "remove", "snapshot", "signature", "init", "step",
})

#: the implicit foreground root: anything callable from user/training code
MAIN_ROOT = "main"


# ---- model dataclasses -----------------------------------------------------


@dataclass(frozen=True)
class LockDef:
    """One lock object: a module-level ``NAME = threading.Lock()`` or a
    ``self.attr = threading.Lock()`` shared by every instance of a class.
    ``site`` is the (path, lineno) of the ``Lock()`` call itself — the same
    frame the runtime :mod:`.lockdep` shim keys its witness on."""

    lock_id: str            # "path::NAME" or "path::Class.attr"
    path: str
    line: int
    reentrant: bool

    @property
    def site(self) -> Tuple[str, int]:
        return (self.path, self.line)


@dataclass
class _Event:
    """One acquisition / IO / call event inside a function body, with the
    lexically-held lock set at that point."""

    kind: str               # "acquire" | "io" | "call"
    line: int
    held: Tuple[str, ...]   # lock_ids held lexically (outermost first)
    lock_id: Optional[str] = None       # acquire
    region: bool = False                # acquire via `with` (lexical region)
    desc: Optional[str] = None          # io: dotted call name
    targets: Tuple[str, ...] = ()       # call: resolved callee qualnames


@dataclass
class FuncInfo:
    qualname: str           # "path::name" / "path::Class.name" / nested "a.b"
    path: str
    name: str
    cls: Optional[str]
    node: ast.AST
    line: int
    events: List[_Event] = field(default_factory=list)
    #: (attr-or-global key, line, held) for shared-state writes
    writes: List[Tuple[str, int, Tuple[str, ...]]] = field(
        default_factory=list)


@dataclass
class _Module:
    path: str
    tree: ast.Module
    source: str
    #: module-level lock names -> LockDef
    locks: Dict[str, LockDef] = field(default_factory=dict)
    #: class name -> {attr: LockDef} for self.attr locks
    class_locks: Dict[str, Dict[str, LockDef]] = field(default_factory=dict)
    #: class name -> set of method names
    class_methods: Dict[str, Set[str]] = field(default_factory=dict)
    #: module-level `x = ClassName(...)` -> class key ("path::Class")
    instances: Dict[str, str] = field(default_factory=dict)
    #: module-level names whose assignment RHS instantiates classes:
    #: name -> [__init__ qualnames] (the import-time-singleton edge)
    ctor_vars: Dict[str, List[str]] = field(default_factory=dict)
    #: local name -> ("module", modpath) or ("name", modpath, origname)
    imports: Dict[str, Tuple] = field(default_factory=dict)
    #: module function names (top level)
    functions: Set[str] = field(default_factory=set)
    classes: Set[str] = field(default_factory=set)


@dataclass
class Program:
    """The resolved whole-program model shared by the concurrency and
    trace-coherence engines."""

    modules: Dict[str, _Module] = field(default_factory=dict)
    funcs: Dict[str, FuncInfo] = field(default_factory=dict)
    locks: Dict[str, LockDef] = field(default_factory=dict)
    #: method name -> [qualnames] across every class (unique-name fallback)
    method_index: Dict[str, List[str]] = field(default_factory=dict)
    #: thread roots: root label -> target qualname
    thread_roots: Dict[str, str] = field(default_factory=dict)
    #: signal-handler roots: root label -> handler qualname, with the
    #: registration site for the finding anchor
    signal_roots: Dict[str, Tuple[str, str, int]] = field(
        default_factory=dict)
    #: per-path suppression maps (parsed once)
    suppressions: Dict[str, Dict[int, FrozenSet[str]]] = field(
        default_factory=dict)
    suppression_problems: List[Finding] = field(default_factory=list)

    # summaries (filled by _summarize)
    callees: Dict[str, Set[str]] = field(default_factory=dict)
    #: transitive lock acquisitions: qualname -> {lock_id: witness chain}
    acquired: Dict[str, Dict[str, str]] = field(default_factory=dict)
    #: transitive IO: qualname -> witness chain (or absent)
    io: Dict[str, str] = field(default_factory=dict)
    #: roots reaching each function (bg labels + MAIN_ROOT)
    roots: Dict[str, Set[str]] = field(default_factory=dict)


# ---- module scan -----------------------------------------------------------


def _module_key(path: str) -> str:
    """Import key for cross-module resolution: posix path sans .py."""
    p = path[:-3] if path.endswith(".py") else path
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    return p


def _scan_module(path: str, source: str) -> Optional[_Module]:
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return None
    mod = _Module(path=path, tree=tree, source=source)

    # imports anywhere in the module (function-level deferred imports are
    # idiomatic here for cycle-breaking); first binding of a name wins so a
    # top-level import is never shadowed by a different nested one
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                local = alias.asname or alias.name.split(".")[0]
                mod.imports.setdefault(
                    local, ("module", alias.name.replace(".", "/")))
        elif isinstance(node, ast.ImportFrom):
            src = _resolve_from_import(path, node)
            if src is None:
                continue
            for alias in node.names:
                local = alias.asname or alias.name
                mod.imports.setdefault(local, ("name", src, alias.name))

    for node in tree.body:
        if isinstance(node, ast.FunctionDef) or \
                isinstance(node, ast.AsyncFunctionDef):
            mod.functions.add(node.name)
        elif isinstance(node, ast.ClassDef):
            mod.classes.add(node.name)
            mod.class_methods[node.name] = {
                n.name for n in node.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if isinstance(node.value, ast.Call):
                ctor = _dotted(node.value.func)
                if ctor in _LOCK_CTORS:
                    mod.locks[name] = LockDef(
                        lock_id=f"{path}::{name}", path=path,
                        line=node.value.lineno,
                        reentrant=_LOCK_CTORS[ctor],
                    )
    return mod


def _resolve_from_import(path: str, node: ast.ImportFrom) -> Optional[str]:
    """``from ..x import y`` in ``pkg/a/b.py`` -> "pkg/x" (posix module
    key); absolute imports pass through as dotted->slashed."""
    if node.level == 0:
        return node.module.replace(".", "/") if node.module else None
    base = _module_key(path).split("/")
    # level=1 strips the module name itself, each extra level one package
    base = base[: len(base) - node.level]
    if node.module:
        base += node.module.split(".")
    return "/".join(base) if base else None


# ---- function-body scan ----------------------------------------------------


class _Scope:
    """Name-resolution scope for one function: enclosing nested defs, the
    class (if a method), and the module."""

    def __init__(self, program: "Program", mod: _Module,
                 cls: Optional[str], nested: Dict[str, str]):
        self.program = program
        self.mod = mod
        self.cls = cls
        self.nested = nested  # local def name -> qualname


class _Builder:
    def __init__(self, paths: Iterable[str], rel_to: Optional[str] = None):
        self.program = Program()
        base = os.path.abspath(rel_to or os.getcwd())
        self._files: List[Tuple[str, str]] = []
        for fp in iter_py_files(paths):
            rel = os.path.relpath(os.path.abspath(fp), base)
            rel = rel.replace(os.sep, "/")
            with open(fp, encoding="utf-8") as fh:
                self._files.append((rel, fh.read()))

    def add_source(self, path: str, source: str) -> None:
        self._files.append((path, source))

    # -- pass 1: modules, locks, classes, imports
    def build(self) -> Program:
        p = self.program
        by_key: Dict[str, _Module] = {}
        for path, source in self._files:
            mod = _scan_module(path, source)
            if mod is None:
                continue
            p.modules[path] = mod
            by_key[_module_key(path)] = mod
            sup, problems = parse_suppressions(path, source)
            p.suppressions[path] = sup
            p.suppression_problems.extend(problems)
        self._by_key = by_key

        # class-level locks + instance map need imports resolved first
        for mod in p.modules.values():
            self._scan_class_locks(mod)
            self._scan_module_instances(mod)
        for mod in p.modules.values():
            for lock in mod.locks.values():
                p.locks[lock.lock_id] = lock
            for attr_locks in mod.class_locks.values():
                for lock in attr_locks.values():
                    p.locks[lock.lock_id] = lock

        # method index for the unique-name fallback
        for mod in p.modules.values():
            for cls, methods in mod.class_methods.items():
                for m in methods:
                    p.method_index.setdefault(m, []).append(
                        f"{mod.path}::{cls}.{m}")

        # -- pass 2: function bodies
        for mod in p.modules.values():
            for node in mod.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._scan_function(mod, None, node, f"{mod.path}::")
                elif isinstance(node, ast.ClassDef):
                    # request-handler classes run their handle methods on
                    # server threads (socketserver.ThreadingTCPServer /
                    # ThreadingHTTPServer): those methods are thread roots
                    handler_base = any(
                        "Handler" in (_dotted(b) or "")
                        for b in node.bases
                    )
                    for sub in node.body:
                        if isinstance(sub, (ast.FunctionDef,
                                            ast.AsyncFunctionDef)):
                            self._scan_function(
                                mod, node.name, sub,
                                f"{mod.path}::{node.name}.")
                            if handler_base and (
                                sub.name == "handle"
                                or sub.name.startswith("do_")
                            ):
                                q = f"{mod.path}::{node.name}.{sub.name}"
                                p.thread_roots[f"thread:{q}"] = q
        _summarize(p)
        return p

    def _scan_class_locks(self, mod: _Module) -> None:
        for node in mod.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            locks: Dict[str, LockDef] = {}
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                    t = sub.targets[0]
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                        and isinstance(sub.value, ast.Call)
                    ):
                        ctor = _dotted(sub.value.func)
                        if ctor in _LOCK_CTORS:
                            locks[t.attr] = LockDef(
                                lock_id=f"{mod.path}::{node.name}.{t.attr}",
                                path=mod.path, line=sub.value.lineno,
                                reentrant=_LOCK_CTORS[ctor],
                            )
            if locks:
                mod.class_locks[node.name] = locks

    def _scan_module_instances(self, mod: _Module) -> None:
        for node in mod.tree.body:
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            name = node.targets[0].id
            ctors: List[str] = []
            for call in ast.walk(node.value):
                if not isinstance(call, ast.Call):
                    continue
                cls_key = self._resolve_class(mod, call.func)
                if cls_key:
                    ctors.append(f"{cls_key}.__init__")
                    if isinstance(node.value, ast.Call) and call is node.value:
                        mod.instances[name] = cls_key
            if ctors:
                mod.ctor_vars[name] = ctors

    def _resolve_class(self, mod: _Module, func: ast.AST) -> Optional[str]:
        """Resolve a constructor expression to "path::Class" if the class
        is defined in a parsed module."""
        d = _dotted(func)
        if not d:
            return None
        head, _, rest = d.partition(".")
        if not rest and head in mod.classes:
            return f"{mod.path}::{head}"
        imp = mod.imports.get(head)
        if imp is None:
            return None
        if imp[0] == "name" and not rest:
            target = self._by_key.get(imp[1])
            if target and imp[2] in target.classes:
                return f"{target.path}::{imp[2]}"
        elif imp[0] == "module" and rest and "." not in rest:
            target = self._by_key.get(imp[1])
            if target and rest in target.classes:
                return f"{target.path}::{rest}"
        return None

    # -- function scanning

    def _scan_function(self, mod: _Module, cls: Optional[str],
                       node: ast.AST, prefix: str,
                       nested_scope: Optional[Dict[str, str]] = None) -> None:
        qualname = f"{prefix}{node.name}"
        fn = FuncInfo(qualname=qualname, path=mod.path, name=node.name,
                      cls=cls, node=node, line=node.lineno)
        self.program.funcs[qualname] = fn
        nested: Dict[str, str] = dict(nested_scope or {})
        # pre-register nested defs so forward references resolve
        for sub in node.body:
            for inner in ast.walk(sub):
                if isinstance(inner, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    nested.setdefault(inner.name, f"{qualname}.{inner.name}")
        scope = _Scope(self.program, mod, cls, nested)
        globals_declared: Set[str] = {
            g for sub in ast.walk(node) if isinstance(sub, ast.Global)
            for g in sub.names
        }
        self._scan_body(fn, scope, node.body, (), globals_declared)
        # nested defs get their own FuncInfo (fresh held set — they run when
        # called, not where defined); calls to them resolve via `nested`
        for sub in node.body:
            for inner in ast.walk(sub):
                if isinstance(inner, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and nested.get(inner.name) == \
                        f"{qualname}.{inner.name}":
                    self._scan_function(mod, cls, inner, f"{qualname}.",
                                        nested)

    def _scan_body(self, fn: FuncInfo, scope: _Scope, body: List[ast.stmt],
                   held: Tuple[str, ...], globals_declared: Set[str]) -> None:
        for stmt in body:
            self._scan_stmt(fn, scope, stmt, held, globals_declared)

    def _scan_stmt(self, fn: FuncInfo, scope: _Scope, stmt: ast.stmt,
                   held: Tuple[str, ...], globals_declared: Set[str]) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # scanned separately with a fresh held set
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            new_held = held
            for item in stmt.items:
                self._scan_expr(fn, scope, item.context_expr, new_held,
                                globals_declared)
                lock = self._resolve_lock(scope, item.context_expr)
                if lock is not None:
                    fn.events.append(_Event(
                        kind="acquire", line=item.context_expr.lineno,
                        held=new_held, lock_id=lock.lock_id, region=True))
                    new_held = new_held + (lock.lock_id,)
            self._scan_body(fn, scope, stmt.body, new_held, globals_declared)
            return
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for t in targets:
                key = self._write_key(scope, t, globals_declared)
                if key and fn.name != "__init__":
                    fn.writes.append((key, stmt.lineno, held))
            value = getattr(stmt, "value", None)
            if value is not None:
                self._scan_expr(fn, scope, value, held, globals_declared)
            return
        # generic statement: scan child statements/expressions with the
        # same held set (if/for/try/while bodies keep the lock)
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                self._scan_stmt(fn, scope, child, held, globals_declared)
            elif isinstance(child, ast.expr):
                self._scan_expr(fn, scope, child, held, globals_declared)
            elif isinstance(child, (ast.excepthandler,)):
                self._scan_body(fn, scope, child.body, held,
                                globals_declared)

    def _scan_expr(self, fn: FuncInfo, scope: _Scope, expr: ast.expr,
                   held: Tuple[str, ...], globals_declared: Set[str]) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                self._scan_call(fn, scope, node, held)
            elif isinstance(node, ast.Name) and \
                    isinstance(node.ctx, ast.Load) and \
                    node.id in scope.mod.ctor_vars:
                # reading a module var whose assignment instantiates
                # classes: the import-time-singleton edge (get_codec's
                # CODECS lookup reaches TopKCodec.__init__)
                fn.events.append(_Event(
                    kind="call", line=node.lineno, held=held,
                    targets=tuple(scope.mod.ctor_vars[node.id])))

    def _scan_call(self, fn: FuncInfo, scope: _Scope, call: ast.Call,
                   held: Tuple[str, ...]) -> None:
        dotted = _dotted(call.func)

        # lock method events: L.acquire() is an acquisition event (no
        # lexical region — conservative), L.release() is ignored
        if isinstance(call.func, ast.Attribute) and \
                call.func.attr == "acquire":
            lock = self._resolve_lock(scope, call.func.value)
            if lock is not None:
                fn.events.append(_Event(
                    kind="acquire", line=call.lineno, held=held,
                    lock_id=lock.lock_id, region=False))
                return

        # thread spawn: target is a root, not a call edge
        if dotted in _THREAD_CTORS:
            target = None
            for kw in call.keywords:
                if kw.arg == "target":
                    target = kw.value
            if target is None and dotted in ("threading.Timer", "Timer") \
                    and len(call.args) >= 2:
                target = call.args[1]
            if target is not None:
                tq = self._resolve_targets(scope, target)
                for q in tq:
                    self.program.thread_roots[f"thread:{q}"] = q
            return

        # signal handler registration
        if dotted in ("signal.signal",) and len(call.args) >= 2:
            for q in self._resolve_targets(scope, call.args[1]):
                self.program.signal_roots[f"signal:{q}"] = (
                    q, fn.path, call.lineno)
            return

        # atexit runs on the main thread: a plain call edge
        if dotted in ("atexit.register",) and call.args:
            targets = self._resolve_targets(scope, call.args[0])
            if targets:
                fn.events.append(_Event(
                    kind="call", line=call.lineno, held=held,
                    targets=tuple(targets)))
            return

        # IO?
        if dotted in _IO_CALLS or (
            isinstance(call.func, ast.Attribute)
            and call.func.attr in _IO_METHOD_SUFFIXES
        ):
            fn.events.append(_Event(
                kind="io", line=call.lineno, held=held,
                desc=dotted or call.func.attr))
            return

        # `type(x)()` re-instantiation: edges to every __init__ in the
        # defining module (get_codec's fresh-instance fix)
        if isinstance(call.func, ast.Call) and \
                _dotted(call.func.func) == "type":
            targets = [
                f"{scope.mod.path}::{c}.__init__"
                for c in sorted(scope.mod.classes)
                if "__init__" in scope.mod.class_methods.get(c, ())
            ]
            if targets:
                fn.events.append(_Event(
                    kind="call", line=call.lineno, held=held,
                    targets=tuple(targets)))
            return

        targets = self._resolve_targets(scope, call.func)
        if targets:
            fn.events.append(_Event(
                kind="call", line=call.lineno, held=held,
                targets=tuple(targets)))
        elif isinstance(call.func, ast.Attribute) and \
                not call.func.attr.startswith("__"):
            # unresolved attribute call: keep the method name so engines
            # that tolerate over-approximation (trace-coherence) can
            # expand it to every same-named method
            fn.events.append(_Event(
                kind="call", line=call.lineno, held=held,
                desc=call.func.attr))

    # -- resolution helpers

    def _resolve_lock(self, scope: _Scope, expr: ast.AST) -> \
            Optional[LockDef]:
        if isinstance(expr, ast.Name):
            lock = scope.mod.locks.get(expr.id)
            if lock is not None:
                return lock
            imp = scope.mod.imports.get(expr.id)
            if imp and imp[0] == "name":
                target = self._by_key.get(imp[1])
                if target:
                    return target.locks.get(imp[2])
            return None
        if isinstance(expr, ast.Attribute):
            base = expr.value
            if isinstance(base, ast.Name):
                if base.id == "self" and scope.cls:
                    return scope.mod.class_locks.get(
                        scope.cls, {}).get(expr.attr)
                cls_key = self._resolve_instance(scope, base.id)
                if cls_key:
                    mpath, _, cname = cls_key.partition("::")
                    target = self.program.modules.get(mpath)
                    if target:
                        return target.class_locks.get(cname, {}).get(
                            expr.attr)
                target = self._imported_module(scope, base.id)
                if target is not None:
                    return target.locks.get(expr.attr)
        return None

    def _resolve_instance(self, scope: _Scope, name: str) -> Optional[str]:
        cls_key = scope.mod.instances.get(name)
        if cls_key:
            return cls_key
        imp = scope.mod.imports.get(name)
        if imp and imp[0] == "name":
            target = self._by_key.get(imp[1])
            if target:
                return target.instances.get(imp[2])
        return None

    def _resolve_targets(self, scope: _Scope, expr: ast.AST) -> List[str]:
        """Resolve a callable expression to function qualnames."""
        if isinstance(expr, ast.Lambda):
            return []  # lambda bodies are scanned inline by _scan_expr
        if isinstance(expr, ast.Name):
            name = expr.id
            if name in scope.nested:
                return [scope.nested[name]]
            if name in scope.mod.functions:
                return [f"{scope.mod.path}::{name}"]
            cls_key = self._resolve_class(scope.mod, expr)
            if cls_key:
                mpath, _, cname = cls_key.partition("::")
                mod = self.program.modules.get(mpath)
                if mod and "__init__" in mod.class_methods.get(cname, ()):
                    return [f"{cls_key}.__init__"]
                return []
            imp = scope.mod.imports.get(name)
            if imp and imp[0] == "name":
                target = self._by_key.get(imp[1])
                if target and imp[2] in target.functions:
                    return [f"{target.path}::{imp[2]}"]
            return []
        if isinstance(expr, ast.Attribute):
            base, attr = expr.value, expr.attr
            if isinstance(base, ast.Name):
                if base.id == "self" and scope.cls:
                    if attr in scope.mod.class_methods.get(scope.cls, ()):
                        return [f"{scope.mod.path}::{scope.cls}.{attr}"]
                    return self._unique_method(attr)
                target = self._imported_module(scope, base.id)
                if target is not None and attr in target.functions:
                    return [f"{target.path}::{attr}"]
                cls_key = self._resolve_instance(scope, base.id)
                if cls_key:
                    mpath, _, cname = cls_key.partition("::")
                    mod = self.program.modules.get(mpath)
                    if mod and attr in mod.class_methods.get(cname, ()):
                        return [f"{cls_key}.{attr}"]
            return self._unique_method(attr)
        return []

    def _imported_module(self, scope: _Scope, name: str) -> \
            Optional[_Module]:
        """``import x.y as z`` and ``from pkg import mod`` both bind a
        module object to a local name."""
        imp = scope.mod.imports.get(name)
        if imp is None:
            return None
        if imp[0] == "module":
            return self._by_key.get(imp[1])
        return self._by_key.get(f"{imp[1]}/{imp[2]}")

    def _unique_method(self, attr: str) -> List[str]:
        if attr in _METHOD_STOPLIST or len(attr) < 4 or \
                attr.startswith("__"):
            return []
        hits = self.program.method_index.get(attr, [])
        return list(hits) if len(hits) == 1 else []

    def _write_key(self, scope: _Scope, target: ast.AST,
                   globals_declared: Set[str]) -> Optional[str]:
        """Shared-state key for an assignment target: a declared-global
        module variable or an instance attribute ("path::Class.attr")."""
        if isinstance(target, ast.Name) and target.id in globals_declared:
            return f"{scope.mod.path}::{target.id}"
        if isinstance(target, ast.Attribute) and \
                isinstance(target.value, ast.Name):
            base = target.value.id
            if base == "self" and scope.cls:
                return f"{scope.mod.path}::{scope.cls}.{target.attr}"
            cls_key = self._resolve_instance(scope, base)
            if cls_key:
                return f"{cls_key}.{target.attr}"
        return None


# ---- summaries (fixpoint) --------------------------------------------------


def _summarize(p: Program) -> None:
    """Call graph + transitive lock/IO summaries + root reachability."""
    for q, fn in p.funcs.items():
        callees: Set[str] = set()
        for ev in fn.events:
            if ev.kind == "call":
                callees.update(t for t in ev.targets if t in p.funcs)
        p.callees[q] = callees

    # direct summaries
    acquired: Dict[str, Dict[str, str]] = {}
    io: Dict[str, str] = {}
    for q, fn in p.funcs.items():
        acq: Dict[str, str] = {}
        for ev in fn.events:
            if ev.kind == "acquire" and ev.lock_id is not None:
                acq.setdefault(
                    ev.lock_id, f"{fn.path}:{ev.line}")
            elif ev.kind == "io" and q not in io:
                io[q] = f"{ev.desc} at {fn.path}:{ev.line}"
        acquired[q] = acq

    # fixpoint over the call graph (cycles converge: sets only grow)
    changed = True
    while changed:
        changed = False
        for q in p.funcs:
            for callee in p.callees[q]:
                for lock_id, chain in acquired.get(callee, {}).items():
                    if lock_id not in acquired[q]:
                        acquired[q][lock_id] = \
                            f"{_short(callee)} -> {chain}"
                        changed = True
                if callee in io and q not in io:
                    io[q] = f"{_short(callee)} -> {io[callee]}"
                    changed = True
    p.acquired = acquired
    p.io = io

    # root reachability
    def closure(start: str) -> Set[str]:
        seen: Set[str] = set()
        stack = [start]
        while stack:
            cur = stack.pop()
            if cur in seen or cur not in p.funcs:
                continue
            seen.add(cur)
            stack.extend(p.callees.get(cur, ()))
        return seen

    bg_reach: Dict[str, Set[str]] = {}
    for label, target in {**p.thread_roots,
                          **{k: v[0] for k, v in p.signal_roots.items()}
                          }.items():
        bg_reach[label] = closure(target)
    bg_all: Set[str] = set().union(*bg_reach.values()) if bg_reach else set()

    main_seeds = {q for q in p.funcs if q not in bg_all}
    main_reach: Set[str] = set()
    stack = list(main_seeds)
    while stack:
        cur = stack.pop()
        if cur in main_reach or cur not in p.funcs:
            continue
        main_reach.add(cur)
        stack.extend(p.callees.get(cur, ()))

    for q in p.funcs:
        roots = {label for label, reach in bg_reach.items() if q in reach}
        if q in main_reach:
            roots.add(MAIN_ROOT)
        p.roots[q] = roots


def _short(qualname: str) -> str:
    return qualname.split("::", 1)[-1]


# ---- the lock graph + rules ------------------------------------------------


def static_lock_graph(p: Program) -> Dict:
    """The static acquisition-order graph the runtime lockdep witness is
    cross-checked against: ``locks`` maps creation sites to lock ids,
    ``edges`` is the set of ordered (held, acquired) pairs with witnesses."""
    edges: Dict[Tuple[str, str], str] = {}
    for q, fn in p.funcs.items():
        for ev in fn.events:
            inner: Dict[str, str] = {}
            if ev.kind == "acquire" and ev.lock_id is not None:
                inner[ev.lock_id] = f"{fn.path}:{ev.line}"
            elif ev.kind == "call":
                for t in ev.targets:
                    for lock_id, chain in p.acquired.get(t, {}).items():
                        inner.setdefault(
                            lock_id,
                            f"{fn.path}:{ev.line} via {_short(t)} -> "
                            f"{chain}")
            for held in ev.held:
                for lock_id, chain in inner.items():
                    edges.setdefault((held, lock_id),
                                     f"{_short(q)}: {chain}")
    return {
        "locks": {lock.site: lock_id for lock_id, lock in p.locks.items()},
        "edges": edges,
    }


def _lock_regions(p: Program) -> Dict[str, List[Dict]]:
    """Per lock: every acquisition site with whether its held region does
    IO (directly or transitively) and the roots of the acquiring function."""
    regions: Dict[str, List[Dict]] = {}
    for q, fn in p.funcs.items():
        # map lexical regions: events whose held-tuple contains the lock
        # happened inside its region
        for ev in fn.events:
            if ev.kind != "acquire" or ev.lock_id is None:
                continue
            region = {
                "func": q, "path": fn.path, "line": ev.line,
                "lexical": ev.region, "io": None, "roots": p.roots.get(
                    q, set()),
            }
            regions.setdefault(ev.lock_id, []).append(region)
        for ev in fn.events:
            if not ev.held:
                continue
            io_chain = None
            if ev.kind == "io":
                io_chain = f"{ev.desc} at {fn.path}:{ev.line}"
            elif ev.kind == "call":
                for t in ev.targets:
                    if t in p.io:
                        io_chain = (f"{_short(t)} -> {p.io[t]} "
                                    f"(called at {fn.path}:{ev.line})")
                        break
            if io_chain is None:
                continue
            for held in ev.held:
                for region in regions.get(held, []):
                    if region["func"] == q and region["io"] is None:
                        region["io"] = io_chain
    return regions


def _rule(rule_id: str) -> Rule:
    for r in CONCURRENCY_RULES:
        if r.id == rule_id:
            return r
    raise KeyError(rule_id)


def run_concurrency_rules(
    paths: Optional[Iterable[str]] = None,
    rel_to: Optional[str] = None,
    program: Optional[Program] = None,
    sources: Optional[Dict[str, str]] = None,
) -> List[Finding]:
    """Build the whole-program model and run the five concurrency rules.
    ``sources`` maps path -> source for in-memory fixtures (tests)."""
    if program is None:
        builder = _Builder(paths or [], rel_to=rel_to)
        for path, source in (sources or {}).items():
            builder.add_source(path, source)
        program = builder.build()
    findings = _raw_concurrency_findings(program)
    out: List[Finding] = []
    for f in findings:
        if not is_suppressed(f, program.suppressions.get(f.path, {})):
            out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def build_program(
    paths: Optional[Iterable[str]] = None,
    rel_to: Optional[str] = None,
    sources: Optional[Dict[str, str]] = None,
) -> Program:
    builder = _Builder(paths or [], rel_to=rel_to)
    for path, source in (sources or {}).items():
        builder.add_source(path, source)
    return builder.build()


def _finding(rule: Rule, path: str, line: int, message: str,
             p: Program) -> Finding:
    mod = p.modules.get(path)
    text = ""
    if mod is not None:
        lines = mod.source.splitlines()
        if 1 <= line <= len(lines):
            text = lines[line - 1].strip()
    return Finding(rule=rule.id, path=path, line=line, message=message,
                   hint=rule.hint, text=text)


def _raw_concurrency_findings(p: Program) -> List[Finding]:
    findings: List[Finding] = []
    graph = static_lock_graph(p)
    edges: Dict[Tuple[str, str], str] = graph["edges"]

    # -- lock-order-inversion: cycles in the acquisition graph
    adj: Dict[str, Set[str]] = {}
    for (a, b), _ in edges.items():
        if a != b:
            adj.setdefault(a, set()).add(b)
    for scc in _tarjan(adj):
        if len(scc) < 2:
            continue
        cyc = sorted(scc)
        rule = _rule("lock-order-inversion")
        for (a, b), witness in sorted(edges.items()):
            if a in scc and b in scc and a != b:
                path, line = _witness_site(witness)
                findings.append(_finding(
                    rule, path, line,
                    f"lock acquisition cycle over {{{', '.join(cyc)}}}: "
                    f"this edge takes {_short(b)} while holding "
                    f"{_short(a)} ({witness}); another path takes them "
                    "in the opposite order", p))
        # anchor every edge of the cycle: fixing any one breaks it

    # -- non-reentrant-reacquire: A -> A with A non-reentrant
    rule = _rule("non-reentrant-reacquire")
    for (a, b), witness in sorted(edges.items()):
        if a == b and not p.locks[a].reentrant:
            path, line = _witness_site(witness)
            findings.append(_finding(
                rule, path, line,
                f"non-reentrant lock {_short(a)} re-acquired while held "
                f"({witness}): this deadlocks the holding thread", p))

    # -- signal-unsafe-lock
    rule = _rule("signal-unsafe-lock")
    for label, (handler, reg_path, reg_line) in sorted(
            p.signal_roots.items()):
        acq = p.acquired.get(handler, {})
        for lock_id, chain in sorted(acq.items()):
            findings.append(_finding(
                rule, reg_path, reg_line,
                f"signal handler {_short(handler)} acquires "
                f"{_short(lock_id)} ({chain}): the handler interrupts "
                "arbitrary code — including the current owner of that "
                "lock — so this can self-deadlock", p))

    # -- lock-held-io
    rule = _rule("lock-held-io")
    regions = _lock_regions(p)
    for lock_id, regs in sorted(regions.items()):
        roots: Set[str] = set()
        for r in regs:
            roots.update(r["roots"])
        if len(roots) < 2:
            continue
        has_io_free = any(r["io"] is None for r in regs)
        if not has_io_free:
            continue
        for r in regs:
            if r["io"] is None:
                continue
            findings.append(_finding(
                rule, r["path"], r["line"],
                f"blocking IO under {_short(lock_id)} "
                f"({r['io']}) while roots {{{', '.join(sorted(roots))}}} "
                "contend on an IO-free path through the same lock: the "
                "fast path wedges behind the IO", p))

    # -- unguarded-shared-write
    rule = _rule("unguarded-shared-write")
    by_key: Dict[str, List[Tuple[str, int, Tuple[str, ...], str]]] = {}
    for q, fn in p.funcs.items():
        for key, line, held in fn.writes:
            by_key.setdefault(key, []).append((fn.path, line, held, q))
    for key, writes in sorted(by_key.items()):
        roots = set()
        for _, _, _, q in writes:
            roots.update(p.roots.get(q, set()))
        if len(roots) < 2:
            continue
        common = set(writes[0][2])
        for _, _, held, _ in writes[1:]:
            common &= set(held)
        if common:
            continue
        path, line = writes[0][0], writes[0][1]
        sites = ", ".join(f"{pp}:{ll}" for pp, ll, _, _ in writes[:4])
        findings.append(_finding(
            rule, path, line,
            f"{_short(key)} written from roots "
            f"{{{', '.join(sorted(roots))}}} with no common lock "
            f"(write sites: {sites}): concurrent writers race", p))

    return findings


def _witness_site(witness: str) -> Tuple[str, int]:
    """Pull the first path:line out of a witness chain for anchoring."""
    for token in witness.replace(",", " ").split():
        if ":" in token and not token.endswith(":"):
            path, _, line = token.rpartition(":")
            if line.isdigit():
                return path, int(line)
    return "<unknown>", 0


def _tarjan(adj: Dict[str, Set[str]]) -> List[Set[str]]:
    """Strongly connected components (iterative Tarjan)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[Set[str]] = []
    counter = [0]
    nodes = set(adj) | {b for bs in adj.values() for b in bs}

    for root in sorted(nodes):
        if root in index:
            continue
        work = [(root, iter(sorted(adj.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(sorted(adj.get(nxt, ())))))
                    advanced = True
                    break
                elif nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc: Set[str] = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.add(w)
                    if w == node:
                        break
                sccs.append(scc)
    return sccs


# ---- rule catalog ----------------------------------------------------------

CONCURRENCY_RULES: List[Rule] = [
    Rule(
        id="lock-order-inversion",
        summary="two locks acquired in opposite orders on different paths "
                "(cycle in the interprocedural acquisition graph)",
        rationale="Thread A holding L1 waiting for L2 while thread B holds "
                  "L2 waiting for L1 is a deadlock that only fires under "
                  "scheduling pressure — exactly the hang class the "
                  "watchdog exists for, except the watchdog's own dump "
                  "path can be a party to it.",
        hint="impose a global acquisition order (take the coarser lock "
             "first everywhere) or narrow one critical section so the "
             "nested acquisition moves outside the outer lock",
    ),
    Rule(
        id="unguarded-shared-write",
        summary="module global / instance attribute written from >=2 "
                "thread roots with no lock common to every write",
        rationale="Two writers with no common lock means lost updates and "
                  "torn compound state; these races surface as "
                  "once-a-week corrupted telemetry or a half-updated "
                  "watchdog deadline, never in unit tests.",
        hint="guard every write with one shared lock, or confine the "
             "variable to a single owning thread and pass changes "
             "through a queue",
    ),
    Rule(
        id="lock-held-io",
        summary="blocking IO (file/socket/subprocess/time.sleep) under a "
                "lock that other thread roots contend on via IO-free "
                "paths",
        rationale="A heartbeat, watchdog or step path blocks "
                  "on a lock whose holder is mid-IO — a slow disk or "
                  "socket turns into missed heartbeats and false-positive "
                  "hang verdicts.",
        hint="snapshot the shared state under the lock, release it, then "
             "do the IO on the snapshot (the flight recorder's "
             "copy-then-dump pattern)",
    ),
    Rule(
        id="signal-unsafe-lock",
        summary="lock acquisition reachable from a signal handler",
        rationale="Signal handlers run re-entrantly on the main thread at "
                  "an arbitrary bytecode boundary: if the interrupted "
                  "code holds the same non-reentrant lock the handler "
                  "wants, the process self-deadlocks (a SIGTERM handler "
                  "that dumps the flight record under its lock).",
        hint="have the handler hand the work to a helper thread and "
             "bounded-join it (obs.recorder.maybe_install_signal_hook's "
             "pattern), or only set a flag the main loop polls",
    ),
    Rule(
        id="non-reentrant-reacquire",
        summary="a held non-reentrant threading.Lock re-acquired on the "
                "same path (directly or through a callee)",
        rationale="threading.Lock does not track ownership: re-acquiring "
                  "it from the holding thread blocks forever, and the "
                  "interprocedural variant (a helper that takes the lock "
                  "its caller already holds) is invisible in review.",
        hint="split the locked method into a public locking wrapper and a "
             "private _locked helper callers-with-the-lock use, or make "
             "the lock an RLock if re-entry is genuinely intended",
    ),
]
