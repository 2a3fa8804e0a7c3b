"""AST hot-path rule engine.

Port of ``bagua_tpu/analysis/ast_rules.py`` with the port's rule catalog.
Rules walk each module's AST once, sharing a *step hot path* analysis, the
eager counterpart of the JAX engine's traced regions (an eager step has no
trace to look in).  A function is in the step's hot path when it is

* named as one of the step's entry points (:data:`HOT_ROOTS`: the trainer's
  ``train_step`` and ``_run_step``, a module's ``forward``, an algorithm's
  per-bucket ``reduce_bucket_grad``/``traced_reduce_bucket_grad``/
  ``process_grads_bucketed``, the overlap scheduler's ``on_grad``), or the
  ``step`` of an optimizer class (a class whose base name ends in
  ``Optimizer``), which runs inside every train step;
* called or referenced from a hot function of the same module, by its bare
  name or as ``self.name`` / ``cls.name`` (the closure is per module, like
  the JAX engine's traced regions: a call into another module is not
  followed);
* or defined inside a hot function.

Each rule carries an id (the suppression and baseline key), a rationale and
a fix hint; ``python -m bagua_tpu_torch.analysis --list-rules`` prints the
catalog.  :data:`~bagua_tpu_torch.analysis.suppressions.JAX_RULE_COUNTERPARTS`
maps each JAX rule to its counterpart here.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Set

from .findings import Finding
from .suppressions import is_suppressed, parse_suppressions

#: the step's entry points, by function name
HOT_ROOTS = frozenset({
    "train_step", "_run_step", "forward", "reduce_bucket_grad",
    "traced_reduce_bucket_grad", "process_grads_bucketed", "on_grad",
})

#: import roots the port must not import (``tests/test_torch_isolation.py``)
FORBIDDEN_IMPORTS = ("jax", "jaxlib", "flax", "optax", "orbax", "pydantic",
                     "bagua_tpu")


def _dotted(node: ast.AST) -> Optional[str]:
    """``torch.cuda.synchronize`` -> "torch.cuda.synchronize"; None for
    non-name chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclass
class ModuleInfo:
    path: str          # repo-relative posix path
    source: str
    tree: ast.Module
    lines: List[str]
    #: every node lexically inside a hot-path function (identity set)
    hot_nodes: Set[int] = field(default_factory=set)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: "Rule", node: ast.AST, message: str) -> Finding:
        return Finding(
            rule=rule.id,
            path=self.path,
            line=getattr(node, "lineno", 0),
            message=message,
            hint=rule.hint,
            text=self.line_text(getattr(node, "lineno", 0)),
        )

    def in_hot(self, node: ast.AST) -> bool:
        return id(node) in self.hot_nodes


def _is_optimizer_class(node: ast.ClassDef) -> bool:
    return any((_dotted(b) or "").endswith("Optimizer") for b in node.bases)


def _mark_hot_path(info: ModuleInfo) -> None:
    """Populate ``info.hot_nodes``: the roots, then the same-module call
    closure, then everything nested in a hot function."""
    fn_types = (ast.FunctionDef, ast.AsyncFunctionDef)
    defs_by_name: Dict[str, List[ast.AST]] = {}
    roots: List[ast.AST] = []
    for node in ast.walk(info.tree):
        if isinstance(node, fn_types):
            defs_by_name.setdefault(node.name, []).append(node)
            if node.name in HOT_ROOTS:
                roots.append(node)
        elif isinstance(node, ast.ClassDef) and _is_optimizer_class(node):
            roots.extend(n for n in node.body
                         if isinstance(n, fn_types) and n.name == "step")
    hot: Dict[int, ast.AST] = {}
    stack = list(roots)
    while stack:
        fn = stack.pop()
        if id(fn) in hot:
            continue
        hot[id(fn)] = fn
        for sub in ast.walk(fn):
            # a call or a reference (``route = self._a if c else self._b``)
            name = None
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
                name = sub.id
            elif isinstance(sub, ast.Attribute) and isinstance(sub.value, ast.Name) \
                    and sub.value.id in ("self", "cls") and isinstance(sub.ctx, ast.Load):
                name = sub.attr
            if name is not None:
                stack.extend(d for d in defs_by_name.get(name, ())
                             if id(d) not in hot)
    for fn in hot.values():
        for sub in ast.walk(fn):
            info.hot_nodes.add(id(sub))


# ---- rules ---------------------------------------------------------------


@dataclass(frozen=True)
class Rule:
    id: str
    summary: str
    rationale: str
    hint: str

    def visit(self, info: ModuleInfo) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError


class HostSyncInStep(Rule):
    """A host synchronization in the step's hot path: the counterpart of
    ``host-sync-in-trace``."""

    #: tensor methods that copy to the host and wait for the device
    _SYNC_METHODS = ("item", "cpu", "tolist")
    #: tensor reductions whose ``float()``/``int()``/``bool()`` reads back
    _REDUCTIONS = ("sum", "mean", "max", "min", "amax", "amin", "norm",
                   "abs", "std", "var", "prod", "all", "any", "numel_nonzero")

    def visit(self, info: ModuleInfo) -> Iterator[Finding]:
        for node in ast.walk(info.tree):
            if not (isinstance(node, ast.Call) and info.in_hot(node)):
                continue
            dotted = _dotted(node.func) or ""
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in self._SYNC_METHODS and not node.args:
                yield info.finding(
                    self, node,
                    f"`.{node.func.attr}()` in the step's hot path copies to "
                    "the host and waits for the device",
                )
            elif dotted.endswith("cuda.synchronize"):
                yield info.finding(
                    self, node,
                    "`torch.cuda.synchronize` in the step's hot path stalls "
                    "the host until the device drains",
                )
            elif dotted in ("float", "int", "bool") and len(node.args) == 1 \
                    and self._reads_tensor(node.args[0]):
                yield info.finding(
                    self, node,
                    f"`{dotted}()` of a tensor reduction in the step's hot "
                    "path is a device-to-host read",
                )

    def _reads_tensor(self, arg: ast.AST) -> bool:
        """A reduction call on some value (``x.sum()``, ``t.max()``): the
        shape a tensor read takes; names and constants are not flagged
        (their type is unknown statically)."""
        return isinstance(arg, ast.Call) and isinstance(arg.func, ast.Attribute) \
            and arg.func.attr in self._REDUCTIONS


class RawEnvRead(Rule):
    """Ad-hoc ``BAGUA_*`` environment reads outside the registry."""

    def _bagua_const(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value.startswith("BAGUA_"):
            return node.value
        return None

    def visit(self, info: ModuleInfo) -> Iterator[Finding]:
        if info.path.replace(os.sep, "/").endswith("bagua_tpu_torch/env.py"):
            return
        for node in ast.walk(info.tree):
            var = None
            if isinstance(node, ast.Call):
                dotted = _dotted(node.func)
                if dotted and (
                    dotted.endswith("environ.get") or dotted.endswith("getenv")
                ) and node.args:
                    var = self._bagua_const(node.args[0])
            elif isinstance(node, ast.Subscript):
                dotted = _dotted(node.value)
                if dotted and dotted.endswith("environ"):
                    var = self._bagua_const(node.slice)
            if var:
                yield info.finding(
                    self, node,
                    f"raw os.environ read of {var} outside the env registry",
                )


class PyRngInStep(Rule):
    """Unseeded global Python/NumPy RNG in the step's hot path: the
    counterpart of ``py-rng-in-trace``."""

    _PREFIXES = ("random.", "np.random.", "numpy.random.")
    #: constructors of a seeded generator object: an explicit stream is fine
    _SEEDED = ("np.random.default_rng", "numpy.random.default_rng",
               "np.random.RandomState", "numpy.random.RandomState",
               "random.Random", "np.random.Generator", "numpy.random.Generator")

    def visit(self, info: ModuleInfo) -> Iterator[Finding]:
        for node in ast.walk(info.tree):
            if not (isinstance(node, ast.Call) and info.in_hot(node)):
                continue
            dotted = _dotted(node.func)
            if dotted and dotted.startswith(self._PREFIXES) and \
                    dotted not in self._SEEDED:
                yield info.finding(
                    self, node,
                    f"`{dotted}` in the step's hot path draws from the "
                    "process-global stream: each rank draws a different "
                    "sample",
                )

class DupLambda(Rule):
    """Copy-pasted helper lambdas within one module."""

    #: minimum identical copies before the duplication is worth a finding
    MIN_COPIES = 3

    def _shape(self, node: ast.Lambda) -> Optional[str]:
        # normalize argument names positionally so `lambda t: f(t)` and
        # `lambda u: f(u)` dedupe; trivial lambdas (no call in the body)
        # are idiom, not duplication
        if not any(isinstance(n, ast.Call) for n in ast.walk(node.body)):
            return None
        clone = ast.parse(ast.unparse(node), mode="eval").body
        rename = {
            a.arg: f"_a{i}" for i, a in enumerate(clone.args.args)
        }
        for sub in ast.walk(clone):
            if isinstance(sub, ast.Name) and sub.id in rename:
                sub.id = rename[sub.id]
            elif isinstance(sub, ast.arg) and sub.arg in rename:
                sub.arg = rename[sub.arg]
        return ast.dump(clone)

    def visit(self, info: ModuleInfo) -> Iterator[Finding]:
        # outermost lambdas only: a duplicated outer lambda would otherwise
        # drag its inner lambdas into their own duplicate groups, double-
        # reporting every site
        nested: Set[int] = set()
        for node in ast.walk(info.tree):
            if isinstance(node, ast.Lambda):
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Lambda) and sub is not node:
                        nested.add(id(sub))
        groups: Dict[str, List[ast.Lambda]] = {}
        for node in ast.walk(info.tree):
            if isinstance(node, ast.Lambda) and id(node) not in nested:
                shape = self._shape(node)
                if shape:
                    groups.setdefault(shape, []).append(node)
        for nodes in groups.values():
            if len(nodes) < self.MIN_COPIES:
                continue
            first = min(n.lineno for n in nodes)
            for node in nodes:
                yield info.finding(
                    self, node,
                    f"lambda duplicated {len(nodes)}x in this module "
                    f"(first at line {first})",
                )


class PerStepReflatten(Rule):
    """Per-step re-flattening in the step's hot path.

    The flat-resident layout exists so that the step never re-packs
    parameters or gradients into flat buffers; a hot-path function that BOTH
    flattens tensors (``.reshape(-1)``, ``.view(-1)``, ``.flatten()``,
    ``.ravel()``, ``parameters_to_vector``, ``_flatten_dense_tensors``) AND
    concatenates (``torch.cat``) re-pays exactly that cost every step.  An
    optimizer's ``step`` runs in every train step, so it counts as hot (the
    JAX rule's ``optax.GradientTransformation`` case)."""

    _FLATTEN_METHODS = ("flatten", "ravel")
    _FLATTEN_CALLS = ("parameters_to_vector", "_flatten_dense_tensors")
    _CONCAT_SUFFIXES = ("cat", "concatenate", "concat")

    def _is_flatten(self, node: ast.Call) -> bool:
        dotted = _dotted(node.func) or ""
        if dotted.endswith(self._FLATTEN_CALLS):
            return True
        f = node.func
        if not isinstance(f, ast.Attribute):
            return False
        if f.attr in self._FLATTEN_METHODS and not node.args:
            return True
        return f.attr in ("reshape", "view") and len(node.args) == 1 and \
            isinstance(node.args[0], ast.UnaryOp) and \
            isinstance(node.args[0].op, ast.USub) and \
            isinstance(node.args[0].operand, ast.Constant) and \
            node.args[0].operand.value == 1

    def visit(self, info: ModuleInfo) -> Iterator[Finding]:
        fn_types = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        for f in ast.walk(info.tree):
            if not isinstance(f, fn_types):
                continue
            inner: Set[int] = set()
            for sub in ast.walk(f):
                if sub is not f and isinstance(sub, fn_types):
                    inner.update(id(s) for s in ast.walk(sub))
            flattens: List[ast.Call] = []
            concats: List[ast.Call] = []
            for node in ast.walk(f):
                if id(node) in inner or not isinstance(node, ast.Call) or \
                        not info.in_hot(node):
                    continue
                dotted = _dotted(node.func) or ""
                if self._is_flatten(node):
                    flattens.append(node)
                elif dotted.split(".")[-1] in self._CONCAT_SUFFIXES and \
                        dotted.startswith(("torch.", "np.", "numpy.")):
                    concats.append(node)
            if flattens and concats:
                yield info.finding(
                    self, concats[0],
                    "step hot-path code flattens tensors (line "
                    f"{flattens[0].lineno}) and concatenates every step: "
                    "the repack the flat-resident layout exists to remove",
                )


class UnregisteredCounter(Rule):
    """Telemetry counter/gauge names must be declared in
    ``bagua_tpu_torch.obs.export.METRIC_REGISTRY``.

    Checks ``<...>counters.incr/set_gauge`` call sites (plus literal-keyed
    ``incr_many`` dicts).  Literal names are matched exactly; f-string
    names (``f"faults/{point}/fired"``) are matched as a pattern — some
    registered name must fit the template; non-literal names are skipped
    (unresolvable statically).  The registry import is lazy and
    import-light (no torch), so the engine runs anywhere."""

    _METHODS = ("incr", "set_gauge", "incr_many")

    @staticmethod
    def _is_counters_call(node: ast.Call) -> bool:
        f = node.func
        if not (isinstance(f, ast.Attribute)
                and f.attr in UnregisteredCounter._METHODS):
            return False
        recv = _dotted(f.value)
        return bool(recv) and (recv == "counters"
                               or recv.endswith(".counters")
                               or recv.endswith("_counters"))

    @staticmethod
    def _name_exprs(node: ast.Call):
        if not node.args:
            return
        arg = node.args[0]
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "incr_many":
            if isinstance(arg, ast.Dict):
                for key in arg.keys:
                    if key is not None:
                        yield key
            return
        yield arg

    def _check_name(self, expr: ast.AST):
        """(metric-name-or-pattern, unregistered?) — None to skip."""
        from ..obs.export import any_registered_matches, is_registered

        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return expr.value, not is_registered(expr.value)
        if isinstance(expr, ast.JoinedStr):
            parts: List[str] = []
            for v in expr.values:
                if isinstance(v, ast.Constant):
                    parts.append(re.escape(str(v.value)))
                else:  # FormattedValue: any non-empty fragment
                    parts.append(".+")
            pattern = "".join(parts)
            return pattern, not any_registered_matches(pattern)
        return None

    def visit(self, info: ModuleInfo) -> Iterator[Finding]:
        for node in ast.walk(info.tree):
            if not (isinstance(node, ast.Call)
                    and self._is_counters_call(node)):
                continue
            for expr in self._name_exprs(node):
                checked = self._check_name(expr)
                if checked is None:
                    continue
                name, unregistered = checked
                if unregistered:
                    yield info.finding(
                        self, node,
                        f"counter name {name!r} is not declared in "
                        "obs.export.METRIC_REGISTRY",
                    )


class JaxImport(Rule):
    """No import of JAX, its libraries or the JAX package in the port: the
    counterpart of ``torch-import`` (the list of
    ``tests/test_torch_isolation.py``)."""

    def visit(self, info: ModuleInfo) -> Iterator[Finding]:
        for node in ast.walk(info.tree):
            roots: List[str] = []
            if isinstance(node, ast.ImportFrom):
                if node.level == 0 and node.module:
                    roots.append(node.module.split(".")[0])
            elif isinstance(node, ast.Import):
                roots.extend(a.name.split(".")[0] for a in node.names)
            for root in roots:
                if root in FORBIDDEN_IMPORTS:
                    yield info.finding(
                        self, node, f"{root} import in the torch port")


RULES: List[Rule] = [
    HostSyncInStep(
        id="host-sync-in-step",
        summary="host sync (`.item()`, `.cpu()`, `.tolist()`, "
                "`torch.cuda.synchronize`, `float()` of a tensor reduction) "
                "in the step's hot path",
        rationale="A host sync in the step stops the host from queueing "
                  "the next kernels until the device drains: the overlap "
                  "scheduler and the comm stream lose the work they exist "
                  "to hide.  The port's deliberate syncs (the grad guard's "
                  "verdict, the autotune check-in's one sync, the MoE "
                  "exact-count read) carry a suppression with the reason.",
        hint="keep readbacks off the step (batch them at a cadence, or "
             "fence with an event the host polls); suppress a deliberate "
             "one with `# bagua: lint-ignore[host-sync-in-step] -- why`",
    ),
    RawEnvRead(
        id="raw-env-read",
        summary="`os.environ` read of a `BAGUA_*` name outside `env.py`",
        rationale="Scattered env reads drift from the documented defaults "
                  "and types; the registry in `bagua_tpu_torch.env` is the "
                  "single source of truth.",
        hint="declare the variable in `env.ENV_REGISTRY` and read it "
             "through an `env.*` accessor",
    ),
    PyRngInStep(
        id="py-rng-in-step",
        summary="unseeded global Python/NumPy RNG call in the step's hot "
                "path",
        rationale="`random.*`/`np.random.*` draw from the process-global "
                  "stream: each rank draws a different sample, a silent "
                  "divergence between ranks that must stay in lockstep.",
        hint="draw from a generator seeded identically on every rank "
             "(`np.random.default_rng(seed)`, `torch.Generator`)",
    ),
    DupLambda(
        id="dup-lambda",
        summary="identical helper lambda copy-pasted 3+ times in a module",
        rationale="Copy-pasted helpers drift independently (one gets a "
                  "fix, its clones keep the bug).",
        hint="hoist one module-level helper and call it everywhere",
    ),
    PerStepReflatten(
        id="per-step-reflatten",
        summary="step hot-path code re-flattens tensors (`.reshape(-1)`/"
                "`.flatten()`/`parameters_to_vector` + `torch.cat`) every "
                "step",
        rationale="Re-packing parameters or gradients into flat buffers in "
                  "the step re-pays, every step, the round trip the "
                  "flat-resident layout removed; an optimizer's `step` runs "
                  "in every train step, so it counts as step code.",
        hint="keep the state bucket-flat across steps (`flat_resident=`) "
             "instead of re-packing per step",
    ),
    UnregisteredCounter(
        id="unregistered-counter",
        summary="`counters.incr`/`set_gauge` with a name not declared in "
                "obs.export.METRIC_REGISTRY",
        rationale="A typo'd metric name silently forks a counter nobody "
                  "reads; the registry is the single source of truth for "
                  "metric names, kinds and docs.",
        hint="declare the name in bagua_tpu_torch.obs.export."
             "METRIC_REGISTRY (kind + doc) or fix the spelling",
    ),
    JaxImport(
        id="jax-import",
        summary="import of jax, jaxlib, flax, optax, orbax, pydantic or "
                "bagua_tpu inside bagua_tpu_torch",
        rationale="The port stands alone on torch and numpy; one such "
                  "import is an ImportError on the card's host, which has "
                  "no JAX.",
        hint="keep a copy of what the port needs in its own package",
    ),
]


# ---- engine --------------------------------------------------------------


def iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            yield p
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in ("__pycache__", ".git", ".pytest_cache")
                )
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)


def analyze_source(
    path: str, source: str, rules: Optional[List[Rule]] = None
) -> List[Finding]:
    """Run the rules over one module's source.  Returns ACTIVE findings
    (suppressions already applied; malformed suppressions reported)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(
            rule="syntax-error", path=path, line=e.lineno or 0,
            message=f"cannot parse: {e.msg}", text="",
        )]
    info = ModuleInfo(
        path=path, source=source, tree=tree, lines=source.splitlines()
    )
    _mark_hot_path(info)
    suppressions, problems = parse_suppressions(path, source)
    findings: List[Finding] = list(problems)
    for rule in (RULES if rules is None else rules):
        for f in rule.visit(info):
            if not is_suppressed(f, suppressions):
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def run_ast_rules(
    paths: Iterable[str],
    rules: Optional[List[Rule]] = None,
    rel_to: Optional[str] = None,
) -> List[Finding]:
    """Run the engine over files/directories; paths in findings are made
    relative to ``rel_to`` (default: cwd) and posix-normalized."""
    base = os.path.abspath(rel_to or os.getcwd())
    findings: List[Finding] = []
    for fp in iter_py_files(paths):
        rel = os.path.relpath(os.path.abspath(fp), base)
        rel = rel.replace(os.sep, "/")
        with open(fp, encoding="utf-8") as fh:
            source = fh.read()
        findings.extend(analyze_source(rel, source, rules))
    return findings
