"""Step-cache-key coherence prover, over the port's cached step state.

Port of ``bagua_tpu/analysis/trace_coherence.py``.  The JAX trainer caches
compiled steps by ``_step_key()``, and every knob that shapes the traced
program must ride that key.  The eager port compiles nothing; what it caches
is the algorithm context (``BaguaTrainer._ctx``: the bucket plan's
communicator, codecs, overlap, chunk targets, layout), built by
``_make_ctx`` and rebuilt from the knobs by ``_refresh_ctx`` (which the
autotune check-in's ``_apply_recommendation`` calls), and the step key
``self._step_key = (ctx.plan, phase, ...)`` that ``train_step`` compares to
start a new build window (``core/backend.py:579, 1412``).  A knob that
shapes the context without riding the key or triggering the rebuild means a
flip keeps running the stale context: the wrong codec or layout at full
speed.

The engine enumerates the knob sources that can change the cached state
*after* trainer construction:

* **env accessors** reached by the context-construction closure (the call
  closure of ``_make_ctx``): environment variables can flip between steps;
* **trainer attributes mutated by the autotune recommendation path**
  (``_apply_recommendation`` and the methods it calls) that the closure
  reads.  Constructor-frozen attributes are exempt without annotation.

A knob is coherent when it rides the key (the key tuple reads it: the
attribute itself, a context field ``_make_ctx`` fills from it, or the env
accessor), or, for a mutable attribute, when the recommendation path calls
the rebuild (``_refresh_ctx``).  Otherwise ``trace-knob-not-keyed`` is
reported.  Knobs that provably do not shape the cached state carry an
annotation::

    self.thing = env.get_thing()  # bagua: trace-invariant[get_thing] -- why

naming an env accessor, the raw ``BAGUA_*`` variable or the attribute; the
``-- reason`` is mandatory (``bad-trace-invariant`` otherwise).  The anchor
is found structurally, as in the JAX engine: the class defining both
``_make_ctx`` (the construction) and ``_refresh_ctx`` (the rebuild), so the
engine runs unchanged on synthetic fixtures.  The key is the value assigned
to ``self._step_key`` in the anchor class (a ``_step_key`` method is read as
in the JAX engine).
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .ast_rules import Rule, _dotted
from .findings import Finding
from .concurrency import (
    _METHOD_STOPLIST,
    FuncInfo,
    Program,
    build_program,
)
from .suppressions import is_suppressed

#: ``# bagua: trace-invariant[name] -- reason``
_ANNOT_RE = re.compile(
    r"#\s*bagua:\s*trace-invariant\[([^\]]*)\]\s*(?:--\s*(\S.*))?"
)

#: the typed read primitives of the env registry: a module function whose
#: body calls one of these with a BAGUA_* literal is an env accessor
_ENV_PRIMITIVES = frozenset({
    "env_int", "env_float", "env_bool", "env_enum", "env_str",
    "env_seconds_or_off", "_raw",
})

#: modules the step-construction closure does NOT follow into: the
#: observability/coordination planes are host-side by construction (their
#: env knobs shape exporters and watchdogs, never the cached step state), and
#: following them would drag every BAGUA_OBS_* accessor into scope
_PRUNE_SEGMENTS = (
    "/obs/", "/elastic/", "/serve/", "/service/",
    "telemetry.py", "watchdog.py", "autopilot",
)

#: expansion cap for unresolved attribute calls — a method name defined on
#: more than this many classes is too ambiguous to follow
_FALLBACK_FANOUT_CAP = 8


def _pruned(path: str) -> bool:
    return any(seg in path or path.endswith(seg.lstrip("/"))
               for seg in _PRUNE_SEGMENTS)


# ---- annotations -----------------------------------------------------------


def collect_annotations(
    p: Program,
) -> Tuple[Set[str], List[Finding]]:
    """Scan every module for trace-invariant annotations.  Returns the set
    of annotated names and the malformed-annotation findings."""
    names: Set[str] = set()
    problems: List[Finding] = []
    for path, mod in p.modules.items():
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(mod.source).readline))
        except (tokenize.TokenizeError, SyntaxError, IndentationError):
            continue
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _ANNOT_RE.search(tok.string)
            if not m:
                continue
            lineno, line = tok.start[0], tok.line.rstrip("\n")
            declared = {n.strip() for n in m.group(1).split(",")
                        if n.strip()}
            reason = (m.group(2) or "").strip()
            if not declared or not reason:
                problems.append(Finding(
                    rule="bad-trace-invariant", path=path, line=lineno,
                    message="malformed trace-invariant: need at least one "
                            "knob name and a `-- reason`",
                    hint="write `# bagua: trace-invariant[name] -- why "
                         "this knob cannot change the cached state`",
                    text=line.strip(),
                ))
                continue
            names.update(declared)
    return names, problems


# ---- env accessor discovery ------------------------------------------------


def _env_accessors(p: Program) -> Dict[str, str]:
    """qualname of accessor function -> BAGUA_* variable it reads."""
    out: Dict[str, str] = {}
    for q, fn in p.funcs.items():
        if fn.cls is not None or q != f"{fn.path}::{fn.name}":
            continue
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func)
            if d is None or d.split(".")[-1] not in _ENV_PRIMITIVES:
                continue
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and \
                        isinstance(arg.value, str) and \
                        arg.value.startswith("BAGUA_"):
                    out[q] = arg.value
    return out


# ---- anchor class ----------------------------------------------------------


#: the anchor's construction and rebuild methods
CONSTRUCT = "_make_ctx"
REBUILD = "_refresh_ctx"
RECOMMEND = "_apply_recommendation"
KEY_ATTR = "_step_key"


def _find_anchor(p: Program) -> Optional[Tuple[str, str]]:
    """(module path, class name) of the class defining both ``_make_ctx``
    and ``_refresh_ctx``."""
    for path, mod in p.modules.items():
        for cls, methods in mod.class_methods.items():
            if CONSTRUCT in methods and REBUILD in methods:
                return path, cls
    return None


def _key_expressions(p: Program, prefix: str) -> List[ast.AST]:
    """The expressions of the step key: each value assigned to
    ``self._step_key`` in the anchor's methods (a bare name followed back to
    its assignment in the same method)."""
    out: List[ast.AST] = []
    for q, fn in p.funcs.items():
        if not q.startswith(prefix):
            continue
        assigns: Dict[str, ast.AST] = {}
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if isinstance(t, ast.Name):
                    assigns[t.id] = node.value
        for node in ast.walk(fn.node):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            t = node.targets[0]
            if isinstance(t, ast.Attribute) and t.attr == KEY_ATTR and \
                    isinstance(t.value, ast.Name) and t.value.id == "self":
                value = node.value
                if isinstance(value, ast.Name) and value.id in assigns:
                    value = assigns[value.id]
                if not (isinstance(value, ast.Constant) and value.value is None):
                    out.append(value)
    return out


def _ctx_fields(p: Program, prefix: str) -> Dict[str, Set[str]]:
    """Context field -> the trainer attributes ``_make_ctx`` fills it from
    (the keywords of the constructor call it returns)."""
    fn = p.funcs.get(f"{prefix}{CONSTRUCT}")
    out: Dict[str, Set[str]] = {}
    if fn is None:
        return out
    for node in ast.walk(fn.node):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Call):
            for kw in node.value.keywords:
                if kw.arg:
                    out[kw.arg] = _self_attr_reads_of(kw.value)
    return out


def _self_attr_reads_of(tree: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Attribute):
            continue
        parts: List[str] = []
        cur: ast.AST = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if isinstance(cur, ast.Name) and cur.id == "self" and parts:
            parts.reverse()
            out.add(parts[0])
            if len(parts) >= 2:
                out.add(".".join(parts[:2]))
    return out


def _class_closure(p: Program, path: str, cls: str,
                   start: str) -> Set[str]:
    """Transitive same-class method closure from one method (used to
    expand ``_step_key``'s helpers and ``_apply_recommendation``'s)."""
    prefix = f"{path}::{cls}."
    seen: Set[str] = set()
    stack = [start]
    while stack:
        q = stack.pop()
        if q in seen or q not in p.funcs:
            continue
        seen.add(q)
        for callee in p.callees.get(q, ()):
            if callee.startswith(prefix):
                stack.append(callee)
    return seen


def _self_attr_reads(fn: FuncInfo) -> Set[str]:
    """Dotted ``self.X`` / ``self.X.Y`` attribute paths loaded in a
    method (depth 2)."""
    return _self_attr_reads_of(fn.node)


def _self_attr_writes(fn: FuncInfo) -> Set[Tuple[str, int]]:
    """(dotted attr path, line) for ``self.X[.Y] = ...`` assignments,
    including ``setattr(self, "X", ...)`` with a literal name."""
    out: Set[Tuple[str, int]] = set()
    for node in ast.walk(fn.node):
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        elif isinstance(node, ast.Call) and \
                _dotted(node.func) == "setattr" and \
                len(node.args) >= 2 and \
                isinstance(node.args[0], ast.Name) and \
                node.args[0].id == "self" and \
                isinstance(node.args[1], ast.Constant) and \
                isinstance(node.args[1].value, str):
            out.add((node.args[1].value, node.lineno))
            continue
        for t in targets:
            parts: List[str] = []
            cur: ast.AST = t
            while isinstance(cur, ast.Attribute):
                parts.append(cur.attr)
                cur = cur.value
            if isinstance(cur, ast.Name) and cur.id == "self" and parts:
                parts.reverse()
                out.add((".".join(parts[:2]), t.lineno))
    return out


# ---- the step-construction closure -----------------------------------------


def _construction_closure(
    p: Program, start: str,
) -> Dict[str, Tuple[str, int, str]]:
    """BFS from ``start`` (``_make_ctx``) over the call graph, with the
    trace-engine extras: unresolved attribute calls expand to every
    same-named method (capped), and pruned host-side modules are not
    followed.  Returns {qualname: (witness path, line, chain)}."""
    seen: Dict[str, Tuple[str, int, str]] = {}
    fn0 = p.funcs[start]
    queue: List[Tuple[str, str]] = [(start, fn0.name)]
    seen[start] = (fn0.path, fn0.line, fn0.name)
    while queue:
        q, chain = queue.pop(0)
        fn = p.funcs[q]
        for ev in fn.events:
            if ev.kind != "call":
                continue
            targets = list(ev.targets)
            if not targets and ev.desc and \
                    ev.desc not in _METHOD_STOPLIST and len(ev.desc) >= 4:
                hits = p.method_index.get(ev.desc, [])
                if 1 <= len(hits) <= _FALLBACK_FANOUT_CAP:
                    targets = hits
            for t in targets:
                if t in seen or t not in p.funcs:
                    continue
                tf = p.funcs[t]
                if _pruned(tf.path):
                    continue
                link = f"{chain} -> {tf.name}"
                seen[t] = (fn.path, ev.line, link)
                queue.append((t, link))
    return seen


# ---- engine ----------------------------------------------------------------


def run_trace_coherence(
    paths: Optional[Iterable[str]] = None,
    rel_to: Optional[str] = None,
    program: Optional[Program] = None,
    sources: Optional[Dict[str, str]] = None,
) -> List[Finding]:
    if program is None:
        program = build_program(paths, rel_to=rel_to, sources=sources)
    findings = _raw_trace_findings(program)
    out: List[Finding] = []
    for f in findings:
        if not is_suppressed(f, program.suppressions.get(f.path, {})):
            out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def _raw_trace_findings(p: Program) -> List[Finding]:
    annotated, findings = collect_annotations(p)
    anchor = _find_anchor(p)
    if anchor is None:
        return findings
    path, cls = anchor
    prefix = f"{path}::{cls}."
    accessors = _env_accessors(p)
    by_name: Dict[str, Set[str]] = {}
    for acc in accessors:
        by_name.setdefault(p.funcs[acc].name, set()).add(acc)

    # -- the key composition: what the key tuple reads directly (attributes,
    # context fields mapped back to the attributes _make_ctx fills them
    # from, env accessors called in it); a `_step_key` method, as in the JAX
    # engine, with its same-class helpers
    key_attrs: Set[str] = set()
    key_env: Set[str] = set()
    fields = _ctx_fields(p, prefix)
    exprs = _key_expressions(p, prefix)
    if f"{prefix}{KEY_ATTR}" in p.funcs:
        for q in _class_closure(p, path, cls, f"{prefix}{KEY_ATTR}"):
            exprs.append(p.funcs[q].node)
    for expr in exprs:
        key_attrs |= _self_attr_reads_of(expr)
        for node in ast.walk(expr):
            if isinstance(node, ast.Attribute) and node.attr in fields and \
                    not (isinstance(node.value, ast.Name) and node.value.id == "self"):
                key_attrs |= fields[node.attr]
            elif isinstance(node, ast.Call):
                d = _dotted(node.func)
                if d is not None:
                    key_env |= by_name.get(d.split(".")[-1], set())

    # -- the context-construction closure
    start = f"{prefix}{CONSTRUCT}"
    closure = _construction_closure(p, start) if start in p.funcs else {}

    env_hits: Dict[str, Tuple[str, int, str]] = {}
    for q, (wpath, wline, chain) in closure.items():
        for ev in p.funcs[q].events:
            if ev.kind != "call":
                continue
            for t in ev.targets:
                if t in accessors and t not in env_hits:
                    env_hits[t] = (p.funcs[q].path, ev.line,
                                   f"{chain} -> {p.funcs[t].name}")

    rule = _rule("trace-knob-not-keyed")
    for acc, (wpath, wline, chain) in sorted(env_hits.items()):
        if acc in key_env:
            continue
        var = accessors[acc]
        acc_name = p.funcs[acc].name
        if {var, acc_name} & annotated:
            continue
        findings.append(Finding(
            rule=rule.id, path=wpath, line=wline,
            message=f"{var} (via {acc_name}) shapes the cached context "
                    f"({chain}) but does not ride the step key: an env "
                    "flip keeps the stale context",
            hint=rule.hint,
            text=_line_text(p, wpath, wline),
        ))

    # -- mutable trainer attrs: the autotune recommendation path
    rec = f"{prefix}{RECOMMEND}"
    mutable: Dict[str, Tuple[str, int]] = {}
    rebuilds = False
    if rec in p.funcs:
        rec_closure = _class_closure(p, path, cls, rec)
        rebuilds = f"{prefix}{REBUILD}" in rec_closure
        for q in rec_closure:
            for attr, line in _self_attr_writes(p.funcs[q]):
                mutable.setdefault(attr, (p.funcs[q].path, line))

    closure_attrs: Set[str] = set()
    for q in closure:
        if q.startswith(prefix):
            closure_attrs |= _self_attr_reads(p.funcs[q])

    for attr, (wpath, wline) in sorted(mutable.items()):
        base = attr.split(".")[0]
        if attr not in closure_attrs and base not in closure_attrs:
            continue  # mutated but never read during construction
        if rebuilds:
            continue  # the recommendation path rebuilds the context
        if attr in key_attrs or (("." in attr) and base in key_attrs):
            continue
        if {attr, base} & annotated:
            continue
        findings.append(Finding(
            rule=rule.id, path=wpath, line=wline,
            message=f"self.{attr} is mutated by the autotune "
                    "recommendation path and read by the context's "
                    "construction, but neither rides the step key nor "
                    f"triggers {REBUILD}: the recommendation keeps running "
                    "the stale context",
            hint=rule.hint,
            text=_line_text(p, wpath, wline),
        ))

    return findings


def _line_text(p: Program, path: str, line: int) -> str:
    mod = p.modules.get(path)
    if mod is None:
        return ""
    lines = mod.source.splitlines()
    return lines[line - 1].strip() if 1 <= line <= len(lines) else ""


def _rule(rule_id: str) -> Rule:
    for r in TRACE_RULES:
        if r.id == rule_id:
            return r
    raise KeyError(rule_id)


TRACE_RULES: List[Rule] = [
    Rule(
        id="trace-knob-not-keyed",
        summary="a knob (env accessor or autotune-mutable trainer attr) "
                "shapes the cached context but neither rides the step key "
                "nor triggers the rebuild",
        rationale="The trainer keeps its context until the key changes "
                  "or the check-in rebuilds it; a knob that shapes the "
                  "context otherwise means a flip keeps running the stale "
                  "codec, layout or overlap (the JAX package's "
                  "BAGUA_TOPK_RATIO freeze, where changed payload shapes "
                  "never retraced).",
        hint="add the knob (or the context field derived from it) to the "
             "step key, call _refresh_ctx after mutating it, or annotate "
             "the read site `# bagua: trace-invariant[name] -- reason` if "
             "it provably cannot alter the cached state",
    ),
    Rule(
        id="bad-trace-invariant",
        summary="malformed trace-invariant annotation (missing knob name "
                "or `-- reason`)",
        rationale="An unexplained invariant claim is indistinguishable "
                  "from silencing the prover; the reason is the review "
                  "surface.",
        hint="write `# bagua: trace-invariant[name] -- why this knob "
             "cannot change the cached state`",
    ),
]
