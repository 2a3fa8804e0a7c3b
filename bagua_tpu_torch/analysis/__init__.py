"""bagua-lint over the port: static analysis for collective consistency and
hot-path hygiene.

Port of ``bagua_tpu/analysis``.  The port has several constructions of one
algorithm step (serialized, overlap-streamed, chunked rings, two tiers); a
silent divergence in their collectives, or between ranks, is a deadlock or
a wrong gradient that no single-process test sees.  The engines:

* :mod:`.collective_check` (counterpart of ``jaxpr_check.py``): eager torch
  has no jaxpr, so every blocking call of ``BaguaCommunicator`` is recorded
  at its one seam (``communication._watched``) as (op, the group's mesh
  axes, dtype, shape) without a device sync; a sweep runs each family's
  serialized and overlapped step on CPU gloo ranks and checks that both
  issue the same multiset of collectives, that every axis is bound on the
  mesh, that every rank issues the same sequence, and accounts the bytes of
  each bucket against the plan.
* :mod:`.ast_rules`: per-module rules over the package source: host syncs
  in the step's hot path, raw ``BAGUA_*`` env reads outside the registry,
  unseeded RNG in the step, copy-pasted lambdas, per-step re-flattening,
  unregistered counters and imports of JAX or the JAX package.
* :mod:`.concurrency`: the whole-program host-concurrency model (thread
  roots, the lock acquisition graph, shared mutable state).
* :mod:`.trace_coherence`: every env knob or autotune-mutable trainer
  attribute that shapes the cached step state rides the step key or
  triggers the context's rebuild.
* :mod:`.lockdep`: the opt-in (``BAGUA_LOCKDEP=on``) runtime witness of real
  lock orders, cross-checked against the static graph (``--witness``).

Run as ``python -m bagua_tpu_torch.analysis [paths]`` (default: the port's
package) or through pytest (``tests/test_torch_analysis.py``).  Findings
carry ``path:line``, a rule id and a fix hint; suppress one with
``# bagua: lint-ignore[rule-id] -- reason``; deferred ones live in the
shrink-only baseline inside the package (``lint_baseline.json``), each with
its reason.  :data:`.suppressions.JAX_RULE_COUNTERPARTS` maps every rule of
the JAX package's engines to its counterpart here.

Import-light (no torch): the static engines run anywhere, and the
collective checker imports torch only when it records or sweeps.
"""

from .findings import Finding, load_baseline, save_baseline  # noqa: F401
from .ast_rules import RULES, run_ast_rules  # noqa: F401
from .suppressions import (  # noqa: F401
    JAX_RULE_COUNTERPARTS,
    KNOWN_RULE_IDS,
    NO_COUNTERPART,
    parse_suppressions,
)
from .concurrency import (  # noqa: F401
    CONCURRENCY_RULES,
    build_program,
    run_concurrency_rules,
    static_lock_graph,
)
from .trace_coherence import TRACE_RULES, run_trace_coherence  # noqa: F401
from .lockdep import LOCKDEP_RULES, cross_check, load_witness  # noqa: F401

__all__ = [
    "Finding",
    "RULES",
    "CONCURRENCY_RULES",
    "TRACE_RULES",
    "LOCKDEP_RULES",
    "KNOWN_RULE_IDS",
    "JAX_RULE_COUNTERPARTS",
    "NO_COUNTERPART",
    "run_ast_rules",
    "run_concurrency_rules",
    "run_trace_coherence",
    "build_program",
    "static_lock_graph",
    "cross_check",
    "load_witness",
    "parse_suppressions",
    "load_baseline",
    "save_baseline",
]
