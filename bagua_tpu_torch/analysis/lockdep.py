"""Runtime lockdep witness.

Port of ``bagua_tpu/analysis/lockdep.py``.  The static concurrency engine's
acquisition-order graph is built from source; this shim checks it against
reality.  When ``BAGUA_LOCKDEP=on``, :func:`maybe_install` patches the
``threading.Lock``/``RLock`` factories so every lock *created from
bagua_tpu_torch code* is wrapped with an instrumented proxy keyed by its
creation site ``(path, lineno)``, the identity the static model gives
module-level and ``self.*`` locks, so the runtime and static graphs join on
it.  Locks created by the stdlib, torch or anything else get the real
primitive back untouched.

Each thread keeps its held-lock stack; every acquisition records the
ordered edges (held site -> acquired site).  If the reverse edge was ever
observed (two threads taking the same pair in opposite orders, a live
deadlock window) the inversion is recorded with both witnesses.  At process
exit the witness (edges, inversions, per-site counts) is written as JSON to
``BAGUA_LOCKDEP_OUT``.

``python -m bagua_tpu_torch.analysis --witness FILE`` feeds a witness back:
:func:`cross_check` gates zero runtime inversions
(``lockdep-runtime-inversion``) and that every witnessed edge between
statically known locks exists in the static graph
(``lockdep-unmodeled-edge``).

Install order matters: ``bagua_tpu_torch/__init__`` calls
:func:`maybe_install` right after the env module loads, BEFORE the imports
that create the package's module-level locks, so a plain
``BAGUA_LOCKDEP=on python script.py`` witnesses all of them.  This module
is stdlib-only and import-light for the same reason.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
from typing import Dict, List, Optional, Tuple

_Site = Tuple[str, int]

#: set once by install(); never uninstalled (the wrapper delegates, so a
#: stale shim is only overhead, never a behavior change)
_STATE: Optional["_LockdepState"] = None

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock


class _LockdepState:
    def __init__(self, pkg_dir: str, out_path: str):
        self.pkg_dir = pkg_dir
        self.out_path = out_path
        # internal bookkeeping lock: a REAL lock, never instrumented
        self.mu = _REAL_LOCK()
        #: (from_site, to_site) -> acquisition count
        self.edges: Dict[Tuple[_Site, _Site], int] = {}
        #: site -> acquisition count
        self.sites: Dict[_Site, int] = {}
        #: observed opposite-order pairs, with the thread names involved
        self.inversions: List[Dict] = []
        self._tls = threading.local()

    def held_stack(self) -> List[_Site]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def note_acquired(self, site: _Site) -> None:
        stack = self.held_stack()
        with self.mu:
            self.sites[site] = self.sites.get(site, 0) + 1
            for held in stack:
                if held == site:
                    continue  # reentrant re-acquire, not an ordering edge
                edge = (held, site)
                first = edge not in self.edges
                self.edges[edge] = self.edges.get(edge, 0) + 1
                if first and (site, held) in self.edges:
                    self.inversions.append({
                        "a": list(held), "b": list(site),
                        "thread": threading.current_thread().name,
                    })
        stack.append(site)

    def note_released(self, site: _Site) -> None:
        stack = self.held_stack()
        # remove the LAST occurrence (locks release innermost-first, and a
        # reentrant lock can appear more than once)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == site:
                del stack[i]
                break

    def witness(self) -> Dict:
        with self.mu:
            return {
                "version": 1,
                "edges": [
                    {"from": list(a), "to": list(b), "count": n}
                    for (a, b), n in sorted(self.edges.items())
                ],
                "inversions": list(self.inversions),
                "sites": [
                    {"site": list(s), "count": n}
                    for s, n in sorted(self.sites.items())
                ],
            }

    def dump(self) -> None:
        try:
            payload = json.dumps(self.witness(), indent=1, sort_keys=True)
            tmp = f"{self.out_path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(payload)
            os.replace(tmp, self.out_path)
        except OSError:
            pass  # diagnostics must never take the process down


class _InstrumentedLock:
    """Proxy over a real Lock/RLock recording acquisition order.  Only the
    primitive-lock surface is proxied (acquire/release/locked/context
    manager) — enough for every lock this package creates."""

    __slots__ = ("_real", "_site", "_state")

    def __init__(self, real, site: _Site, state: _LockdepState):
        self._real = real
        self._site = site
        self._state = state

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._real.acquire(blocking, timeout)
        if got:
            self._state.note_acquired(self._site)
        return got

    def release(self):
        self._real.release()
        self._state.note_released(self._site)

    def locked(self):
        return self._real.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<lockdep {self._site[0]}:{self._site[1]} {self._real!r}>"

    def __getattr__(self, name):
        # the rest of the primitive's surface goes to the real lock: an
        # RLock's _is_owned/_release_save/_acquire_restore, which
        # threading.Condition uses when present (without them its fallback
        # takes an owned RLock for unowned, and wait() raises)
        return getattr(self._real, name)


def _creation_site(state: _LockdepState) -> Optional[_Site]:
    """(pkg-relative path, lineno) of the frame creating the lock, if that
    frame is bagua_tpu_torch code (excluding this module)."""
    try:
        frame = sys._getframe(2)
    except ValueError:
        return None
    fname = frame.f_code.co_filename
    if not fname.startswith(state.pkg_dir) or \
            fname == os.path.abspath(__file__):
        return None
    rel = os.path.relpath(fname, os.path.dirname(state.pkg_dir))
    return (rel.replace(os.sep, "/"), frame.f_lineno)


def _lock_factory():
    state = _STATE
    real = _REAL_LOCK()
    if state is None:
        return real
    site = _creation_site(state)
    if site is None:
        return real
    return _InstrumentedLock(real, site, state)


def _rlock_factory():
    state = _STATE
    real = _REAL_RLOCK()
    if state is None:
        return real
    site = _creation_site(state)
    if site is None:
        return real
    return _InstrumentedLock(real, site, state)


def install(out_path: Optional[str] = None) -> bool:
    """Patch the lock factories and register the exit dump.  Idempotent;
    returns whether the shim is (now) active."""
    global _STATE
    if _STATE is not None:
        return True
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    _STATE = _LockdepState(
        pkg_dir=pkg_dir,
        out_path=out_path or "bagua_lockdep_witness.json",
    )
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    atexit.register(_STATE.dump)
    return True


def maybe_install() -> bool:
    """Install iff ``BAGUA_LOCKDEP=on`` (via the env registry).  Called
    from ``bagua_tpu_torch/__init__`` right after the env module loads so the
    package's own module-level locks are created through the shim."""
    if _STATE is not None:
        return True
    from .. import env

    if env.get_lockdep_mode() != "on":
        return False
    return install(env.get_lockdep_out() or None)


def dump_now() -> None:
    """Write the witness now (no-op when the shim is not installed): for
    exits that skip ``atexit``, such as the watchdog's ``os._exit``."""
    if _STATE is not None:
        _STATE.dump()


def current_witness() -> Optional[Dict]:
    """The live witness dict, or None when the shim is not installed."""
    return _STATE.witness() if _STATE is not None else None


def load_witness(path: str) -> Dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


# ---- static cross-check ----------------------------------------------------


def cross_check(witness: Dict, static_graph: Dict) -> List["Finding"]:
    """Gate the runtime witness against the static acquisition graph:
    zero runtime inversions, and every witnessed edge between locks the
    static model knows must be a static edge (else the static engine's
    graph is missing a real ordering and its inversion verdicts are not
    trustworthy)."""
    from .findings import Finding

    findings: List[Finding] = []
    site_to_lock: Dict[_Site, str] = {
        tuple(site): lock_id
        for site, lock_id in static_graph["locks"].items()
    }
    static_edges = {
        (a, b) for (a, b) in static_graph["edges"]
    }

    for inv in witness.get("inversions", []):
        a, b = tuple(inv["a"]), tuple(inv["b"])
        findings.append(Finding(
            rule="lockdep-runtime-inversion",
            path=a[0], line=a[1],
            message=f"locks created at {a[0]}:{a[1]} and {b[0]}:{b[1]} "
                    f"were acquired in BOTH orders at runtime (thread "
                    f"{inv.get('thread', '?')}): a live deadlock window "
                    "the witnessed run actually exercised",
            hint="impose one acquisition order for this lock pair",
            text="",
        ))

    for edge in witness.get("edges", []):
        a, b = tuple(edge["from"]), tuple(edge["to"])
        lock_a, lock_b = site_to_lock.get(a), site_to_lock.get(b)
        if lock_a is None or lock_b is None:
            continue  # lock the static model does not catalog: not a gate
        if lock_a == lock_b:
            continue
        if (lock_a, lock_b) not in static_edges:
            findings.append(Finding(
                rule="lockdep-unmodeled-edge",
                path=a[0], line=a[1],
                message=f"runtime took {lock_b} while holding {lock_a} "
                        f"({edge['count']}x), but the static acquisition "
                        "graph has no such edge: the concurrency engine "
                        "is blind to a real ordering",
                hint="teach analysis/concurrency.py to resolve the call "
                     "path that creates this edge (or file the lock "
                     "under the right owner)",
                text="",
            ))
    return findings


# rule catalog entries for --list-rules / docs
from .ast_rules import Rule  # noqa: E402  (after the stdlib-only core)

LOCKDEP_RULES: List[Rule] = [
    Rule(
        id="lockdep-runtime-inversion",
        summary="the runtime witness observed a lock pair acquired in "
                "both orders",
        rationale="Unlike the static rule this is not an approximation: "
                  "two real threads actually interleaved the pair both "
                  "ways during the witnessed run, so the deadlock needs "
                  "only scheduling luck.",
        hint="impose one acquisition order for this lock pair",
    ),
    Rule(
        id="lockdep-unmodeled-edge",
        summary="a witnessed acquisition-order edge between known locks "
                "is missing from the static graph",
        rationale="The static inversion verdict is only as good as its "
                  "edge set; a real edge the model cannot derive means "
                  "a blind spot every static 'no cycle' claim inherits.",
        hint="extend the concurrency engine's call resolution to cover "
             "the path that creates this edge",
    ),
]
