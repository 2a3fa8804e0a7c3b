"""Checkpoint and resume.

Port of ``bagua_tpu/checkpoint.py`` without orbax: ``torch.save`` /
``torch.load(weights_only=True)`` under the same policy layer, with async
saves, retention, a sha256 integrity chain, a fallback to the newest verified
step, layout sidecars written once a save is durable, and the storage
quarantine.

On disk a step is a directory ``<dir>/<step>/`` holding one file a rank,
``rank{r}.pt``, and ``manifest.json``; the layout sidecar is
``<dir>/<step>.layout.json``.  Each rank is its own process, so each writes
its own part: a plain state (a tree of dicts, lists and tuples of tensors and
numbers, or a :class:`~bagua_tpu_torch.core.backend.TrainState`) is the
rank's own, and every rank writes and reads its own copy; a
:class:`RankedState` names the part that is the same on every rank
(``shared``, written by rank 0 alone) beside the rank's own (``per_rank``).
Rank 0 writes the manifest and the sidecar only once every rank's file is
durable.  A step without a manifest was never completed and is not a restore
candidate.

An async save takes its host snapshot of the state (device tensors copied to
pinned host memory, host tensors cloned) before :meth:`save` returns, so the
next training step may update the state in place; a background thread then
hashes the snapshot and writes it to a temporary name that is renamed when
complete.  The snapshot's digest is the integrity record.

Integrity across ranks: on restore every rank verifies its own file's digest,
and the ranks agree on the verdict through a MIN allreduce, so a corrupted or
torn part on any rank makes every rank fall back to the same older step.  At
world 1 nothing here needs a process group.  At world > 1 :meth:`save`,
:meth:`restore`, :meth:`wait` and :meth:`close` are collective: call them on
every rank, on a directory every rank sees (one host, or a shared file
system).

The two packages' files differ (orbax's format against ``torch.save``'s):
neither restores the other's checkpoints.  JAX's ``mesh=`` of ``restore`` has
no counterpart: restored tensors land on the devices of ``state_like``.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import shutil
import threading
import time
import weakref
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# live managers, so that an emergency path can flush queued async saves
_LIVE_MANAGERS: "weakref.WeakSet" = weakref.WeakSet()


# ---- storage quarantine ----------------------------------------------------
#
# Repeated integrity failures on one checkpoint directory mean the storage
# under it is rotting.  A quarantined path (``quarantine_storage_path``, or
# ``BAGUA_CKPT_QUARANTINED_PATHS``) redirects every live manager's later SAVES
# to a ``<dir>.redirect`` sibling, while RESTORES keep walking both
# directories, newest first across the union.

_QUARANTINE_LOCK = threading.Lock()
_QUARANTINED: set = set()
_QUARANTINE_SEEDED = False


def _normalize_storage_path(path: str) -> str:
    p = str(path)
    if "://" in p:  # a URI: kept verbatim minus trailing slashes
        return p.rstrip("/")
    return os.path.abspath(p).rstrip("/")


def _seed_quarantine_from_env() -> None:
    """One-time seed from ``BAGUA_CKPT_QUARANTINED_PATHS``."""
    global _QUARANTINE_SEEDED
    if _QUARANTINE_SEEDED:
        return
    _QUARANTINE_SEEDED = True
    from . import env as _env

    for p in _env.get_ckpt_quarantined_paths():
        _QUARANTINED.add(_normalize_storage_path(p))


def quarantine_storage_path(path: str) -> bool:
    """Quarantine a checkpoint directory (idempotent; True when newly
    quarantined).  Live managers on the path redirect their next save; later
    managers resolve the redirect at construction."""
    with _QUARANTINE_LOCK:
        _seed_quarantine_from_env()
        p = _normalize_storage_path(path)
        if p in _QUARANTINED:
            return False
        _QUARANTINED.add(p)
    logger.warning("checkpoint storage QUARANTINED: %s — saves redirect to %s",
                   p, redirect_directory(p))
    return True


def is_quarantined(path: str) -> bool:
    with _QUARANTINE_LOCK:
        _seed_quarantine_from_env()
        return _normalize_storage_path(path) in _QUARANTINED


def quarantined_paths() -> List[str]:
    with _QUARANTINE_LOCK:
        _seed_quarantine_from_env()
        return sorted(_QUARANTINED)


def clear_quarantine() -> None:
    """Forget every quarantine (test isolation)."""
    global _QUARANTINE_SEEDED
    with _QUARANTINE_LOCK:
        _QUARANTINED.clear()
        _QUARANTINE_SEEDED = True


def redirect_directory(path: str) -> str:
    """Where saves for a quarantined ``path`` land."""
    return _normalize_storage_path(path) + ".redirect"


def active_directory(path: str) -> str:
    """A requested checkpoint directory resolved through the quarantine
    registry (a redirect that rots is quarantined in turn, up to a small
    bound)."""
    p = _normalize_storage_path(path)
    for _ in range(4):
        if not is_quarantined(p):
            return p
        p = redirect_directory(p)
    return p


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint failed verification at restore: an unreadable file, a
    torn sidecar or manifest, or a content digest that differs from the one
    recorded at save time (a torn write, bit rot, or an injected
    ``ckpt.write`` fault).  With no explicit step, restore treats it as a
    reason to fall back to the previous step."""


class RankedState(NamedTuple):
    """A state to save in two parts: ``shared``, the same on every rank and
    written once, by rank 0, and ``per_rank``, this rank's own, written by
    every rank.  :meth:`BaguaCheckpointManager.restore` returns one with each
    rank's own ``per_rank``."""

    shared: Any
    per_rank: Any


# ---- trees -----------------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree, path: str = ""):
    """``(path, leaf)`` pairs in the JAX package's flatten order: dict keys
    sorted, sequences in order, named-tuple fields by name; None holds no
    leaf.  Paths read as ``jax.tree_util.keystr`` writes them."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree, key=lambda k: (type(k).__name__, k)):
            yield from _flatten_with_paths(tree[k], f"{path}[{k!r}]")
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from _flatten_with_paths(getattr(tree, f), f"{path}.{f}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_paths(v, f"{path}[{i}]")
    else:
        yield path, tree


def _raw_bytes(t: torch.Tensor) -> memoryview:
    """The bytes of a host tensor, without a copy where it is contiguous."""
    t = t.detach()
    if t.is_cuda:
        t = t.cpu()
    return memoryview(t.contiguous().reshape(-1).view(torch.uint8).numpy())


def compute_state_digest(state: Any) -> Optional[dict]:
    """Content checksum of a state tree: sha256 over every leaf's path,
    shape, dtype (numpy's name) and raw bytes, in a fixed order (dict keys
    sorted).  Other leaves hash their ``repr``.  For a tree of dicts, lists
    and tuples of arrays it equals the JAX package's digest of the same
    arrays.  ``{"algo": "sha256", "digest": hex, "leaves": n}``."""
    from .bucket import dtype_name

    h = hashlib.sha256()
    n = 0
    for path, leaf in _flatten_with_paths(state):
        n += 1
        h.update(path.encode())
        if isinstance(leaf, torch.Tensor):
            h.update(str(tuple(leaf.shape)).encode())
            h.update(dtype_name(leaf.dtype).encode())
            h.update(_raw_bytes(leaf))
        elif isinstance(leaf, np.ndarray):
            h.update(str(leaf.shape).encode())
            h.update(str(leaf.dtype).encode())
            h.update(np.ascontiguousarray(leaf).tobytes())
        else:
            h.update(repr(leaf).encode())
    return {"algo": "sha256", "digest": h.hexdigest(), "leaves": n}


def _positions(opt: torch.optim.Optimizer) -> List[str]:
    """Keys of an optimizer's parameters by position (groups in order)."""
    return [str(i) for i in range(sum(len(g["params"]) for g in opt.param_groups))]


def optimizer_state_tree(opt: torch.optim.Optimizer, keys) -> dict:
    """A torch optimizer's state keyed by parameter name rather than by
    position: ``{"groups": [{"hyper": {...}, "params": [key, ...]}],
    "state": {key: {...}}}``, ``keys[i]`` naming the optimizer's ``i``-th
    parameter (groups in order).  The layout conversions of a restore move
    such trees between parameter names and bucket flats."""
    sd = opt.state_dict()
    groups, key_of, i = [], {}, 0
    for g in sd["param_groups"]:
        names = list(keys[i:i + len(g["params"])])
        key_of.update(zip(g["params"], names))
        groups.append({"hyper": {k: v for k, v in g.items() if k != "params"}, "params": names})
        i += len(g["params"])
    return {"groups": groups, "state": {key_of[idx]: dict(st) for idx, st in sd["state"].items()}}


def check_optimizer_state_tree(opt: torch.optim.Optimizer, tree, keys, path: str = "") -> None:
    """Raise :class:`CheckpointIntegrityError` unless ``tree`` (from
    :func:`optimizer_state_tree`) fits ``opt``, whose parameters ``keys``
    name: the same groups of the same parameters, state only for them."""
    if not isinstance(tree, dict) or set(tree) != {"groups", "state"}:
        raise _structure_error(path, "no optimizer state saved")
    live, i = [], 0
    for g in opt.param_groups:
        live.append(list(keys[i:i + len(g["params"])]))
        i += len(g["params"])
    saved = [list(g["params"]) for g in tree["groups"]]
    if [sorted(g) for g in saved] != [sorted(g) for g in live]:
        raise _structure_error(path, f"optimizer groups over {saved}, live {live}")
    stray = set(tree["state"]) - set(keys)
    if stray:
        raise _structure_error(path, f"optimizer state of unknown parameters {sorted(stray)}")


def load_optimizer_state_tree(opt: torch.optim.Optimizer, tree, keys) -> None:
    """Load a tree of :func:`optimizer_state_tree` into ``opt`` (through its
    ``load_state_dict``: the optimizer and its parameters keep their
    identity)."""
    index = {k: i for i, k in enumerate(keys)}
    groups, i = [], 0
    for g, saved in zip(opt.param_groups, tree["groups"]):
        n = len(g["params"])
        groups.append(dict(saved["hyper"], params=list(range(i, i + n))))
        i += n
    opt.load_state_dict({"state": {index[k]: st for k, st in tree["state"].items()},
                         "param_groups": groups})


def to_tree(obj):
    """``obj`` as a tree ``torch.save`` writes and ``weights_only`` loads:
    tensors, numbers, strings, None, dicts, lists, tuples; a torch optimizer
    becomes its :func:`optimizer_state_tree` by parameter position, a named
    tuple a dict of its fields."""
    if isinstance(obj, torch.Tensor) or obj is None or isinstance(obj, (int, float, str, bool)):
        return obj
    if isinstance(obj, torch.optim.Optimizer):
        return optimizer_state_tree(obj, _positions(obj))
    if _is_namedtuple(obj):
        return {f: to_tree(getattr(obj, f)) for f in obj._fields}
    if isinstance(obj, dict):
        return {k: to_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_tree(v) for v in obj)
    raise TypeError(f"cannot checkpoint an object of type {type(obj).__name__}")


def _structure_error(path: str, what: str):
    return CheckpointIntegrityError(
        f"checkpoint does not fit the state it restores into at {path or 'the root'}: {what}")


def check_tree(live, saved, path: str = "") -> None:
    """Raise :class:`CheckpointIntegrityError` where ``saved`` cannot be
    copied into ``live`` (structure, tensor shapes)."""
    if isinstance(live, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or tuple(saved.shape) != tuple(live.shape):
            got = tuple(saved.shape) if isinstance(saved, torch.Tensor) else type(saved).__name__
            raise _structure_error(path, f"saved {got}, live {tuple(live.shape)}")
    elif isinstance(live, torch.optim.Optimizer):
        check_optimizer_state_tree(live, saved, _positions(live), path)
    elif _is_namedtuple(live):
        if not isinstance(saved, dict) or set(saved) != set(live._fields):
            got = sorted(saved) if isinstance(saved, dict) else saved
            raise _structure_error(path, f"fields {got!r}")
        for f in live._fields:
            check_tree(getattr(live, f), saved[f], f"{path}.{f}")
    elif isinstance(live, dict):
        if not isinstance(saved, dict) or set(saved) != set(live):
            raise _structure_error(path, "dict keys differ")
        for k in live:
            check_tree(live[k], saved[k], f"{path}[{k!r}]")
    elif isinstance(live, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(live):
            raise _structure_error(path, "sequence lengths differ")
        for i, (a, b) in enumerate(zip(live, saved)):
            check_tree(a, b, f"{path}[{i}]")
    elif live is None and saved is not None:
        raise _structure_error(path, "the live state holds None")


@torch.no_grad()
def apply_tree(live, saved):
    """``saved`` copied into ``live`` in place where ``live`` holds tensors
    and optimizers (their identity and views survive); returns the restored
    object (a new named tuple, dict or list around the same tensors)."""
    if isinstance(live, torch.Tensor):
        live.copy_(saved)
        return live
    if isinstance(live, torch.optim.Optimizer):
        load_optimizer_state_tree(live, saved, _positions(live))
        return live
    if _is_namedtuple(live):
        return type(live)(*(apply_tree(getattr(live, f), saved[f]) for f in live._fields))
    if isinstance(live, dict):
        return {k: apply_tree(v, saved[k]) for k, v in live.items()}
    if isinstance(live, (list, tuple)):
        return type(live)(apply_tree(a, b) for a, b in zip(live, saved))
    return saved


def copy_tree(tree, like=None, device=None):
    """A copy of a loaded tree with tensors of their own, detached from the
    file they were mapped from: on ``like``'s devices where it gives them,
    else on ``device`` (the host by default)."""
    if isinstance(tree, torch.Tensor):
        to = like.device if isinstance(like, torch.Tensor) else (device or "cpu")
        return tree.to(device=to, copy=True)
    if isinstance(tree, dict):
        return {k: copy_tree(v, like.get(k) if isinstance(like, dict) else None, device)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        likes = like if isinstance(like, (list, tuple)) else [None] * len(tree)
        return type(tree)(copy_tree(v, lk, device) for v, lk in zip(tree, likes))
    return tree


def _is_train_state(x) -> bool:
    from .core.backend import TrainState

    return isinstance(x, TrainState)


def train_state_tree(state) -> dict:
    """A :class:`TrainState` as a plain tree: its step, the module's
    ``state_dict``, the optimizer's and the algorithm's state."""
    return {"step": int(state.step), "model": dict(state.model.state_dict()),
            "optimizer": to_tree(state.optimizer), "opt_state": to_tree(state.opt_state),
            "algo_state": to_tree(state.algo_state)}


def restore_train_state(like, tree):
    """Copy ``tree`` into the live :class:`TrainState` ``like`` in place: the
    module through ``load_state_dict`` (parameter storage and flat views
    survive), the optimizer through its own."""
    import dataclasses

    like.model.load_state_dict(tree["model"])
    apply_tree(like.optimizer, tree["optimizer"])
    return dataclasses.replace(
        like, step=int(tree["step"]),
        opt_state=apply_tree(like.opt_state, tree["opt_state"]),
        algo_state=apply_tree(like.algo_state, tree["algo_state"]))


def check_train_state(like, tree) -> None:
    if not isinstance(tree, dict) or set(tree) != {"step", "model", "optimizer", "opt_state",
                                                   "algo_state"}:
        raise _structure_error("", "not a TrainState checkpoint")
    check_tree(dict(like.model.state_dict()), tree["model"], "['model']")
    check_tree(like.optimizer, tree["optimizer"], "['optimizer']")
    check_tree(like.opt_state, tree["opt_state"], "['opt_state']")
    check_tree(like.algo_state, tree["algo_state"], "['algo_state']")


# ---- ranks -----------------------------------------------------------------


def _rank_world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _default_comm():
    """The global communicator at world > 1, else None."""
    if _rank_world()[1] <= 1:
        return None
    from .communication import get_backend

    return get_backend().global_communicator


def _comm_device(comm) -> torch.device:
    if dist.get_backend(comm.group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _agree_min(comm, value: int) -> int:
    """The least of every rank's ``value`` (``value`` at world 1)."""
    if comm is None or comm.nranks() <= 1:
        return value
    from .communication import ReduceOp

    t = torch.tensor([value], dtype=torch.int64, device=_comm_device(comm))
    return int(comm.allreduce(t, ReduceOp.MIN).item())


_DIGEST_BYTES = 72   # 64 hex characters, then the leaf count as 8 bytes


def _gather_records(comm, ok: bool, digest: Optional[dict], nbytes: int) -> List[dict]:
    """Every rank's ``(ok, digest, bytes)`` after its part of a save."""
    rec = {"ok": ok, "digest": digest, "bytes": nbytes}
    if comm is None or comm.nranks() <= 1:
        return [rec]
    row = np.zeros(_DIGEST_BYTES + 16, dtype=np.uint8)
    if digest is not None:
        row[:64] = np.frombuffer(digest["digest"].encode(), dtype=np.uint8)
        row[64:72] = np.frombuffer(np.int64(digest["leaves"]).tobytes(), dtype=np.uint8)
    row[72:80] = np.frombuffer(np.int64(nbytes).tobytes(), dtype=np.uint8)
    row[80] = 1 if ok else 0
    row[81] = 1 if digest is not None else 0
    t = torch.from_numpy(row).to(_comm_device(comm))
    rows = comm.allgather(t[None], axis=0, tiled=True).cpu().numpy()
    out = []
    for r in rows:
        d = None
        if r[81]:
            d = {"algo": "sha256", "digest": bytes(r[:64]).decode(),
                 "leaves": int(np.frombuffer(r[64:72].tobytes(), dtype=np.int64)[0])}
        out.append({"ok": bool(r[80]), "digest": d,
                    "bytes": int(np.frombuffer(r[72:80].tobytes(), dtype=np.int64)[0])})
    return out


def flush_all_checkpoints(timeout_s: float = 10.0) -> None:
    """Best-effort flush of every live manager's queued async saves, bounded
    by ``timeout_s``: for emergency exits, where an unbounded wait could
    itself hang."""
    managers = list(_LIVE_MANAGERS)
    if not managers:
        return

    def flush():
        for m in managers:
            try:
                m.wait()
            except Exception as e:  # noqa: BLE001 - best effort
                logger.warning("checkpoint flush failed: %s", e)

    t = threading.Thread(target=flush, name="bagua-ckpt-flush", daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        logger.error("checkpoint flush did not finish within %.0f s — queued async "
                     "saves may be lost", timeout_s)


# ---- one save --------------------------------------------------------------


class _Save:
    """One rank's part of one save: its host snapshot, hashed and written by
    a background thread (async) or by the caller (sync)."""

    def __init__(self, step: int, directory: str, rank: int, world: int, kind: str,
                 payload, buffers, meta: dict, integrity: bool, started: float):
        self.step, self.directory, self.rank, self.world = step, directory, rank, world
        self.kind, self.payload, self.buffers, self.meta = kind, payload, buffers, meta
        self.integrity = integrity
        self.started = started
        self.digest: Optional[dict] = None
        self.digest_s = 0.0
        self.nbytes = 0
        self.durable_s = 0.0
        self.error: Optional[BaseException] = None
        self.thread: Optional[threading.Thread] = None

    def run(self) -> None:
        try:
            hasher = None
            if self.integrity:
                hasher = threading.Thread(target=self._hash, name="bagua-ckpt-digest")
                hasher.start()
            root = Path(self.directory) / str(self.step)
            root.mkdir(parents=True, exist_ok=True)
            final = root / f"rank{self.rank}.pt"
            tmp = root / f".rank{self.rank}.pt.tmp"
            with open(tmp, "wb") as f:
                torch.save(self.payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
            self.nbytes = final.stat().st_size
            if hasher is not None:
                hasher.join()
            self.durable_s = time.perf_counter() - self.started
        except Exception as e:  # noqa: BLE001 - raised by the finish, on every rank
            self.error = e

    def _hash(self) -> None:
        t0 = time.perf_counter()
        self.digest = compute_state_digest(self.payload)
        self.digest_s = time.perf_counter() - t0


def _note_directory(directory: str) -> None:
    """Fleet view: the storage path this rank saves to rides the obs
    summary, so that a quarantine decision can name it
    (``bagua_tpu/checkpoint.py:245-251``)."""
    try:
        from .obs.export import note_ckpt_directory

        note_ckpt_directory(directory)
    except Exception:  # noqa: BLE001 - obs is never load-bearing here
        pass


class BaguaCheckpointManager:
    """Save and restore training state with retention, async saves and an
    integrity chain (see the module docstring).

    Args:
        directory: where steps are written.
        max_to_keep: the newest steps kept; older ones are deleted with
            their sidecars.
        save_interval_steps: :meth:`save` proceeds at steps that are
            multiples of it (and never at or below the latest saved step).
        async_save: write in a background thread after the snapshot.
        integrity: record each part's sha256 digest in the sidecar and
            verify it on restore, so that a corrupted or torn step falls back
            to the previous verified one.  Costs one pass over the snapshot
            on the writer's side and one over the file at restore.

    After each save ``last_save`` holds this rank's timings in seconds:
    ``stall_s`` (the snapshot, the step loop's wait), ``digest_s``,
    ``durable_s`` (from the call until the file is renamed) and ``bytes``.
    """

    def __init__(self, directory: str, max_to_keep: int = 3, save_interval_steps: int = 1,
                 async_save: bool = True, integrity: bool = True):
        #: the directory the caller asked for (quarantine verdicts name it);
        #: ``directory`` is the active one, possibly redirected
        self.requested_directory = str(directory)
        self.directory = active_directory(self.requested_directory)
        if self.directory != _normalize_storage_path(self.requested_directory):
            logger.warning("checkpoint directory %s is quarantined; using %s",
                           self.requested_directory, self.directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        #: earlier directories of the quarantine chain (oldest first), read
        #: by restores only
        self._fallbacks: List[str] = []
        chain = _normalize_storage_path(self.requested_directory)
        while chain != self.directory:
            self._fallbacks.append(chain)
            chain = redirect_directory(chain)
        self._async_save = bool(async_save)
        self._integrity = bool(integrity)
        #: sidecars of saves not yet durable, written at the next proceeding
        #: save, wait() or close(); a restore of such a step reads them here
        self._pending_layouts: Dict[int, dict] = {}
        #: durable steps the ``ckpt.write`` hook has not had its chance at
        self._uncorrupted_steps: List[int] = []
        self._inflight: Optional[_Save] = None
        self._last_saved: Optional[int] = None
        #: pinned host buffers of the last finished snapshot, reused by the
        #: next one of the same shapes
        self._pool: Dict[tuple, List[torch.Tensor]] = {}
        self.last_save: Dict[str, float] = {}
        _LIVE_MANAGERS.add(self)
        _note_directory(self.directory)

    # ---- save ----------------------------------------------------------

    def _should_save(self, step: int) -> bool:
        latest = self._last_saved
        if latest is None:
            latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return step % self.save_interval_steps == 0

    def save(self, step: int, state: Any, metadata: Optional[dict] = None) -> bool:
        """Save ``state`` at ``step`` (async by default); False when the
        interval policy skips it.  ``state``: a tree of tensors, a
        :class:`RankedState` or a ``TrainState``.  The host snapshot is
        complete when this returns.

        ``metadata``: an optional JSON-serializable layout descriptor
        (``trainer.checkpoint_layout_metadata()``) stored in the sidecar
        ``<dir>/<step>.layout.json`` and validated on :meth:`restore` through
        ``expect_metadata=``.  An async save's sidecar is written once the
        save is durable: at the next proceeding save, :meth:`wait` or
        :meth:`close`."""
        from .obs.spans import trace_span

        self._ensure_active_manager()
        step = int(step)
        if not self._should_save(step):
            return False
        with trace_span("ckpt/save", step=step, async_save=self._async_save):
            self._save(step, state, metadata)
        return True

    def _save(self, step: int, state: Any, metadata: Optional[dict]) -> None:
        # the previous async save is finished before a new one starts
        self._finish_inflight()
        t0 = time.perf_counter()
        rank, world = _rank_world()
        if isinstance(state, RankedState):
            kind, payload = "ranked", {"rank": to_tree(state.per_rank)}
            if rank == 0:
                payload["shared"] = to_tree(state.shared)
        elif _is_train_state(state):
            kind, payload = "train_state", {"rank": train_state_tree(state)}
        else:
            kind, payload = "tree", {"rank": to_tree(state)}
        buffers: List[torch.Tensor] = []
        snapshot = self._snapshot(payload, buffers)
        if any(b.is_pinned() for b in buffers):
            torch.cuda.current_stream().synchronize()
        job = _Save(step, self.directory, rank, world, kind, snapshot, buffers,
                    dict(metadata) if metadata is not None else {},
                    self._integrity, t0)
        self.last_save = {"step": step, "stall_s": time.perf_counter() - t0}
        self._inflight = job
        self._last_saved = step
        self._pending_layouts[step] = job.meta
        if self._async_save:
            job.thread = threading.Thread(target=job.run, name="bagua-ckpt-write", daemon=True)
            job.thread.start()
        else:
            job.run()
            self._finish_inflight()

    def _snapshot(self, tree, buffers: List[torch.Tensor]):
        """Host copies of every tensor of ``tree``: device tensors into
        pinned buffers (copies queued on the current stream), host ones
        cloned."""
        if isinstance(tree, torch.Tensor):
            t = tree.detach()
            if not t.is_cuda:
                return t.clone()
            key = (tuple(t.shape), t.dtype)
            pool = self._pool.get(key)
            buf = pool.pop() if pool else torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            buffers.append(buf)
            return buf
        if isinstance(tree, dict):
            return {k: self._snapshot(v, buffers) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._snapshot(v, buffers) for v in tree)
        return tree

    def _finish_inflight(self) -> None:
        """Make the save in flight durable on every rank, then (rank 0)
        write its manifest and sidecar and prune; collective at world > 1."""
        job, self._inflight = self._inflight, None
        if job is None:
            return
        if job.thread is not None:
            job.thread.join()
        comm = _default_comm() if job.world > 1 else None
        records = _gather_records(comm, job.error is None, job.digest, job.nbytes)
        # the pool keeps the last snapshot's buffers only
        self._pool = {}
        for buf in job.buffers:
            if buf.is_pinned():
                self._pool.setdefault((tuple(buf.shape), buf.dtype), []).append(buf)
        job.payload = job.buffers = None
        self.last_save.update(digest_s=job.digest_s, durable_s=job.durable_s, bytes=job.nbytes)
        failed = [r for r, rec in enumerate(records) if not rec["ok"]]
        if failed:
            self._pending_layouts.pop(job.step, None)
            self._last_saved = None
            if job.error is not None:
                raise RuntimeError(f"checkpoint save of step {job.step} failed") from job.error
            raise RuntimeError(f"checkpoint save of step {job.step} failed on rank(s) {failed}")
        meta = self._pending_layouts.pop(job.step, job.meta)
        if self._integrity and "integrity" not in meta and records[0]["digest"] is not None:
            meta["integrity"] = dict(records[0]["digest"])
            if job.world > 1:
                meta["integrity"]["ranks"] = [rec["digest"] for rec in records]
        error = None
        if job.rank == 0:
            try:
                self._commit(job, meta, records)
            except Exception as e:  # noqa: BLE001 - agreed on below
                error = e
        if _agree_min(comm, 0 if error is not None else 1) == 0:
            self._last_saved = None
            if error is not None:
                raise RuntimeError(f"checkpoint commit of step {job.step} failed") from error
            raise RuntimeError(f"checkpoint commit of step {job.step} failed on rank 0")
        self._uncorrupted_steps.append(job.step)
        self._run_chaos_corruption()

    def _commit(self, job: _Save, meta: dict, records: List[dict]) -> None:
        """Rank 0, every part durable: the sidecar, then the manifest (which
        makes the step a restore candidate, its digests already recorded),
        then retention."""
        if meta:
            self._write_layout(job.step, meta)
        root = Path(self.directory) / str(job.step)
        manifest = {"step": job.step, "world": job.world, "kind": job.kind,
                    "bytes": [rec["bytes"] for rec in records]}
        tmp = root / ".manifest.json.tmp"
        tmp.write_text(json.dumps(manifest))
        tmp.replace(root / "manifest.json")
        self._prune()

    def _run_chaos_corruption(self) -> None:
        """Apply an armed ``ckpt.write`` fault to this rank's files of the
        steps now durable (a no-op while nothing is armed)."""
        from .faults import inject as _inject

        pending, self._uncorrupted_steps = self._uncorrupted_steps, []
        rank = _rank_world()[0]
        for step in pending:
            _inject.maybe_corrupt_checkpoint(self.directory, step, rank=rank)

    def _write_layout(self, step: int, metadata: dict) -> None:
        from .faults import inject as _inject

        path = self._layout_path(step)
        # tmp + replace: a crash mid-write leaves no sidecar or a whole one
        tmp = path.parent / f".{path.name}.tmp"
        tmp.write_text(json.dumps(metadata))
        tmp.replace(path)
        _inject.maybe_corrupt_sidecar(path, step)

    def _prune(self) -> None:
        """Rank 0: delete the steps beyond the newest ``max_to_keep`` of the
        active directory, and the sidecars of steps no longer kept."""
        steps = self.all_steps()
        if self.max_to_keep is not None and len(steps) > self.max_to_keep:
            for s in steps[:len(steps) - self.max_to_keep]:
                shutil.rmtree(Path(self.directory) / str(s), ignore_errors=True)
        live = set(self.all_steps())
        for p in Path(self.directory).glob("*.layout.json"):
            try:
                if int(p.name.split(".")[0]) not in live:
                    p.unlink()
            except (ValueError, OSError) as e:
                logger.debug("layout sidecar pruning skipped for %s: %s", p, e)

    # ---- quarantine ------------------------------------------------------

    def _ensure_active_manager(self) -> None:
        """Follow a quarantine of the active directory made since the last
        call: flush the save in flight there, keep the directory for
        restores, and point saves at the redirect."""
        active = active_directory(self.requested_directory)
        if active == self.directory:
            return
        logger.warning("checkpoint storage quarantine: redirecting saves %s -> %s (restores "
                       "keep walking both)", self.directory, active)
        try:
            self.wait()
        except Exception as e:  # noqa: BLE001 - rotting storage may throw
            logger.warning("flush of quarantined checkpoint dir failed: %s", e)
        self._fallbacks.append(self.directory)
        self.directory = active
        self._last_saved = None
        _note_directory(self.directory)

    @contextlib.contextmanager
    def _using(self, directory: str):
        """Point restores at another directory of the chain for a while."""
        if directory == self.directory:
            yield
            return
        prev, self.directory = self.directory, directory
        try:
            yield
        finally:
            self.directory = prev

    # ---- steps -----------------------------------------------------------

    @staticmethod
    def _steps_in(directory: str) -> List[int]:
        """The completed steps under ``directory`` (those with a manifest),
        ascending."""
        try:
            entries = os.listdir(directory)
        except OSError:
            return []
        return sorted(int(e) for e in entries if e.isdigit()
                      and os.path.exists(os.path.join(directory, e, "manifest.json")))

    def all_steps(self) -> List[int]:
        """The completed steps of the active directory, ascending."""
        return self._steps_in(self.directory)

    def _candidate_steps(self) -> List[Tuple[int, str]]:
        """(step, directory) restore candidates, newest first; at equal steps
        the active directory shadows the fallbacks, and a newer link of the
        redirect chain an older one."""
        out = {s: self.directory for s in self.all_steps()}
        for d in reversed(self._fallbacks):
            for s in self._steps_in(d):
                out.setdefault(s, d)
        return [(s, out[s]) for s in sorted(out, reverse=True)]

    def latest_step(self) -> Optional[int]:
        steps = [s for s, _ in self._candidate_steps()[:1]]
        if self._inflight is not None:
            steps.append(self._inflight.step)
        return max(steps) if steps else None

    # ---- layout sidecars -------------------------------------------------

    def _layout_path(self, step: int) -> Path:
        return Path(self.directory) / f"{int(step)}.layout.json"

    def _read_layout(self, step: int) -> Optional[dict]:
        if int(step) in self._pending_layouts:
            # a step whose save is not durable yet: the stash is authoritative
            return self._pending_layouts[int(step)]
        path = self._layout_path(step)
        if not path.exists():
            return None
        try:
            return json.loads(path.read_text())
        except (ValueError, UnicodeDecodeError) as e:
            # a torn or garbage sidecar makes the step unverifiable: an
            # integrity failure, so that a latest-step restore falls back
            raise CheckpointIntegrityError(
                f"layout sidecar for step {step} is unreadable ({e}) — torn write or "
                "corruption") from e

    def read_layout(self, step: int) -> Optional[dict]:
        """The layout sidecar saved with ``step`` (None when it was saved
        without ``metadata=`` or digest).  ``BaguaTrainer.restore_checkpoint``
        reads it to decide whether a checkpoint needs a relayout or a leaf
        conversion."""
        return self._read_layout(int(step))

    #: metadata keys that carry layout payload (the bucket layout, the
    #: residual's descriptor) or side records (the digest), never compared
    _LAYOUT_PAYLOAD_KEYS = ("flat_layout", "stacked", "integrity", "ef")

    @classmethod
    def _normalize_layout(cls, meta: Optional[dict]) -> Optional[dict]:
        if meta is None:
            return None
        m = {k: v for k, v in meta.items() if k not in cls._LAYOUT_PAYLOAD_KEYS}
        if m.get("layout") == "zero_flat":
            # the JAX package's older name of the flat layout
            m["layout"] = "flat"
        return m

    @classmethod
    def _check_layout(cls, saved: Optional[dict], expected: Optional[dict]) -> None:
        # per-rank (gossip) state depends on the world size even under an
        # identical plan: read before normalization strips the key
        stacked = bool((saved or {}).get("stacked")) or bool((expected or {}).get("stacked"))
        saved = cls._normalize_layout(saved)
        expected = cls._normalize_layout(expected)
        if (saved is not None and expected is not None and saved.get("plan_signature")
                and saved.get("plan_signature") == expected.get("plan_signature")):
            # the signature pins the concrete layout: the bucket_bytes knob
            # may differ while splitting identically, and for unstacked state
            # a world change leaves alignment-1 flats identical.
            # ``opt_shards`` is still compared
            keys = ("bucket_bytes",) if stacked else ("bucket_bytes", "world_size")
            for k in keys:
                saved.pop(k, None)
                expected.pop(k, None)
        if expected is None:
            if saved is not None and saved.get("plan_dependent"):
                logger.warning(
                    "checkpoint was saved in a plan-dependent layout (%s) but no "
                    "expect_metadata was passed — restore cannot verify the bucket plan/world "
                    "size still match", saved.get("layout"))
            return
        if saved is None:
            logger.warning(
                "expect_metadata given but the checkpoint carries no layout metadata (saved "
                "before metadata support, or without metadata=) — cannot verify layout "
                "compatibility")
            return
        missing = [k for k in expected if k not in saved]
        if missing:
            # keys added after the checkpoint was written: legacy sidecars
            # stay restorable at the same topology
            logger.warning("checkpoint layout metadata predates field(s) %s — cannot verify "
                           "those; restoring", ", ".join(sorted(missing)))
        mismatched = {k: (saved[k], expected[k]) for k in expected
                      if k in saved and saved[k] != expected[k]}
        if not mismatched:
            return
        detail = ", ".join(f"{k}: checkpoint={a!r} vs current={b!r}"
                           for k, (a, b) in sorted(mismatched.items()))
        plan_dependent = (saved.get("plan_dependent") or expected.get("plan_dependent")
                          or "layout" in mismatched)
        if not plan_dependent:
            logger.info("checkpoint layout metadata differs (%s) but both layouts are "
                        "plan-independent; restoring", detail)
            return
        raise ValueError(
            "checkpoint layout mismatch — this checkpoint cannot restore directly into the "
            f"current trainer ({detail}).  Flat-resident layouts are bucket-plan- and "
            "world-size-dependent: an elastic restart at a different process count or a "
            "bucket_bytes change produces different flat-buffer shapes.  Use "
            "trainer.restore_checkpoint(manager, state_like) — it re-lays-out or "
            "leaf-converts flat checkpoints across plans (sharded-opt-state ZeRO excepted) — "
            "or restart with the original world size/bucket_bytes, or re-save in the "
            "plan-independent leaf layout (flat_resident='off') before changing the "
            "topology.")

    # ---- restore ---------------------------------------------------------

    def _manifest(self, step: int) -> dict:
        path = Path(self.directory) / str(int(step)) / "manifest.json"
        try:
            return json.loads(path.read_text())
        except (OSError, ValueError, UnicodeDecodeError) as e:
            raise CheckpointIntegrityError(
                f"checkpoint step {step} is unreadable (manifest: {type(e).__name__}: "
                f"{e})") from e

    def _load_part(self, step: int, rank: int, sidecar: Optional[dict],
                   verify: bool = True) -> dict:
        """Rank ``rank``'s file of ``step`` (tensors mapped from the file),
        its digest checked against the sidecar's record."""
        path = Path(self.directory) / str(int(step)) / f"rank{rank}.pt"
        try:
            payload = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        except Exception as e:
            # missing, truncated or garbled: the corruption class.  A
            # transient read error is classified so too; the walk then
            # tries older steps, and the final error chains this one
            raise CheckpointIntegrityError(
                f"checkpoint step {step} is unreadable ({type(e).__name__}: {e})") from e
        recorded = (sidecar or {}).get("integrity")
        if verify and self._integrity and recorded:
            from .obs.spans import trace_span

            want = recorded["ranks"][rank] if "ranks" in recorded else recorded
            with trace_span("ckpt/verify", ckpt_step=int(step)):
                actual = compute_state_digest(payload)
            if actual["digest"] != (want or {}).get("digest"):
                raise CheckpointIntegrityError(
                    f"checkpoint step {step} content digest mismatch on rank {rank} (saved "
                    f"{(want or {}).get('digest', '?')[:12]}…, restored "
                    f"{actual['digest'][:12]}…) — on-disk corruption")
            from .telemetry import counters

            counters.incr("ckpt/verified_restores")
        return payload

    def _load_step(self, step: int, sidecar: Optional[dict],
                   ranks: Optional[Iterable[int]] = None):
        """``(manifest, shared, parts)``: the step's manifest, the shared
        part (rank 0's file) and the per-rank parts by saved rank: this
        rank's own (None past the saved world), or those of the saved
        ``ranks``.  Every part this rank reads past rank 0's shared one is
        verified here."""
        manifest = self._manifest(step)
        rank = _rank_world()[0]
        world = int(manifest["world"])
        wanted = list(ranks) if ranks is not None else ([rank] if rank < world else [])
        loaded = {r: self._load_part(step, r, sidecar) for r in wanted}
        shared = None
        if manifest["kind"] == "ranked":
            # rank 0 verifies its own file; the agreement covers the others
            first = loaded.get(0) or self._load_part(step, 0, sidecar, verify=False)
            shared = first.get("shared")
        return manifest, shared, {r: p["rank"] for r, p in loaded.items()}

    def _attempt(self, fn: Callable, comm):
        """Run ``fn`` on every rank and agree: ``(result, None)`` when it
        succeeded everywhere; ``(None, error)`` with a
        :class:`CheckpointIntegrityError` when some rank failed verification;
        any other failure is raised on every rank."""
        result, error, code = None, None, 2
        try:
            result = fn()
        except CheckpointIntegrityError as e:
            error, code = e, 1
        except Exception as e:  # noqa: BLE001 - agreed on below
            error, code = e, 0
        agreed = _agree_min(comm, code)
        if agreed == 2:
            return result, None
        if agreed == 0:
            if code == 0:
                raise error
            raise RuntimeError("checkpoint restore failed on another rank")
        if error is None:
            error = CheckpointIntegrityError("another rank's part failed verification")
        return None, error

    def restore(self, state_like: Any = None, step: Optional[int] = None,
                expect_metadata: Optional[dict] = None) -> Tuple[int, Any]:
        """Restore the given (or the newest verified) step: ``(step,
        state)``.  A ``TrainState`` ``state_like`` is restored into in place
        (module parameters, optimizer state) and returned with the saved
        step; a tree ``state_like`` gives the devices of the restored tensors
        and must match the saved structure and shapes.

        Integrity chain: with no explicit ``step``, the steps are walked
        newest first and the first one that every rank verifies is restored
        (an unreadable file, a torn sidecar or a digest mismatch disqualify a
        step, loudly).  An explicit ``step`` never falls back: a failed
        verification raises :class:`CheckpointIntegrityError`.  Layout
        mismatches (``expect_metadata``) are configuration errors and raise
        at once in both modes."""
        self._ensure_active_manager()
        self._finish_inflight()

        def one(s):
            return self._restore_step(s, state_like, expect_metadata)

        if step is not None:
            s, finish = self._restore_explicit(int(step), one)
        else:
            s, finish = self._restore_newest_verified(one)
        return s, finish()

    def _restore_explicit(self, step: int, restore_one, comm=None):
        """``restore_one(step)`` agreed over the ranks, from whichever
        directory of the chain holds the step; raises on a failed
        verification."""
        comm = _default_comm() if comm is None else comm
        directory = dict((s, d) for s, d in reversed(self._candidate_steps())).get(
            step, self.directory)
        from .obs.spans import trace_span

        with self._using(directory), trace_span("ckpt/restore", ckpt_step=step):
            result, error = self._attempt(lambda: restore_one(step), comm)
        if error is not None:
            raise error
        return result

    def _restore_newest_verified(self, restore_one, comm=None):
        """The one integrity-fallback policy: walk the steps newest first and
        return the first result of ``restore_one(step)`` that no rank failed
        to verify.  ``BaguaTrainer.restore_checkpoint`` uses it too."""
        from .faults import inject as _inject
        from .obs.spans import trace_span
        from .telemetry import counters

        self._ensure_active_manager()
        comm = _default_comm() if comm is None else comm
        candidates = self._candidate_steps()
        if not candidates:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        last_err: Optional[Exception] = None
        for i, (s, d) in enumerate(candidates):
            with self._using(d), trace_span("ckpt/restore", ckpt_step=int(s)):
                result, error = self._attempt(lambda: restore_one(s), comm)
            if error is not None:
                counters.incr("ckpt/integrity_failures")
                logger.error("checkpoint step %d FAILED verification (%s) — falling back to "
                             "the previous checkpoint", s, error)
                last_err = error
                continue
            if i > 0:
                counters.incr("ckpt/fallback_restores")
                logger.warning(
                    "checkpoint integrity: restored step %d after %d newer checkpoint(s) "
                    "failed verification — training resumes from an OLDER state than the "
                    "last save", s, i)
                _inject.record_recovery("ckpt.write")
                _inject.record_recovery("ckpt.sidecar")
            return result
        raise CheckpointIntegrityError(
            f"no checkpoint under {self.directory} passed verification ({len(candidates)} "
            "candidate step(s) tried)") from last_err

    def _restore_step(self, step: int, state_like: Any, expect_metadata: Optional[dict]):
        """Load and verify ``step`` and check it against ``state_like``:
        ``(step, finish)``, where ``finish()`` (run once every rank agreed)
        returns the restored state."""
        # the sidecar first: its layout error must come before a shape error
        sidecar = self._read_layout(step)
        self._check_layout(sidecar, expect_metadata)
        manifest, shared, parts = self._load_step(step, sidecar)
        own = parts.get(_rank_world()[0])
        kind = manifest["kind"]
        if kind == "train_state":
            if not _is_train_state(state_like):
                raise CheckpointIntegrityError(
                    f"checkpoint step {step} holds a TrainState: pass the live TrainState as "
                    "state_like")
            check_train_state(state_like, own)
            return step, lambda: restore_train_state(state_like, own)
        if kind == "ranked":
            if isinstance(state_like, RankedState):
                check_tree(state_like.shared, shared, ".shared")
                check_tree(state_like.per_rank, own, ".per_rank")
                return step, lambda: RankedState(copy_tree(shared, state_like.shared),
                                                 copy_tree(own, state_like.per_rank))
            return step, lambda: RankedState(copy_tree(shared), copy_tree(own))
        if state_like is not None:
            check_tree(state_like, own)
        return step, lambda: copy_tree(own, state_like)

    def try_restore(self, state_like: Any = None,
                    expect_metadata: Optional[dict] = None) -> Tuple[Optional[int], Any]:
        """Restore the newest step if there is one, else ``(None,
        state_like)``: the resume-on-restart entry point."""
        if self.latest_step() is None:
            return None, state_like
        return self.restore(state_like, expect_metadata=expect_metadata)

    def wait(self) -> None:
        """Block until the save in flight is durable on every rank, then
        write its sidecar."""
        self._finish_inflight()

    def close(self) -> None:
        self._finish_inflight()
        self._pool.clear()
        _LIVE_MANAGERS.discard(self)
