"""Collective-sequence checker over a recorded collective-call log.

The counterpart of ``bagua_tpu/analysis/jaxpr_check.py``.  The JAX checker
traces a step to its jaxpr and reads the collective primitives out of it; an
eager torch step has no program to read, so this one records what the step
really issues.  Every blocking call of ``BaguaCommunicator`` passes through
one seam (``communication._watched``), where a :class:`CollectiveRecorder`
sees ``(op, communicator, operand)`` and keeps a :class:`Collective`: the
op, the mesh axes of the communicator's group, the operand's dtype and
shape, and the thread's ``communication.recording_tag``: the bucket whose
reduction issued it, or ``"plan"`` for the plan's upkeep.  Reading a shape
and a dtype is metadata: recording adds no device synchronization.

Checks, as the JAX checker's:

1. **axis binding** (``unbound-mesh-axis``): every collective's group axes
   are axes of the trainer's mesh.
2. **rank agreement** (``rank-collective-divergence``, the counterpart of
   ``cond-collective-divergence``): every rank issues the same sequence of
   collectives on each group of axes; a rank-dependent branch that posts a
   collective the other ranks never post is the eager form of the SPMD
   deadlock the JAX checker finds in ``cond`` branches.
3. **construction equivalence** (``overlap-serialized-divergence``): the
   serialized and the overlap-streamed step of one family issue the same
   MULTISET of collectives, with the bytes of each bucket accounted against
   the plan (:func:`bucket_accounting`).  The plan's upkeep is not the
   step's construction: the overlap scheduler's first step broadcasts rank
   0's gradient-readiness order (one ``int64`` vector, tagged ``"plan"``),
   which the JAX package derives on the host from its traced program with no
   collective (``bagua_tpu/core/backend.py:757-781``, outside its jaxpr).
   Those calls are compared across ranks like every other, listed in the
   report (``plan_collectives``), and left out of the two paths' multisets.

:func:`run_collective_checks` is the sweep over :data:`DEFAULT_FAMILIES` x
:data:`DEFAULT_ACCUM_STEPS` (JAX's, ``jaxpr_check.py:71-78``): one spawn of
:data:`SWEEP_WORLD` CPU gloo ranks, two nodes of two, each rank building
every configuration's serialized and overlapped trainer and recording the
first ``train_step`` of each; a ``:hier`` family runs its two-level form on
the ``{inter: 2, intra: 2}`` mesh, ``:hier-<codec>`` forces that codec on
the inter-node tier (``compress_inter``), ``:hier-compressed`` keeps the
family's own (``auto``).

Imports torch only where it records or sweeps.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .findings import Finding

#: families of the sweep, and their accumulation steps (JAX's defaults)
DEFAULT_FAMILIES = ("gradient_allreduce", "zero", "bytegrad",
                    "gradient_allreduce:hier", "zero:hier", "bytegrad:hier",
                    "gradient_allreduce:hier-int8",
                    "gradient_allreduce:hier-fp8_e4m3",
                    "gradient_allreduce:hier-fp8_e5m2",
                    "gradient_allreduce:hier-onebit_ef",
                    "bytegrad:hier-onebit_ef")
DEFAULT_ACCUM_STEPS = (1, 4)

#: the sweep's world: two nodes of two ranks
SWEEP_WORLD = 4
SWEEP_INTRA = 2

#: dtype name -> bytes an element
_ITEMSIZE = {"float64": 8, "float32": 4, "float16": 2, "bfloat16": 2,
             "int64": 8, "int32": 4, "int16": 2, "int8": 1, "uint8": 1,
             "bool": 1, "float8_e4m3fn": 1, "float8_e5m2": 1, "none": 0}


@dataclass(frozen=True)
class Collective:
    """One collective call's signature, as rank matching sees it."""

    op: str
    axes: Tuple[str, ...]
    shape: Tuple[int, ...]
    dtype: str

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n * _ITEMSIZE.get(self.dtype, 4)

    def render(self) -> str:
        shape = "x".join(map(str, self.shape)) or "scalar"
        return (f"{self.op}[{','.join(self.axes)}] "
                f"{shape}:{self.dtype} ({self.nbytes} B)")

    def to_json(self) -> list:
        return [self.op, list(self.axes), list(self.shape), self.dtype]

    @classmethod
    def from_json(cls, row) -> "Collective":
        op, axes, shape, dtype = row
        return cls(op, tuple(axes), tuple(shape), dtype)


def communicator_axes(trainer) -> Dict[int, Tuple[str, ...]]:
    """``id(communicator) -> mesh axes`` for every communicator ``trainer``
    reduces over: its bucket communicator (its comm axes), the two tiers of
    its context (``intra``, ``inter``) and the groups of its mesh."""
    axes: Dict[int, Tuple[str, ...]] = {id(trainer.comm): tuple(trainer.comm_axes)}
    intra, inter = trainer._tiers()
    for comm, name in ((intra, "intra"), (inter, "inter")):
        if comm is not None:
            axes.setdefault(id(comm), (name,))
    if trainer.mesh is not None:
        for key, comm in trainer.mesh._comms.items():
            axes.setdefault(id(comm), tuple(key))
    return axes


class CollectiveRecorder:
    """Record every blocking communicator call while installed (a context
    manager; one recorder at a time).  ``axes_of`` maps a communicator's
    ``id`` to its group's mesh axes (:func:`communicator_axes`); a call on an
    unknown communicator records the axes ``("?",)``, which no mesh binds."""

    def __init__(self, axes_of: Optional[Dict[int, Tuple[str, ...]]] = None):
        self.axes_of = dict(axes_of or {})
        self.log: List[Collective] = []
        #: the tag of each entry of ``log``: its bucket, "plan", or None
        self.buckets: List[Optional[object]] = []
        self._lock = threading.Lock()

    def _record(self, op: str, comm, args: tuple) -> None:
        from .. import communication

        x = next((a for a in args if hasattr(a, "shape") and hasattr(a, "dtype")), None)
        shape = tuple(int(d) for d in x.shape) if x is not None else ()
        dtype = str(x.dtype).replace("torch.", "") if x is not None else "none"
        entry = Collective(op, self.axes_of.get(id(comm), ("?",)), shape, dtype)
        bucket = communication.recorded_tag()
        with self._lock:
            self.log.append(entry)
            self.buckets.append(bucket)

    def __enter__(self) -> "CollectiveRecorder":
        from .. import communication

        if communication._COLLECTIVE_RECORDER is not None:
            raise RuntimeError("a collective recorder is already installed")
        communication._COLLECTIVE_RECORDER = self._record
        return self

    def __exit__(self, *exc) -> None:
        from .. import communication

        communication._COLLECTIVE_RECORDER = None


# ---- the checks --------------------------------------------------------------


def multiset(collectives: Sequence[Collective]) -> Counter:
    return Counter(collectives)


def diff_multisets(a: Counter, b: Counter) -> str:
    lines = []
    for c in sorted(set(a) | set(b), key=lambda c: (c.op, c.axes, c.shape, c.dtype)):
        na, nb = a.get(c, 0), b.get(c, 0)
        if na != nb:
            lines.append(f"  {c.render()}: serialized x{na}, overlap x{nb}")
    return "\n".join(lines)


def check_axis_binding(collectives: Sequence[Collective], mesh_axes: Sequence[str],
                       context: str = "") -> List[Finding]:
    known = set(mesh_axes)
    findings = []
    for c in collectives:
        missing = [a for a in c.axes if a not in known]
        if missing:
            findings.append(Finding(
                rule="unbound-mesh-axis", path="<collectives>", line=0,
                message=(f"{context + ': ' if context else ''}{c.render()} runs over "
                         f"axes {missing} not bound on the mesh (axes: {sorted(known)})"),
                hint="build the communicator from the trainer's mesh, or declare the "
                     "axis on it",
                text=f"{context}:{c.op}:{','.join(missing)}",
            ))
    return findings


def check_rank_agreement(logs: Sequence[Sequence[Collective]],
                         context: str = "") -> List[Finding]:
    """Every rank's log, per group of axes, is the same sequence."""
    def by_axes(log):
        out: Dict[Tuple[str, ...], List[Collective]] = {}
        for c in log:
            out.setdefault(c.axes, []).append(c)
        return out

    findings = []
    ref = by_axes(logs[0]) if logs else {}
    for rank, log in enumerate(logs[1:], start=1):
        mine = by_axes(log)
        for axes in sorted(set(ref) | set(mine)):
            a, b = ref.get(axes, []), mine.get(axes, [])
            if a != b:
                k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
                at0 = a[k].render() if k < len(a) else "(nothing)"
                atr = b[k].render() if k < len(b) else "(nothing)"
                findings.append(Finding(
                    rule="rank-collective-divergence", path="<collectives>", line=0,
                    message=(f"{context + ': ' if context else ''}rank {rank} and rank 0 "
                             f"issue different collectives over {list(axes)}: call {k} is "
                             f"{atr} on rank {rank}, {at0} on rank 0 (lengths {len(b)} and "
                             f"{len(a)}): the ranks deadlock or reduce mismatched data"),
                    hint="post every collective on every rank of the group, in one order; "
                         "never branch on a rank-local value around a collective",
                    text=f"{context}:rank{rank}:{','.join(axes)}",
                ))
    return findings


def bucket_accounting(plan, collectives: Sequence[Collective],
                      buckets: Sequence[Optional[int]], world: int) -> List[dict]:
    """Per-bucket byte accounting: the collectives each bucket's reduction
    issued (its ``recording_tag``), or, for an untagged collective
    (ZeRO's parameter allgather after the update), the bucket whose padded
    size or ``1/world`` shard it carries, where exactly one bucket has it.
    The rest is a ``"unattributed"`` row, so summing the rows gives the
    total wire bytes of ``collectives``."""
    rows = [{"bucket": i, "padded_numel": int(b.padded_numel),
             "flat_bytes": int(b.padded_numel) * _ITEMSIZE.get(
                 str(b.dtype).replace("torch.", ""), 4),
             "collectives": [], "wire_bytes": 0}
            for i, b in enumerate(plan.buckets)]
    by_size: Dict[int, List[int]] = {}
    for i, b in enumerate(plan.buckets):
        sizes = {int(b.padded_numel)}
        if b.padded_numel % world == 0:
            sizes.add(int(b.padded_numel) // world)
        for s in sizes:
            by_size.setdefault(s, []).append(i)
    rest = {"bucket": "unattributed", "padded_numel": 0, "flat_bytes": 0,
            "collectives": [], "wire_bytes": 0}
    for c, tag in zip(collectives, buckets):
        numel = 1
        for d in c.shape:
            numel *= int(d)
        if tag is None and len(by_size.get(numel, ())) == 1:
            tag = by_size[numel][0]
        row = rows[tag] if isinstance(tag, int) and 0 <= tag < len(rows) else rest
        row["collectives"].append(c.render())
        row["wire_bytes"] += c.nbytes
    return rows + ([rest] if rest["collectives"] else [])


def step_entries(record: dict) -> Tuple[List[Collective], List[object], List[Collective]]:
    """A record's log split into the step's construction (entries and their
    tags) and the plan's upkeep (tag ``"plan"``)."""
    step, tags, plan = [], [], []
    for c, tag in zip(record["log"], record["buckets"]):
        if tag == "plan":
            plan.append(c)
        else:
            step.append(c)
            tags.append(tag)
    return step, tags, plan


def check_equivalence(family: str, accum_steps: int,
                      records: Dict[str, dict]) -> Tuple[List[Finding], dict]:
    """``records[mode]`` (mode ``"off"`` serialized, ``"on"`` overlapped):
    ``{"log": [Collective], "buckets": [tag], "mesh_axes": [...], "plan":
    BucketPlan, "world": n}`` of one rank.  Requires multiset equality of
    the step's construction, with the axis binding of every entry and the
    byte accounting of each bucket."""
    findings: List[Finding] = []
    report: dict = {"family": family, "accum_steps": accum_steps}
    steps = {}
    for mode in ("off", "on"):
        rec = records[mode]
        findings.extend(check_axis_binding(
            rec["log"], rec["mesh_axes"],
            context=f"{family}/accum{accum_steps}/overlap={mode}"))
        step, tags, plan = step_entries(rec)
        steps[mode] = step
        report["serialized" if mode == "off" else "overlap"] = {
            "collectives": [c.render() for c in step],
            "plan_collectives": [c.render() for c in plan],
            "total_wire_bytes": int(sum(c.nbytes for c in step)),
            "buckets": bucket_accounting(rec["plan"], step, tags, rec["world"]),
        }
    ser, ovl = multiset(steps["off"]), multiset(steps["on"])
    report["equal"] = ser == ovl
    if ser != ovl:
        findings.append(Finding(
            rule="overlap-serialized-divergence", path="<collectives>", line=0,
            message=(f"{family} (accum_steps={accum_steps}): overlap and serialized "
                     "steps issue different collective multisets:\n"
                     f"{diff_multisets(ser, ovl)}"),
            hint="both paths must ride Algorithm.reduce_bucket_grad: one "
                 "implementation, so they cannot drift",
            text=f"{family}:accum{accum_steps}",
        ))
    return findings, report


# ---- the family harness (one rank) -------------------------------------------


def parse_family(family: str) -> Tuple[str, bool, Optional[str]]:
    """``family[:hier[-codec]]`` -> (base family, hierarchical,
    compress_inter), with the JAX checker's variants."""
    base, _, variant = family.partition(":")
    if base not in ("gradient_allreduce", "zero", "bytegrad"):
        raise ValueError(f"unknown family {family!r}")
    hierarchical = variant.startswith("hier")
    compress_inter = None
    if hierarchical and variant != "hier":
        suffix = variant[len("hier-"):] if variant.startswith("hier-") else ""
        if suffix == "compressed":
            compress_inter = "auto"
        elif suffix:
            from ..compression.codecs import get_codec

            get_codec(suffix)   # fail fast on a typo'd codec
            compress_inter = suffix
        else:
            raise ValueError(f"unknown family variant {family!r}")
    elif variant and not hierarchical:
        raise ValueError(f"unknown family variant {family!r}")
    return base, hierarchical, compress_inter


def _fixture():
    """Tiny deterministic MLP and batch (the JAX checker's dims 8-32-32-4,
    32 rows): several buckets at the sweep's 2 KiB bucket size."""
    import numpy as np
    import torch

    rng = np.random.RandomState(0)
    dims = [8, 32, 32, 4]
    layers: List[torch.nn.Module] = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        lin = torch.nn.Linear(a, b)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(rng.randn(b, a).astype(np.float32) * 0.02))
            lin.bias.zero_()
        layers.append(lin)
        if i < len(dims) - 2:
            layers.append(torch.nn.Tanh())
    model = torch.nn.Sequential(*layers)
    batch = {"x": rng.randn(32, dims[0]).astype(np.float32),
             "y": rng.randn(32, dims[-1]).astype(np.float32)}

    def loss_fn(m, b):
        return torch.mean((m(b["x"]) - b["y"]) ** 2)

    return model, batch, loss_fn


def record_family(family: str, accum_steps: int, overlap: str,
                  bucket_bytes: int = 2048, device: str = "cpu") -> dict:
    """Build one configuration's trainer on this rank's process group and
    record its first ``train_step``: ``{"log", "buckets", "mesh_axes",
    "plan", "world"}`` (see :func:`check_equivalence`)."""
    import functools

    import torch

    from .. import algorithms
    from ..core.backend import BaguaTrainer
    from ..parallel.mesh import hierarchical_mesh

    base, hierarchical, compress_inter = parse_family(family)
    sgd = functools.partial(torch.optim.SGD, lr=1e-2)
    if base == "gradient_allreduce":
        algo, opt = algorithms.GradientAllReduceAlgorithm(hierarchical=hierarchical), sgd
    elif base == "bytegrad":
        algo, opt = algorithms.ByteGradAlgorithm(hierarchical=hierarchical), sgd
    else:
        algo = algorithms.ZeroOptimizerAlgorithm(
            functools.partial(torch.optim.Adam, lr=1e-3), hierarchical=hierarchical)
        opt = None
    mesh = hierarchical_mesh() if hierarchical else None
    model, batch, loss_fn = _fixture()
    trainer = BaguaTrainer(loss_fn, opt, algo, mesh=mesh, bucket_bytes=bucket_bytes,
                           accum_steps=accum_steps, overlap=overlap, autotune=False,
                           compress_inter=compress_inter, device=device)
    state = trainer.init(model)
    batch = trainer.shard_batch(batch)
    mesh_axes = trainer.mesh.axis_names if trainer.mesh is not None else ("dp",)
    with CollectiveRecorder(communicator_axes(trainer)) as rec:
        trainer.train_step(state, batch)
    if getattr(trainer, "_worker", None) is not None:
        trainer._worker.close()
    return {"log": list(rec.log), "buckets": list(rec.buckets),
            "mesh_axes": tuple(mesh_axes), "plan": trainer.plan,
            "world": trainer.world_size}


def _sweep_rank(rank: int, world: int, init_method: str, families: Sequence[str],
                accum_steps: Sequence[int], out_path: str) -> None:
    """One rank of the sweep: every configuration, both modes; the logs and
    the plans' bucket sizes to ``out_path`` as JSON."""
    import torch

    from .. import communication

    torch.set_num_threads(1)
    communication.init_process_group(init_method, world_size=world, rank=rank,
                                     device="cpu", intra_size=SWEEP_INTRA)
    out = []
    for family in families:
        for accum in accum_steps:
            for mode in ("off", "on"):
                rec = record_family(family, accum, mode)
                out.append({
                    "family": family, "accum": accum, "mode": mode,
                    "log": [c.to_json() for c in rec["log"]], "buckets": rec["buckets"],
                    "mesh_axes": list(rec["mesh_axes"]), "world": rec["world"],
                    "plan": [[int(b.padded_numel), str(b.dtype).replace("torch.", "")]
                             for b in rec["plan"].buckets],
                })
    with open(out_path, "w") as fh:
        json.dump(out, fh)
    torch.distributed.destroy_process_group()


class PlanRows:
    """A plan's buckets as ``[[padded_numel, dtype], ...]`` rows (read back
    from a rank's JSON), with the attributes :func:`bucket_accounting`
    reads."""

    def __init__(self, rows):
        self.buckets = [type("Bucket", (), {"padded_numel": n, "dtype": d})()
                        for n, d in rows]


def sweep_ranks(families: Sequence[str] = DEFAULT_FAMILIES,
                accum_steps: Sequence[int] = DEFAULT_ACCUM_STEPS,
                workdir: Optional[str] = None, timeout_s: float = 300.0) -> List[List[dict]]:
    """One spawn of :data:`SWEEP_WORLD` CPU gloo ranks (two nodes of two)
    recording every configuration; returns each rank's runs (JSON rows, in
    order: every family x accum, serialized then overlapped).  The ranks'
    files go to a fresh directory under ``workdir`` (default the system's
    temporary directory)."""
    import tempfile

    for family in families:
        parse_family(family)
    workdir = tempfile.mkdtemp(prefix="bagua_collectives_", dir=workdir)
    outs = [os.path.join(workdir, f"rank{r}.json") for r in range(SWEEP_WORLD)]
    init = f"file://{os.path.join(workdir, 'store')}"
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ, "OMP_NUM_THREADS": "1", "BAGUA_AUTOTUNE": "0",
           "PYTHONPATH": os.pathsep.join(p for p in (pkg_root, os.environ.get("PYTHONPATH"))
                                         if p)}
    env.pop("LOCAL_WORLD_SIZE", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bagua_tpu_torch.analysis.collective_check", "--rank", str(r),
         "--world", str(SWEEP_WORLD), "--init-method", init,
         "--families", ",".join(families),
         "--accum-steps", ",".join(str(a) for a in accum_steps), "--out", outs[r]],
        env=env) for r in range(SWEEP_WORLD)]
    deadline = time.monotonic() + timeout_s
    try:
        # a rank that fails leaves its peers waiting in a collective: stop
        # every rank at the first failure or at the deadline
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    codes = [p.returncode for p in procs]
    if codes != [0] * SWEEP_WORLD:
        raise RuntimeError(f"collective sweep ranks exited {codes} (logs: {workdir})")
    ranks = []
    for path in outs:
        with open(path) as fh:
            ranks.append(json.load(fh))
    return ranks


def check_sweep(ranks: List[List[dict]]) -> Tuple[List[Finding], List[dict]]:
    """The checks over :func:`sweep_ranks`' output: on every rank, axis
    binding and overlap-vs-serialized equivalence; across ranks, the
    sequence agreement.  Reports are rank 0's."""
    findings: List[Finding] = []
    reports: List[dict] = []
    for i in range(0, len(ranks[0]), 2):
        family, accum = ranks[0][i]["family"], ranks[0][i]["accum"]
        for rank, runs in enumerate(ranks):
            records = {}
            for run in runs[i:i + 2]:
                records[run["mode"]] = {
                    "log": [Collective.from_json(c) for c in run["log"]],
                    "buckets": run["buckets"], "mesh_axes": run["mesh_axes"],
                    "plan": PlanRows(run["plan"]), "world": run["world"]}
            f, report = check_equivalence(family, accum, records)
            findings.extend(f)
            if rank == 0:
                reports.append(report)
        for mode_i in (i, i + 1):
            findings.extend(check_rank_agreement(
                [[Collective.from_json(c) for c in runs[mode_i]["log"]] for runs in ranks],
                context=f"{family}/accum{accum}/overlap={ranks[0][mode_i]['mode']}"))
    # one finding per (rule, text): every rank reports an equivalence fault
    seen, unique = set(), []
    for f in findings:
        if (f.rule, f.text) not in seen:
            seen.add((f.rule, f.text))
            unique.append(f)
    return unique, reports


def run_collective_checks(families: Sequence[str] = DEFAULT_FAMILIES,
                          accum_steps: Sequence[int] = DEFAULT_ACCUM_STEPS,
                          workdir: Optional[str] = None, timeout_s: float = 300.0,
                          ) -> Tuple[List[Finding], List[dict]]:
    """The sweep (:func:`sweep_ranks`) and its checks (:func:`check_sweep`)."""
    return check_sweep(sweep_ranks(families, accum_steps, workdir, timeout_s))


def _main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="one rank of the collective sweep")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--families", required=True)
    ap.add_argument("--accum-steps", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    _sweep_rank(args.rank, args.world, args.init_method,
                [f for f in args.families.split(",") if f],
                [int(a) for a in args.accum_steps.split(",") if a], args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
