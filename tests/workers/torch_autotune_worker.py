"""One rank of the port's autotune runs over gloo
(tests/test_torch_autotune_integration.py).

    python torch_autotune_worker.py RANK WORLD INIT_METHOD DATA_NPZ PARAMS_NPZ OUT_NPZ RUNS

Trains the golden-task MLP (``torch_trainer_worker.FlaxLayoutMLP``) on this
rank's slice of the fixed batch for each run of the comma-separated
``RUNS``:

- ``tuned``: a trainer at autotune level 1 (the spawner sets
  ``BAGUA_SERVICE_PORT`` and the service's ``BAGUA_AUTOTUNE_*``, so rank 0's
  ``init_process_group`` starts the sidecar; ``BAGUA_AUTOTUNE_SPACE=legacy``)
  until the first check-in that changes the plan, then 10 steps more; and an
  untuned control trainer over the same steps.  Keys: ``losses``,
  ``control_losses``, ``signatures`` (a hash of the plan a step),
  ``checkins`` (step, speed, buckets a check-in), the final parameters of
  both (``param/``, ``control/``), and the service task's registered tensors
  (rank 0, ``registered``).
- ``qadam`` / ``qadam:leaf``: Adam 1e-2, gradient allreduce for 3 steps, a
  switch to QAdam (warmup 20) for 3, back for 3, on the resident (or leaf)
  layout.  Keys: ``losses``, ``adopted`` (the largest adopted first moment),
  ``anchor`` (QAdam's warmup minus the step count at the switch), ``back``
  (whether the torch optimizer came back with ``exp_avg``), ``param/``.
- ``async``: SGD 0.05 on the leaf layout, 3 steps, async model average for 6,
  back for 3.  Keys: ``losses``, ``param/`` (after the catch-up average),
  ``diverged`` (whether the ranks' weights differed during async).
- ``ef``: SGD 0.1, 3 steps, ``compress_intra="onebit_ef"`` for 3, ``"off"``
  for 2.  Keys: ``losses``, ``ef_zero`` (the residual right after its
  migration, all zeros), ``ef_sizes`` (its buckets' elements) and
  ``padded`` (the plan's), ``ef_after`` (whether ``algo_state`` holds a
  residual after the flip back), ``trace`` (the parameter flat a step).
- ``sequence``: SGD 0.1 through the fixed recommendations in
  ``SEQUENCE_JSON`` (a JSON list of ``[step, hyperparameters]``, applied
  before that step), as the JAX trainer runs them.  Keys: ``losses``.
Imports only torch, numpy and the port.
"""

import functools
import hashlib
import json
import os
import sys

import numpy as np
import torch

import bagua_tpu_torch as bt
from bagua_tpu_torch.define import BaguaHyperparameter

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_trainer_worker import FlaxLayoutMLP  # noqa: E402

SGD = functools.partial(torch.optim.SGD, lr=0.1)
ADAM = functools.partial(torch.optim.Adam, lr=1e-2)


def _loss(m, b):
    return torch.nn.functional.cross_entropy(m(b["x"]), b["y"])


def _trainer(params_path, opt, algo, **kw):
    t = bt.BaguaTrainer(_loss, opt, algo, device="cpu", **kw)
    return t, t.init(FlaxLayoutMLP(np.load(params_path)))


def _params(prefix, model):
    return {f"{prefix}/{n}": p.detach().numpy().copy() for n, p in model.named_parameters()}


def _sig(trainer):
    return int(hashlib.sha1(repr(trainer.plan.signature()).encode()).hexdigest()[:12], 16)


def run_tuned(batch, params_path):
    t, s = _trainer(params_path, SGD, bt.GradientAllReduceAlgorithm(hierarchical=False),
                    autotune=True, model_name="tuned")
    assert t.autotune, "registration failed"
    losses, sigs, changed_at = [], [], None
    first = _sig(t)
    while len(losses) < 410:
        s, loss = t.train_step(s, batch)
        losses.append(loss.item())
        sigs.append(_sig(t))
        if changed_at is None and sigs[-1] != first:
            changed_at = len(losses)
        if changed_at is not None and len(losses) >= changed_at + 10:
            break
    c, cs = _trainer(params_path, SGD, bt.GradientAllReduceAlgorithm(hierarchical=False),
                     autotune=False)
    control = []
    for _ in losses:
        cs, loss = c.train_step(cs, batch)
        control.append(loss.item())
    out = {"losses": np.array(losses), "control_losses": np.array(control),
           "signatures": np.array(sigs, dtype=np.int64),
           "checkins": np.array([[ci["step"], ci["speed"], ci["buckets"]]
                                 for ci in t.autotune_checkins])}
    out.update(_params("param", s.model))
    out.update(_params("control", cs.model))
    if bt.get_rank() == 0:
        from bagua_tpu_torch import communication

        task = communication._AUTOTUNE_SERVER.RequestHandlerClass.service._task("tuned")
        out["registered"] = np.array([d.name for d in task.tensor_list])
    return out


def run_qadam(batch, params_path, leaf):
    t, s = _trainer(params_path, ADAM, bt.GradientAllReduceAlgorithm(), autotune=False,
                    flat_resident="off" if leaf else "on")
    losses = []
    out = {}
    for phase, family in enumerate(("gradient_allreduce", "qadam", "gradient_allreduce")):
        if phase:
            t._apply_recommendation(BaguaHyperparameter(algorithm=family))
            if family == "qadam":
                out["anchor"] = t.algorithm.warmup_steps - t._step_counter
        for i in range(3):
            s, loss = t.train_step(s, batch)
            losses.append(loss.item())
            if family == "qadam" and i == 0:
                moments = s.opt_state.exp_avg
                moments = moments.values() if isinstance(moments, dict) else moments
                out["adopted"] = max(float(m.abs().max()) for m in moments)
    out["back"] = s.optimizer is not None and all(
        "exp_avg" in st for st in s.optimizer.state.values())
    out["losses"] = np.array(losses)
    out.update(_params("param", s.model))
    return out


def run_async(batch, params_path):
    t, s = _trainer(params_path, functools.partial(torch.optim.SGD, lr=0.05),
                    bt.GradientAllReduceAlgorithm(), autotune=False, flat_resident="off")
    losses, diverged = [], False
    comm = t.comm
    for family, n in (("gradient_allreduce", 3), ("async", 6), ("gradient_allreduce", 3)):
        if losses:
            t._apply_recommendation(BaguaHyperparameter(algorithm=family))
        for _ in range(n):
            s, loss = t.train_step(s, batch)
            losses.append(loss.item())
            if family == "async":
                w = torch.cat([p.detach().reshape(-1) for p in s.model.parameters()])
                gathered = comm.allgather(w[None], axis=0, tiled=True)
                diverged |= not torch.equal(gathered[0], gathered[-1])
    out = {"losses": np.array(losses), "diverged": diverged,
           "family": type(t.algorithm).__name__}
    out.update(_params("param", s.model))
    return out


def run_ef(batch, params_path):
    t, s = _trainer(params_path, SGD, bt.GradientAllReduceAlgorithm(), autotune=False)
    losses, trace = [], []
    out = {"padded": np.array([b.padded_numel for b in t.plan.buckets])}
    for codec, n in (("auto", 3), ("onebit_ef", 3), ("off", 2)):
        if codec != "auto":
            t._apply_recommendation(BaguaHyperparameter(compress_intra=codec))
            assert t._pending_state_migration is not None
            s = t._pending_state_migration(s)
            t._pending_state_migration = None
            if codec == "onebit_ef":
                ef = s.algo_state["ef"]["buckets"]
                out["ef_zero"] = bool(all(not r.any() and r.dtype == torch.float32 for r in ef))
                out["ef_sizes"] = np.array([r.numel() for r in ef])
        for _ in range(n):
            s, loss = t.train_step(s, batch)
            losses.append(loss.item())
            named = {k: p.detach() for k, p in s.model.named_parameters()}
            trace.append(torch.cat(t.plan.flatten(named)).numpy().copy())
    out["ef_after"] = isinstance(s.algo_state, dict) and "ef" in s.algo_state
    out["losses"] = np.array(losses)
    out["trace"] = np.stack(trace)
    return out


def run_sequence(batch, params_path):
    sequence = {int(k): v for k, v in json.loads(os.environ["SEQUENCE_JSON"])}
    t, s = _trainer(params_path, SGD, bt.GradientAllReduceAlgorithm(), autotune=False)
    losses = []
    for i in range(max(sequence) + 3):
        if i in sequence:
            t._apply_recommendation(BaguaHyperparameter(**sequence[i]))
        s, loss = t.train_step(s, batch)
        losses.append(loss.item())
    return {"losses": np.array(losses)}


def main(rank, world, init_method, data_path, params_path, out_path, runs):
    torch.set_num_threads(1)
    bt.init_process_group(init_method, world_size=world, rank=rank, device="cpu")
    data = np.load(data_path)
    rows = data["x"].shape[0] // world
    part = slice(rank * rows, (rank + 1) * rows)
    batch = {"x": torch.from_numpy(data["x"][part]),
             "y": torch.from_numpy(data["y"][part].astype(np.int64))}
    out = {}
    for run in runs.split(","):
        if run == "tuned":
            res = run_tuned(batch, params_path)
        elif run.startswith("qadam"):
            res = run_qadam(batch, params_path, leaf=run.endswith(":leaf"))
        elif run == "async":
            res = run_async(batch, params_path)
        elif run == "ef":
            res = run_ef(batch, params_path)
        else:
            res = run_sequence(batch, params_path)
        out.update({f"{run}/{k}": v for k, v in res.items()})
    np.savez(out_path, **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    r, w, init, data, params, out, runs = sys.argv[1:]
    main(int(r), int(w), init, data, params, out, runs)
