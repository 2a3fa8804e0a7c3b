"""One rank of the port's tensor- and pipeline-parallel checks over gloo
(tests/test_torch_tensor_parallel.py, tests/test_torch_pipeline_parallel.py,
tests/test_torch_3d_parallel.py, tests/test_torch_hierarchical_mp.py,
tests/test_torch_checkpoint_meshes.py, tests/test_torch_generate.py).

    python torch_tensor_pipeline_worker.py RANK WORLD INIT_METHOD IN_NPZ OUT_NPZ CASES

Runs each case of the comma-separated ``CASES`` in order on this rank and
writes its outputs under ``<case>/`` in ``OUT_NPZ``.  ``IN_NPZ`` holds, for
each case, its spec as JSON (``<case>/spec``), its tokens and the GLOBAL
flax params the test made with the JAX package (``<case>/params/<name>``).
A spec holds:

- ``model``: ``lm`` (``TransformerLM``, with ring attention over ``sp``
  where the mesh has that axis, and ``MoEMLP`` in the odd layers over
  ``ep`` where it has that one) or ``pp`` (``PipelinedTransformerLM`` with
  ``n_micro`` microbatches), at the widths of ``cfg`` and the mesh's ``tp``
  (and ``pp``) sizes;
- ``mesh``: the axis sizes, set as the global mesh;
- ``algo`` (``ga``, ``bytegrad``, ``qadam``, ``zero``; ``algo_kw``), ``opt``
  (``sgd``, ``adam``), ``lr``, ``steps``, ``trainer_kw``: the trainer's,
  with ``tp_axis``, ``pp_axis``, ``seq_axis``, ``expert_axis`` for the
  mesh's axes;
- ``kind``: ``train`` (losses, ``unstack_params``, the layout, the data
  rank, the plan, each bucket's ``bucket_tier_bytes`` and whether the
  context has two tiers), ``fwd`` (the model's logits on
  ``tokens[:, :-1]``), ``ckpt`` (4 steps straight against 2,
  ``save_checkpoint``, a fresh trainer's ``restore_checkpoint`` and 2 more;
  then a restore onto the mesh ``other_mesh`` and 2 steps there: their
  losses, or the restore's error), ``remesh`` (2 steps on ``mesh``, a save,
  a restore onto ``other_mesh`` and 2 steps there: their losses, or the
  error), ``error`` (the error of the first step), ``conjugates``
  (``tp_reduce`` and ``tp_gather_grad`` over the tp axis on random
  operands, and the control: an allreduce whose backward is an allreduce
  too), ``generate`` (``generate_tp`` over the mesh's ``tp`` axis of the
  GLOBAL params, ``n`` tokens after the prompt ``tokens`` at
  ``temperature``, twice from a generator seeded ``seed``: the tokens and
  the logits);
- ``control``: ``noprescale`` turns off the trainer's ``pp_size`` prescale
  (the run the prescale gate must catch).

Imports only torch, numpy and the port.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import torch

import bagua_tpu_torch as bt
from bagua_tpu_torch.communication import ReduceOp
from bagua_tpu_torch.models.convert import params_from_jax
from bagua_tpu_torch.parallel import tensor_parallel as tpm


def _unflat(flat):
    tree = {}
    for name, arr in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return tree


def _params(data, case):
    prefix = f"{case}/params/"
    return _unflat({k[len(prefix):]: data[k] for k in data.files if k.startswith(prefix)})


#: the experts of the ``ep`` meshes' MoE layers
N_EXPERTS = 4


def _model(spec, mesh):
    tp, pp, sp, ep = (mesh.get(a, 1) for a in ("tp", "pp", "sp", "ep"))
    cfg = bt.TransformerConfig(**spec["cfg"], dtype=torch.float32,
                               tp_axis="tp" if tp > 1 else None, tp_size=tp,
                               sp_axis="sp" if sp > 1 else None)
    if spec["model"] == "pp":
        return bt.PipelinedTransformerLM(cfg, pp_size=pp, n_microbatches=spec.get("n_micro", 1),
                                         device="cpu")
    factory = None
    if ep > 1:
        moe = lambda: bt.MoEMLP(N_EXPERTS, cfg.d_ff, d_model=cfg.d_model, ep_size=ep, k=2,
                                dropless=True, dtype=torch.float32)
        factory = lambda i: moe if i % 2 == 1 else None
    return bt.TransformerLM(cfg, device="cpu", mlp_factory=factory,
                            attn_fn=bt.make_ring_attention(sp) if sp > 1 else None)


def _trainer(spec, mesh_sizes, mesh):
    algo, kw = spec.get("algo", "ga"), spec.get("algo_kw", {})
    if algo == "qadam":
        algorithm, opt = bt.QAdamAlgorithm(**kw), None
    else:
        make = (functools.partial(torch.optim.SGD, lr=spec["lr"]) if spec["opt"] == "sgd"
                else functools.partial(torch.optim.Adam, lr=spec["lr"]))
        algorithm, opt = {
            "zero": lambda: (bt.ZeroOptimizerAlgorithm(make, **kw), None),
            "bytegrad": lambda: (bt.ByteGradAlgorithm(**kw), make),
            "ga": lambda: (bt.GradientAllReduceAlgorithm(**kw), make)}[algo]()
    axes = {f"{k}_axis": a for k, a in (("tp", "tp"), ("pp", "pp"), ("seq", "sp"),
                                        ("expert", "ep"))
            if mesh_sizes.get(a, 1) > 1}
    if spec["model"] == "pp":
        loss_fn = bt.pp_lm_loss_fn
    elif mesh_sizes.get("sp", 1) > 1:
        loss_fn = bt.sp_lm_loss_fn(mesh_sizes["sp"])
    elif mesh_sizes.get("ep", 1) > 1:
        loss_fn = bt.moe_lm_loss_fn()
    else:
        loss_fn = bt.lm_loss_fn
    trainer = bt.BaguaTrainer(loss_fn, opt, algorithm, device="cpu", mesh=mesh, **axes,
                              **spec.get("trainer_kw", {}))
    if spec.get("control") == "noprescale":
        trainer._prescale_partial_grads = lambda grads: None
    return trainer


_MESHES = {}


def _mesh(sizes):
    """The mesh of ``sizes``, built once a worker (collective: every rank
    runs the cases in one order), set as the global mesh."""
    key = json.dumps(sizes)
    if key not in _MESHES:
        _MESHES[key] = bt.build_mesh(sizes)
    bt.set_global_mesh(_MESHES[key])
    return _MESHES[key]


def _fresh(spec, data, case, mesh_sizes):
    mesh = _mesh(mesh_sizes)
    model = _model(spec, mesh_sizes)
    model.load_state_dict(params_from_jax(_params(data, case), model))
    trainer = _trainer(spec, mesh_sizes, mesh)
    return trainer, trainer.init(model)


def _steps(trainer, state, tokens, n):
    batch = trainer.shard_batch({"tokens": tokens}, global_batch=True)
    losses = []
    for _ in range(n):
        state, loss = trainer.train_step(state, batch)
        losses.append(loss.item())
    return state, losses


def run_train(spec, data, case, tokens):
    trainer, state = _fresh(spec, data, case, spec["mesh"])
    state, losses = _steps(trainer, state, tokens, spec["steps"])
    out = {f"param/{n}": t.numpy() for n, t in trainer.unstack_params(state).items()}
    trainer.flush_grad_health()
    algo, ctx = trainer.algorithm, trainer._ctx
    tiers = [ctx.bucket_tier_bytes(i, getattr(algo, "hierarchical", False),
                                   dcn_codec=algo.wire_codec_dcn,
                                   flat_codec=algo.wire_codec_flat)
             for i in range(len(ctx.plan.buckets))]
    out.update(losses=np.array(losses), resident=np.array(trainer._flat_resident),
               healthy=np.array([float(trainer.step_metrics.get("grad_healthy", 1.0))]),
               data_rank=np.array(trainer.data_rank), world=np.array(trainer.world_size),
               dp_axes=np.array(",".join(trainer.dp_axes)),
               plan=np.array(",".join(trainer.plan.tensor_names)),
               tiers=np.array(json.dumps(tiers)), two_tier=np.array(ctx.two_tier()))
    return out


def run_fwd(spec, data, case, tokens):
    _mesh(spec["mesh"])
    model = _model(spec, spec["mesh"])
    model.load_state_dict(params_from_jax(_params(data, case), model))
    with torch.no_grad():
        return {"logits": model(torch.tensor(tokens[:, :-1])).numpy()}


def run_error(spec, data, case, tokens):
    trainer, state = _fresh(spec, data, case, spec["mesh"])
    try:
        _steps(trainer, state, tokens, 1)
        return {"error": np.array("")}
    except NotImplementedError as e:
        return {"error": np.array(str(e))}


def run_ckpt(spec, data, case, tokens, directory):
    trainer, state = _fresh(spec, data, case, spec["mesh"])
    state, straight = _steps(trainer, state, tokens, 4)
    want = trainer.unstack_params(state)
    trainer, state = _fresh(spec, data, case, spec["mesh"])
    state, first = _steps(trainer, state, tokens, 2)
    mgr = bt.BaguaCheckpointManager(directory, async_save=False)
    trainer.save_checkpoint(mgr, 2, state)
    mgr.wait()
    meta = trainer.checkpoint_layout_metadata()
    trainer, state = _fresh(spec, data, case, spec["mesh"])
    step, state = trainer.restore_checkpoint(mgr, state)
    state, rest = _steps(trainer, state, tokens, 2)
    got = trainer.unstack_params(state)
    other = _on_other_mesh(spec, data, case, tokens, mgr) if spec.get("other_mesh") else {}
    mgr.close()
    return {"straight": np.array(straight), "resumed": np.array(first + rest),
            "step": np.array(step), "error": np.array(""), **other,
            "same": np.array(all(torch.equal(got[n], want[n]) for n in want)),
            "meta": np.array(json.dumps(meta, sort_keys=True)),
            "files": np.array(sorted(os.listdir(os.path.join(directory, "2"))))}


def _on_other_mesh(spec, data, case, tokens, mgr):
    """A restore of the newest step onto ``other_mesh`` (its model built at
    that mesh's widths) and 2 steps there: ``other_losses``, or the
    restore's ``error``."""
    other, other_state = _fresh(spec, data, case, spec["other_mesh"])
    try:
        _, other_state = other.restore_checkpoint(mgr, other_state)
    except ValueError as e:
        return {"error": np.array(str(e)), "other_losses": np.zeros(0)}
    _, losses = _steps(other, other_state, tokens, 2)
    return {"error": np.array(""), "other_losses": np.array(losses),
            "other_world": np.array(other.world_size)}


def run_remesh(spec, data, case, tokens, directory):
    trainer, state = _fresh(spec, data, case, spec["mesh"])
    state, first = _steps(trainer, state, tokens, 2)
    mgr = bt.BaguaCheckpointManager(directory, async_save=False)
    trainer.save_checkpoint(mgr, 2, state)
    mgr.wait()
    out = _on_other_mesh(spec, data, case, tokens, mgr)
    mgr.close()
    return {"first": np.array(first), **out}


def run_generate(spec, data, case, tokens):
    """``generate_tp`` of the GLOBAL params (a dense model's state dict) on
    a tensor-parallel model of this rank's widths, whose own weights are
    not used."""
    mesh = _mesh(spec["mesh"])
    dense = bt.TransformerLM(bt.TransformerConfig(**spec["cfg"], dtype=torch.float32),
                             device="cpu")
    dense.load_state_dict(params_from_jax(_params(data, case), dense))
    model = _model(spec, spec["mesh"])
    out = {}
    for i in range(2):
        gen = torch.Generator().manual_seed(spec.get("seed", 0))
        toks, logits = bt.generate_tp(model, dense.state_dict(), tokens, spec["n"], mesh,
                                      temperature=spec.get("temperature", 0.0),
                                      generator=gen, return_logits=True)
        out[f"tokens{i}"], out[f"logits{i}"] = toks.numpy(), logits.numpy()
    return out


class _RawAllReduce(torch.autograd.Function):
    """The control of ``tp_reduce``: an allreduce whose backward is an
    allreduce too."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.allreduce(x.clone(), ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.allreduce(g.clone(), ReduceOp.SUM), None


def run_conjugates(spec, data, case, tokens):
    mesh = _mesh(spec["mesh"])
    comm, r = mesh.comm("tp"), mesh.coords["tp"]
    g = torch.tensor(data[f"{case}/g"])
    out = {}
    for name, fn in (("reduce", tpm.tp_reduce), ("gather", tpm.tp_gather_grad),
                     ("control", _RawAllReduce.apply)):
        x = (torch.tensor(data[f"{case}/x"]) + r).requires_grad_()
        y = fn(x, comm)
        (y * g).sum().backward()
        out[f"{name}/y"], out[f"{name}/dx"] = y.detach().numpy(), x.grad.numpy()
    return out


RUNS = {"train": run_train, "fwd": run_fwd, "error": run_error, "ckpt": run_ckpt,
        "conjugates": run_conjugates, "remesh": run_remesh, "generate": run_generate}


def spawn(world, cases, data, tmp, timeout=300):
    """Run ``world`` ranks of this worker over gloo on ``cases`` with the
    arrays of ``data`` (name -> array) and return each rank's outputs.  A
    rank still running after ``timeout`` seconds (a pipeline whose transfers
    do not pair up hangs) fails the spawn."""
    np.savez(tmp / "in.npz", **data)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")])}
    outs = [tmp / f"out{r}.npz" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         f"file://{tmp / 'store'}", str(tmp / "in.npz"), str(outs[r]), ",".join(cases)],
        env=env) for r in range(world)]
    try:
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert codes == [0] * world, codes
    return [dict(np.load(o)) for o in outs]


def main(rank, world, init_method, in_path, out_path, cases):
    # the ranks yield the CPU to the suite's other tests (JAX's virtual
    # devices must meet at their collectives within a timeout)
    os.nice(10)
    torch.set_num_threads(1)
    bt.init_process_group(init_method, world_size=world, rank=rank, device="cpu")
    data = np.load(in_path)
    out = {}
    for case in cases.split(","):
        spec = json.loads(str(data[f"{case}/spec"]))
        tokens = data[f"{case}/tokens"].astype(np.int64)
        args = ([os.path.join(os.path.dirname(out_path), f"ckpt_{case}")]
                if spec["kind"] in ("ckpt", "remesh") else [])
        torch.manual_seed(0)
        result = RUNS[spec["kind"]](spec, data, case, tokens, *args)
        out.update({f"{case}/{k}": v for k, v in result.items()})
        bt.set_global_mesh(None)
    np.savez(out_path, **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])
