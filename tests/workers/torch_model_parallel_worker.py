"""One rank of the port's expert- and sequence-parallel checks over gloo
(tests/test_torch_expert_parallel.py, tests/test_torch_sequence_parallel.py,
tests/test_torch_mesh.py).

    python torch_model_parallel_worker.py RANK WORLD INIT_METHOD IN_NPZ OUT_NPZ CHECKS

Runs each check of the comma-separated ``CHECKS`` in order on this rank,
with the inputs of ``IN_NPZ`` (seeded numpy arrays and flax params the test
made with the JAX package), and writes its outputs under ``<check>/`` in
``OUT_NPZ``.  A check is ``NAME[:ARG...]``:

- ``mesh``: the coordinates and, for every combination of the axes of
  ``{"dp": 2, "ep": -1}``, the group's size, rank and the global ranks
  gathered over it;
- ``moe:MODE:FORM`` (``MODE`` dropless|capacity, ``FORM`` dense|ragged): one
  ``MoEMLP`` expert-parallel over every rank (``{"ep": WORLD}``), this
  rank's slice of the batch ``moe/x``; its output, the gradients of its
  expert tables for ``sum(y * moe/g)`` and the router's summed over ranks;
- ``sgd:MODE``: one SGD step (lr 0.1) of a bare ``MoEMLP`` through
  ``BaguaTrainer(expert_axis="ep")`` on ``{"ep": WORLD}``, loss the mean
  squared error to ``sgd/y``; the global parameters after it;
- ``lm:ALGO:AXES`` (``AXES`` like ``dp2ep2``, ``ep2``, ``dp2sp2``;
  ``ALGO`` ga|bytegrad|zero|qadam; ``ATTN`` ring|ringplain|ulysses under
  sp): three Adam steps (lr ``LR``; ZeRO over Adam at ``LR``; QAdam at
  ``QADAM`` through its switch after two warmup steps) of the small LM of
  the test (MoE in odd layers under ep; ring or Ulysses attention under sp)
  through the trainer; losses, ``unstack_params``, the layout and the
  optimizer state's bytes (ZeRO's chunks, its local optimizer's);
- ``ckpt[:ALGO]``: the dp2ep2 MoE LM: 4 steps straight, against 2 steps, a
  save, and a fresh trainer restoring it and taking 2 more (losses and
  parameters bitwise; QAdam in its warmup phase, since a restored trainer
  counts its steps anew); with ``ga`` (the default) then a restore into an
  ``{"ep": WORLD}`` trainer (its error);
- ``attn:KIND`` (``ring``, ``ringplain``, ``ulysses``): ``attn/q,k,v``
  ``[b, S, h, d]`` sharded over ``{"sp": WORLD}`` along S; the output and
  the q/k/v gradients of ``sum(out * attn/g)`` of this rank's chunk;
- ``sploss``: ``sp_lm_loss_fn`` of the LM of ``lmsp/params`` on the whole
  batch, averaged over the ranks;
- ``spsgd:ATTN[:offset0]``: one SGD step (lr 0.1) of the LM of
  ``lmsp/params`` on ``{"sp": WORLD}`` through the trainer, the whole batch
  on every rank; the global parameters after it.  ``offset0`` builds the
  model without ``sp_axis`` (every shard at positions from 0): the control
  that the step's comparison must catch.

Imports only torch, numpy and the port.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import torch

import bagua_tpu_torch as bt
from bagua_tpu_torch.model_parallel.moe import MoEMLP
from bagua_tpu_torch.models.convert import params_from_jax
from bagua_tpu_torch.models.transformer import TransformerConfig, TransformerLM

#: the benches' Adam rate: an update is at most LR, so a one-ulp gradient
#: difference at a near-zero gradient moves a parameter by up to LR
LR = 1e-4
STEPS = 3
#: QAdam's settings: two warmup steps, then the compressed phase
QADAM = dict(warmup_steps=2, lr=1e-3)
#: the small LMs of the tests (f32)
SMALL_EP = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_seq_len=8)
SMALL_SP = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_seq_len=32)
N_EXPERTS = 4


def _prefixed(data, prefix):
    return {k[len(prefix):]: data[k] for k in data.files if k.startswith(prefix)}


def _mesh(axes: str):
    """``"dp2ep2"`` -> the mesh ``{"dp": 2, "ep": 2}``, set as the global one."""
    sizes, i = {}, 0
    while i < len(axes):
        name = axes[i:i + 2]
        j = i + 2
        while j < len(axes) and axes[j].isdigit():
            j += 1
        sizes[name] = int(axes[i + 2:j])
        i = j
    mesh = bt.build_mesh(sizes)
    bt.set_global_mesh(mesh)
    return mesh


def check_mesh(rank, world, data):
    mesh = bt.build_mesh({"dp": 2, "ep": -1})
    out = {"coords": np.array([mesh.coords[a] for a in mesh.axis_names])}
    for axes in (("dp",), ("ep",), ("dp", "ep")):
        comm = mesh.comm(axes)
        key = "+".join(axes)
        if comm is None:
            continue
        out[f"{key}/size"] = np.array(comm.nranks())
        out[f"{key}/rank"] = np.array(comm.rank())
        out[f"{key}/ranks"] = comm.allgather(torch.tensor([rank])).numpy()
    return out


def _load_moe(layer, p):
    """A ``MoEMLP`` from the flax params of one ``MoEMLP`` (router kernel
    ``[d, E]``, global expert tables)."""
    layer.load_state_dict(params_from_jax(
        {"router.kernel": p["router"], "expert_wi": p["wi"], "expert_wo": p["wo"]}, layer))


def check_moe(rank, world, data, mode, form):
    _mesh(f"ep{world}")
    p = _prefixed(data, "moe/")
    n_exp, d = p["wi"].shape[0], p["wi"].shape[1]
    layer = MoEMLP(n_exp, p["wi"].shape[2], d_model=d, ep_size=world, k=2,
                   capacity_factor=float(n_exp), dtype=torch.float32,
                   dropless=mode == "dropless", use_ragged=form == "ragged")
    _load_moe(layer, p)
    rows = p["x"].shape[0] // world
    part = slice(rank * rows, (rank + 1) * rows)
    x = torch.tensor(p["x"][part])
    y = layer(x)
    (y * torch.tensor(p["g"][part])).sum().backward()
    router = bt.allreduce(layer.router.weight.grad, bt.ReduceOp.SUM)
    return {"y": y.detach().numpy(), "d_wi": layer.expert_wi.grad.numpy(),
            "d_wo": layer.expert_wo.grad.numpy(), "d_router": router.numpy()}


def check_sgd(rank, world, data, mode):
    mesh = _mesh(f"ep{world}")
    p = _prefixed(data, "sgd/")
    n_exp, d = p["wi"].shape[0], p["wi"].shape[1]
    layer = MoEMLP(n_exp, p["wi"].shape[2], d_model=d, ep_size=world, k=2,
                   capacity_factor=float(n_exp), dtype=torch.float32,
                   dropless=mode == "dropless")
    _load_moe(layer, p)

    def loss_fn(model, batch):
        return ((model(batch["x"]) - batch["y"]) ** 2).mean()

    trainer = bt.BaguaTrainer(loss_fn, functools.partial(torch.optim.SGD, lr=0.1),
                              bt.GradientAllReduceAlgorithm(), device="cpu", mesh=mesh,
                              expert_axis="ep")
    state = trainer.init(layer)
    batch = trainer.shard_batch({"x": p["x"], "y": p["y"]}, global_batch=True)
    state, loss = trainer.train_step(state, batch)
    out = {f"param/{n}": t.numpy() for n, t in trainer.unstack_params(state).items()}
    out["loss"] = np.array(loss.item())
    out["plan"] = np.array(",".join(trainer.plan.tensor_names))
    return out


def _lm(mesh, attn, data, prefix, sp_axis="sp"):
    """The test's small LM on this rank: MoE in the odd layers under an
    ``ep`` axis, ring or Ulysses attention under an ``sp`` axis (the
    position offset read from ``sp_axis``); weights from the flax params
    under ``prefix``."""
    ep, sp = mesh.shape.get("ep", 1), mesh.shape.get("sp", 1)
    if "ep" in mesh.shape:
        cfg = TransformerConfig(**SMALL_EP, dtype=torch.float32)
        moe = lambda: MoEMLP(N_EXPERTS, cfg.d_ff, d_model=cfg.d_model, ep_size=ep, k=2,
                             dropless=True, dtype=torch.float32)
        model = TransformerLM(cfg, device="cpu",
                              mlp_factory=lambda i: moe if i % 2 == 1 else None)
    else:
        cfg = TransformerConfig(**SMALL_SP, dtype=torch.float32, sp_axis=sp_axis)
        attn_fn = {"ring": bt.make_ring_attention(sp),
                   "ringplain": bt.make_ring_attention(sp, use_flash="never"),
                   "ulysses": bt.make_ulysses_attention(sp)}[attn]
        model = TransformerLM(cfg, device="cpu", attn_fn=attn_fn)
    model.load_state_dict(params_from_jax(_prefixed(data, prefix), model))
    return model


def _lm_trainer(mesh, algo, qadam=QADAM, **kw):
    if "ep" in mesh.shape:
        loss_fn, axes = bt.moe_lm_loss_fn(), {"expert_axis": "ep"}
    else:
        loss_fn, axes = bt.sp_lm_loss_fn(mesh.shape["sp"]), {"seq_axis": "sp"}
    adam = functools.partial(torch.optim.Adam, lr=LR)
    algorithm = {"bytegrad": lambda: bt.ByteGradAlgorithm(hierarchical=False),
                 "ga": bt.GradientAllReduceAlgorithm,
                 "zero": lambda: bt.ZeroOptimizerAlgorithm(adam),
                 "qadam": lambda: bt.QAdamAlgorithm(**qadam)}[algo]()
    return bt.BaguaTrainer(loss_fn, None if algorithm.owns_optimizer else adam, algorithm,
                           device="cpu", mesh=mesh, **axes, **kw)


def _opt_bytes(trainer, state):
    """The bytes of the optimizer state this rank holds: ZeRO's chunk
    optimizer's and its local optimizer's apart, else the torch
    optimizer's or QAdam's moments."""
    size = lambda opt: sum(v.numel() * v.element_size() for st in opt.state.values()
                           for v in st.values() if torch.is_tensor(v) and v.dim())
    opt = state.opt_state
    if isinstance(opt, bt.algorithms.zero.ZeroOptState):
        return np.array([size(opt.optimizer), size(opt.local) if opt.local else 0])
    if opt is not None:
        moments = list(opt.exp_avg.values()) + list(opt.exp_avg_sq.values())
        return np.array([sum(t.numel() * t.element_size() for t in moments), 0])
    return np.array([size(state.optimizer), 0])


def check_lm(rank, world, data, algo, axes, attn="ring"):
    mesh = _mesh(axes)
    prefix = "lmep/params/" if "ep" in mesh.shape else "lmsp/params/"
    model = _lm(mesh, attn, data, prefix)
    trainer = _lm_trainer(mesh, algo)
    state = trainer.init(model)
    tokens = data["lmep/tokens" if "ep" in mesh.shape else "lmsp/tokens"]
    batch = trainer.shard_batch({"tokens": tokens.astype(np.int64)}, global_batch=True)
    losses = []
    for _ in range(STEPS):
        state, loss = trainer.train_step(state, batch)
        losses.append(loss.item())
    out = {f"param/{n}": t.numpy() for n, t in trainer.unstack_params(state).items()}
    out.update(losses=np.array(losses), resident=np.array(trainer._flat_resident),
               data_rank=np.array(trainer.data_rank), plan=np.array(
                   ",".join(trainer.plan.tensor_names)),
               staged=np.array(trainer.host_staged_bytes),
               opt_bytes=_opt_bytes(trainer, state))
    return out


def check_ckpt(rank, world, data, directory, algo="ga"):
    mesh = _mesh("dp2ep2")
    tokens = data["lmep/tokens"].astype(np.int64)

    def fresh():
        model = _lm(mesh, None, data, "lmep/params/")
        # a restored trainer counts its steps from 0, and so switches QAdam's
        # phase later than the straight run (in both packages): the resume
        # is held in the warmup phase
        trainer = _lm_trainer(mesh, algo, qadam={**QADAM, "warmup_steps": 100})
        return trainer, trainer.init(model)

    def steps(trainer, state, n):
        batch = trainer.shard_batch({"tokens": tokens}, global_batch=True)
        losses = []
        for _ in range(n):
            state, loss = trainer.train_step(state, batch)
            losses.append(loss.item())
        return state, losses

    trainer, state = fresh()
    state, straight = steps(trainer, state, 4)
    want = trainer.unstack_params(state)
    trainer, state = fresh()
    state, first = steps(trainer, state, 2)
    mgr = bt.BaguaCheckpointManager(directory, async_save=False)
    trainer.save_checkpoint(mgr, 2, state)
    mgr.wait()
    meta = trainer.checkpoint_layout_metadata()
    trainer, state = fresh()
    step, state = trainer.restore_checkpoint(mgr, state)
    state, rest = steps(trainer, state, 2)
    got = trainer.unstack_params(state)
    same = all(torch.equal(got[n], want[n]) for n in want)
    out = {"straight": np.array(straight), "resumed": np.array(first + rest),
           "step": np.array(step), "same": np.array(same),
           "mesh": np.array(str(meta.get("mesh"))), "files": np.array(sorted(
               os.listdir(os.path.join(directory, "2"))))}
    if algo != "ga":
        mgr.close()
        return out
    # another expert-parallel mesh: refused, before anything is written
    mesh4 = _mesh(f"ep{world}")
    cfg = TransformerConfig(**SMALL_EP, dtype=torch.float32)
    moe = lambda: MoEMLP(N_EXPERTS, cfg.d_ff, d_model=cfg.d_model, ep_size=world, k=2,
                         dropless=True, dtype=torch.float32)
    model4 = TransformerLM(cfg, device="cpu", mlp_factory=lambda i: moe if i % 2 == 1 else None)
    trainer4 = _lm_trainer(mesh4, "ga")
    state4 = trainer4.init(model4)
    try:
        trainer4.restore_checkpoint(mgr, state4)
        error = ""
    except ValueError as e:
        error = str(e)
    mgr.close()
    return {**out, "error": np.array(error)}


def check_attn(rank, world, data, kind):
    _mesh(f"sp{world}")
    p = _prefixed(data, "attn/")
    attn = {"ring": bt.make_ring_attention(world),
            "ringplain": bt.make_ring_attention(world, use_flash="never"),
            "ulysses": bt.make_ulysses_attention(world)}[kind]
    s = p["q"].shape[1] // world
    part = slice(rank * s, (rank + 1) * s)
    q, k, v = (torch.tensor(p[n][:, part]).requires_grad_() for n in "qkv")
    out = attn(q, k, v, torch.float32)
    (out * torch.tensor(p["g"][:, part])).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
            "dv": v.grad.numpy()}


def check_sploss(rank, world, data):
    mesh = _mesh(f"sp{world}")
    model = _lm(mesh, "ring", data, "lmsp/params/")
    loss = bt.sp_lm_loss_fn(world)(model, {"tokens": torch.tensor(
        data["lmsp/tokens"][:2].astype(np.int64))})
    return {"loss": bt.allreduce(loss.detach()).numpy()}


def check_spsgd(rank, world, data, attn, offset="offset"):
    mesh = _mesh(f"sp{world}")
    model = _lm(mesh, attn, data, "lmsp/params/",
                sp_axis=None if offset == "offset0" else "sp")
    trainer = bt.BaguaTrainer(bt.sp_lm_loss_fn(world), functools.partial(torch.optim.SGD, lr=0.1),
                              bt.GradientAllReduceAlgorithm(), device="cpu", mesh=mesh,
                              seq_axis="sp")
    state = trainer.init(model)
    batch = trainer.shard_batch({"tokens": data["lmsp/tokens"].astype(np.int64)},
                                global_batch=True)
    state, _ = trainer.train_step(state, batch)
    return {f"param/{n}": t.numpy() for n, t in trainer.unstack_params(state).items()}


CHECKS = {"mesh": check_mesh, "moe": check_moe, "sgd": check_sgd, "lm": check_lm,
          "ckpt": check_ckpt, "attn": check_attn, "sploss": check_sploss,
          "spsgd": check_spsgd}


def spawn(world, checks, data, tmp):
    """Run ``world`` ranks of this worker over gloo on ``checks`` with the
    arrays of ``data`` (name -> array) and return each rank's outputs."""
    np.savez(tmp / "in.npz", **data)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")])}
    outs = [tmp / f"out{r}.npz" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         f"file://{tmp / 'store'}", str(tmp / "in.npz"), str(outs[r]), ",".join(checks)],
        env=env) for r in range(world)]
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert codes == [0] * world, codes
    return [dict(np.load(o)) for o in outs]


def main(rank, world, init_method, in_path, out_path, checks):
    torch.set_num_threads(1)
    bt.init_process_group(init_method, world_size=world, rank=rank, device="cpu")
    data = np.load(in_path)
    out = {}
    for check in checks.split(","):
        name, *args = check.split(":")
        if name == "ckpt":
            args = [os.path.join(os.path.dirname(out_path), check.replace(":", "_"))] + args
        torch.manual_seed(0)
        result = CHECKS[name](rank, world, data, *args)
        out.update({f"{check}/{k}": v for k, v in result.items()})
        bt.set_global_mesh(None)
    np.savez(out_path, **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])
