"""One rank of the port's gloo runs (tests/test_torch_trainer.py,
tests/test_torch_compressed.py, tests/test_torch_onebit.py,
tests/test_torch_hierarchical.py, tests/test_torch_zero.py,
tests/test_torch_decentralized.py).

    python torch_trainer_worker.py RANK WORLD INIT_METHOD DATA_NPZ OUT_NPZ STEPS [ALGOS [PARAMS_NPZ]]

Trains the golden-task MLP on this rank's contiguous slice of the batch in
``DATA_NPZ`` and writes the loss history and final params to ``OUT_NPZ``.
Without ``ALGOS`` it trains once with ``GradientAllReduceAlgorithm`` at
512-byte buckets from a per-rank random init (the trainer gives every rank
rank 0's weights) and writes unprefixed keys.  ``ALGOS`` is a comma-separated
list of the names in ``ALGORITHMS`` below, each trained at the default
bucket size from the flax params in ``PARAMS_NPZ`` (keys ``dense_<i>.kernel``
``[in, out]`` and ``dense_<i>.bias``) held in flax's layout, so that every
bucket flat, and so every codec chunk, holds the same elements as the JAX
trainer's; keys prefixed ``<algo>/``, with the L1 norm of this rank's
error-feedback residual (``ef_norm``, -1 when there is none) and whether it
is finite, the plan's padded element count (``padded_numel``) and, for the
ZeRO runs, the elements of each of this rank's optimizer state tensors by
name (``state/<name>``); for the gossip families, whose weights differ
between ranks, the parameters and the algorithm state after every step
(``trace/<name>``, ``trace/params`` in bucket order, ``trace/peer_weights``,
``trace/left`` ...) and the codec calls (``codec_calls``).  The tiers' size
is ``LOCAL_WORLD_SIZE`` (else the world).
Imports only torch, numpy and the port.
"""

import os

import contextlib
import functools
import sys

import numpy as np
import torch

import bagua_tpu_torch as bt
from bagua_tpu_torch.models.mlp import MLP

SGD = functools.partial(torch.optim.SGD, lr=0.1)
#: ``bench._algorithms()["zero"]``'s ``optax.sgd(0.1, momentum=0.9)``
SGD_MOMENTUM = functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)
ADAM = functools.partial(torch.optim.Adam, lr=1e-2)


class FlaxLayoutMLP(torch.nn.Module):
    """The golden-task MLP with flax ``Dense`` kernels ``[in, out]``,
    registered in the order of the JAX package's sorted pytree flatten
    (``dense_0.bias``, ``dense_0.kernel``, ...).  torch's ``Linear`` keeps
    ``[out, in]``, which orders a bucket's elements differently, so a codec
    chunk would hold other elements than the JAX trainer's."""

    def __init__(self, params):
        super().__init__()
        self.n = len({k.split(".")[0] for k in params.files})
        for i in range(self.n):
            layer = torch.nn.Module()
            layer.bias = torch.nn.Parameter(torch.from_numpy(params[f"dense_{i}.bias"]))
            layer.kernel = torch.nn.Parameter(torch.from_numpy(params[f"dense_{i}.kernel"]))
            self.add_module(f"dense_{i}", layer)

    def forward(self, x):
        for i in range(self.n):
            layer = getattr(self, f"dense_{i}")
            x = x @ layer.kernel + layer.bias
            if i < self.n - 1:
                x = torch.relu(x)
        return x


#: name -> (algorithm factory, BaguaTrainer keywords, environment)
ALGORITHMS = {
    "gradient_allreduce": (bt.GradientAllReduceAlgorithm, {}, {}),
    "bytegrad": (lambda: bt.ByteGradAlgorithm(hierarchical=False), {}, {}),
    "qadam": (lambda: bt.QAdamAlgorithm(warmup_steps=2, hierarchical=False), {}, {}),
    "int8": (bt.GradientAllReduceAlgorithm, {"compress_intra": "int8"}, {}),
    # the defaults: hierarchical=True, two-level where the tiers allow it
    "bytegrad_default": (bt.ByteGradAlgorithm, {}, {}),
    "qadam_default": (lambda: bt.QAdamAlgorithm(warmup_steps=2), {}, {}),
    # the stateful codecs on the flat ring, with and without the residual
    "onebit": (bt.GradientAllReduceAlgorithm, {"compress_intra": "onebit_ef"}, {}),
    "onebit_off": (bt.GradientAllReduceAlgorithm, {"compress_intra": "onebit_ef"},
                   {"BAGUA_EF_RESIDUAL": "off"}),
    "topk": (bt.GradientAllReduceAlgorithm, {"compress_intra": "topk"},
             {"BAGUA_TOPK_RATIO": "0.1"}),
    # the two-level allreduce, full precision and with an inter-node codec
    "hier": (lambda: bt.GradientAllReduceAlgorithm(hierarchical=True), {}, {}),
    "hier_onebit": (lambda: bt.GradientAllReduceAlgorithm(hierarchical=True),
                    {"compress_inter": "onebit_ef"}, {}),
    "hier_int8": (lambda: bt.GradientAllReduceAlgorithm(hierarchical=True),
                  {"compress_inter": "int8"}, {}),
    # ZeRO-1: flat, staged (two nodes of two at world 4; one node, so flat,
    # at world 2), through the int8 ring, clipped; with Adam beside the
    # replicated Adam it must equal
    "zero": (lambda: bt.ZeroOptimizerAlgorithm(SGD_MOMENTUM), {}, {}),
    "zero_hierarchical": (lambda: bt.ZeroOptimizerAlgorithm(SGD_MOMENTUM, hierarchical=True),
                          {}, {}),
    "zero_int8": (lambda: bt.ZeroOptimizerAlgorithm(SGD_MOMENTUM), {"compress_intra": "int8"},
                  {}),
    "zero_clip": (lambda: bt.ZeroOptimizerAlgorithm(SGD_MOMENTUM, clip_global_norm=0.5), {}, {}),
    "zero_adam": (lambda: bt.ZeroOptimizerAlgorithm(ADAM), {}, {}),
    "adam": (bt.GradientAllReduceAlgorithm, {}, {}),
    # the gossip families: flat, every interval 1 or 2, the peer weights
    # tracked; hierarchical (one node at world 2, two nodes of two at world
    # 4); the default constructors
    "dec_all": (lambda: bt.DecentralizedAlgorithm(hierarchical=False,
                                                  track_peer_weights=True), {}, {}),
    "dec_all_i2": (lambda: bt.DecentralizedAlgorithm(
        hierarchical=False, communication_interval=2, track_peer_weights=True), {}, {}),
    "dec_shift_one": (lambda: bt.DecentralizedAlgorithm(
        hierarchical=False, peer_selection_mode="shift_one", track_peer_weights=True), {}, {}),
    "dec_shift_one_i2": (lambda: bt.DecentralizedAlgorithm(
        hierarchical=False, peer_selection_mode="shift_one", communication_interval=2,
        track_peer_weights=True), {}, {}),
    "dec_hier": (lambda: bt.DecentralizedAlgorithm(hierarchical=True, track_peer_weights=True),
                 {}, {}),
    "dec_hier_shift_one": (lambda: bt.DecentralizedAlgorithm(
        hierarchical=True, peer_selection_mode="shift_one", track_peer_weights=True), {}, {}),
    "dec_default": (bt.DecentralizedAlgorithm, {}, {}),
    "lowprec": (lambda: bt.LowPrecisionDecentralizedAlgorithm(hierarchical=False), {}, {}),
    "lowprec_i2": (lambda: bt.LowPrecisionDecentralizedAlgorithm(
        hierarchical=False, communication_interval=2), {}, {}),
    "lowprec_default": (bt.LowPrecisionDecentralizedAlgorithm, {}, {}),
}
#: the optimizer of a run that does not own its optimizer, where not SGD
OPTIMIZERS = {"adam": ADAM}


@contextlib.contextmanager
def _environ(values):
    """``values`` set in the environment for the run (the codec knobs are
    read while the trainer is built and at every lookup of the codec)."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def _trainer(algo, ce, bucket_bytes=None):
    factory, kw, _ = ALGORITHMS[algo]
    opt = None if algo.startswith(("qadam", "zero")) else OPTIMIZERS.get(algo, SGD)
    return bt.BaguaTrainer(ce, opt, factory(), device="cpu", bucket_bytes=bucket_bytes, **kw)


def main(rank, world, init_method, data_path, out_path, steps, algos=None, params_path=None):
    torch.set_num_threads(1)
    bt.init_process_group(init_method, world_size=world, rank=rank, device="cpu")
    data = np.load(data_path)
    rows = data["x"].shape[0] // world
    part = slice(rank * rows, (rank + 1) * rows)
    local = {"x": data["x"][part], "y": data["y"][part].astype(np.int64)}

    def ce(m, b):
        return torch.nn.functional.cross_entropy(m(b["x"]), b["y"])

    out = {}
    for algo in (algos or "gradient_allreduce").split(","):
        with _environ(ALGORITHMS[algo][2]):
            out.update(_run(algo, algos is None, rank, data, local, ce, steps, params_path))
    np.savez(out_path, **out)
    torch.distributed.destroy_process_group()


def _run(algo, random_init, rank, data, local, ce, steps, params_path):
    """One algorithm's run on this rank; returns its output arrays."""
    if random_init:
        model = MLP(data["x"].shape[1], features=(32, 8), device="cpu", seed=int(rank))
        trainer, prefix = _trainer(algo, ce, bucket_bytes=512), ""
    else:
        model = FlaxLayoutMLP(np.load(params_path))
        trainer, prefix = _trainer(algo, ce), f"{algo}/"
    state = trainer.init(model)   # every rank starts from rank 0's weights
    batch = trainer.shard_batch(local)
    losses, trace = [], {}
    gossip = not trainer.algorithm.replicated_params
    codec = _CodecCalls() if gossip else contextlib.nullcontext()
    with codec:
        for _ in range(steps):
            state, loss = trainer.train_step(state, batch)
            losses.append(loss.item())
            if gossip:
                _trace_step(trace, trainer, model, state.algo_state)
    ef = (state.algo_state or {}).get("ef")
    ef = None if ef is None else ef["buckets"]
    out = {prefix + "losses": np.array(losses),
           prefix + "n_buckets": len(trainer.plan.buckets),
           prefix + "ef_norm": -1.0 if ef is None else float(sum(r.abs().sum() for r in ef)),
           prefix + "ef_finite": ef is None or all(bool(r.isfinite().all()) for r in ef),
           prefix + "padded_numel": sum(b.padded_numel for b in trainer.plan.buckets)}
    if algo.startswith("zero"):
        for st in state.opt_state.optimizer.state.values():
            for key, t in st.items():
                if t.dim() > 0:
                    out[f"{prefix}state/{key}"] = out.get(f"{prefix}state/{key}", 0) + t.numel()
    out.update({prefix + n: p.detach().numpy().copy() for n, p in model.named_parameters()})
    if gossip:
        out[prefix + "codec_calls"] = codec.calls
        out[prefix + "eval_loss"] = trainer.eval_step(state, batch).item()
        out.update({f"{prefix}trace/{k}": np.stack(v) for k, v in trace.items()})
    return out


class _CodecCalls:
    """Counts the MinMaxUInt8 compress and decompress calls the gossip
    families make while entered (on the CPU the codec takes its plain
    version, which no launch count sees)."""

    def __enter__(self):
        from bagua_tpu_torch.algorithms import decentralized

        self.calls, self._module = 0, decentralized
        self._saved = (decentralized.compress_chunked, decentralized.decompress_chunked)

        def counted(fn):
            def call(*args):
                self.calls += 1
                return fn(*args)
            return call

        decentralized.compress_chunked, decentralized.decompress_chunked = map(
            counted, self._saved)
        return self

    def __exit__(self, *exc):
        self._module.compress_chunked, self._module.decompress_chunked = self._saved


def _trace_step(trace, trainer, model, algo_state):
    """Append this step's parameters, by name and as their bucket flats
    (``params``), and the gossip state's flats (``peer_weights``, the
    ``left``/``right``/``self`` replicas) to ``trace``; each bucket list
    concatenated."""
    named = {n: p.detach() for n, p in model.named_parameters()}
    items = list(named.items()) + [("params", trainer.plan.flatten(named))]
    items += list((algo_state or {}).items())
    items = [(k, torch.cat(v) if isinstance(v, list) else v) for k, v in items]
    for key, t in items:
        trace.setdefault(key, []).append(t.numpy().copy())


if __name__ == "__main__":
    r, w, init, data, out, steps, *rest = sys.argv[1:]
    main(int(r), int(w), init, data, out, int(steps), *rest)
