"""``examples/torch/squad_finetune.py --tiny`` against ``examples/squad_finetune.py``.

Both at the tiny config (4 layers, d_model 128, seq 64) in f32 (the port's
``--dtype float32``; the JAX side builds its example's ``SquadModel`` at the
same f32 config), from the JAX example's init carried across by
``params_from_jax``, on the JAX example's synthetic rows (numpy seed 0, 8
rows):

- the first step's loss equals JAX's within 1e-5;
- ``gradient_allreduce`` (AdamW 1e-3) stays on JAX's trajectory (the JAX
  trainer on its 8 CPU devices, one row each) within 1e-4 relative over 4
  steps;
- ``bytegrad`` and ``qadam`` at two gloo ranks (the codec's plain path on
  the CPU) give finite losses that fall, the same on both ranks.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from workers.torch_example_worker import load, spawn

torch.set_num_threads(1)   # these tests share the CPU with the other workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, ROWS, LR, STEPS = 64, 8, 1e-3, 4
TINY = ["--tiny", "--dtype", "float32", "--seq", str(SEQ), "--lr", str(LR)]


def _jax_example():
    path = os.path.join(REPO, "examples", "squad_finetune.py")
    spec = importlib.util.spec_from_file_location("jax_squad_finetune", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_run():
    """The JAX example's lines at the tiny f32 config: its init, the first
    loss and 4 logged gradient-allreduce losses on the 8 CPU devices."""
    import bagua_tpu
    from bagua_tpu.models.transformer import TransformerConfig

    jex = _jax_example()
    bagua_tpu.init_process_group()
    assert len(jax.devices()) == 8
    cfg = TransformerConfig(vocab_size=1024, d_model=128, n_heads=4, n_layers=4, d_ff=512,
                            max_seq_len=SEQ, dtype=jnp.float32)
    model = jex.SquadModel(cfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (ROWS, SEQ)).astype(np.int32)
    starts = rng.integers(0, SEQ, ROWS).astype(np.int32)
    ends = np.minimum(starts + rng.integers(1, 16, ROWS), SEQ - 1).astype(np.int32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(ids[:2]))["params"]

    def loss_fn(p, b):
        s_logits, e_logits = model.apply({"params": p}, b["ids"])
        return 0.5 * (
            optax.softmax_cross_entropy_with_integer_labels(s_logits, b["start"]).mean()
            + optax.softmax_cross_entropy_with_integer_labels(e_logits, b["end"]).mean())

    batch = {"ids": jnp.asarray(ids), "start": jnp.asarray(starts), "end": jnp.asarray(ends)}
    first = float(loss_fn(params, batch))
    algo, tx = jex.make_algorithm("gradient_allreduce", LR)
    trainer = bagua_tpu.BaguaTrainer(loss_fn, tx, algo)
    state = trainer.init(params)
    sharded = trainer.shard_batch(batch)
    losses = []
    for _ in range(STEPS):
        state, loss = trainer.train_step(state, sharded)
        losses.append(float(loss))
    return jax.tree.map(np.asarray, params), first, losses


def test_first_loss_and_trajectory_match_jax(jax_run):
    params, first, want = jax_run
    ex = load("squad_finetune")
    args = ex.parser().parse_args([*TINY, "--batch", str(ROWS), "--steps", str(STEPS),
                                   "--algorithm", "gradient_allreduce", "--device", "cpu"])
    out = ex.run(args, params)
    assert out["world"] == 1 and out["batch"] == ROWS
    np.testing.assert_allclose(out["losses"][0], first, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out["losses"], want, rtol=1e-4)
    assert np.isfinite(out["seq_per_sec"])


@pytest.mark.parametrize("algorithm", ["bytegrad", "qadam"])
def test_compressed_families_train_at_two_ranks(jax_run, tmp_path, algorithm):
    params, _, _ = jax_run
    ranks = spawn("squad_finetune", 2, [*TINY, "--batch", str(ROWS // 2), "--steps",
                                        str(STEPS), "--algorithm", algorithm], tmp_path,
                  params=params)
    losses = ranks[0]["losses"]
    assert ranks[1]["losses"] == losses
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert f"algorithm={algorithm}" in ranks[0]["stdout"]
    assert "throughput=" in ranks[0]["stdout"]
