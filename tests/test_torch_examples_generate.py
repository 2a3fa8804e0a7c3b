"""``examples/torch/generate_lm.py`` against ``examples/generate_lm.py``.

The port's example trains the tiny f32 LM to memorize the JAX example's
sequence through ``prefetch_to_device`` and regenerates its continuation
with ``generate`` (world 1, in this process) and, at two gloo ranks, with
``generate_tp`` over a tp 2 mesh as well; both print ``generate_lm OK``.
From the JAX example's init, carried across by ``params_from_jax``, the
first training loss equals the JAX model's loss on the same tokens within
1e-5 (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from workers.torch_example_worker import load, spawn

torch.set_num_threads(1)   # these tests share the CPU with the other workers


def test_world_1_regenerates_the_sequence(capsys):
    ex = load("generate_lm")
    out = ex.run(ex.parser().parse_args(["--device", "cpu"]))
    assert "generate_lm OK" in capsys.readouterr().out
    assert out["tokens"][0] == ex.SEQ[4:-1].tolist() and out["tokens_tp"] is None


def test_first_loss_matches_jax_from_carried_weights():
    from bagua_tpu.models.transformer import TransformerConfig, TransformerLM, lm_loss_fn

    ex = load("generate_lm")
    cfg = TransformerConfig(vocab_size=32, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                            max_seq_len=24, dtype=jnp.float32)
    model = TransformerLM(cfg)
    tokens = np.tile(ex.SEQ.astype(np.int32), (8, 1))
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:2, :-1]))["params"]
    want = float(lm_loss_fn(model)(params, {"tokens": jnp.asarray(tokens)}))
    out = ex.run(ex.parser().parse_args(["--device", "cpu"]), jax.tree.map(np.asarray, params))
    np.testing.assert_allclose(out["losses"][0], want, atol=1e-5, rtol=1e-5)


def test_tp2_at_two_ranks(tmp_path):
    ranks = spawn("generate_lm", 2, [], tmp_path)
    want = load("generate_lm").SEQ[4:-1].tolist()
    for rec in ranks:
        assert "generate_lm OK" in rec["stdout"] and "generated (tp=2)" in rec["stdout"]
        assert rec["tokens"][0] == want and rec["tokens_tp"][0] == want
