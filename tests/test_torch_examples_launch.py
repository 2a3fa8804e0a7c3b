"""``examples/torch/communication_primitives.py`` and
``examples/torch/elastic_training.py`` as a user runs them: under the port's
launcher (``python -m bagua_tpu_torch.distributed.run``, the console script
``bagua-tpu-torch-run``) on gloo ranks of the CPU.

- Every eager primitive of the port against numpy math over the rank axis
  at 2 and 4 ranks (exact, sums within 1e-5), as
  ``tests/test_examples.py::test_communication_primitives_example`` runs the
  JAX example.
- The elastic example under ``--max_restarts 1`` with
  ``BAGUA_TEST_CRASH_AT_STEP``: the first attempt crashes, the gang restart
  resumes from the newest checkpoint and finishes.  Its resumed trajectory
  equals an uninterrupted run's losses within 1e-6 (same world, same
  reduction order: the restore is exact).
- Every example asks for the card unless ``--device cpu`` is given, and
  raises without one: nothing falls back to the CPU.
"""

import re

import pytest

from workers.torch_example_worker import launch, load


@pytest.mark.parametrize("world", [2, 4])
def test_communication_primitives_under_the_launcher(tmp_path, world):
    code, out = launch("communication_primitives", world, [], tmp_path)
    assert code == 0, out[-3000:]
    assert out.count(f"communication primitives OK (world={world})") == world, out[-3000:]


@pytest.mark.parametrize("example,argv", [
    ("mnist_mlp", []), ("elastic_training", ["--ckpt-dir", "unused"]),
    ("communication_primitives", []), ("generate_lm", []), ("moe_mnist", []),
    ("squad_finetune", ["--tiny"]), ("imagenet_resnet", ["--tiny"]), ("parallelism_zoo", []),
])
def test_every_example_needs_a_card_unless_cpu_is_asked_for(example, argv):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(example).main(argv)


def test_communication_primitives_needs_two_ranks():
    ex = load("communication_primitives")
    with pytest.raises(AssertionError, match="at least 2"):
        ex.main(["--device", "cpu"])


def _losses(text):
    # the ranks' lines may interleave on the launcher's output
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"step (\d+) loss (-?\d+\.\d{6})", text)}


def test_elastic_crash_restart_resumes(tmp_path):
    ckpt = tmp_path / "ck"
    code, out = launch("elastic_training", 2,
                       ["--ckpt-dir", str(ckpt), "--steps", "12", "--save-every", "3"],
                       tmp_path, flags=["--max_restarts", "1"],
                       env={"BAGUA_TEST_CRASH_AT_STEP": "7"})
    assert code == 0, out[-3000:]
    assert "injected crash" in out
    assert "resumed from checkpoint step 6" in out
    assert "final_loss" in out
    code2, straight = launch("elastic_training", 2,
                             ["--ckpt-dir", str(tmp_path / "ck2"), "--steps", "12",
                              "--save-every", "3"], tmp_path)
    assert code2 == 0, straight[-3000:]
    want, got = _losses(straight), _losses(out.split("resumed from checkpoint step 6")[-1])
    assert sorted(got) == list(range(7, 12))
    for step, loss in got.items():
        assert abs(loss - want[step]) <= 1e-6, (step, loss, want[step])
