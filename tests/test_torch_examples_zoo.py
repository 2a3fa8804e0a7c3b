"""``examples/torch/parallelism_zoo.py`` at four gloo ranks of the CPU: every
row of the JAX zoo (``examples/parallelism_zoo.py``) on meshes sized from the
world (dp 2 x tp, pp, sp, ep 2; 2 x 2 hierarchical; pp 2 x tp 2; ZeRO-1 with
accumulation at dp 4): every row trains 5 Adam steps to a finite loss below
the first step's, the same loss on every rank, and the script ends with
``all parallelism axes ran``.  The row sizing is held at worlds 1, 2, 4 and
8 (8: the JAX example's meshes), a row that does not fit printed as skipped
with its reason.
"""

import numpy as np
import pytest

from workers.torch_example_worker import load, spawn

JAX_MESHES = [{"dp": 8}, {"inter": 2, "intra": 4}, {"dp": 2, "tp": 4}, {"dp": 2, "pp": 4},
              {"dp": 2, "sp": 4}, {"dp": 2, "ep": 4}, {"dp": 2, "pp": 2, "tp": 2}, {"dp": 8}]


def test_world_8_rows_are_the_jax_meshes():
    zoo = load("parallelism_zoo")
    assert [axes for _, axes, _ in zoo.rows(8)] == JAX_MESHES


@pytest.mark.parametrize("world,n_skipped", [(1, 6), (2, 2), (4, 0)])
def test_rows_are_sized_from_the_world(world, n_skipped):
    zoo = load("parallelism_zoo")
    rows = zoo.rows(world)
    assert len(rows) == len(JAX_MESHES)
    skipped = [(name, why) for name, axes, why in rows if axes is None]
    assert len(skipped) == n_skipped and all(why for _, why in skipped)
    for _, axes, _ in rows:
        if axes is not None:
            assert int(np.prod(list(axes.values()))) == world


def test_every_row_trains_at_world_4(tmp_path):
    ranks = spawn("parallelism_zoo", 4, [], tmp_path, timeout=400)
    assert all("all parallelism axes ran" in r["stdout"] for r in ranks)
    losses = ranks[0]["losses"]
    assert len(losses) == len(JAX_MESHES) and not ranks[0]["skipped"]
    for name, row in losses.items():
        assert np.isfinite(row).all() and row[-1] < row[0], (name, row)
        for other in ranks[1:]:
            assert other["losses"][name] == row, name
