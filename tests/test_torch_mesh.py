"""Port's mesh of rank axes against the JAX package's ``build_mesh``: the
rank -> coordinate order (row-major in axis order), the ``-1`` inference and
its errors, the groups of each axis and combination of axes, and their
communicators over gloo (tests/workers/torch_model_parallel_worker.py,
4 ranks)."""

import itertools
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import bagua_tpu_torch as bt
from bagua_tpu.parallel.mesh import build_mesh as jbuild_mesh
from bagua_tpu_torch.parallel.mesh import Mesh, mesh_axis_size, resolve_axis_sizes

sys.path.insert(0, str(Path(__file__).resolve().parent / "workers"))
import torch_model_parallel_worker as worker  # noqa: E402

SIZES = [{"dp": 8}, {"dp": 2, "ep": 4}, {"ep": 4, "dp": 2}, {"dp": 2, "sp": 2, "ep": 2},
         {"inter": 2, "intra": 4}, {"dp": -1, "sp": 2}, {"dp": 2, "ep": -1}]


@pytest.fixture(scope="module", autouse=True)
def process_group():
    bt.init_process_group(device="cpu")


@pytest.mark.parametrize("sizes", SIZES, ids=str)
def test_rank_coordinates_match_jax(sizes):
    jmesh = jbuild_mesh(sizes)
    layout = Mesh(resolve_axis_sizes(sizes, 8), 0)
    assert layout.shape == dict(jmesh.shape)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for idx in itertools.product(*(range(n) for n in ids.shape)):
        mesh = Mesh(layout.shape, int(ids[idx]))
        assert tuple(mesh.coords[a] for a in mesh.axis_names) == idx
        assert mesh.rank == int(ids[idx])
    # each group: the ranks sharing every other coordinate, in JAX's order
    for n in range(1, len(jmesh.axis_names) + 1):
        for axes in itertools.combinations(jmesh.axis_names, n):
            others = [a for a in jmesh.axis_names if a not in axes]
            moved = np.moveaxis(ids, [jmesh.axis_names.index(a) for a in others],
                                range(len(others)))
            for block in moved.reshape((-1,) + moved.shape[len(others):]):
                want = sorted(int(r) for r in block.reshape(-1))
                for r in want:
                    assert Mesh(layout.shape, r).group_ranks(axes) == want
            assert mesh_axis_size(layout, axes) == int(np.prod([jmesh.shape[a] for a in axes]))


@pytest.mark.parametrize("sizes", [{"dp": -1, "ep": -1}, {"dp": 3, "ep": -1}, {"dp": 3},
                                   {"dp": 2, "ep": 2}], ids=str)
def test_inference_errors_match_jax(sizes):
    with pytest.raises(ValueError) as jerr:
        jbuild_mesh(sizes)
    with pytest.raises(ValueError) as err:
        resolve_axis_sizes(sizes, 8)
    assert str(err.value) == str(jerr.value)


def test_world_one_makes_no_group():
    mesh = bt.build_mesh({"dp": 1, "ep": 1, "sp": 1})
    assert mesh.communicators() == [] and mesh.comm("ep") is None
    assert mesh.index(("dp", "ep")) == 0 and mesh.size_of("sp") == 1
    assert bt.build_mesh().shape == {"dp": 1}
    with pytest.raises(ValueError, match="is not a mesh axis"):
        mesh.comm("tp")
    bt.set_global_mesh(mesh)
    try:
        assert bt.get_global_mesh() is mesh
    finally:
        bt.set_global_mesh(None)
    tiers = bt.hierarchical_mesh()
    assert tiers.shape == {"inter": 1, "intra": 1} and tiers.comm("intra") is None


def test_axis_groups_over_gloo(tmp_path):
    """Four ranks on ``{"dp": 2, "ep": -1}``: each group's size, this rank's
    place in it and the ranks gathered over it are the layout's."""
    outs = worker.spawn(4, ["mesh"], {"none": np.zeros(1)}, tmp_path)
    shape = resolve_axis_sizes({"dp": 2, "ep": -1}, 4)
    for r, o in enumerate(outs):
        mine = Mesh(shape, r)
        np.testing.assert_array_equal(o["mesh/coords"], [mine.coords["dp"], mine.coords["ep"]])
        for axes in (("dp",), ("ep",), ("dp", "ep")):
            key = "+".join(axes)
            ranks = mine.group_ranks(axes)
            assert int(o[f"mesh/{key}/size"]) == len(ranks)
            assert int(o[f"mesh/{key}/rank"]) == mine.index(axes) == ranks.index(r)
            np.testing.assert_array_equal(o[f"mesh/{key}/ranks"], ranks)
