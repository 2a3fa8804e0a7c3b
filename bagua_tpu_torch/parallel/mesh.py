"""A mesh of named axes over the ranks of the process group.

Port of ``bagua_tpu/parallel/mesh.py``.  The JAX package lays its devices out
in a named mesh and runs every model-side collective over an axis of it.
Here one process drives one device, so a mesh is a layout of the ranks:
:func:`build_mesh` ``({"dp": 2, "ep": 2})`` puts rank ``r`` at the
coordinates of ``r`` in row-major order over the axes in the order given, as
JAX's ``np.asarray(devices).reshape(shape)`` puts device ``r``.  Each axis,
and each combination of axes, is a process group of its own: the ranks that
share every other coordinate.  The groups are made when the mesh is built,
all of them on every rank in one fixed order, as ``dist.new_group``
requires (so :func:`build_mesh` is collective at world size > 1), and
:meth:`Mesh.comm` hands out a
:class:`~bagua_tpu_torch.communication.BaguaCommunicator` over them.  A
group's ranks are ordered as the mesh orders them (``new_group`` sorts
them), so an axis's group rank is the rank's coordinate on it.  An axis of
size 1 has no group: its collectives are the identity, and at world size 1
no group and no collective is made at all.

Axis names follow the JAX package: ``dp`` data parallel, ``inter``/``intra``
the two tiers of dp, ``ep`` expert parallel (the MoE exchanges), ``sp``
sequence parallel (ring attention, Ulysses).  :func:`hierarchical_mesh` maps
``inter``/``intra`` onto the backend's existing tier communicators rather
than a second set of groups.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch.distributed as dist

from ..communication import BaguaCommunicator, get_backend

Axes = Union[str, Sequence[str]]

_GLOBAL_MESH: Optional["Mesh"] = None


def _world() -> Tuple[int, int]:
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """The ranks laid out over named axes; see the module docstring.

    ``shape`` maps each axis to its size, in mesh order; ``coords`` this
    rank's coordinate on each.  Built by :func:`build_mesh`."""

    def __init__(self, axis_sizes: Dict[str, int], rank: int):
        self.shape: Dict[str, int] = dict(axis_sizes)
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.size = int(math.prod(self.shape.values()))
        self.rank = rank
        #: the global rank at each point of the mesh (row-major)
        self.ranks = np.arange(self.size).reshape(tuple(self.shape.values()))
        self.coords: Dict[str, int] = dict(zip(
            self.axis_names, (int(c) for c in np.unravel_index(rank, self.ranks.shape))))
        #: the communicator of each group this rank is in, by its axes above
        #: size 1 (:func:`build_mesh` and :func:`hierarchical_mesh` fill it)
        self._comms: Dict[Tuple[str, ...], BaguaCommunicator] = {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        """``axes`` as a tuple of mesh axes in mesh order; unknown names
        raise."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in names:
            if a not in self.shape:
                raise ValueError(f"{a!r} is not a mesh axis (mesh axes: {self.axis_names})")
        return tuple(a for a in self.axis_names if a in names)

    def _key(self, axes: Axes) -> Tuple[str, ...]:
        """The axes of ``axes`` whose size is above 1: they alone make the
        group."""
        return tuple(a for a in self._axes(axes) if self.shape[a] > 1)

    def group_ranks(self, axes: Axes, coords: Optional[Dict[str, int]] = None) -> list:
        """The global ranks of the group over ``axes`` of the rank at
        ``coords`` (default this rank): those that share its coordinate on
        every other axis, in mesh order."""
        names, coords = self._axes(axes), coords or self.coords
        index = tuple(slice(None) if a in names else coords[a] for a in self.axis_names)
        return sorted(int(r) for r in np.asarray(self.ranks[index]).reshape(-1))

    def _make_groups(self) -> None:
        """Every group of every combination of the axes above size 1, on
        every rank in the same order (combinations by size, then mesh
        order; the groups of one combination in row-major order of the
        other coordinates)."""
        axes = [a for a in self.axis_names if self.shape[a] > 1]
        for n in range(1, len(axes) + 1):
            for key in itertools.combinations(axes, n):
                others = [a for a in self.axis_names if a not in key]
                mine = None
                for point in itertools.product(*(range(self.shape[a]) for a in others)):
                    ranks = self.group_ranks(key, dict(zip(others, point)))
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        mine = group
                self._comms[key] = BaguaCommunicator(mine)

    def size_of(self, axes: Axes) -> int:
        """The number of ranks along ``axes`` (an axis or a tuple of them)."""
        return int(math.prod(self.shape[a] for a in self._axes(axes)))

    def index(self, axes: Axes) -> int:
        """This rank's index along ``axes``: its coordinate on one axis, the
        row-major index of its coordinates on several (in mesh order, as
        JAX's ``axis_index`` of a tuple of axes)."""
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def comm(self, axes: Axes) -> Optional[BaguaCommunicator]:
        """The communicator of this rank's group over ``axes``; None where
        the group is this rank alone (every axis of size 1)."""
        key = self._key(axes)
        if not key:
            return None
        if key not in self._comms:
            raise ValueError(f"mesh {self.shape} has no group over {key}")
        return self._comms[key]

    def communicators(self) -> list:
        """The distinct communicators of the mesh's groups."""
        out = []
        for c in self._comms.values():
            if all(c is not d for d in out):
                out.append(c)
        return out


def resolve_axis_sizes(axis_sizes: Optional[Dict[str, int]], n: int) -> Dict[str, int]:
    """``axis_sizes`` over ``n`` ranks, a single ``-1`` inferred, with the
    JAX package's errors; default ``{"dp": n}``."""
    if not axis_sizes:
        axis_sizes = {"dp": n}
    axis_sizes = dict(axis_sizes)
    unknown = [k for k, v in axis_sizes.items() if v == -1]
    known = int(np.prod([v for v in axis_sizes.values() if v != -1]))
    if len(unknown) > 1:
        raise ValueError("at most one axis size may be -1")
    if unknown:
        if n % known != 0:
            raise ValueError(f"{n} devices not divisible by {known}")
        axis_sizes[unknown[0]] = n // known
    total = int(np.prod(list(axis_sizes.values())))
    if total != n:
        raise ValueError(f"mesh {axis_sizes} needs {total} devices, have {n}")
    return axis_sizes


def build_mesh(axis_sizes: Optional[Dict[str, int]] = None) -> Mesh:
    """A mesh over the ranks of the process group (one rank without one):
    ``axis_sizes`` maps axis name -> size, a single ``-1`` inferred
    (:func:`resolve_axis_sizes`); default the 1-D data-parallel mesh.
    Collective at world size > 1: every rank builds the same mesh at the
    same point."""
    n, rank = _world()
    mesh = Mesh(resolve_axis_sizes(axis_sizes, n), rank)
    if mesh.size > 1:
        mesh._make_groups()
    return mesh


def hierarchical_mesh(intra_size: Optional[int] = None) -> Mesh:
    """The 2-D ``("inter", "intra")`` mesh of the backend's two tiers:
    ``intra`` the ranks of one node (``intra_size``, default the backend's
    intra-node size), ``inter`` the nodes.  Its groups are the backend's
    tier communicators, not new ones."""
    n, rank = _world()
    backend_intra = get_backend().intranode_communicator.nranks()
    if intra_size is None:
        intra_size = backend_intra
    if n % intra_size != 0:
        raise ValueError(f"{n} devices not divisible by intra_size={intra_size}")
    if intra_size != backend_intra:
        raise ValueError(f"intra_size={intra_size} differs from the backend's intra-node size "
                         f"{backend_intra}: pass intra_size to init_process_group instead")
    mesh = Mesh({"inter": n // intra_size, "intra": intra_size}, rank)
    backend = get_backend()
    for axes, c in ((("inter", "intra"), backend.global_communicator),
                    (("inter",), backend.internode_communicator),
                    (("intra",), backend.intranode_communicator)):
        if mesh._key(axes):
            mesh._comms.setdefault(mesh._key(axes), c)
    return mesh


def set_global_mesh(mesh: Optional[Mesh]) -> None:
    """Register ``mesh`` as the process-wide mesh the model-side layers
    (``MoEMLP``, ring and Ulysses attention, the position offset of
    ``TransformerConfig.sp_axis``) run their collectives over; None clears
    it."""
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_global_mesh() -> Mesh:
    """The process-wide mesh (created on first use: the 1-D dp mesh, which
    is collective at world size > 1)."""
    global _GLOBAL_MESH
    if _GLOBAL_MESH is None:
        _GLOBAL_MESH = build_mesh()
    return _GLOBAL_MESH


def get_global_mesh_if_set() -> Optional[Mesh]:
    """The registered mesh, or None: never creates one."""
    return _GLOBAL_MESH


def mesh_axis_size(mesh: Mesh, axes: Axes) -> int:
    """The number of ranks along ``axes`` of ``mesh``."""
    return mesh.size_of(axes)


def require_axis(axis_name: str, size: int, what: str) -> Mesh:
    """The global mesh, which must hold ``axis_name`` of ``size``: the
    model-side layers' check, with an error that says what to do."""
    mesh = _GLOBAL_MESH
    if mesh is None or axis_name not in mesh.shape:
        have = "no mesh is set" if mesh is None else f"the mesh has axes {mesh.axis_names}"
        raise ValueError(
            f"{what} runs over the mesh axis {axis_name!r} of size {size}, but {have}: call "
            f"bagua_tpu_torch.set_global_mesh(bagua_tpu_torch.build_mesh({{..., "
            f"{axis_name!r}: {size}}})) on every rank first")
    if mesh.shape[axis_name] != size:
        raise ValueError(f"{what} expects the mesh axis {axis_name!r} of size {size}, the mesh "
                         f"has {mesh.shape[axis_name]}")
    return mesh
