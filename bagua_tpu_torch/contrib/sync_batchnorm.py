"""Cross-rank synchronous batch normalization.

Port of ``bagua_tpu/contrib/sync_batchnorm.py``, the counterpart of the
reference's ``bagua/torch_api/contrib/sync_batchnorm.py:31+``.  Each rank
computes its batch's f32 ``mean`` and ``mean_sq`` per feature (dim 1), and
the two are averaged over the ranks of ``axis_name`` in one collective,
:func:`~bagua_tpu_torch.parallel.functional.pmean`, whose backward averages
the cotangents as ``lax.pmean``'s transpose does in the JAX package.  With
equal per-rank batches the averaged moments are the whole batch's, and a
trainer step, which averages the ranks' gradients, equals the step of one
rank on the concatenated batch.

``axis_name`` names axes of the global mesh
(:func:`~bagua_tpu_torch.parallel.mesh.set_global_mesh`); the norm averages
over that mesh's group of those axes.  Axes the mesh does not have are not
bound (the JAX package's ``_bound_axes``), and with none bound, no mesh set
or a group of one rank the module is the local batch norm: the world-size-1
fallback of the reference (``:83-85``).  ``torch.nn.SyncBatchNorm`` does
not fit: it takes CUDA tensors only and tracks the unbiased variance.

Plugs into :class:`~bagua_tpu_torch.models.resnet.ResNet` via ``norm_cls``::

    model = ResNet50(norm_cls=functools.partial(SyncBatchNorm, axis_name="dp"))
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ..models.resnet import BatchNorm
from ..parallel.functional import pmean
from ..parallel.mesh import get_global_mesh_if_set

__all__ = ["SyncBatchNorm"]

Axes = Union[str, Sequence[str]]


def _bound_comm(axis_name: Optional[Axes]):
    """The communicator of the global mesh's group over the axes of
    ``axis_name`` that it has; None where none is bound or the group is one
    rank."""
    mesh = get_global_mesh_if_set()
    if axis_name is None or mesh is None:
        return None
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    bound = tuple(a for a in axes if a in mesh.shape)
    return mesh.comm(bound) if bound else None


class SyncBatchNorm(BatchNorm):
    """A batch norm whose batch statistics are averaged over mesh axes.

    The fields of ``flax.linen.BatchNorm`` (``use_running_average``,
    ``momentum``, ``epsilon``, ``dtype``, ``param_dtype``, ``use_bias``,
    ``use_scale``, ``bias_init``, ``scale_init``), plus ``axis_name``: the
    mesh axis (or axes) of data parallelism.  Running statistics, the
    biased variance, ``update_stats`` and :attr:`batch_stats` as in
    :class:`~bagua_tpu_torch.models.resnet.BatchNorm`.  Features are dim 1
    (``[N, C, ...]``) where the JAX module takes the last axis."""

    def __init__(self, num_features: int, use_running_average: Optional[bool] = None,
                 axis_name: Optional[Axes] = None, momentum: float = 0.99, **kwargs):
        super().__init__(num_features, use_running_average=use_running_average,
                         momentum=momentum, **kwargs)
        self.axis_name = axis_name

    def _average(self, mean, mean_sq):
        comm = _bound_comm(self.axis_name)
        if comm is None:
            return mean, mean_sq
        # equal per-rank batches: the mean of the per-rank moments is the
        # global moment (the reference gathers mean, var and count and
        # recombines them; equal counts make the mean enough)
        return pmean(torch.stack([mean, mean_sq]), comm).unbind(0)

    def _normalize(self, x, mean, var):
        shape = self._shape(x)
        y = (x.float() - mean.view(shape)) * torch.rsqrt(var + self.epsilon).view(shape)
        if self.weight is not None:
            y = y * self.weight.view(shape)
        if self.bias is not None:
            y = y + self.bias.view(shape)
        return y
