"""Contrib layer: optimizer fusion, load balancing, sample caching, SyncBN.

Port of ``bagua_tpu/contrib/``, the counterpart of the reference's
``bagua/torch_api/contrib/``: a fused-optimizer factory, numpy-seeded
samplers, a sample cache over in-memory, TCP or redis stores, a batch norm
synchronized over mesh axes, and device prefetching.
"""

from .cache_loader import CacheLoader  # noqa: F401
from .cached_dataset import CachedDataset  # noqa: F401
from .fused_optimizer import FusedOptimizer, fuse_optimizer  # noqa: F401
from .load_balancing_data_loader import (  # noqa: F401
    LoadBalancingDistributedBatchSampler,
    LoadBalancingDistributedSampler,
)
from .prefetch import prefetch_to_device  # noqa: F401
from .sync_batchnorm import SyncBatchNorm  # noqa: F401

__all__ = [
    "fuse_optimizer",
    "FusedOptimizer",
    "LoadBalancingDistributedSampler",
    "LoadBalancingDistributedBatchSampler",
    "CacheLoader",
    "CachedDataset",
    "SyncBatchNorm",
    "prefetch_to_device",
]
