"""Dataset wrapper that caches samples through :class:`CacheLoader`.

Port of ``bagua_tpu/contrib/cached_dataset.py``, the counterpart of the
reference's ``bagua/torch_api/contrib/cached_dataset.py``.
Duck-typed: wraps anything indexable with ``__len__`` (a torch ``Dataset``,
a list, an HF dataset...) — useful when producing a sample involves slow IO
or preprocessing on the host.
"""

from __future__ import annotations

from .cache_loader import CacheLoader

__all__ = ["CachedDataset"]


class CachedDataset:
    """Caches ``dataset[i]`` under key ``"{dataset_name}_{i}"`` on first access.

    >>> ds = CachedDataset(dataset, backend="memory", dataset_name="train")
    >>> sample = ds[3]          # slow the first time, cached after
    """

    def __init__(
        self,
        dataset,
        backend: str = "memory",
        dataset_name: str = "",
        writer_buffer_size: int = 20,
        **kwargs,
    ):
        self.dataset = dataset
        self.cache_loader = CacheLoader(
            backend, dataset_name, writer_buffer_size, **kwargs
        )

    def __getitem__(self, item):
        return self.cache_loader.get(item, lambda i: self.dataset[i])

    def __len__(self):
        return len(self.dataset)
