"""The port's samplers, cache loader, cached dataset and digits data against
the JAX package's (``tests/test_contrib_data.py`` mirrored case for case).

The samplers draw from ``numpy.random.default_rng(seed + epoch)`` in both
packages, so their index lists must be EQUAL to the JAX package's for the
same seeds, epochs and ranks, and the batch samplers' batches likewise; the
digits split is the JAX package's array for array."""

import numpy as np
import pytest
import torch

from bagua_tpu import contrib as jcontrib
from bagua_tpu.contrib.digits_data import load_digits_dataset as jload_digits
from bagua_tpu_torch.contrib import (
    CachedDataset,
    CacheLoader,
    LoadBalancingDistributedBatchSampler,
    LoadBalancingDistributedSampler,
)
from bagua_tpu_torch.contrib.digits_data import load_digits_dataset

N = 97
WORLD = 4


class CountingDataset:
    """Indexable dataset that counts raw accesses."""

    def __init__(self, n):
        self.n = n
        self.accesses = 0

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.accesses += 1
        return np.full((4,), i, dtype=np.int32)


def _complexities(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 1000, n).tolist()


def _make_samplers(n=N, world=WORLD, cls=LoadBalancingDistributedSampler, **kw):
    data = _complexities(n)
    return data, [cls(data, complexity_fn=lambda x: x, num_replicas=world, rank=r, **kw)
                  for r in range(world)]


def _budget_batches(data, budget=1500):
    def batch_fn(indices):
        batches, cur, used = [], [], 0
        for i in indices:
            if cur and used + data[i] > budget:
                batches.append(cur)
                cur, used = [], 0
            cur.append(i)
            used += data[i]
        if cur:
            batches.append(cur)
        return batches

    return batch_fn


@pytest.mark.parametrize("kw", [
    {}, {"seed": 7}, {"shuffle": False}, {"drop_last": True}, {"random_level": 0.3},
    {"random_level": 1.0, "seed": 3},
], ids=["default", "seed7", "no_shuffle", "drop_last", "random_0.3", "random_1.0"])
def test_sampler_indices_equal_jax(kw):
    """Every rank's index list, epoch by epoch, equals the JAX sampler's."""
    _, ours = _make_samplers(**kw)
    _, theirs = _make_samplers(cls=jcontrib.LoadBalancingDistributedSampler, **kw)
    for epoch in (0, 1, 5):
        for a, b in zip(ours, theirs):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            assert list(a) == list(b)
            assert len(a) == len(b)


def test_batch_sampler_batches_equal_jax():
    data = _complexities(N)
    for epoch in (0, 2):
        for r in range(WORLD):
            ours = LoadBalancingDistributedBatchSampler(
                LoadBalancingDistributedSampler(data, lambda x: x, num_replicas=WORLD, rank=r),
                batch_fn=_budget_batches(data))
            theirs = jcontrib.LoadBalancingDistributedBatchSampler(
                jcontrib.LoadBalancingDistributedSampler(data, lambda x: x,
                                                         num_replicas=WORLD, rank=r),
                batch_fn=_budget_batches(data))
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert list(ours) == list(theirs) and len(ours) == len(theirs)


def test_digits_arrays_equal_jax():
    for kw in ({}, {"test_frac": 0.3, "seed": 5, "train_multiple_of": 16}):
        for got, want in zip(load_digits_dataset(**kw), jload_digits(**kw)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_partition_and_coverage():
    _, samplers = _make_samplers()
    per_rank = [list(s) for s in samplers]
    assert {len(ix) for ix in per_rank} == {samplers[0].num_samples}
    seen = set()
    for ix in per_rank:
        seen.update(ix)
    assert seen == set(range(N))


def test_step_complexity_is_balanced():
    data, samplers = _make_samplers(n=96)
    per_rank = [list(s) for s in samplers]
    sorted_cx = sorted(data)
    max_window = max(sorted_cx[i + WORLD - 1] - sorted_cx[i]
                     for i in range(len(sorted_cx) - WORLD + 1))
    for step in range(len(per_rank[0])):
        step_cx = [data[per_rank[r][step]] for r in range(WORLD)]
        assert max(step_cx) - min(step_cx) <= max_window


def test_epoch_determinism_and_reshuffle():
    _, samplers = _make_samplers()
    s = samplers[0]
    s.set_epoch(0)
    first = list(s)
    s.set_epoch(0)
    assert list(s) == first
    s.set_epoch(1)
    assert list(s) != first


def test_ranks_agree_on_chunks():
    _, samplers = _make_samplers()
    for s in samplers:
        s.set_epoch(3)
    chunks = [s.shuffle_chunks() for s in samplers]
    for other in chunks[1:]:
        assert other[0] == chunks[0][0]
        assert other[1] == chunks[0][1]


def test_default_world_and_rank_from_env(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "2")
    from bagua_tpu_torch import env

    s = LoadBalancingDistributedSampler(_complexities(12), lambda x: x)
    # the process group's world where one exists (another test module of
    # this worker may have made one), else the environment's
    assert (s.num_replicas, s.rank) == (env.get_world_size(), env.get_rank())
    if not torch.distributed.is_initialized():
        assert (s.num_replicas, s.rank) == (3, 2)


def test_drop_last_and_validation():
    data = _complexities(10)
    s = LoadBalancingDistributedSampler(data, lambda x: x, num_replicas=4, rank=0,
                                        drop_last=True)
    assert len(list(s)) == s.num_samples == 2
    with pytest.raises(ValueError):
        LoadBalancingDistributedSampler(data, lambda x: x, num_replicas=4, rank=4)
    with pytest.raises(ValueError):
        LoadBalancingDistributedSampler(data, lambda x: x, num_replicas=4, rank=0,
                                        random_level=1.5)


def test_batch_sampler_same_batch_count_across_ranks():
    data = _complexities(N)
    batch_samplers = [
        LoadBalancingDistributedBatchSampler(
            LoadBalancingDistributedSampler(data, lambda x: x, num_replicas=WORLD, rank=r),
            batch_fn=_budget_batches(data))
        for r in range(WORLD)
    ]
    assert len({len(list(bs)) for bs in batch_samplers}) == 1
    bs = batch_samplers[0]
    bs.set_epoch(1)
    assert len(bs) > 0


def test_batch_sampler_cycle_pads_small_ranks():
    data = _complexities(32)

    def batch_fn_skewed(indices):
        if sum(data[i] for i in indices) > np.median(
                [data[i] for i in range(32)]) * len(indices):
            return [[i] for i in indices]
        return [list(indices)]

    samplers = [
        LoadBalancingDistributedBatchSampler(
            LoadBalancingDistributedSampler(data, lambda x: x, num_replicas=2, rank=r,
                                            shuffle=False),
            batch_fn=batch_fn_skewed)
        for r in range(2)
    ]
    counts = [len(list(bs)) for bs in samplers]
    assert counts[0] == counts[1] == samplers[0].total_batch


def test_cache_loader_hit_miss():
    loader = CacheLoader(backend="memory", dataset_name="t", writer_buffer_size=1)
    calls = []

    def load_fn(k):
        calls.append(k)
        return {"k": k}

    assert loader.get(5, load_fn) == {"k": 5}
    assert loader.get(5, load_fn) == {"k": 5}
    assert calls == [5]
    assert loader.num_keys() == 1


def test_cache_loader_write_batching_visible_before_flush():
    loader = CacheLoader(backend="memory", dataset_name="t", writer_buffer_size=10)
    calls = []

    def load_fn(k):
        calls.append(k)
        return k * 2

    for k in range(9):
        loader.get(k, load_fn)
    assert loader.num_keys() == 0
    for k in range(9):
        assert loader.get(k, load_fn) == k * 2
    assert calls == list(range(9))
    loader.get(9, load_fn)
    assert loader.num_keys() == 10


@pytest.mark.parametrize("backend", ["memory", "tcp"])
def test_cached_dataset(backend):
    ds = CountingDataset(20)
    kw = {"num_shards": 2} if backend == "tcp" else {}
    cached = CachedDataset(ds, backend=backend, dataset_name="cd", writer_buffer_size=1, **kw)
    try:
        assert len(cached) == 20
        np.testing.assert_array_equal(cached[3], cached[3])
        assert ds.accesses == 1
        _ = [cached[i] for i in range(20)]
        assert ds.accesses == 20
        _ = [cached[i] for i in range(20)]
        assert ds.accesses == 20  # all hits
        assert cached.cache_loader.num_keys() == 20
    finally:
        cached.cache_loader.store.shutdown()


def test_cached_dataset_tcp_backend():
    ds = CountingDataset(8)
    cached = CachedDataset(ds, backend="tcp", dataset_name="cdt", writer_buffer_size=1,
                           num_shards=2)
    _ = [cached[i] for i in range(8)]
    _ = [cached[i] for i in range(8)]
    assert ds.accesses == 8
    assert cached.cache_loader.num_keys() == 8
    cached.cache_loader.store.shutdown()


def test_cache_keys_and_payloads_equal_jax():
    """The same key scheme and pickled payloads: a port loader reads what a
    JAX loader wrote into a shared store, and the reverse."""
    from bagua_tpu_torch.contrib.utils.store import InMemoryStore

    ours = CacheLoader(backend="memory", dataset_name="ds")
    theirs = jcontrib.CacheLoader(backend="memory", dataset_name="ds")
    theirs.store = theirs.fetcher.store = ours.store = ours.fetcher.store = InMemoryStore()
    theirs.get(3, lambda k: np.arange(k))
    ours.get(4, lambda k: np.arange(k))
    np.testing.assert_array_equal(ours.get(3, lambda k: None), np.arange(3))
    np.testing.assert_array_equal(theirs.get(4, lambda k: None), np.arange(4))
    assert sorted(ours.store._data) == ["ds_3", "ds_4"]
