"""Load-balancing distributed samplers.

Port of ``bagua_tpu/contrib/load_balancing_data_loader.py`` (its own copy:
the port imports nothing of the JAX package), the counterpart of the
reference's ``bagua/torch_api/contrib/load_balancing_data_loader.py:12-324``.
Same semantics: samples are sorted by a user ``complexity_fn``, split into
``num_replicas``-sized chunks of *similar* complexity, chunk order is shuffled
per epoch, and rank ``r`` takes element ``r`` of each chunk — so every rank's
step-``i`` sample has comparable cost and stragglers disappear.  Useful for
exactly the reference's scenario (variable-length NLP/speech batches
in an SPMD step where the slowest shard gates the collective).

Works with any indexable dataset; determinism comes from
``numpy.random.default_rng(seed + epoch)``, identical across ranks.  Drop-in
for ``torch.utils.data.DataLoader(sampler=...)`` (it only needs ``__iter__``
/ ``__len__`` / ``set_epoch``).
"""

from __future__ import annotations

import math
from typing import Callable, Iterator, List, Optional

import numpy as np

__all__ = [
    "LoadBalancingDistributedSampler",
    "LoadBalancingDistributedBatchSampler",
]


class LoadBalancingDistributedSampler:
    """Distributed sampler that equalizes per-step sample complexity.

    Args:
        dataset: indexable dataset of constant size.
        complexity_fn: sample -> int complexity measure.
        num_replicas: world size (default: ``bagua_tpu_torch.env`` world size).
        rank: this worker's rank (default from env).
        shuffle: shuffle chunk order each epoch (seeded, rank-identical).
        seed: shared base seed.
        drop_last: drop the tail instead of wrap-padding it.
        random_level: 0.0 = perfect balance .. 1.0 = fully random; implemented
            as additive uniform noise on complexities scaled by their range
            (reference :146-152).
    """

    def __init__(
        self,
        dataset,
        complexity_fn: Callable[..., int],
        num_replicas: Optional[int] = None,
        rank: Optional[int] = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        random_level: float = 0.0,
    ) -> None:
        if num_replicas is None or rank is None:
            from .. import env

            num_replicas = num_replicas or env.get_world_size()
            rank = env.get_rank() if rank is None else rank
        if rank >= num_replicas or rank < 0:
            raise ValueError(
                f"Invalid rank {rank}, rank should be in [0, {num_replicas - 1}]"
            )
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed

        dataset_len = len(dataset)
        if self.drop_last and dataset_len % num_replicas != 0:
            self.num_samples = math.ceil((dataset_len - num_replicas) / num_replicas)
        else:
            self.num_samples = math.ceil(dataset_len / num_replicas)
        self.total_size = self.num_samples * num_replicas

        self.item_complexity_map = {
            i: complexity_fn(dataset[i]) for i in range(dataset_len)
        }
        self.ordered_indices = sorted(
            self.item_complexity_map, key=self.item_complexity_map.__getitem__
        )
        if not 0.0 <= random_level <= 1.0:
            raise ValueError(
                f"Invalid random level {random_level}, should be in [0.0, 1.0]"
            )
        complexities = list(self.item_complexity_map.values())
        self.random_number = int(
            (max(complexities) - min(complexities)) * random_level + 1
        )

    def _chunks_wrap_padding(self, indices: List[int]) -> List[List[int]]:
        """Successive ``num_replicas``-sized chunks, wrapping around to fill
        exactly ``num_samples`` chunks (reference :155-166)."""
        n = self.num_replicas
        num_chunks = max(1, self.num_samples)
        out, cur = [], []
        for i in range(num_chunks * n):
            cur.append(indices[i % len(indices)])
            if len(cur) == n:
                out.append(cur)
                cur = []
        return out

    def shuffle_chunks(self):
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            # random_number == 1 means noise drawn from [0, 1) == always 0:
            # skip the pointless perturb+resort and reuse the sorted order
            if self.random_number > 1:
                noise = rng.integers(
                    0, self.random_number, len(self.item_complexity_map)
                )
                perturbed = {
                    k: v + int(n)
                    for (k, v), n in zip(self.item_complexity_map.items(), noise)
                }
                ordered = sorted(perturbed, key=perturbed.__getitem__)
            else:
                ordered = self.ordered_indices
            index_chunks = self._chunks_wrap_padding(ordered)
            chunk_indices = rng.permutation(len(index_chunks)).tolist()
        else:
            index_chunks = self._chunks_wrap_padding(self.ordered_indices)
            chunk_indices = list(range(len(index_chunks)))

        if not self.drop_last:
            padding_size = self.num_samples - len(chunk_indices)
            if padding_size > 0:
                if padding_size <= len(chunk_indices):
                    chunk_indices += chunk_indices[:padding_size]
                else:
                    chunk_indices += (
                        chunk_indices * math.ceil(padding_size / len(chunk_indices))
                    )[:padding_size]
        else:
            chunk_indices = chunk_indices[: self.num_samples]
        assert len(chunk_indices) == self.num_samples
        return index_chunks, chunk_indices

    def __iter__(self) -> Iterator[int]:
        index_chunks, chunk_indices = self.shuffle_chunks()
        indices = [index_chunks[i][self.rank] for i in chunk_indices]
        assert len(indices) == self.num_samples
        return iter(indices)

    def __len__(self) -> int:
        return self.num_samples

    def set_epoch(self, epoch: int) -> None:
        """Call before each epoch so shuffling differs across epochs but
        agrees across ranks."""
        self.epoch = epoch


class LoadBalancingDistributedBatchSampler:
    """Yields variable-sized batches from a load-balancing sampler.

    ``batch_fn(indices) -> list of batches`` lets the user pack
    variable-length samples into token-budgeted batches; ranks are padded (or
    truncated with ``drop_last``) to the same number of batches so the SPMD
    step count agrees (reference :232-324).
    """

    def __init__(
        self,
        sampler: LoadBalancingDistributedSampler,
        batch_fn: Callable[[List[int]], List[List[int]]],
        drop_last: bool = False,
    ) -> None:
        if not isinstance(sampler, LoadBalancingDistributedSampler):
            raise ValueError(
                "sampler should be of LoadBalancingDistributedSampler type."
            )
        if sampler.drop_last:
            raise ValueError("drop_last of sampler should be False")
        self.sampler = sampler
        self.batch_fn = batch_fn
        self.drop_last = drop_last
        self.num_replicas = sampler.num_replicas
        self.rank = sampler.rank
        self.generate_batches()

    def generate_batches(self) -> None:
        index_chunks, chunk_indices = self.sampler.shuffle_chunks()
        batches = []
        for rank in range(self.num_replicas):
            sub_indices = [index_chunks[i][rank] for i in chunk_indices]
            batches.append(self.batch_fn(sub_indices))

        self.total_batch = (
            max(len(b) for b in batches)
            if not self.drop_last
            else min(len(b) for b in batches)
        )
        # cycle-pad: every rank must yield exactly total_batch batches or the
        # SPMD step counts diverge and a collective hangs (a rank with fewer
        # than half the max count needs more than one lap of its own batches)
        self.padded_batches = [
            [batch[i % len(batch)] for i in range(self.total_batch)]
            if batch else []
            for batch in batches
        ]

    def __iter__(self):
        return iter(self.padded_batches[self.rank])

    def __len__(self) -> int:
        return self.total_batch

    def set_epoch(self, epoch: int) -> None:
        """Re-shuffle and re-pack for a new epoch (rank-consistent)."""
        self.sampler.set_epoch(epoch)
        self.generate_batches()
