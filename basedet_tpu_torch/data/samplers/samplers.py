"""Samplers (counterpart of ``basedet_tpu/data/samplers/samplers.py``):
aspect-ratio grouped batches, YOLOX's shuffled epoch batches, the rank's
rows of either, and the contiguous inference shard. Each pass draws from a
generator seeded by the sampler's seed and its pass count, so a seed gives
the same batches every run."""
from __future__ import annotations

import random
from typing import Iterator, List, Sequence

import numpy as np


class AspectRatioGroupSampler:
    """Batches of indices whose images share an aspect-ratio group (h/w >= 1
    or < 1), so that padded batches waste less; shuffled by
    ``np.random.RandomState(seed + pass)``, as the JAX package's."""

    def __init__(self, aspect_ratios: Sequence[float], batch_size: int, shuffle: bool = True, seed: int = 0):
        self.groups = (np.asarray(aspect_ratios) >= 1.0).astype(np.int32)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def __iter__(self) -> Iterator[List[int]]:
        idxs = np.arange(len(self.groups))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idxs)
        self.epoch += 1
        buckets: dict = {0: [], 1: []}
        for i in idxs:
            g = int(self.groups[i])
            buckets[g].append(int(i))
            if len(buckets[g]) == self.batch_size:
                yield buckets[g]
                buckets[g] = []
        leftover = buckets[0] + buckets[1]
        for i in range(0, len(leftover) - self.batch_size + 1, self.batch_size):
            yield leftover[i:i + self.batch_size]

    def __len__(self) -> int:
        return len(self.groups) // self.batch_size


class ShuffledBatchSampler:
    """YOLOX's epoch: every index once, shuffled by ``random.Random(seed +
    pass)``, cut into full batches (the JAX package's ``epoch_iter`` with
    its global ``random``)."""

    def __init__(self, size: int, batch_size: int, seed: int = 0):
        self.size = size
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0

    def __iter__(self) -> Iterator[List[int]]:
        idxs = list(range(self.size))
        random.Random(self.seed + self.epoch).shuffle(idxs)
        self.epoch += 1
        for i in range(0, len(idxs) - self.batch_size + 1, self.batch_size):
            yield idxs[i:i + self.batch_size]

    def __len__(self) -> int:
        return self.size // self.batch_size


class RankBatchSampler:
    """The rank's rows of each global batch of ``batch_sampler``: indices
    ``[rank·n, (rank + 1)·n)`` of a batch of ``n·world_size``. The global
    sequence is the wrapped sampler's at any world size."""

    def __init__(self, batch_sampler, rank: int = 0, world_size: int = 1):
        if batch_sampler.batch_size % world_size:
            raise ValueError(f"a global batch of {batch_sampler.batch_size} does not split over {world_size} ranks")
        self.batch_sampler = batch_sampler
        self.batch_size = batch_sampler.batch_size // world_size
        self.rank = rank

    def __iter__(self) -> Iterator[List[int]]:
        n = self.batch_size
        for batch in self.batch_sampler:
            yield batch[self.rank * n:(self.rank + 1) * n]

    def __len__(self) -> int:
        return len(self.batch_sampler)


class InferenceSampler:
    """The contiguous shard of the dataset for one rank."""

    def __init__(self, total: int, rank: int = 0, world_size: int = 1):
        shard = (total + world_size - 1) // world_size
        self.begin = min(rank * shard, total)
        self.end = min(self.begin + shard, total)

    def __iter__(self) -> Iterator[int]:
        return iter(range(self.begin, self.end))

    def __len__(self) -> int:
        return self.end - self.begin
