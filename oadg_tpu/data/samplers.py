"""Sampler API parity (reference mmdet/datasets/samplers/): GroupSampler,
DistributedGroupSampler, InfiniteBatchSampler families.

The loader (data/builder.py PrefetchLoader) implements aspect-ratio
group batching natively; these classes expose the reference's sampler
interface for code that builds samplers directly. 'Distributed' variants
shard by (rank, world) — on a jax mesh a single process usually feeds every
device, so rank=0/world=1 is the common case.
"""
from __future__ import annotations

import itertools
from typing import Iterator, Optional

import numpy as np


class GroupSampler:
    """Aspect-ratio-grouped batch order (reference
    datasets/samplers/group_sampler.py:10)."""

    def __init__(self, dataset, samples_per_gpu: int = 1, seed: int = 0):
        self.dataset = dataset
        self.samples_per_gpu = samples_per_gpu
        self.flag = getattr(dataset, "flag",
                            np.zeros(len(dataset), np.uint8))
        self.rng = np.random.RandomState(seed)
        sizes = np.bincount(self.flag)
        self.num_samples = int(sum(
            int(np.ceil(s / samples_per_gpu)) * samples_per_gpu
            for s in sizes))

    def __iter__(self) -> Iterator[int]:
        indices = []
        for g in np.unique(self.flag):
            idx = np.where(self.flag == g)[0]
            self.rng.shuffle(idx)
            pad = (-len(idx)) % self.samples_per_gpu
            if pad:
                idx = np.concatenate([idx, idx[:pad]])
            indices.append(idx)
        batches = np.concatenate(indices).reshape(-1, self.samples_per_gpu)
        order = self.rng.permutation(len(batches))
        return iter(batches[order].reshape(-1).tolist())

    def __len__(self):
        return self.num_samples


class DistributedGroupSampler(GroupSampler):
    """Rank-sharded group sampler (reference group_sampler.py:51)."""

    def __init__(self, dataset, samples_per_gpu: int = 1, num_replicas: int = 1,
                 rank: int = 0, seed: int = 0):
        super().__init__(dataset, samples_per_gpu, seed)
        self.num_replicas = num_replicas
        self.rank = rank
        self.num_samples = int(np.ceil(
            super().__len__() / num_replicas))

    def __iter__(self):
        all_idx = list(super().__iter__())
        return iter(all_idx[self.rank::self.num_replicas])

    def __len__(self):
        return self.num_samples


class DistributedSampler:
    def __init__(self, dataset, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)

    def __iter__(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return iter(idx[self.rank::self.num_replicas].tolist())

    def __len__(self):
        return int(np.ceil(len(self.dataset) / self.num_replicas))


class InfiniteBatchSampler:
    """Endless batch index stream (reference
    datasets/samplers/infinite_sampler.py:98)."""

    def __init__(self, dataset, batch_size: int = 1, num_replicas: int = 1,
                 rank: int = 0, seed: int = 0, shuffle: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)

    def _stream(self):
        n = len(self.dataset)
        while True:
            order = (self.rng.permutation(n) if self.shuffle
                     else np.arange(n))
            yield from order[self.rank::self.num_replicas].tolist()

    def __iter__(self):
        stream = self._stream()
        while True:
            yield list(itertools.islice(stream, self.batch_size))


class InfiniteGroupBatchSampler(InfiniteBatchSampler):
    """Group-aware endless batches (reference infinite_sampler.py:10)."""

    def __iter__(self):
        flag = getattr(self.dataset, "flag",
                       np.zeros(len(self.dataset), np.uint8))
        buckets = {g: [] for g in np.unique(flag)}
        stream = self._stream()
        while True:
            i = next(stream)
            g = flag[i]
            buckets[g].append(i)
            if len(buckets[g]) == self.batch_size:
                yield buckets[g]
                buckets[g] = []
