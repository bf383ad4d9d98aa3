"""Samplers — port of `paddle_tpu/io/sampler.py` (reference:
`python/paddle/io/dataloader/sampler.py`, `batch_sampler.py`).  The random
samplers draw from numpy's global RNG, as the reference's do, so one
`np.random.seed` gives both packages the same order."""
from __future__ import annotations

import math

import numpy as np


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples if self._num_samples is not None else len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            yield from np.random.randint(0, n, self.num_samples).tolist()
        else:
            yield from np.random.permutation(n)[:self.num_samples].tolist()

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices, generator=None):
        self.indices = list(indices)

    def __iter__(self):
        yield from np.random.permutation(self.indices).tolist()

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        yield from np.random.choice(len(self.weights), self.num_samples,
                                    replace=self.replacement, p=p).tolist()

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Rank-sharded batch sampler (reference
    `python/paddle/io/dataloader/batch_sampler.py` DistributedBatchSampler)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None, shuffle=False,
                 drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            # the reference asks distributed.get_world_size/get_rank here
            raise NotImplementedError(
                "DistributedBatchSampler without num_replicas and rank reads "
                "them from the eager process group, which arrives with a "
                "later slice of the port (ROADMAP Queue 1 item 13: Paddle "
                "API breadth, eager distributed/ with launch, spawn, fleet "
                "and auto_tuner); pass num_replicas= and rank=")
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        indices += indices[: self.total_size - len(indices)]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size
