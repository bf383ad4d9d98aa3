"""`paddle.io` of the port — port of `paddle_tpu/io/`: datasets, samplers
and the DataLoader with its shared-memory worker ring."""
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,  # noqa
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,  # noqa
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)
from .dataloader import DataLoader, default_collate_fn, get_worker_info  # noqa
