"""The distributed sampler of training (the reference's EnlargedSampler,
data_sampler.py:11-54).

Own copy of the JAX package's ``data/sampler.py``: an epoch-seeded
permutation of ``num_samples * num_replicas`` indices, wrapped modulo the
dataset (the dataset-enlarge ratio of iteration-based training), of which
each rank takes every ``num_replicas``-th from its own offset. The
permutation comes from numpy's RandomState, not a torch Generator, as in the
JAX package: the same indices as it, with the reference's distribution and
determinism but not its bits.
"""

from __future__ import annotations

import math

import numpy as np


class EnlargedSampler:
    def __init__(self, num_items: int, num_replicas: int, rank: int,
                 ratio: int = 1):
        self.num_items = num_items
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.num_samples = math.ceil(num_items * ratio / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.num_samples

    def __iter__(self):
        g = np.random.RandomState(self.epoch)
        indices = g.permutation(self.total_size) % self.num_items
        return iter(indices[self.rank:self.total_size:self.num_replicas]
                    .tolist())
