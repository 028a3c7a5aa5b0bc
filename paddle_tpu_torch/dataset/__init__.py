"""The bulk-training Dataset factory (the port's copy of
``paddle_tpu.dataset``'s ``DatasetFactory`` / ``InMemoryDataset`` /
``QueueDataset``; reference ``python/paddle/fluid/dataset.py``).

The canned readers of the JAX package (mnist, cifar, imdb, uci_housing,
wmt16, movielens and ``more.py``) are not ported yet (ROADMAP A12).
"""
from .factory import DatasetFactory, InMemoryDataset, QueueDataset  # noqa: F401

__all__ = ["DatasetFactory", "InMemoryDataset", "QueueDataset"]
