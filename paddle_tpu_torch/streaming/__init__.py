"""Streaming online learning — close the train→serve loop in seconds (the
port's copy of ``paddle_tpu.streaming``).

Reference analog: the reference's online-learning deployments run
``QueueDataset`` over a fleet data pipe (``train_from_dataset`` forever),
grow sparse tables on demand inside pslib (DownpourSparseTable's
accessors materialize unseen feasigns and decay/shrink cold ones), save
``delta`` checkpoints (``fleet.save_persistables(mode=delta)``) and push
fresh rows to Cube/serving on a cadence. This package is that loop,
over the PS tier:

- ``StreamingDataset`` — unbounded ingestion: a generator/pipe source
  feeds ``train_from_dataset``/``PsEmbeddingTier.steps`` continuously,
  with a windowed held-out split peeled off the same stream for eval;
- ``ps.DynamicEmbeddingShard`` — the vocab is no longer provisioned
  up front: rows materialize on first pull and cold ids are swept out
  (TTL + watermark LFU), see ``ps/dynamic.py``;
- ``Checkpointer.save_delta`` — incremental checkpoints persist only
  rows touched since the chain head (the push journal IS the delta),
  see ``parallel/checkpoint.py``;
- ``DeltaPublisher`` — touched rows stream to serving replicas
  (``PsLookupPredictor.apply_delta``) within a bounded staleness budget;
- ``OnlineTrainer`` — the loop that wires all four together.
"""
from .dataset import StreamingDataset
from .delta_push import DeltaPublisher
from .trainer import OnlineTrainer, auc, eval_auc

__all__ = ["StreamingDataset", "DeltaPublisher", "OnlineTrainer", "auc",
           "eval_auc"]
