"""OnlineTrainer — the loop that wires the four streaming pillars (the
port's copy of ``paddle_tpu.streaming.trainer``).

Reference analog: an online CTR job around the reference is a forever
loop of ``train_from_dataset`` over a data pipe, with pslib shrink/decay
on a timer, delta saves, and Cube pushes. Here:

    per step        tier.run_step over StreamingDataset batches
    sweep_every     table.sweep() — dynamic-vocab TTL/watermark eviction
    delta_every     checkpointer.save_delta — rows touched since chain head
    compact_every   every Nth delta becomes a FULL save (chain restart)
    eval_every      publisher flush + eval_fn over the held-out window

All cadences are in steps (an online "step" is the natural clock — wall
time cadences belong to the publisher, which already has one). The loop
is resumable: ``run(max_steps=k)`` drains k steps and returns, so a soak
interleaves training with serving assertions in the same process.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..observability import get_registry

__all__ = ["OnlineTrainer", "auc", "eval_auc"]


def auc(scores, labels) -> float:
    """Rank-based (Mann-Whitney) AUC with tied-score averaging — plain
    numpy, no sklearn in the container. NaN when the window is one-class
    (early stream): callers treat that as "no reading yet"."""
    scores = np.asarray(scores, np.float64).ravel()
    labels = np.asarray(labels, np.float64).ravel() > 0.5
    npos = int(labels.sum())
    nneg = int(labels.size) - npos
    if npos == 0 or nneg == 0:
        return float("nan")
    _, inv, counts = np.unique(scores, return_inverse=True,
                               return_counts=True)
    first_rank = np.cumsum(counts) - counts + 1  # 1-based
    avg_rank = first_rank + (counts - 1) / 2.0
    ranks = avg_rank[inv]
    return float((ranks[labels].sum() - npos * (npos + 1) / 2.0)
                 / (npos * nneg))


def eval_auc(dataset, score_fn: Callable, label_slot: str) -> float:
    """AUC of ``score_fn(feed) -> scores`` over the dataset's held-out
    window (``StreamingDataset.eval_batches``). Scoring through a
    ``PsLookupPredictor`` here is deliberate: the reading then measures
    exactly what serving would return, post-delta-push bytes included."""
    scores: List[np.ndarray] = []
    labels: List[np.ndarray] = []
    for feed in dataset.eval_batches():
        lbl = np.asarray(feed[label_slot]).ravel()
        s = np.asarray(score_fn(feed)).ravel()
        if s.size != lbl.size:
            raise ValueError(
                f"eval_auc: score_fn returned {s.size} scores for "
                f"{lbl.size} labels")
        scores.append(s)
        labels.append(lbl)
    if not scores:
        return float("nan")
    return auc(np.concatenate(scores), np.concatenate(labels))


class OnlineTrainer:
    """Drive a ``PsEmbeddingTier`` over a ``StreamingDataset`` with the
    online-learning cadences. All collaborators are optional — a bare
    (exe, program, tier, dataset) runs forever with no sweeps, no
    checkpoints, no eval; each cadence activates when its knob is > 0
    AND its collaborator is present."""

    def __init__(self, exe, program, tier, dataset, *,
                 fetch_list=None, scope=None,
                 ps_tables: Optional[Dict[str, object]] = None,
                 checkpointer=None,
                 publishers: Sequence = (),
                 sweep_every: int = 0, delta_every: int = 0,
                 compact_every: int = 0,
                 eval_every: int = 0,
                 eval_fn: Optional[Callable[[], float]] = None):
        self.exe = exe
        self.program = program
        self.tier = tier
        self.dataset = dataset
        self.fetch_list = list(fetch_list or [])
        self.scope = scope
        self.ps_tables = dict(ps_tables or {})
        self.ck = checkpointer
        self.publishers = list(publishers)
        if (delta_every or compact_every) and (
                checkpointer is None or not self.ps_tables):
            raise ValueError(
                "delta_every/compact_every need checkpointer= and "
                "ps_tables= (a delta checkpoint IS the PS increment)")
        if sweep_every and not self.ps_tables:
            raise ValueError("sweep_every needs ps_tables= (the tables "
                             "whose dynamic shards get swept)")
        self.sweep_every = int(sweep_every)
        self.delta_every = int(delta_every)
        self.compact_every = int(compact_every)
        self.eval_every = int(eval_every)
        self.eval_fn = eval_fn
        self.step = 0
        self._deltas_since_full = 0
        self.history: Dict[str, list] = {"loss": [], "eval": [],
                                         "evicted": []}
        reg = get_registry()
        self._c_steps = reg.counter("stream/steps")
        self._c_sweeps = reg.counter("stream/sweeps")
        self._c_deltas = reg.counter("stream/delta_saves")
        self._c_fulls = reg.counter("stream/full_saves")
        self._c_evals = reg.counter("stream/evals")

    # -- cadence bodies ------------------------------------------------------
    def _sweep(self) -> int:
        evicted = 0
        for t in self.ps_tables.values():
            evicted += int(t.sweep())
        self._c_sweeps.inc()
        self.history["evicted"].append((self.step, evicted))
        return evicted

    def _checkpoint(self) -> None:
        self._deltas_since_full += 1
        if (self.compact_every
                and self._deltas_since_full >= self.compact_every):
            # compaction: a full save rewrites the table and re-anchors
            # the delta chain, bounding restore replay length
            self.ck.save(self.step, program=self.program, scope=self.scope,
                         ps_tables=self.ps_tables)
            self._deltas_since_full = 0
            self._c_fulls.inc()
        else:
            self.ck.save_delta(self.step, self.ps_tables)
            self._c_deltas.inc()

    def _eval(self) -> Optional[float]:
        for p in self.publishers:
            p.flush()  # eval must see the newest published bytes
        if self.eval_fn is None:
            return None
        v = float(self.eval_fn())
        self.history["eval"].append((self.step, v))
        self._c_evals.inc()
        return v

    # -- the loop ------------------------------------------------------------
    def run(self, max_steps: Optional[int] = None) -> int:
        """Drain up to ``max_steps`` training steps from the stream (None
        = until the source ends). Returns #steps run this call; the
        trainer's cadences and ``self.step`` carry across calls."""
        n = 0
        it = self.tier.steps(self.dataset.reader(), scope=self.scope)
        try:
            for prepared in it:
                fetched = self.tier.run_step(
                    self.exe, prepared, fetch_list=self.fetch_list,
                    scope=self.scope)
                self.step += 1
                n += 1
                self._c_steps.inc()
                if self.fetch_list:
                    self.history["loss"].append(
                        float(np.mean(np.asarray(fetched[0]))))
                if self.sweep_every and self.step % self.sweep_every == 0:
                    self._sweep()
                if (self.delta_every
                        and self.step % self.delta_every == 0):
                    self._checkpoint()
                if self.eval_every and self.step % self.eval_every == 0:
                    self._eval()
                if max_steps is not None and n >= max_steps:
                    break
        finally:
            it.close()  # deterministic prefetch-loader shutdown
        return n

    def finish(self) -> None:
        """End-of-run barrier: drain the tier's pushers, final publisher
        flush, and join any in-flight checkpoint write."""
        self.tier.flush()
        for p in self.publishers:
            p.flush()
        if self.ck is not None:
            self.ck.wait()
