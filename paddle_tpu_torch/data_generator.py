"""Dataset text-format emitters (the port's copy of
``paddle_tpu.data_generator``).

Reference analog: ``python/paddle/fluid/incubate/data_generator/__init__.py``
(DataGenerator :21, MultiSlotDataGenerator :157, MultiSlotStringDataGenerator
— users override generate_sample to parse raw lines into
[(slot_name, [feasign, ...]), ...]; the generator serializes them into the
MultiSlot text format "len v1 v2 ... len v1 ...").

That format is exactly what this framework's native C++ loader parses
(``native/src/dataloader.cc``), so a reference data_generator script produces
files `Dataset.set_filelist` consumes unchanged.
"""
from __future__ import annotations

import sys
from typing import Iterable


class DataGenerator:
    """Base: override generate_sample(line); optionally generate_batch."""

    def __init__(self):
        self.batch_size_ = 1

    def set_batch(self, batch_size: int):
        if int(batch_size) < 1:
            raise ValueError(
                f"set_batch: batch_size must be >= 1, got {batch_size}")
        self.batch_size_ = int(batch_size)

    # -- user hooks ---------------------------------------------------------
    def generate_sample(self, line):
        """Return a callable yielding [(name, [feasign, ...]), ...] per
        sample (the reference's generator-of-generators protocol)."""
        raise NotImplementedError(
            "please rewrite this function to return a generator of "
            "[(name, [feasign, ...]), ...] samples")

    def generate_batch(self, samples):
        """Default batching: yield samples unchanged, one per line."""
        def local_iter():
            for s in samples:
                yield s
        return local_iter

    def _gen_str(self, line) -> str:
        raise NotImplementedError(
            "please use MultiSlotDataGenerator or "
            "MultiSlotStringDataGenerator")

    # -- drivers ------------------------------------------------------------
    def run_from_memory(self, lines: Iterable = (None,), out=None):
        """Feed generate_sample with in-memory lines, write MultiSlot text
        to `out` (default stdout)."""
        out = out or sys.stdout
        batch_samples = []
        for line in lines:
            gen = self.generate_sample(line)
            for sample in gen():
                if sample is None:
                    continue
                batch_samples.append(sample)
                if len(batch_samples) == self.batch_size_:
                    for s in self.generate_batch(batch_samples)():
                        out.write(self._gen_str(s))
                    batch_samples = []
        if batch_samples:
            for s in self.generate_batch(batch_samples)():
                out.write(self._gen_str(s))

    def run_from_stdin(self):
        self.run_from_memory(sys.stdin)

    def iter_samples(self, lines: Iterable = (None,)):
        """Structured driver: yield each post-``generate_batch`` sample as
        its ``[(name, [feasign, ...]), ...]`` pair list, skipping the text
        round-trip — the streaming path (``streaming.StreamingDataset``)
        consumes these directly instead of re-parsing MultiSlot text the
        same process just serialized."""
        batch_samples = []
        for line in lines:
            gen = self.generate_sample(line)
            for sample in gen():
                if sample is None:
                    continue
                batch_samples.append(sample)
                if len(batch_samples) == self.batch_size_:
                    for s in self.generate_batch(batch_samples)():
                        yield s
                    batch_samples = []
        if batch_samples:
            for s in self.generate_batch(batch_samples)():
                yield s


class MultiSlotDataGenerator(DataGenerator):
    """Numeric feasigns → "len v1 v2 ..." per slot, space-joined."""

    def _gen_str(self, line) -> str:
        # per-pair validation mirrors the reference (_gen_str :192): an
        # empty sample or an empty slot silently serializes to a line the
        # C++ parser mis-frames — fail at the generator instead
        if not isinstance(line, (list, tuple)):
            raise ValueError(
                "generate_sample must yield a list/tuple of "
                "(name, [feasign, ...]) pairs, got " + repr(type(line)))
        if not line:
            raise ValueError(
                "the output of generate_sample/generate_batch is empty — "
                "every sample needs at least one slot")
        parts = []
        for pair in line:
            if not (isinstance(pair, (list, tuple)) and len(pair) == 2):
                raise ValueError(
                    "each slot must be a (name, [feasign, ...]) pair, got "
                    + repr(pair))
            name, elements = pair
            if not elements:
                raise ValueError(
                    f"slot {name!r} has no feasigns — the MultiSlot format "
                    "cannot express an empty slot (emit a default id)")
            parts.append(str(len(elements)))
            parts.extend(str(e) for e in elements)
        return " ".join(parts) + "\n"


class MultiSlotStringDataGenerator(MultiSlotDataGenerator):
    """Same wire format; feasigns are ALREADY strings, joined without
    numeric conversion (the reference's fast path is its own _gen_str
    :157, not an inherited str() loop)."""

    def _gen_str(self, line) -> str:
        if not isinstance(line, (list, tuple)) or not line:
            raise ValueError(
                "generate_sample must yield a non-empty list/tuple of "
                "(name, [str, ...]) pairs, got " + repr(line))
        parts = []
        for pair in line:
            if not (isinstance(pair, (list, tuple)) and len(pair) == 2):
                raise ValueError(
                    "each slot must be a (name, [str, ...]) pair, got "
                    + repr(pair))
            name, elements = pair
            if not elements:
                raise ValueError(
                    f"slot {name!r} has no feasigns — emit a default value")
            parts.append(str(len(elements)))
            parts.extend(elements)  # already strings: no str() pass
        return " ".join(parts) + "\n"
