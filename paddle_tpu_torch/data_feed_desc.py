"""fluid.data_feed_desc (the port's copy of ``paddle_tpu.data_feed_desc``;
reference data_feed_desc.py — DataFeedDesc wraps
the data_feed.proto text config consumed by the C++ MultiSlotDataFeed).

Here it parses the same prototxt surface into the fields the native loader
(paddle_tpu_torch/native) and Dataset runtime consume: batch size, slot names,
types, and dense dimensions.
"""
from __future__ import annotations

import re

__all__ = ["DataFeedDesc"]


class DataFeedDesc:
    def __init__(self, proto_file: str):
        self._text = open(proto_file).read()
        self.batch_size = 32
        m = re.search(r"batch_size\s*:\s*(\d+)", self._text)
        if m:
            self.batch_size = int(m.group(1))
        # slot names come only from slots{...} blocks — the feed-class
        # `name:` at top level is not a slot
        self.slots = re.findall(
            r'slots\s*\{[^}]*?name\s*:\s*"([^"]+)"', self._text, re.S)
        self.types = re.findall(r'type\s*:\s*"([^"]+)"', self._text)

    def set_batch_size(self, batch_size: int):
        self.batch_size = batch_size
        self._text = re.sub(r"batch_size\s*:\s*\d+",
                            f"batch_size: {batch_size}", self._text)

    def _set_slot_flag(self, names, flag):
        for n in names:
            if n not in self.slots:
                raise ValueError(
                    f"slot {n!r} not found in the data feed proto "
                    f"(slots: {self.slots})")
            self._text = re.sub(
                r'(slots\s*\{[^}]*?name\s*:\s*"' + re.escape(n)
                + r'"[^}]*?' + flag + r'\s*:\s*)\w+',
                r"\g<1>true", self._text, flags=re.S)

    def set_dense_slots(self, dense_slots_name):
        self._set_slot_flag(dense_slots_name, "is_dense")

    def set_use_slots(self, use_slots_name):
        self._set_slot_flag(use_slots_name, "is_used")

    def desc(self) -> str:
        return self._text
