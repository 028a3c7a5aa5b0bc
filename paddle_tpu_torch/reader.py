"""Sequence packing for NMT-style (src, tgt) pair streams: the port's copy of
``pack_by_tokens`` and ``packed_attention_masks`` of ``paddle_tpu.reader``
(plain numpy; the port imports nothing of the JAX package)."""
from __future__ import annotations

import numpy as np


def pack_by_tokens(reader, src_budget, tgt_budget, pad_value=0):
    """Packs consecutive sentence pairs into fixed-shape rows of
    ``src_budget``/``tgt_budget`` tokens, so that one shape carries little
    pad. Segment ids keep attention block-diagonal (see
    :func:`packed_attention_masks` and the block-sparse attention op), so
    packed sentences never see each other, exactly like separate rows.

    Yields dict rows (all 1-D numpy):
      src_ids  [Ts] int32   packed source tokens
      tgt_ids  [Tt] int32   packed decoder INPUT tokens (per-sentence
                            shift: sentence tokens t0..t_{l-2})
      lbl_ids  [Tt] int32   labels (t1..t_{l-1}); 0 = pad/ignore
      src_seg  [Ts] int32   1-based segment id per source token, 0 = pad
      tgt_seg  [Tt] int32   ditto for target positions
      src_pos  [Ts] int32   position WITHIN the segment (restarts at 0)
      tgt_pos  [Tt] int32   ditto

    A pair is added to the current row while both budgets hold; pairs longer
    than a whole row are dropped (bucketing's drop rule)."""
    def gen():
        def new_row():
            return {
                "src_ids": np.full(src_budget, pad_value, "int32"),
                "tgt_ids": np.full(tgt_budget, pad_value, "int32"),
                "lbl_ids": np.full(tgt_budget, pad_value, "int32"),
                "src_seg": np.zeros(src_budget, "int32"),
                "tgt_seg": np.zeros(tgt_budget, "int32"),
                "src_pos": np.zeros(src_budget, "int32"),
                "tgt_pos": np.zeros(tgt_budget, "int32"),
            }

        row, sp, tp, seg = new_row(), 0, 0, 0
        for sample in reader():
            src, tgt = sample[0], sample[1]
            ls, lt = len(src), len(tgt) - 1  # lt decoder positions
            if ls > src_budget or lt > tgt_budget or lt < 1:
                continue  # cannot fit any row
            if sp + ls > src_budget or tp + lt > tgt_budget:
                if seg:
                    yield row
                row, sp, tp, seg = new_row(), 0, 0, 0
            seg += 1
            row["src_ids"][sp:sp + ls] = src
            row["src_seg"][sp:sp + ls] = seg
            row["src_pos"][sp:sp + ls] = np.arange(ls)
            row["tgt_ids"][tp:tp + lt] = tgt[:-1][:lt]
            row["lbl_ids"][tp:tp + lt] = tgt[1:][:lt]
            row["tgt_seg"][tp:tp + lt] = seg
            row["tgt_pos"][tp:tp + lt] = np.arange(lt)
            sp += ls
            tp += lt
        if seg:
            yield row

    return gen


def packed_attention_masks(src_seg, tgt_seg, neg=-1e4):
    """Additive attention masks for a batch of packed rows
    (:func:`pack_by_tokens`): 0 where attention is allowed, ``neg``
    elsewhere. Tokens only see their own sentence, so a packed batch computes
    what separate padded rows would.

    src_seg [B,Ts], tgt_seg [B,Tt]  →
      enc_mask   [B,1,Ts,Ts]  block-diagonal self-attention
      self_mask  [B,1,Tt,Tt]  block-diagonal AND causal
      cross_mask [B,1,Tt,Ts]  target segment k ↔ source segment k
    """
    src_seg = np.asarray(src_seg)
    tgt_seg = np.asarray(tgt_seg)
    Tt = tgt_seg.shape[1]
    sv = src_seg[:, :, None]  # [B,Ts,1]
    tv = tgt_seg[:, :, None]  # [B,Tt,1]
    enc = (sv == src_seg[:, None, :]) & (sv > 0)
    causal = np.tril(np.ones((Tt, Tt), bool))
    dec = (tv == tgt_seg[:, None, :]) & (tv > 0) & causal
    cross = (tv == src_seg[:, None, :]) & (tv > 0)
    to_add = lambda m: np.where(m, 0.0, neg).astype("float32")[:, None]
    return to_add(enc), to_add(dec), to_add(cross)
