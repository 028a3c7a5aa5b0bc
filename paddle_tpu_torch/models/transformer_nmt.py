"""Transformer-big NMT (WMT14 en-de) — static-graph builder, the port's copy
of ``paddle_tpu.models.transformer_nmt``.

Both DSLs name every parameter the same way, so a parameter set carries
across one to one (``io.load_params_from_numpy``), optimizer state included.
Three ways to feed a batch: length-bucketed padded rows with additive masks,
packed rows (``reader.pack_by_tokens``) with dense segment masks, and packed
rows whose segment-id rows go straight to the block-sparse attention op
(``attn="sparse"``: the hand-written Hopper kernels on the card).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .. import layers
from ..core.program import Program, program_guard, remat_unit
from ..initializer import ConstantInitializer, NormalInitializer
from ..optimizer import Adam
from ..param_attr import ParamAttr


@dataclass
class TransformerConfig:
    src_vocab: int = 32000
    tgt_vocab: int = 32000
    d_model: int = 1024       # transformer-big
    n_heads: int = 16
    d_ff: int = 4096
    n_enc: int = 6
    n_dec: int = 6
    dropout: float = 0.1
    max_len: int = 256

    @property
    def head_dim(self):
        return self.d_model // self.n_heads


def _attr(name):
    return ParamAttr(name=name, initializer=NormalInitializer(0.0, 0.02))


def _mha(cfg, q_in, kv_in, mask, name, is_test=False, seg=None,
         causal=False):
    d, nh, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    q = layers.fc(q_in, d, num_flatten_dims=2, param_attr=_attr(f"{name}.q.w"),
                  bias_attr=False)
    k = layers.fc(kv_in, d, num_flatten_dims=2, param_attr=_attr(f"{name}.k.w"),
                  bias_attr=False)
    v = layers.fc(kv_in, d, num_flatten_dims=2, param_attr=_attr(f"{name}.v.w"),
                  bias_attr=False)

    if seg is not None:
        # block-sparse packed-segment path: visibility comes from the
        # segment-id rows themselves (seg = (q_seg, k_seg)) instead of a
        # dense additive [B,1,Tq,Tk] mask; fully padded key tiles are skipped
        # by the kernels (ops/kernels/flash_attention_sparse.py)
        q_seg, k_seg = seg
        out = layers.flash_attention_sparse(
            q, k, v, nh, q_seg, k_seg, causal=causal,
            dropout_prob=cfg.dropout, is_test=is_test)
        return layers.fc(out, d, num_flatten_dims=2,
                         param_attr=_attr(f"{name}.o.w"), bias_attr=False)

    def heads(t):
        return layers.transpose(layers.reshape(t, [0, -1, nh, hd]), [0, 2, 1, 3])

    qh, kh, vh = heads(q), heads(k), heads(v)
    scores = layers.matmul(qh, kh, transpose_y=True, alpha=1.0 / math.sqrt(hd))
    if mask is not None:
        scores = layers.elementwise_add(scores, mask)
    probs = layers.softmax(scores)
    if cfg.dropout > 0:
        probs = layers.dropout(probs, cfg.dropout, is_test=is_test,
                               dropout_implementation="upscale_in_train")
    out = layers.matmul(probs, vh)
    out = layers.reshape(layers.transpose(out, [0, 2, 1, 3]), [0, -1, d])
    return layers.fc(out, d, num_flatten_dims=2, param_attr=_attr(f"{name}.o.w"),
                     bias_attr=False)


def _ffn(cfg, x, name, is_test=False):
    h = layers.fc(x, cfg.d_ff, num_flatten_dims=2, act="relu",
                  param_attr=_attr(f"{name}.ffn1.w"),
                  bias_attr=ParamAttr(name=f"{name}.ffn1.b",
                                      initializer=ConstantInitializer(0.0)))
    if cfg.dropout > 0:
        h = layers.dropout(h, cfg.dropout, is_test=is_test,
                           dropout_implementation="upscale_in_train")
    return layers.fc(h, cfg.d_model, num_flatten_dims=2,
                     param_attr=_attr(f"{name}.ffn2.w"),
                     bias_attr=ParamAttr(name=f"{name}.ffn2.b",
                                         initializer=ConstantInitializer(0.0)))


def _ln(x, name):
    return layers.layer_norm(x, begin_norm_axis=2,
                             param_attr=ParamAttr(name=f"{name}.scale",
                                                  initializer=ConstantInitializer(1.0)),
                             bias_attr=ParamAttr(name=f"{name}.bias",
                                                 initializer=ConstantInitializer(0.0)))


def _residual(cfg, x, sub, is_test=False):
    if cfg.dropout > 0:
        sub = layers.dropout(sub, cfg.dropout, is_test=is_test,
                             dropout_implementation="upscale_in_train")
    return layers.elementwise_add(x, sub)


def _pos_encoding_np(max_len, d_model):
    pos = np.arange(max_len)[:, None]
    i = np.arange(d_model)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / d_model)
    enc = np.zeros((max_len, d_model), dtype="float32")
    enc[:, 0::2] = np.sin(angle[:, 0::2])
    enc[:, 1::2] = np.cos(angle[:, 1::2])
    return enc


def _embed(cfg, ids, vocab, name, is_test=False, pos=None):
    emb = layers.embedding(ids, [vocab, cfg.d_model], param_attr=_attr(name))
    emb = layers.scale(emb, scale=math.sqrt(cfg.d_model))
    seq_len = ids.shape[1] if ids.shape and len(ids.shape) > 1 and ids.shape[1] > 0 else cfg.max_len
    if pos is not None:
        # packed rows: positions restart per segment, so gather the sinusoid
        # table by explicit per-token position ids. The table covers the row
        # length too: the gather op raises on an out-of-range index (XLA
        # clamps it silently in the JAX package), and a packed sentence is
        # at most a row long.
        table = layers.assign(
            _pos_encoding_np(max(cfg.max_len, seq_len), cfg.d_model))
        pe = layers.gather(table, layers.reshape(pos, [-1]))
        pe = layers.reshape(pe, [-1, seq_len, cfg.d_model])
    else:
        pe = layers.assign(_pos_encoding_np(seq_len, cfg.d_model))
    emb = layers.elementwise_add(emb, pe)  # broadcast [T,D] over batch
    if cfg.dropout > 0:
        emb = layers.dropout(emb, cfg.dropout, is_test=is_test,
                             dropout_implementation="upscale_in_train")
    return emb


def encoder(cfg, src_ids, src_mask, is_test=False, pos=None, seg=None):
    x = _embed(cfg, src_ids, cfg.src_vocab, "src_embedding", is_test, pos=pos)
    self_seg = (seg, seg) if seg is not None else None
    for i in range(cfg.n_enc):
        name = f"enc_{i}"
        # one remat unit per encoder layer (the attr the JAX package emits;
        # the port runs it as a tag only, remat is not ported)
        with remat_unit(name):
            x = _ln(_residual(cfg, x, _mha(cfg, x, x, src_mask, f"{name}.self", is_test,
                                           seg=self_seg),
                              is_test), f"{name}.ln1")
            x = _ln(_residual(cfg, x, _ffn(cfg, x, name, is_test), is_test), f"{name}.ln2")
    return x


def decoder(cfg, tgt_ids, enc_out, self_mask, cross_mask, is_test=False,
            pos=None, tgt_seg=None, src_seg=None):
    x = _embed(cfg, tgt_ids, cfg.tgt_vocab, "tgt_embedding", is_test, pos=pos)
    sparse = tgt_seg is not None
    self_seg = (tgt_seg, tgt_seg) if sparse else None
    cross_seg = (tgt_seg, src_seg) if sparse else None
    for i in range(cfg.n_dec):
        name = f"dec_{i}"
        with remat_unit(name):
            x = _ln(_residual(cfg, x, _mha(cfg, x, x, self_mask, f"{name}.self", is_test,
                                           seg=self_seg, causal=sparse),
                              is_test), f"{name}.ln1")
            x = _ln(_residual(cfg, x, _mha(cfg, x, enc_out, cross_mask, f"{name}.cross", is_test,
                                           seg=cross_seg),
                              is_test), f"{name}.ln2")
            x = _ln(_residual(cfg, x, _ffn(cfg, x, name, is_test), is_test), f"{name}.ln3")
    return layers.fc(x, cfg.tgt_vocab, num_flatten_dims=2,
                     param_attr=_attr("out_proj.w"), bias_attr=False)


def build_train_program(cfg: TransformerConfig, src_len: int, tgt_len: int,
                        lr=1e-3, is_test=False, optimizer_factory=None,
                        packed=False, attn="dense"):
    """Masks are fed as additive float tensors (0 keep / -1e4 drop).

    Bucketed (default): src_mask [B,1,1,Ts] (pad); tgt self-mask
    [B,1,Tt,Tt] (causal+pad); cross attention reuses src_mask.

    ``packed=True`` (reader.pack_by_tokens rows): several sentences share a
    row, so every mask is segment-block-diagonal and full rank: src_mask
    [B,1,Ts,Ts], tgt_mask [B,1,Tt,Tt], a separate cross_mask [B,1,Tt,Ts],
    plus per-token position ids (positions restart at each packed sentence)
    fed as src_pos/tgt_pos.

    ``attn="sparse"`` (packed only): the dense masks never exist — the
    segment-id rows themselves are fed (src_seg/tgt_seg [B,T] int32) and
    attention runs through the block-sparse flash kernels, which skip fully
    padded key tiles in the forward and backward. Hard segment masking
    (exact zeros) instead of additive -1e4.

    Returns (main, startup, feed names, loss)."""
    if attn not in ("dense", "sparse"):
        raise ValueError(f"attn must be 'dense' or 'sparse', got {attn!r}")
    if attn == "sparse" and not packed:
        raise ValueError("attn='sparse' requires packed=True (the segment "
                         "descriptor comes from pack_by_tokens rows)")
    main = Program()
    startup = Program()
    with program_guard(main, startup):
        src = layers.data("src_ids", [src_len], dtype="int64")
        tgt = layers.data("tgt_ids", [tgt_len], dtype="int64")
        lbl = layers.data("lbl_ids", [tgt_len, 1], dtype="int64")
        src_seg = tgt_seg = None
        if packed and attn == "sparse":
            src_seg = layers.data("src_seg", [src_len], dtype="int32")
            tgt_seg = layers.data("tgt_seg", [tgt_len], dtype="int32")
            src_mask = tgt_mask = cross_mask = None
            src_pos = layers.data("src_pos", [src_len], dtype="int64")
            tgt_pos = layers.data("tgt_pos", [tgt_len], dtype="int64")
        elif packed:
            src_mask = layers.data("src_mask", [1, src_len, src_len])
            tgt_mask = layers.data("tgt_mask", [1, tgt_len, tgt_len])
            cross_mask = layers.data("cross_mask", [1, tgt_len, src_len])
            src_pos = layers.data("src_pos", [src_len], dtype="int64")
            tgt_pos = layers.data("tgt_pos", [tgt_len], dtype="int64")
        else:
            src_mask = layers.data("src_mask", [1, 1, src_len])
            tgt_mask = layers.data("tgt_mask", [1, tgt_len, tgt_len])
            cross_mask, src_pos, tgt_pos = src_mask, None, None
        enc_out = encoder(cfg, src, src_mask, is_test, pos=src_pos,
                          seg=src_seg)
        logits = decoder(cfg, tgt, enc_out, tgt_mask, cross_mask, is_test,
                         pos=tgt_pos, tgt_seg=tgt_seg, src_seg=src_seg)
        loss_tok = layers.softmax_with_cross_entropy(logits, lbl, ignore_index=0)
        valid = layers.cast(layers.not_equal(
            lbl, layers.fill_constant([1], "int64", 0)), "float32")
        loss = layers.elementwise_div(
            layers.reduce_sum(layers.elementwise_mul(loss_tok, valid)),
            layers.reduce_sum(valid))
        opt = optimizer_factory() if optimizer_factory else Adam(lr)
        opt.minimize(loss)
    feeds = ["src_ids", "tgt_ids", "lbl_ids"]
    if packed and attn == "sparse":
        feeds += ["src_seg", "tgt_seg", "src_pos", "tgt_pos"]
    elif packed:
        feeds += ["src_mask", "tgt_mask", "cross_mask", "src_pos", "tgt_pos"]
    else:
        feeds += ["src_mask", "tgt_mask"]
    return main, startup, feeds, loss


def length_buckets(lengths, buckets=(32, 64, 128, 256)):
    """Bucketing helper replacing LoD batching: map raw lengths to the
    smallest bucket ≥ len."""
    out = []
    for L in lengths:
        for b in buckets:
            if L <= b:
                out.append(b)
                break
        else:
            out.append(buckets[-1])
    return out
