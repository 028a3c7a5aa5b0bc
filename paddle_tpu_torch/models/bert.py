"""BERT/ERNIE-base encoder — static-graph builder, the port's copy of
``paddle_tpu.models.bert``.

Both DSLs name every parameter the same way, so a parameter set carries
across one to one (``io.load_params_from_numpy``), optimizer state included.
The encoder serves through the inference Predictor; ``build_pretrain_program``
builds the masked-LM pretraining step the JAX package's bench trains
(``Executor.run`` with an optimizer, f32 or bf16 AMP).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from .. import layers
from ..core.program import Program, program_guard, remat_unit
from ..initializer import ConstantInitializer, NormalInitializer
from ..param_attr import ParamAttr


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attn_dropout: float = 0.1
    initializer_range: float = 0.02
    # tensor-parallel axis name (None = no TP annotations)
    tp_axis: Optional[str] = None
    # fused memory-efficient attention (the Hopper kernel on the card)
    # instead of the materialized-scores matmul/softmax/matmul pattern
    use_flash_attention: bool = True

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


def _attr(cfg: BertConfig, name: str, shard_spec=None):
    return ParamAttr(name=name,
                     initializer=NormalInitializer(0.0, cfg.initializer_range),
                     shard_spec=shard_spec)


def _tp(cfg: BertConfig, *spec):
    """Build a PartitionSpec-style tuple only when TP is on."""
    if cfg.tp_axis is None:
        return None
    return tuple(s if s != "tp" else cfg.tp_axis for s in spec)


def encoder_layer(cfg: BertConfig, x, attn_mask, idx: int, is_test=False):
    """One transformer block: MHA + FFN, post-LN (BERT style)."""
    h = cfg.hidden_size
    nh, hd = cfg.num_heads, cfg.head_dim
    pre = f"encoder_{idx}"

    # qkv fused projection: [h, 3h] sharded on output dim under TP
    qkv = layers.fc(x, 3 * h, num_flatten_dims=2,
                    param_attr=_attr(cfg, f"{pre}.qkv.w", _tp(cfg, None, "tp")),
                    bias_attr=ParamAttr(name=f"{pre}.qkv.b",
                                        initializer=ConstantInitializer(0.0),
                                        shard_spec=_tp(cfg, "tp")))
    q, k, v = layers.split(qkv, 3, dim=2)

    if cfg.use_flash_attention:
        # packed [B, T, H] call — the head split/merge happens inside the
        # fused op, keeping the graph free of reshape/transpose ops
        ctxv = layers.flash_attention(q, k, v, attn_mask,
                                      dropout_prob=cfg.attn_dropout,
                                      is_test=is_test,
                                      num_heads=nh)  # [B, T, H]
    else:
        def heads(t, name):
            t = layers.reshape(t, [0, -1, nh, hd], name=name)
            return layers.transpose(t, [0, 2, 1, 3])  # [B, nh, T, hd]

        q, k, v = (heads(q, f"{pre}.q"), heads(k, f"{pre}.k"),
                   heads(v, f"{pre}.v"))
        scores = layers.matmul(q, k, transpose_y=True, alpha=1.0 / math.sqrt(hd))
        # mask: [B,1,1,T] additive
        scores = layers.elementwise_add(scores, layers.unsqueeze(attn_mask, [1]))
        probs = layers.softmax(scores)
        if cfg.attn_dropout > 0:
            probs = layers.dropout(probs, cfg.attn_dropout, is_test=is_test,
                                   dropout_implementation="upscale_in_train")
        ctxv = layers.matmul(probs, v)  # [B, nh, T, hd]
        ctxv = layers.transpose(ctxv, [0, 2, 1, 3])
        ctxv = layers.reshape(ctxv, [0, -1, nh * hd])
    # output proj: input dim sharded under TP (row-parallel)
    attn_out = layers.fc(ctxv, h, num_flatten_dims=2,
                         param_attr=_attr(cfg, f"{pre}.attn_out.w", _tp(cfg, "tp", None)),
                         bias_attr=ParamAttr(name=f"{pre}.attn_out.b",
                                             initializer=ConstantInitializer(0.0)))
    if cfg.hidden_dropout > 0:
        attn_out = layers.dropout(attn_out, cfg.hidden_dropout, is_test=is_test,
                                  dropout_implementation="upscale_in_train")
    x = layers.layer_norm(layers.elementwise_add(x, attn_out), begin_norm_axis=2,
                          param_attr=ParamAttr(name=f"{pre}.ln1.scale",
                                               initializer=ConstantInitializer(1.0)),
                          bias_attr=ParamAttr(name=f"{pre}.ln1.bias",
                                              initializer=ConstantInitializer(0.0)))

    ffn1 = layers.fc(x, cfg.ffn_size, num_flatten_dims=2, act="gelu",
                     param_attr=_attr(cfg, f"{pre}.ffn1.w", _tp(cfg, None, "tp")),
                     bias_attr=ParamAttr(name=f"{pre}.ffn1.b",
                                         initializer=ConstantInitializer(0.0),
                                         shard_spec=_tp(cfg, "tp")))
    ffn2 = layers.fc(ffn1, h, num_flatten_dims=2,
                     param_attr=_attr(cfg, f"{pre}.ffn2.w", _tp(cfg, "tp", None)),
                     bias_attr=ParamAttr(name=f"{pre}.ffn2.b",
                                         initializer=ConstantInitializer(0.0)))
    if cfg.hidden_dropout > 0:
        ffn2 = layers.dropout(ffn2, cfg.hidden_dropout, is_test=is_test,
                              dropout_implementation="upscale_in_train")
    return layers.layer_norm(layers.elementwise_add(x, ffn2), begin_norm_axis=2,
                             param_attr=ParamAttr(name=f"{pre}.ln2.scale",
                                                  initializer=ConstantInitializer(1.0)),
                             bias_attr=ParamAttr(name=f"{pre}.ln2.bias",
                                                 initializer=ConstantInitializer(0.0)))


def embeddings(cfg: BertConfig, src_ids, pos_ids, sent_ids, is_test=False):
    tok = layers.embedding(src_ids, [cfg.vocab_size, cfg.hidden_size],
                           param_attr=_attr(cfg, "word_embedding", _tp(cfg, "tp", None)))
    pos = layers.embedding(pos_ids, [cfg.max_position, cfg.hidden_size],
                           param_attr=_attr(cfg, "pos_embedding"))
    sent = layers.embedding(sent_ids, [cfg.type_vocab_size, cfg.hidden_size],
                            param_attr=_attr(cfg, "sent_embedding"))
    emb = layers.elementwise_add(layers.elementwise_add(tok, pos), sent)
    emb = layers.layer_norm(emb, begin_norm_axis=2,
                            param_attr=ParamAttr(name="emb.ln.scale",
                                                 initializer=ConstantInitializer(1.0)),
                            bias_attr=ParamAttr(name="emb.ln.bias",
                                                initializer=ConstantInitializer(0.0)))
    if cfg.hidden_dropout > 0:
        emb = layers.dropout(emb, cfg.hidden_dropout, is_test=is_test,
                             dropout_implementation="upscale_in_train")
    return emb


def bert_encoder(cfg: BertConfig, src_ids, pos_ids, sent_ids, input_mask,
                 is_test=False):
    """input_mask: [B, T] float (1 = token). Returns sequence output [B,T,H]."""
    emb = embeddings(cfg, src_ids, pos_ids, sent_ids, is_test)
    # additive mask [B,1,T]: (mask-1)*10000 → 0 for keep, -10000 for pad
    # (the packed flash path consumes [B,1,T]; the dense path re-expands)
    neg = layers.scale(layers.elementwise_add(input_mask,
                                              layers.fill_constant([1], "float32", -1.0)),
                       scale=10000.0)
    mask4 = layers.unsqueeze(neg, [1])
    x = emb
    # each transformer block is one remat unit (the same attr the JAX
    # package's builder emits; the port runs it as a tag only, since remat
    # is not ported yet)
    for i in range(cfg.num_layers):
        with remat_unit(f"bert_layer_{i}"):
            x = encoder_layer(cfg, x, mask4, i, is_test)
    return x


def bert_pretrain_loss(cfg: BertConfig, seq_out, mlm_labels, input_mask):
    """Masked-LM loss averaged over the labelled positions (label -100 is
    ignored). The decoder has its own output matrix (``mlm_out.w``), not
    tied to the word embedding, as in the JAX package."""
    logits = layers.fc(seq_out, cfg.vocab_size, num_flatten_dims=2,
                       param_attr=_attr(cfg, "mlm_out.w", _tp(cfg, None, "tp")),
                       bias_attr=ParamAttr(name="mlm_out.b",
                                           initializer=ConstantInitializer(0.0),
                                           shard_spec=_tp(cfg, "tp")))
    loss = layers.softmax_with_cross_entropy(logits, mlm_labels, ignore_index=-100)
    # mean over non-ignored tokens
    valid = layers.cast(layers.not_equal(
        mlm_labels, layers.fill_constant([1], "int64", -100)), "float32")
    total = layers.reduce_sum(layers.elementwise_mul(loss, valid))
    denom = layers.reduce_sum(valid)
    return layers.elementwise_div(total, denom)


def build_pretrain_program(cfg: BertConfig, batch_size: int, seq_len: int,
                           optimizer_factory=None, is_test=False):
    """Build (main, startup, feeds, fetch) for a full pretrain step."""
    main = Program()
    startup = Program()
    with program_guard(main, startup):
        src = layers.data("src_ids", [seq_len], dtype="int64")
        pos = layers.data("pos_ids", [seq_len], dtype="int64")
        sent = layers.data("sent_ids", [seq_len], dtype="int64")
        mask = layers.data("input_mask", [seq_len], dtype="float32")
        labels = layers.data("mlm_labels", [seq_len, 1], dtype="int64")
        seq_out = bert_encoder(cfg, src, pos, sent, mask, is_test)
        loss = bert_pretrain_loss(cfg, seq_out, labels, mask)
        if optimizer_factory is not None:
            opt = optimizer_factory()
            opt.minimize(loss)
    return main, startup, ["src_ids", "pos_ids", "sent_ids", "input_mask", "mlm_labels"], loss


def param_count(cfg: BertConfig) -> int:
    h, f, v = cfg.hidden_size, cfg.ffn_size, cfg.vocab_size
    per_layer = 3 * h * h + 3 * h + h * h + h + 2 * (2 * h) + h * f + f + f * h + h
    emb = v * h + cfg.max_position * h + cfg.type_vocab_size * h + 2 * h
    head = h * v + v
    return cfg.num_layers * per_layer + emb + head
