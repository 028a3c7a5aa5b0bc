"""DeepFM CTR (BASELINE config 5; Criteo-style high-dim sparse lookup_table):
the port's copy of ``paddle_tpu.models.deepfm``, emitting the same program
with the same parameter names (``fm_t``, ``fm_w1``, ``fm_emb``, ``deep_*``).

Reference capability replaced: the pserver sparse-embedding path
(distributed_lookup_table + parameter_prefetch.cc) becomes a device-resident
embedding table; the reference's O(touched-rows) sparse-apply cost model
(selected_rows_functor.cc MergeAdd + optimizers/adagrad_op.cc sparse
kernels) is kept by SelectedRows gradients and, with ``packed_rows=``, the
packed row-major table of ``ops/deferred_rows.py`` updated by the fused
sparse-Adagrad kernel, or with ``deferred_rows=``, the deferred-row log of
the same module (the optimizer state in extra columns of the f32 table, a
fold every ``segments`` steps). ``shard_axis`` shards the tables over
their vocabulary on a mesh axis (``core/mesh_step.py``: each rank holds
its rows, reads zeros for the other rows' ids and keeps the SelectedRows
gradient rows of its range).
"""
from __future__ import annotations

from .. import layers, optimizer
from ..core.program import Program, program_guard
from ..initializer import RowPackInitializer, UniformInitializer
from ..param_attr import ParamAttr


def deepfm(sparse_ids, dense_feats, vocab_size: int, num_fields: int,
           embed_dim: int = 16, hidden_sizes=(400, 400, 400),
           shard_axis=None, is_sparse: bool = False,
           fused_table: bool = False, state_mult: int = 1,
           row_packed: bool = False):
    """sparse_ids: [B, num_fields] int64; dense_feats: [B, num_dense].

    is_sparse=True (opt-in) routes the table gradients through SelectedRows
    rows (lookup_table_op.cc sparse path) — O(batch·dim) gradient work
    instead of a dense [vocab, dim] scatter per step. Opt-in because only
    sgd/adam/adagrad have SelectedRows kernels (grad clipping and other
    optimizers need dense grads), matching the reference's constraint.

    fused_table=True stores the first-order weights as column `embed_dim`
    of a single [vocab, embed_dim+1] table (one gather + one sparse-update
    stream instead of two — a TPU-native fusion; the math is identical to
    the reference's separate [vocab,1] + [vocab,D] tables since the two
    lookups always share their ids).

    state_mult>1 widens the table rows to carry the deferred-row
    optimizer's moment state in-row (the Downpour g2sum layout — see
    ops/deferred_rows.py): 2 for adagrad, 3 for adam. The model reads
    only the visible [:embed_dim+1] columns.
    """
    spec = (shard_axis, None) if shard_axis else None
    if state_mult > 1 and not fused_table:
        raise ValueError("state_mult>1 (deferred moment state) requires "
                         "fused_table=True")
    if fused_table:
        vis = embed_dim + 1
        init = (RowPackInitializer(vis, vis * state_mult, -1e-2, 1e-2)
                if row_packed else UniformInitializer(-1e-2, 1e-2))
        both = layers.embedding(
            sparse_ids, [vocab_size, vis * state_mult], is_sparse=is_sparse,
            row_pack=row_packed,
            param_attr=ParamAttr(name="fm_t", initializer=init,
                                 shard_spec=spec))
        if state_mult > 1:
            both = layers.slice(both, axes=[2], starts=[0], ends=[vis])
        w1 = layers.slice(both, axes=[2], starts=[embed_dim],
                          ends=[embed_dim + 1])
        emb = layers.slice(both, axes=[2], starts=[0], ends=[embed_dim])
    else:
        # first-order weights
        w1 = layers.embedding(sparse_ids, [vocab_size, 1], is_sparse=is_sparse,
                              param_attr=ParamAttr(name="fm_w1",
                                                   initializer=UniformInitializer(-1e-4, 1e-4),
                                                   shard_spec=spec))
        emb = layers.embedding(sparse_ids, [vocab_size, embed_dim],
                               is_sparse=is_sparse,
                               param_attr=ParamAttr(name="fm_emb",
                                                    initializer=UniformInitializer(-1e-2, 1e-2),
                                                    shard_spec=spec))
    first_order = layers.reduce_sum(w1, dim=[1, 2], keep_dim=False)

    # second-order: embeddings [B, F, D]
    sum_sq = layers.square(layers.reduce_sum(emb, dim=[1]))
    sq_sum = layers.reduce_sum(layers.square(emb), dim=[1])
    second_order = layers.scale(
        layers.reduce_sum(layers.elementwise_sub(sum_sq, sq_sum), dim=[1]), scale=0.5)

    # deep part
    deep = layers.reshape(emb, [0, num_fields * embed_dim])
    deep = layers.concat([deep, dense_feats], axis=1)
    for i, hs in enumerate(hidden_sizes):
        deep = layers.fc(deep, hs, act="relu", name=f"deep_{i}")
    deep_out = layers.fc(deep, 1, name="deep_out")

    logit = layers.elementwise_add(
        layers.elementwise_add(layers.unsqueeze(first_order, [1]),
                               layers.unsqueeze(second_order, [1])),
        deep_out)
    return logit


_TABLE_NAMES = {"fm_w1", "fm_emb", "fm_t"}


def _table_optimizer(kind, lr, deferred_rows, packed_rows):
    if kind == "sgd":
        return optimizer.SGD(lr, deferred_rows=deferred_rows,
                                   packed_rows=packed_rows)
    if kind == "adagrad":
        return optimizer.Adagrad(lr, deferred_rows=deferred_rows,
                                       packed_rows=packed_rows)
    if kind == "adam":
        return optimizer.Adam(lr, deferred_rows=deferred_rows,
                                    packed_rows=packed_rows)
    raise ValueError(
        f"embedding_optimizer={kind!r}: expected one of sgd/adagrad/adam")


def build_train_program(vocab_size=100000, num_fields=26, num_dense=13,
                        embed_dim=16, lr=1e-3, shard_axis=None,
                        is_sparse=False, embedding_optimizer=None,
                        deferred_rows=None, fused_table=False,
                        packed_rows=None, hidden_sizes=(400, 400, 400)):
    """embedding_optimizer="sgd"/"adagrad"/"adam" puts the Criteo-scale
    table(s) on their own rule while the dense net keeps Adam — the
    reference's CTR practice (Downpour sparse tables run their own rule
    while the dense net runs a full optimizer).

    packed_rows={"rows_per_step": B*num_fields[, "fused": bool]} stores
    the fused table packed row-major with the optimizer state in its rows
    and updates the touched rows only (ops/deferred_rows.py).
    deferred_rows={"rows_per_step": B*num_fields[, "segments": K]} widens
    the f32 table by the optimizer's state columns (state_mult) and routes
    its updates through the deferred-row log: O(touched rows) a step plus
    one fold every K steps, run by the executor's epilogue. Either requires
    is_sparse=True, fused_table=True and an embedding_optimizer choice.
    """
    state_mult = 1
    if deferred_rows is not None or packed_rows is not None:
        if not (is_sparse and fused_table):
            raise ValueError(
                "deferred_rows/packed_rows need is_sparse=True "
                "(SelectedRows grads) and fused_table=True (single lookup "
                "site per table)")
        state_mult = {"sgd": 1, "adagrad": 2, "adam": 3}.get(
            embedding_optimizer, 1)
    main = Program()
    startup = Program()
    with program_guard(main, startup):
        ids = layers.data("sparse_ids", [num_fields], dtype="int64")
        dense = layers.data("dense", [num_dense])
        label = layers.data("label", [1])
        logit = deepfm(ids, dense, vocab_size, num_fields, embed_dim,
                       hidden_sizes=hidden_sizes,
                       shard_axis=shard_axis, is_sparse=is_sparse,
                       fused_table=fused_table, state_mult=state_mult,
                       row_packed=packed_rows is not None)
        loss = layers.mean(
            layers.sigmoid_cross_entropy_with_logits(logit, label))
        prob = layers.sigmoid(logit)
        if embedding_optimizer is None:
            if deferred_rows is not None or packed_rows is not None:
                raise ValueError(
                    "deferred_rows/packed_rows need embedding_optimizer")
            optimizer.Adam(lr).minimize(loss)
        else:
            adam = optimizer.Adam(lr)
            table_opt = _table_optimizer(embedding_optimizer, lr,
                                         deferred_rows, packed_rows)
            # ONE backward pass, gradients split across the two rules
            params_grads = adam.backward(loss)
            table_pg = [pg for pg in params_grads
                        if pg[0].name in _TABLE_NAMES]
            dense_pg = [pg for pg in params_grads
                        if pg[0].name not in _TABLE_NAMES]
            adam.apply_gradients(dense_pg)
            table_opt.apply_gradients(table_pg)
            main._deferred_table_optimizer = table_opt
    return main, startup, ["sparse_ids", "dense", "label"], loss, prob
