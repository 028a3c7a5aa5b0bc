"""Rank helper of the port's multi-rank tests (``tests/test_torch_parallel.py``,
``tests/test_torch_zero_sharding.py``, ``tests/test_torch_tensor_parallel.py``,
``tests/test_torch_moe.py``).

``World(n, tmpdir)`` spawns n processes (the ``spawn`` start method) that
join one gloo group through a ``FileStore`` file under `tmpdir` (never a
fixed port: the suite runs several files at once) and then serve cases:
``World.run(name, kwargs or [kwargs a rank])`` sends the case to every rank
and returns each rank's result. Every group has a timeout and every
receive waits a bounded time, so a hung rank fails its test, not the
suite; a world whose case failed is torn down.

Each rank pins ``torch.set_num_threads(1)`` and imports torch and the port
only, never jax or paddle_tpu: the JAX side of a twin runs in the test
process. The model builders take the package as an argument (``build_*
(fluid)``), so the test builds the same program with the JAX package.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import traceback
import warnings

import numpy as np

CASE_TIMEOUT = 240.0   # seconds a case may take on every rank
GROUP_TIMEOUT = 180.0  # seconds any collective of the group may wait


# -- model builders (either package) ------------------------------------------

def build_zero_mlp(fluid, opt="adam", seed=7):
    """tests/test_zero_sharding.py's `_build`: one dp-divisible weight, one
    13-row weight and 13- and 1-element biases. Returns (main, startup,
    loss name)."""
    from_np = fluid.initializer.NumpyArrayInitializer
    rng = np.random.RandomState(seed)

    def attr(name, shape):
        w = (rng.rand(*shape).astype("float32") - 0.5) * 0.2
        return fluid.ParamAttr(name=name, initializer=from_np(w))

    opts = {"sgd": lambda: fluid.optimizer.SGD(0.1),
            "momentum": lambda: fluid.optimizer.Momentum(0.1, momentum=0.9),
            "adam": lambda: fluid.optimizer.Adam(0.01),
            "adagrad": lambda: fluid.optimizer.Adagrad(0.1),
            "lamb": lambda: fluid.optimizer.Lamb(0.01)}
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [16])
        y = fluid.layers.data("y", [1])
        h = fluid.layers.fc(x, 32, act="relu",
                            param_attr=attr("zw0", (16, 32)),
                            bias_attr=attr("zb0", (32,)))
        h = fluid.layers.fc(h, 13, act="relu",
                            param_attr=attr("zw1", (32, 13)),
                            bias_attr=attr("zb1", (13,)))
        out = fluid.layers.fc(h, 1, param_attr=attr("zw2", (13, 1)),
                              bias_attr=attr("zb2", (1,)))
        loss = fluid.layers.mean(fluid.layers.square(out - y))
        opts[opt]().minimize(loss)
    return main, startup, loss.name


def build_unit_mlp(fluid, seed=3):
    """tests/test_stage3_sharding.py's `_unit_mlp`: a dropout-free MLP
    whose three hidden blocks are remat units. Returns (main, startup,
    loss name)."""
    rng = np.random.RandomState(seed)

    def attr(name, shape):
        w = (rng.rand(*shape).astype("float32") - 0.5) * 0.2
        return fluid.ParamAttr(
            name=name, initializer=fluid.initializer.NumpyArrayInitializer(w))

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [16])
        y = fluid.layers.data("y", [1])
        h = x
        for i in range(3):
            with fluid.remat_unit(f"blk_{i}"):
                h = fluid.layers.fc(h, 32, act="tanh",
                                    param_attr=attr(f"rw{i}",
                                                    (h.shape[-1], 32)),
                                    bias_attr=attr(f"rb{i}", (32,)))
        out = fluid.layers.fc(h, 1, param_attr=attr("rwo", (32, 1)),
                              bias_attr=attr("rbo", (1,)))
        loss = fluid.layers.mean(fluid.layers.square(out - y))
        fluid.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss.name


def build_narrow(fluid):
    """fc 16 → 4 (a 4-element bias: one element a rank at dp=4) → fc 1,
    Adam: a leaf whose shard is as small as the optimizer's scalar state."""
    rng = np.random.RandomState(6)

    def attr(name, shape):
        w = (rng.rand(*shape).astype("float32") - 0.5) * 0.2
        return fluid.ParamAttr(
            name=name, initializer=fluid.initializer.NumpyArrayInitializer(w))

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [16])
        y = fluid.layers.data("y", [1])
        h = fluid.layers.fc(x, 4, act="tanh", param_attr=attr("nw0", (16, 4)),
                            bias_attr=attr("nb0", (4,)))
        out = fluid.layers.fc(h, 1, param_attr=attr("nw1", (4, 1)),
                              bias_attr=attr("nb1", (1,)))
        loss = fluid.layers.mean(fluid.layers.square(out - y))
        fluid.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss.name


def unit_mlp_feed():
    rng = np.random.RandomState(5)
    return {"x": rng.rand(32, 16).astype("float32"),
            "y": rng.rand(32, 1).astype("float32")}


def zero_mlp_feed():
    rng = np.random.RandomState(0)
    return {"x": rng.rand(32, 16).astype("float32"),
            "y": rng.rand(32, 1).astype("float32")}


def build_ce_fc(fluid):
    """tests/test_parallel.py's data-parallel model: fc → softmax CE →
    SGD."""
    w = np.random.RandomState(5).rand(16, 4).astype("float32") * 0.1
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [16])
        y = fluid.layers.data("y", [1], dtype="int64")
        logits = fluid.layers.fc(
            x, 4, bias_attr=False,
            param_attr=fluid.ParamAttr(
                name="w", initializer=fluid.initializer.NumpyArrayInitializer(
                    w)))
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss.name


def build_conv_bn(fluid):
    """A tiny conv + batch-norm (+ relu) net with a fused 1×1-conv+BN tail
    and accuracy: every batch reduction of the ResNet path."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", [4, 8, 8])
        label = fluid.layers.data("label", [1], dtype="int64")
        h = fluid.layers.conv2d(img, 8, 3, padding=1, bias_attr=False)
        h = fluid.layers.batch_norm(h, act="relu")
        h = fluid.layers.fused_conv_bn(h, 16, act="relu") \
            if hasattr(fluid.layers, "fused_conv_bn") else h
        h = fluid.layers.pool2d(h, pool_type="avg", global_pooling=True)
        logits = fluid.layers.fc(h, 3)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        acc = fluid.layers.accuracy(fluid.layers.softmax(logits), label)
        fluid.optimizer.Momentum(0.05, momentum=0.9).minimize(loss)
    return main, startup, loss.name, acc.name


def tiny_bert_cfg(fluid_bert, attn_dropout=0.0):
    return fluid_bert.BertConfig(
        vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
        ffn_size=128, max_position=32, hidden_dropout=0.0,
        attn_dropout=attn_dropout)


def build_tiny_bert(fluid, bert_mod, batch, seq, attn_dropout=0.0):
    main, startup, _, loss = bert_mod.build_pretrain_program(
        tiny_bert_cfg(bert_mod, attn_dropout), batch, seq,
        optimizer_factory=lambda: fluid.optimizer.Adam(1e-3))
    return main, startup, loss.name


def bert_feed(batch, seq, seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 128, (batch, seq, 1)).astype("int64")
    labels[rng.rand(batch, seq) < 0.5] = -100
    mask = np.ones((batch, seq), "float32")
    mask[:, seq - 3:] = 0.0
    return {"src_ids": rng.randint(0, 128, (batch, seq)).astype("int64"),
            "pos_ids": np.tile(np.arange(seq, dtype="int64"), (batch, 1)),
            "sent_ids": np.zeros((batch, seq), "int64"),
            "input_mask": mask, "mlm_labels": labels}


def rows(feed, rank, world):
    """This rank's rows of a global feed dict."""
    out = {}
    for k, v in feed.items():
        n = v.shape[0] // world
        out[k] = v[rank * n:(rank + 1) * n]
    return out


def _tp_module(fluid):
    import importlib

    return importlib.import_module(fluid.__name__ + ".parallel.tensor_parallel")


def tp_bert_cfg(bert_mod, tp, flash=True):
    """tests/test_parallel.py's TP BERT (hidden 32, 4 heads, 2 layers)."""
    return bert_mod.BertConfig(vocab_size=128, hidden_size=32, num_layers=2,
                               num_heads=4, ffn_size=64, max_position=32,
                               hidden_dropout=0.0, attn_dropout=0.0,
                               tp_axis="tp" if tp else None,
                               use_flash_attention=flash)


def build_tp_bert(fluid, tp, flash=True, opt="sgd"):
    bert_mod = _models(fluid).bert
    factory = {"sgd": lambda: fluid.optimizer.SGD(0.01),
               "adam": lambda: fluid.optimizer.Adam(1e-3)}[opt]
    main, startup, _, loss = bert_mod.build_pretrain_program(
        tp_bert_cfg(bert_mod, tp, flash), 4, 16, optimizer_factory=factory)
    main.random_seed = 7
    return main, startup, loss.name


def tp_bert_feed():
    rng = np.random.RandomState(0)
    return {"src_ids": rng.randint(0, 128, (4, 16)).astype("int64"),
            "pos_ids": np.tile(np.arange(16), (4, 1)).astype("int64"),
            "sent_ids": np.zeros((4, 16), dtype="int64"),
            "input_mask": np.ones((4, 16), dtype="float32"),
            "mlm_labels": rng.randint(0, 128, (4, 16, 1)).astype("int64")}


NMT_KW = dict(d_model=32, n_heads=4, d_ff=64, n_enc=1, n_dec=1,
              src_vocab=64, tgt_vocab=64, dropout=0.0)


def build_tp_nmt(fluid, tp):
    """tests/test_parallel.py's TP NMT: annotate_tp(main, NMT_RULES)."""
    nmt = _models(fluid).transformer_nmt
    main, startup, _, loss = nmt.build_train_program(
        nmt.TransformerConfig(**NMT_KW), 8, 8,
        optimizer_factory=lambda: fluid.optimizer.SGD(0.05))
    if tp:
        tpm = _tp_module(fluid)
        assert tpm.annotate_tp(main, tpm.NMT_RULES) >= 8
    main.random_seed = 7
    return main, startup, loss.name


def tp_nmt_feed(b=4, ts=8, tt=8):
    rng = np.random.RandomState(0)
    causal = np.triu(np.full((tt, tt), -1e4, "float32"), 1)
    return {"src_ids": rng.randint(1, 64, (b, ts)).astype("int64"),
            "tgt_ids": rng.randint(1, 64, (b, tt)).astype("int64"),
            "lbl_ids": rng.randint(1, 64, (b, tt, 1)).astype("int64"),
            "src_mask": np.zeros((b, 1, 1, ts), "float32"),
            "tgt_mask": np.broadcast_to(causal, (b, 1, tt, tt)).copy()}


def build_ckpt_mlp(fluid, tp):
    """tests/test_checkpoint.py's `_build`: w0 carries (None, "tp") when
    tp is on; Adam."""
    main, startup = fluid.Program(), fluid.Program()
    init = fluid.initializer.NumpyArrayInitializer
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [16])
        y = fluid.layers.data("y", [1], dtype="int64")
        w0 = np.random.RandomState(5).rand(16, 8).astype("float32") * 0.1
        h = fluid.layers.fc(x, 8, act="relu", bias_attr=False,
                            param_attr=fluid.ParamAttr(
                                name="w0", initializer=init(w0),
                                shard_spec=(None, "tp") if tp else None))
        w1 = np.random.RandomState(6).rand(8, 4).astype("float32") * 0.1
        logits = fluid.layers.fc(h, 4, bias_attr=False,
                                 param_attr=fluid.ParamAttr(
                                     name="w1", initializer=init(w1)))
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.Adam(0.05).minimize(loss)
    return main, startup, loss.name


def ckpt_mlp_feed():
    rng = np.random.RandomState(0)
    return {"x": rng.rand(32, 16).astype("float32"),
            "y": rng.randint(0, 4, (32, 1)).astype("int64")}


def build_w_tp(fluid, tp=True):
    """tests/dist_ckpt_runner.py's `build`: one (None, "tp") weight w_tp,
    softmax CE, SGD."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [16])
        y = fluid.layers.data("y", [1], dtype="int64")
        w = (np.random.RandomState(5).rand(16, 8).astype("float32") - 0.5)
        logits = fluid.layers.fc(
            x, 8, bias_attr=False,
            param_attr=fluid.ParamAttr(
                name="w_tp",
                initializer=fluid.initializer.NumpyArrayInitializer(w),
                shard_spec=(None, "tp") if tp else None))
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss.name


def w_tp_feed():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(8, 16).astype("float32"),
            "y": rng.randint(0, 8, (8, 1)).astype("int64")}


def build_sparse_table(fluid, tp):
    """tests/test_sparse_embedding.py's tp-sharded table model."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        main.random_seed = startup.random_seed = 3
        ids = layers.data("ids", [6], dtype="int64")
        y = layers.data("y", [1], dtype="float32")
        emb = layers.embedding(
            ids, [64, 8], is_sparse=True,
            param_attr=fluid.ParamAttr(
                name="table",
                initializer=fluid.initializer.NormalInitializer(0.0, 0.1),
                shard_spec=("tp", None) if tp else None))
        pred = layers.fc(layers.reduce_sum(emb, dim=1), 1,
                         param_attr=fluid.ParamAttr(name="w"),
                         bias_attr=fluid.ParamAttr(name="b"))
        loss = layers.reduce_mean(layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(0.5).minimize(loss)
    return main, startup, loss.name


def sparse_table_feed():
    rng = np.random.RandomState(0)
    return {"ids": rng.randint(0, 50, (8, 6)).astype("int64"),
            "y": rng.rand(8, 1).astype("float32")}


DEEPFM_V, DEEPFM_B = 4096, 16


def build_tp_deepfm(fluid, tp, packed=True):
    """DeepFM with a vocab-sharded table on sparse Adagrad: the packed fm_t
    table (the fused row kernel's path) or the unpacked fm_w1/fm_emb."""
    deepfm = _models(fluid).deepfm
    kw = dict(vocab_size=DEEPFM_V, shard_axis="tp" if tp else None,
              is_sparse=True, embedding_optimizer="adagrad",
              hidden_sizes=(16,), lr=0.05)
    if packed:
        kw.update(fused_table=True,
                  packed_rows={"rows_per_step": DEEPFM_B * 26})
    main, startup, _, loss, _ = deepfm.build_train_program(**kw)
    main.random_seed = startup.random_seed = 11
    return main, startup, loss.name


def tp_deepfm_feed(seed=0):
    rng = np.random.RandomState(seed)
    return {"sparse_ids": rng.randint(0, DEEPFM_V, (DEEPFM_B, 26))
            .astype("int64"),
            "dense": rng.rand(DEEPFM_B, 13).astype("float32"),
            "label": rng.randint(0, 2, (DEEPFM_B, 1)).astype("float32")}


def build_moe_layer(fluid, k=1, cf=8.0, experts=8, opt="sgd"):
    """tests/test_moe.py's static-graph MoE block."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        main.random_seed = startup.random_seed = 7
        x = layers.data("x", [16])
        y = layers.data("y", [16])
        h, aux = layers.moe_ffn(x, num_experts=experts, hidden_size=32, k=k,
                                capacity_factor=cf)
        mse = layers.reduce_mean(layers.square(layers.elementwise_sub(h, y)))
        loss = layers.elementwise_add(mse, layers.scale(aux, scale=0.01))
        {"sgd": lambda: fluid.optimizer.SGD(0.05),
         "adam": lambda: fluid.optimizer.Adam(0.01)}[opt]().minimize(loss)
    return main, startup, loss.name


def moe_feed(seed=1):
    rng = np.random.RandomState(seed)
    return {"x": rng.rand(32, 16).astype("float32"),
            "y": rng.rand(32, 16).astype("float32")}


def build_gather_mlp(fluid, tp):
    """A column-parallel fc whose sliced output meets layer_norm (which
    declares nothing for a slice: the mesh step gathers it whole), then a
    replicated fc; Adam."""
    rng = np.random.RandomState(4)
    init = fluid.initializer.NumpyArrayInitializer

    def attr(name, shape, spec=None):
        w = (rng.rand(*shape).astype("float32") - 0.5) * 0.4
        return fluid.ParamAttr(name=name, initializer=init(w),
                               shard_spec=spec if tp else None)

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [16])
        y = fluid.layers.data("y", [1])
        h = fluid.layers.fc(x, 32, param_attr=attr("gw0", (16, 32),
                                                   (None, "tp")),
                            bias_attr=attr("gb0", (32,), ("tp",)))
        h = fluid.layers.layer_norm(h)
        out = fluid.layers.fc(h, 1, param_attr=attr("gw1", (32, 1)))
        loss = fluid.layers.mean(fluid.layers.square(out - y))
        fluid.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss.name


TP_MODELS = {"bert": build_tp_bert, "gather_mlp": build_gather_mlp, "nmt": build_tp_nmt,
             "ckpt_mlp": build_ckpt_mlp, "w_tp": build_w_tp,
             "sparse_table": build_sparse_table, "deepfm": build_tp_deepfm,
             "moe": lambda fluid, tp, **kw: build_moe_layer(fluid, **kw)}


def _models(fluid):
    import importlib

    return importlib.import_module(fluid.__name__ + ".models")


def jax_state(jfluid, model, tp=True, **kw):
    """The JAX package's startup state of a TP_MODELS model (numpy), to
    start the port's ranks from."""
    from paddle_tpu.core import unique_name as jn

    with jn.guard():
        main, startup, _ = TP_MODELS[model](jfluid, tp, **kw)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.TPUPlace()).run(startup)
        return {v.name: np.asarray(scope.find_var(v.name))
                for v in main.list_vars()
                if v.persistable and scope.find_var(v.name) is not None}


def jax_run(jfluid, model, feed, axes=None, data_axis="dp", steps=3,
            state=None, fetch=None, tp=None, **kw):
    """The JAX package's losses (and final state) of a TP_MODELS model on
    one device (`axes` None) or on a mesh of the test process's devices;
    `tp` (default: a mesh is given) builds it with its shard specs."""
    from paddle_tpu.core import unique_name as jn
    from paddle_tpu.parallel import make_mesh

    with jn.guard():
        main, startup, loss = TP_MODELS[model](
            jfluid, axes is not None if tp is None else tp, **kw)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.TPUPlace())
        exe.run(startup)
        if state is not None:
            for n, v in state.items():
                scope.set_var(n, v)
        prog = main
        if axes is not None:
            prog = jfluid.CompiledProgram(main).with_mesh(
                make_mesh(axes), data_axis=data_axis)
        losses = [float(np.asarray(exe.run(prog, feed=feed,
                                           fetch_list=[loss])[0]))
                  for _ in range(steps)]
        final = {n: np.asarray(scope.find_var(n)) for n in (fetch or ())}
    return losses, final


# -- cases (run on every rank) ------------------------------------------------

def _port():
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import unique_name

    return fluid, unique_name


def _state_info(main, scope):
    """name -> (local shape, global shape, shard axis or None) of every
    persistable in the scope."""
    from paddle_tpu_torch.core.mesh_step import is_dtensor

    info = {}
    for v in main.list_vars():
        if not v.persistable:
            continue
        val = scope.find_var(v.name)
        if val is None or not hasattr(val, "shape"):
            continue
        if is_dtensor(val):
            axes = [p.dim for p in val.placements if p.is_shard()]
            info[v.name] = (tuple(val.to_local().shape), tuple(val.shape),
                            axes[0] if axes else None)
        else:
            info[v.name] = (tuple(val.shape), tuple(val.shape), None)
    return info


def _whole_dtensors(main, scope):
    """name -> the whole (padded) value of every sharded persistable, as
    ``np.asarray`` of the JAX package's padded array reads it."""
    from paddle_tpu_torch.core.dtypes import to_numpy
    from paddle_tpu_torch.core.mesh_step import is_dtensor

    return {v.name: to_numpy(scope.find_var(v.name).full_tensor())
            for v in main.list_vars()
            if v.persistable and is_dtensor(scope.find_var(v.name))}


def _logical_state(main, scope, names=None):
    from paddle_tpu_torch.core.dtypes import to_numpy
    from paddle_tpu_torch.core.mesh_step import logical_value

    out = {}
    for v in main.list_vars():
        if not v.persistable or (names is not None and v.name not in names):
            continue
        val = scope.find_var(v.name)
        if val is None or not hasattr(val, "shape"):
            continue
        out[v.name] = to_numpy(logical_value(main, v.name, val))
    return out


def case_train(model, feed, steps=4, stage=0, state=None, opt="adam",
               data_parallel=True, env=None, remat=None, fetch_state=True):
    """Build `model`, load `state` (numpy, from the JAX startup) or run the
    port's startup, and run `steps` steps on this rank's `feed` rows
    through with_data_parallel at ZeRO `stage` (or the plain executor).
    Returns the fetches a step (bytes and arrays), the state layout, the
    final logical state and the state-bytes gauge."""
    fluid, names = _port()
    from paddle_tpu_torch.observability.registry import get_registry

    old_env = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        with names.guard():
            if model == "zero_mlp":
                main, startup, loss = build_zero_mlp(fluid, opt)
                fetch = [loss]
            elif model == "unit_mlp":
                main, startup, loss = build_unit_mlp(fluid)
                fetch = [loss]
            elif model == "narrow":
                main, startup, loss = build_narrow(fluid)
                fetch = [loss]
            elif model == "ce_fc":
                main, startup, loss = build_ce_fc(fluid)
                fetch = [loss]
            elif model == "conv_bn":
                main, startup, loss, acc = build_conv_bn(fluid)
                fetch = [loss, acc]
            elif model == "tiny_bert":
                from paddle_tpu_torch.models import bert

                b = feed["src_ids"].shape[0]
                main, startup, loss = build_tiny_bert(
                    fluid, bert, b, feed["src_ids"].shape[1],
                    attn_dropout=float((env or {}).get("ATTN_DROPOUT", 0)))
                fetch = [loss]
            else:
                raise ValueError(model)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            exe.run(startup)
            if state is not None:
                fluid.io.load_params_from_numpy(state, scope=scope)
            prog = main
            if data_parallel:
                bs = fluid.BuildStrategy()
                bs.sharding_strategy = stage
                if remat:
                    bs.remat_policy = remat
                prog = fluid.CompiledProgram(main).with_data_parallel(
                    loss_name=loss, build_strategy=bs)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                outs = []
                gauge = []
                for _ in range(steps):
                    outs.append(exe.run(prog, feed=feed, fetch_list=fetch))
                    gauge.append(get_registry().gauge(
                        "memory/state_bytes_per_device").value)
            result = {
                "warnings": [str(w.message) for w in caught],
                "gauge_steps": gauge,
                "whole": _whole_dtensors(main, scope),
                "losses": [np.asarray(o[0]).tobytes() for o in outs],
                "fetches": [[np.asarray(x) for x in o] for o in outs],
                "info": _state_info(main, scope),
                "padded": dict(getattr(main, "_zero_padded", {}) or {}),
                "state_bytes": get_registry().gauge(
                    "memory/state_bytes_per_device").value,
            }
            if fetch_state:
                result["state"] = _logical_state(main, scope)
        return result
    finally:
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def case_collectives(x):
    """The array-level collectives on a dim-0 sharded DTensor of `x`."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from paddle_tpu_torch.parallel import (all_gather, all_reduce, all_to_all,
                                           broadcast, make_mesh,
                                           reduce_scatter)
    from paddle_tpu_torch.parallel import collective as C

    mesh = make_mesh({"dp": C.dist.get_world_size()})
    t = torch.from_numpy(np.asarray(x))
    xs = DTensor.from_local(t.chunk(mesh.size())[mesh.get_local_rank()],
                            mesh, [Shard(0)], run_check=False)
    ones = DTensor.from_local(torch.ones_like(t), mesh, [Replicate()],
                              run_check=False)
    a2a_in = DTensor.from_local(
        torch.arange(mesh.size() * 2, dtype=torch.float32).reshape(-1, 1)
        + 100 * mesh.get_local_rank(), mesh, [Shard(0)], run_check=False)
    out = {"all_reduce": all_reduce(xs, mesh, "dp").to_local().numpy(),
           "all_gather": all_gather(xs, mesh, "dp").to_local().numpy(),
           "broadcast": broadcast(xs, mesh, "dp", root=2).to_local().numpy(),
           "reduce_scatter": reduce_scatter(ones, mesh,
                                            "dp").full_tensor().numpy(),
           "all_to_all": all_to_all(a2a_in, mesh, "dp", 0,
                                    0).to_local().numpy(),
           "axis_index": C.axis_index((mesh, "dp"))}
    perm = [(i, (i + 1) % mesh.size()) for i in range(mesh.size())]
    out["ppermute"] = C.ppermute(t[:2] + mesh.get_local_rank(), (mesh, "dp"),
                                 perm).numpy()
    out["psum"] = C.psum(t[:2] * 0 + mesh.get_local_rank(),
                         (mesh, "dp")).numpy()
    C.barrier(mesh)
    return out


def case_ring(q, k, v, causal, impl="plain", grads=False, ulysses=False,
              sp=None):
    """This rank's sequence shard through ring (or Ulysses) attention on
    an `sp` mesh axis (the whole world, or a {"dp", "sp"} mesh when `sp`
    is smaller); with `grads` the gradients of sum(out²)."""
    from paddle_tpu_torch.parallel import (make_mesh, ring_self_attention,
                                           ulysses_attention)
    from paddle_tpu_torch.parallel import collective as C

    world = C.dist.get_world_size()
    sp = sp or world
    mesh = make_mesh({"sp": sp} if sp == world
                     else {"dp": world // sp, "sp": sp})
    from paddle_tpu_torch.core.dtypes import from_numpy

    qt, kt, vt = (from_numpy(a).requires_grad_(grads) for a in (q, k, v))
    if ulysses:
        out = ulysses_attention(qt, kt, vt, mesh, "sp", causal=causal)
    else:
        out = ring_self_attention(qt, kt, vt, mesh, "sp", causal=causal,
                                  impl=impl)
    res = {"out": out.detach().float().numpy()}
    if grads:
        (out.float() ** 2).sum().backward()
        res.update(dq=qt.grad.float().numpy(), dk=kt.grad.float().numpy(),
                   dv=vt.grad.float().numpy())
    return res


def case_mesh_shapes():
    from paddle_tpu_torch.parallel import auto_mesh, mesh_shape

    return [mesh_shape(auto_mesh(tp=2)), mesh_shape(auto_mesh(tp=2, pp=2))]


def case_surface():
    """The mesh surface: the meshes that run (an sp dim without seq_axis,
    a pp dim without pipeline ops and an ep dim beside the data axis
    compute replicated; each runs a step on this rank's rows: its loss and
    the plain run's), and what it refuses, naming the item."""
    import torch.distributed as dist

    fluid, names = _port()
    from paddle_tpu_torch.parallel import DistributedStrategy, make_mesh
    from paddle_tpu_torch.parallel import collective as C

    world = C.dist.get_world_size()
    got = {}
    with names.guard():
        main, startup, loss = build_zero_mlp(fluid)
    feed = zero_mlp_feed()
    exe = fluid.Executor(fluid.CPUPlace())

    def step(axes):
        prog = fluid.CompiledProgram(main).with_mesh(make_mesh(axes))
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            return float(np.asarray(exe.run(
                prog, feed=rows(feed, dist.get_rank() // 2, world // 2),
                fetch_list=[loss])[0]).reshape(-1)[0])

    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        got["plain"] = float(np.asarray(exe.run(
            main, feed=feed, fetch_list=[loss])[0]).reshape(-1)[0])
    for label, fn in (
            ("seq_axis", lambda: step({"dp": world // 2, "sp": 2})),
            ("pp", lambda: step({"dp": world // 2, "pp": 2})),
            ("ep", lambda: step({"dp": world // 2, "ep": 2})),
            ("places", lambda: fluid.CompiledProgram(main).with_data_parallel(
                places=[fluid.CPUPlace()] * (world + 1))),
            ("gm", lambda: fluid.CompiledProgram(main).with_mesh(
                make_mesh({"dp": world}), strategy=_strategy(
                    DistributedStrategy, gradient_merge_steps=2)))):
        try:
            got[label] = fn()
        except (NotImplementedError, RuntimeError, ValueError) as e:
            got[label] = f"{type(e).__name__}: {e}"
    return got


def _strategy(cls, **kw):
    s = cls()
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def case_with_mesh(feed, state, stage, steps=3):
    """with_mesh(make_mesh({"dp": N}), strategy=sharding_degree/stage)."""
    fluid, names = _port()
    from paddle_tpu_torch.parallel import DistributedStrategy, make_mesh
    from paddle_tpu_torch.parallel import collective as C

    with names.guard():
        main, startup, loss = build_zero_mlp(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    st = _strategy(DistributedStrategy, sharding_degree=2 if stage else 1,
                   sharding_stage=max(stage, 1))
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.load_params_from_numpy(state, scope=scope)
        prog = fluid.CompiledProgram(main).with_mesh(
            make_mesh({"dp": C.dist.get_world_size()}), strategy=st)
        return [np.asarray(exe.run(prog, feed=feed, fetch_list=[loss])[0])
                .tobytes() for _ in range(steps)], _state_info(main, scope)


def case_parallel_executor(feed, state, stage):
    fluid, names = _port()
    from paddle_tpu_torch.observability.registry import get_registry

    with names.guard():
        main, startup, loss = build_zero_mlp(fluid, "sgd")
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(startup)
        fluid.io.load_params_from_numpy(state, scope=scope)
        bs = fluid.BuildStrategy()
        bs.sharding_strategy = stage
        pe = fluid.ParallelExecutor(use_cuda=False, loss_name=loss,
                                    main_program=main, build_strategy=bs)
        out = pe.run(fetch_list=[loss], feed=feed)
        return {"sharding_strategy": pe.sharding_strategy,
                "device_count": pe.device_count,
                "gauge": get_registry().gauge("executor/device_count").value,
                "loss": np.asarray(out[0])}


def case_run_batched(feed_list, state, stage):
    """run_batched and train_scanned (K = 2) on a CompiledProgram with a
    mesh: bitwise the plain runs of the same feeds."""
    fluid, names = _port()
    outs = []
    for batched in (False, True, "scanned"):
        with names.guard():
            main, startup, loss = build_zero_mlp(fluid)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            exe.run(startup)
            fluid.io.load_params_from_numpy(state, scope=scope)
            bs = fluid.BuildStrategy()
            bs.sharding_strategy = stage
            prog = fluid.CompiledProgram(main).with_data_parallel(
                loss_name=loss, build_strategy=bs)
            if batched == "scanned":
                outs.append(exe.train_scanned(
                    prog, reader=lambda: iter(feed_list), scan_steps=2,
                    fetch_list=[loss])[0])
            elif batched:
                outs.append(exe.run_batched(prog, feed_list,
                                            fetch_list=[loss])[0])
            else:
                outs.append(np.stack([exe.run(prog, feed=f,
                                              fetch_list=[loss])[0]
                                      for f in feed_list]))
    return [o.tobytes() for o in outs]


def case_amp_fp16(feed, stage, steps=3):
    """The ZeRO MLP under float16 AMP with dynamic loss scaling (its found-
    inf test before update_loss_scaling) at `stage`; returns the loss
    bytes, the loss-scaling state a step and the final parameters."""
    fluid, names = _port()
    from paddle_tpu_torch.contrib import mixed_precision

    with names.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [16])
            y = fluid.layers.data("y", [1])
            init = fluid.initializer.NumpyArrayInitializer
            rng = np.random.RandomState(3)
            h = fluid.layers.fc(x, 32, act="relu", param_attr=fluid.ParamAttr(
                name="aw0", initializer=init(
                    (rng.rand(16, 32).astype("float32") - 0.5) * 0.2)))
            out = fluid.layers.fc(h, 1, param_attr=fluid.ParamAttr(
                name="aw1", initializer=init(
                    (rng.rand(32, 1).astype("float32") - 0.5) * 0.2)))
            loss = fluid.layers.mean(fluid.layers.square(out - y))
            opt = mixed_precision.decorate(
                fluid.optimizer.Adam(0.01), dtype="float16",
                init_loss_scaling=2.0 ** 15, decr_every_n_nan_or_inf=1)
            opt.minimize(loss)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        bs = fluid.BuildStrategy()
        bs.sharding_strategy = stage
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=bs)
        losses, scales = [], []
        for i in range(steps):
            (lv,) = exe.run(prog, feed=feed[i], fetch_list=[loss])
            losses.append(np.asarray(lv).tobytes())
            scales.append(float(np.asarray(
                scope.find_var("loss_scaling").cpu()).reshape(-1)[0]))
        return {"losses": losses, "scales": scales,
                "params": _logical_state(main, scope, {"aw0", "aw1"})}


def case_ckpt_save(dirname, feed, state, stage, steps=2, drop_rng=False):
    """Train at `stage`, save with the Checkpointer (sharded state goes to
    the per-rank shard files), then one more step; returns that step's
    loss and the state saved. `drop_rng` leaves the torch generator out
    of the save (the JAX package cannot read one)."""
    fluid, names = _port()
    from paddle_tpu_torch.parallel import Checkpointer

    with names.guard():
        main, startup, loss = build_zero_mlp(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        if state is not None:
            fluid.io.load_params_from_numpy(state, scope=scope)
        bs = fluid.BuildStrategy()
        bs.sharding_strategy = stage
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss, build_strategy=bs)
        for _ in range(steps):
            exe.run(prog, feed=feed, fetch_list=[loss])
        saved = _logical_state(main, scope)
        if drop_rng:
            from paddle_tpu_torch.core.executor import _RNG_STATE

            gen = scope.find_var(_RNG_STATE)
            scope.set_var(_RNG_STATE, None)
        ck = Checkpointer(dirname)
        ck.save(step=steps, program=main, scope=scope)
        ck.wait()
        if drop_rng:
            scope.set_var(_RNG_STATE, gen)
        nxt = np.asarray(exe.run(prog, feed=feed, fetch_list=[loss])[0])
        return {"next": nxt.tobytes(), "saved": saved,
                "info": _state_info(main, scope),
                "files": sorted(os.listdir(dirname))}


def case_ckpt_restore(dirname, feed, stage):
    """Restore the newest checkpoint into a fresh scope and run one step at
    `stage` on this world; returns the loss and the restored state."""
    fluid, names = _port()
    from paddle_tpu_torch.parallel import Checkpointer

    with names.guard():
        main, startup, loss = build_zero_mlp(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        Checkpointer(dirname).restore(program=main, scope=scope,
                                      place=fluid.CPUPlace())
        restored = _logical_state(main, scope)
        bs = fluid.BuildStrategy()
        bs.sharding_strategy = stage
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss, build_strategy=bs)
        out = np.asarray(exe.run(prog, feed=feed, fetch_list=[loss])[0])
        return {"loss": out.tobytes(), "restored": restored}


def case_dropout_masks(feed, rate):
    """A tiny BERT at attention and hidden dropout `rate`, every rank fed
    the SAME rows; returns the global attention output of the first step
    (each rank draws its own masks)."""
    fluid, names = _port()
    from paddle_tpu_torch.models import bert

    with names.guard():
        cfg = bert.BertConfig(vocab_size=128, hidden_size=64, num_layers=1,
                              num_heads=2, ffn_size=128, max_position=32,
                              hidden_dropout=rate, attn_dropout=rate)
        main, startup, _, loss = bert.build_pretrain_program(
            cfg, feed["src_ids"].shape[0], feed["src_ids"].shape[1])
    seq = [v for v in main.global_block().ops
           if v.type == "flash_attention"][0].outputs["Out"][0]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
        out = exe.run(prog, feed=feed, fetch_list=[seq])[0]
    return np.asarray(out)


def case_ragged_feed(feed, state, short_rows=None, short_step=1, steps=3):
    """The zero_mlp run at stage 0 on this rank's `feed`, cut to
    `short_rows` rows from step `short_step` on (a ragged last batch):
    returns the losses of the steps that ran and the error that stopped
    the run, if any."""
    fluid, names = _port()
    with names.guard():
        main, startup, loss = build_zero_mlp(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    losses, error = [], None
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.load_params_from_numpy(state, scope=scope)
        prog = fluid.CompiledProgram(main).with_data_parallel(loss_name=loss)
        short = {k: v[:short_rows] for k, v in feed.items()}
        try:
            for i in range(steps):
                fd = feed if i < short_step or short_rows is None else short
                losses.append(np.asarray(exe.run(
                    prog, feed=fd, fetch_list=[loss])[0]).tobytes())
        except ValueError as e:
            error = f"{type(e).__name__}: {e}"
    return losses, error


def case_across_batch(op):
    """One step of a program whose `op` works across the batch dim of a
    batch-sharded value, on this rank's rows and on the plain executor with
    the whole batch: returns (the error it raised or None, the mesh run's
    loss, the plain run's loss)."""
    import torch.distributed as dist

    fluid, names = _port()
    with names.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [16])
            h = fluid.layers.fc(x, 8)
            if op == "matmul_transpose_x":   # hᵀh: a sum over the rows
                h = fluid.layers.matmul(h, h, transpose_x=True)
            elif op == "softmax_axis0":
                h = fluid.layers.softmax(h, axis=0)
            elif op == "transpose":
                h = fluid.layers.transpose(h, [1, 0])
            elif op == "sequence_pool":   # a LoD op, row by row
                h = fluid.layers.sequence_pool(
                    fluid.layers.reshape(h, [-1, 2, 4]), "sum",
                    length=fluid.layers.data("len", [1], dtype="int64"))
            loss = fluid.layers.mean(h)
            fluid.optimizer.SGD(0.1).minimize(loss)
    world, rank = dist.get_world_size(), dist.get_rank()
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(4 * world, 16).astype("float32")}
    if op == "sequence_pool":
        feed["len"] = rng.randint(1, 3, (4 * world, 1)).astype("int64")
    exe = fluid.Executor(fluid.CPUPlace())
    out = []
    for prog_of, fd in ((lambda: fluid.CompiledProgram(main)
                         .with_data_parallel(loss_name=loss.name),
                         rows(feed, rank, world)), (lambda: main, feed)):
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            try:
                got = exe.run(prog_of(), feed=fd, fetch_list=[loss])[0]
                out.append(float(np.asarray(got).reshape(-1)[0]))
            except NotImplementedError as e:
                return f"{type(e).__name__}: {e}", None, None
    return None, out[0], out[1]


def _r_hashes(main, scope, tp_names):
    """sha1 of every replicated persistable's bytes on this rank."""
    import hashlib

    from paddle_tpu_torch.core.dtypes import to_numpy
    from paddle_tpu_torch.core.mesh_step import is_dtensor

    out = {}
    for v in main.list_vars():
        val = scope.find_var(v.name)
        if (not v.persistable or v.name in tp_names or is_dtensor(val)
                or not hasattr(val, "shape")):
            continue
        out[v.name] = hashlib.sha1(to_numpy(val).tobytes()).hexdigest()
    return out


def case_tp(model, feed, axes, state=None, steps=3, data_axis="dp",
            stage=0, tp=True, fetch_state=True, fetch=None, save=None,
            restore=None, model_kw=None, peak=False):
    """Build a TP_MODELS model, start from `state` (the JAX startup's) or
    from the port's startup, and run `steps` steps of this rank's `feed`
    on a mesh of `axes` at ZeRO `stage`. Returns the losses (bytes), the
    hashes of the replicated persistables after each step, the state
    layout, the final logical state and the extra fetches of the last
    step. `save`/`restore` is a checkpoint directory written after the
    steps / read before them. With `peak`, the last step runs under the
    planner's live-bytes count (``planner._PeakBytes``, the state it
    starts from included): its peak is returned as ``peak_bytes``."""
    import contextlib

    import torch

    fluid, names = _port()
    from paddle_tpu_torch import planner
    from paddle_tpu_torch.parallel import Checkpointer, make_mesh

    with names.guard():
        main, startup, loss = TP_MODELS[model](fluid, tp, **(model_kw or {}))
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        if state is not None:
            fluid.io.load_params_from_numpy(state, scope=scope)
        step = None
        if restore is not None:
            step = Checkpointer(restore).restore(program=main, scope=scope,
                                                 place=fluid.CPUPlace())
        prog = main
        if axes is not None:
            bs = fluid.BuildStrategy()
            bs.sharding_strategy = stage
            prog = fluid.CompiledProgram(main).with_mesh(
                make_mesh(axes), data_axis=data_axis)
            prog.build_strategy = bs
        tp_names = {v.name for v in main.list_vars()
                    if getattr(v, "shard_spec", None)}
        losses, hashes, extra, mode = [], [], None, None
        for i in range(steps):
            count = contextlib.nullcontext()
            if peak and i == steps - 1:
                count = mode = planner._PeakBytes(torch.device("cpu"))
                for t in planner._state_leaves(main, scope):
                    mode.track(t)
            with count:
                out = exe.run(prog, feed=feed if not isinstance(feed, list)
                              else feed[i],
                              fetch_list=[loss] + list(fetch or ()))
            losses.append(np.asarray(out[0]).tobytes())
            extra = [np.asarray(o) for o in out[1:]]
            hashes.append(_r_hashes(main, scope, tp_names))
        from paddle_tpu_torch.observability.registry import get_registry

        result = {"losses": losses, "hashes": hashes, "extra": extra,
                  "info": _state_info(main, scope), "restored": step,
                  "state_bytes": get_registry().gauge(
                      "memory/state_bytes_per_device").value,
                  "peak_bytes": mode and mode.peak}
        if fetch_state:
            result["state"] = _logical_state(main, scope)
        if save is not None:
            ck = Checkpointer(save, keep=0)
            ck.save(7, program=main, scope=scope, blocking=True)
            result["files"] = sorted(os.listdir(save))
    return result


def case_tp_batched(model, feed_list, axes, state):
    """run, run_batched and train_scanned (K = 2) of a TP_MODELS model on
    a mesh of `axes`, each from `state`: the losses (bytes) of each, and
    the fetched sliced intermediate of the plain runs (whole)."""
    fluid, names = _port()
    from paddle_tpu_torch.parallel import make_mesh

    outs = []
    for how in ("run", "batched", "scanned"):
        with names.guard():
            main, startup, loss = TP_MODELS[model](fluid, True)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            exe.run(startup)
            fluid.io.load_params_from_numpy(state, scope=scope)
            prog = fluid.CompiledProgram(main).with_mesh(make_mesh(axes),
                                                         data_axis="dp")
            if how == "scanned":
                got = exe.train_scanned(prog, reader=lambda: iter(feed_list),
                                        scan_steps=2, fetch_list=[loss])[0]
            elif how == "batched":
                got = exe.run_batched(prog, feed_list, fetch_list=[loss])[0]
            else:
                got = np.stack([np.asarray(exe.run(prog, feed=f,
                                                   fetch_list=[loss])[0])
                                for f in feed_list])
        outs.append(np.asarray(got).tobytes())
    return outs


def case_vocab_parallel(logits, labels, ids, table):
    """The lookup and the cross entropy on this rank's slice of the vocab
    (the world is the model axis): the lookup's summand and the loss, its
    gradient slice and the whole-vocab references."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.core.executor import ExecContext
    from paddle_tpu_torch.core.mesh_step import TPShard
    from paddle_tpu_torch.core.registry import get_op

    n, r = dist.get_world_size(), dist.get_rank()
    group = dist.group.WORLD
    w = torch.from_numpy(table)
    v = w.shape[0] // n
    ctx = ExecContext("cpu")
    ctx.tp_in = {"W": [TPShard(0, r, n, group)], "Ids": [None]}
    part = get_op("lookup_table").fn(
        ctx, {"W": [w[r * v:(r + 1) * v]], "Ids": [torch.from_numpy(ids)]},
        {"padding_idx": 3})["Out"][0]
    whole_rows = part.clone()
    dist.all_reduce(whole_rows, group=group)
    x = torch.from_numpy(logits)
    c = x.shape[-1] // n
    local = x[..., r * c:(r + 1) * c].clone().requires_grad_()
    ctx.tp_in = {"Logits": [TPShard(x.ndim - 1, r, n, group)],
                 "Label": [None]}
    out = get_op("softmax_with_cross_entropy").fn(
        ctx, {"Logits": [local], "Label": [torch.from_numpy(labels)]},
        {"ignore_index": -100})["Loss"][0]
    (out.float() * torch.arange(1, out.numel() + 1).reshape(out.shape)
     ).sum().backward()
    return {"rows": whole_rows.numpy(), "loss": out.detach().float().numpy(),
            "grad": local.grad.float().numpy()}


def case_selected_rows(counts, height, tp_size=1):
    """`MeshStep.selected_rows` of a SelectedRows gradient whose row count
    is counts[rank] (ids rank·100 + i, rows filled with the id): every
    rank's rows laid end to end in rank order."""
    import types

    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.core.mesh_step import MeshStep
    from paddle_tpu_torch.core.selected_rows import SelectedRows

    r = dist.get_rank()
    ids = torch.arange(counts[r], dtype=torch.int64) + 100 * r
    rows = ids[:, None].float().expand(-1, 3).contiguous()
    step = types.SimpleNamespace(tp_state={}, size=dist.get_world_size(),
                                 group=dist.group.WORLD, tp_rank=0)
    got = MeshStep.selected_rows(step, "t", SelectedRows(ids, rows, height))
    return got.ids.numpy(), got.rows.numpy(), got.height


def case_tp_surface():
    """What a tp mesh refuses: BERT's 30,522-row vocabulary over tp = 4 and
    a spec naming an axis the mesh lacks; and what runs: a second model
    axis (under the "pp" label: a program with no spec on either axis
    computes replicated) and a sequence axis beside the model axis (tp
    BERT on sp×tp). Each run's losses beside the plain run's."""
    fluid, names = _port()
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel import collective as C

    world = C.dist.get_world_size()
    got = {}

    def attempt(label, fn):
        try:
            got[label] = fn()
        except (NotImplementedError, ValueError) as e:
            got[label] = f"{type(e).__name__}: {e}"

    def losses(main, startup, loss, feed, prog_of, steps=2):
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            prog = prog_of(main)
            return [float(np.asarray(exe.run(prog, feed=feed,
                                             fetch_list=[loss])[0]))
                    for _ in range(steps)]

    def run(vocab, axes, seq_axis=None, data_axis="dp"):
        with names.guard():
            cfg = bert.BertConfig(vocab_size=vocab, hidden_size=32,
                                  num_layers=1, num_heads=4, ffn_size=64,
                                  max_position=32, hidden_dropout=0.0,
                                  attn_dropout=0.0, tp_axis="tp")
            main, startup, _, loss = bert.build_pretrain_program(cfg, 4, 16)
        return losses(main, startup, loss, tp_bert_feed(),
                      lambda m: m if axes is None else
                      fluid.CompiledProgram(m).with_mesh(
                          make_mesh(axes), data_axis=data_axis,
                          seq_axis=seq_axis))

    attempt("vocab_30522_tp4", lambda: run(30522, {"dp": 1, "tp": world}))
    attempt("axis_missing", lambda: run(128, {"dp": world}))
    with names.guard():
        main, startup, loss = build_zero_mlp(fluid)
    attempt("pp", lambda: losses(
        main, startup, loss, zero_mlp_feed(),
        lambda m: fluid.CompiledProgram(m).with_mesh(
            make_mesh({"tp": 2, "mp": world // 2}), data_axis=None)))
    got["pp_plain"] = losses(main, startup, loss, zero_mlp_feed(),
                             lambda m: m)
    attempt("seq_axis", lambda: run(128, {"sp": 2, "tp": world // 2},
                                    seq_axis="sp", data_axis=None))
    got["seq_axis_plain"] = run(128, None)
    return got


def case_moe_expert_parallel(x, params, k, cf, grads=False, axis_size=None):
    """parallel.moe.moe_ffn_expert_parallel on this rank's tokens over the
    world (the ep axis); with `grads`, the gradients of
    sum(y²) + 0.1·aux with respect to the five parameters (each rank's
    part; the caller sums them)."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import moe

    r, n = dist.get_rank(), dist.get_world_size()
    xs = torch.from_numpy(x).chunk(n)[r]
    ps = [torch.from_numpy(p).requires_grad_(grads) for p in params]
    y, aux = moe.moe_ffn_expert_parallel(xs, *ps, dist.group.WORLD, k=k,
                                         capacity_factor=cf)
    out = {"y": y.detach().numpy(), "aux": float(aux)}
    if grads:
        (torch.sum(y ** 2) + 0.1 * aux).backward()
        out["grads"] = [p.grad.numpy() for p in ps]
    return out


def case_moe_train(x, params, steps=2):
    """A plain torch training step of the expert-parallel block (tests/
    test_moe.py's jitted Adam step): each rank's gradients summed over the
    world, torch.optim.Adam(1e-3); returns the losses."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import moe

    r, n = dist.get_rank(), dist.get_world_size()
    xs = torch.from_numpy(x).chunk(n)[r]
    ps = [torch.nn.Parameter(torch.from_numpy(p).clone()) for p in params]
    opt = torch.optim.Adam(ps, lr=1e-3)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        y, aux = moe.moe_ffn_expert_parallel(xs, *ps, dist.group.WORLD, k=2,
                                             capacity_factor=2.0)
        mse = torch.sum((y - xs) ** 2)
        total = mse.detach().clone()
        dist.all_reduce(total)
        loss = total / (xs.shape[0] * n * xs.shape[1]) + 0.01 * aux
        ((mse / (xs.shape[0] * n * xs.shape[1])) + 0.01 * aux / n).backward()
        for p in ps:
            dist.all_reduce(p.grad)
        opt.step()
        losses.append(float(loss))
    return losses


CASES = {n[5:]: f for n, f in dict(globals()).items()
         if n.startswith("case_") and callable(f)}


# -- the world ----------------------------------------------------------------

def _serve(rank, world, store, conn, cases=None):
    import importlib

    import torch

    torch.set_num_threads(1)
    table = CASES if cases is None else importlib.import_module(cases).CASES
    from paddle_tpu_torch.parallel import init_parallel_env

    init_parallel_env(f"file://{store}", world, rank, device="cpu",
                      timeout=GROUP_TIMEOUT)
    import torch.distributed as dist

    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            name, kwargs = msg
            try:
                conn.send(("ok", table[name](**kwargs)))
            except Exception:  # reported to the test, which fails on it
                conn.send(("err", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    """n gloo ranks serving cases (see the module docstring)."""

    _count = 0

    def __init__(self, n: int, tmpdir: str, cases: str = None):
        """`cases`: the module whose ``CASES`` the ranks serve (default
        this one's)."""
        ctx = mp.get_context("spawn")
        # a new file for every world: a world started again after a failed
        # case must not meet the old world's addresses in its store
        World._count += 1
        store = os.path.join(str(tmpdir),
                             f"store-{n}-{os.getpid()}-{World._count}")
        self.n = n
        self.pending = None
        self.conns, self.procs = [], []
        for r in range(n):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_serve, args=(r, n, store, child, cases),
                            daemon=True)
            p.start()
            self.conns.append(parent)
            self.procs.append(p)

    def run(self, name, kwargs=None, timeout=CASE_TIMEOUT):
        """Run case `name` on every rank (`kwargs`: one dict for all, or a
        list with one a rank); returns the results in rank order."""
        self.submit(name, kwargs)
        return self.collect(name, timeout)

    def submit(self, name, kwargs=None):
        """Start case `name` on every rank (as ``run``) and return at once:
        the test computes its reference meanwhile, then calls
        ``collect``. A case that a failed test left uncollected is
        collected first, so no answer reaches the wrong case."""
        if self.pending is not None:
            self.collect(self.pending)
        per = kwargs if isinstance(kwargs, list) else [kwargs or {}] * self.n
        for c, kw in zip(self.conns, per):
            c.send((name, kw))
        self.pending = name

    def collect(self, name, timeout=CASE_TIMEOUT):
        """The results of the case ``submit`` started, in rank order."""
        self.pending = None
        out = []
        for r, c in enumerate(self.conns):
            if not c.poll(timeout):
                self.close()
                raise TimeoutError(f"rank {r} did not answer case {name!r} "
                                   f"within {timeout} s")
            status, val = c.recv()
            if status != "ok":
                self.close()
                raise RuntimeError(f"rank {r} failed case {name!r}:\n{val}")
            out.append(val)
        return out

    @property
    def alive(self) -> bool:
        return all(p.is_alive() for p in self.procs)

    def close(self):
        for c in self.conns:
            try:
                c.send(None)
            except (BrokenPipeError, OSError):
                pass
        for p in self.procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(5)
