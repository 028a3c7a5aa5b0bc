"""Rank helper of the port's tests of the mesh's remaining layouts
(``tests/test_torch_dp_across_batch.py``, ``tests/test_torch_mesh_axes.py``):
model functions that take the package (``build_*(fluid, ...)``, so a test
builds the same program with the JAX package), registered beside
``torch_pipe_runner``'s models, and the cases the ranks of a
``torch_dist_runner.World(n, tmp, cases="torch_mesh_runner")`` serve
(``torch_pipe_runner``'s ``case_pipe`` and the ones below). Each rank
imports torch and the port only, never jax or paddle_tpu.
"""
from __future__ import annotations

import numpy as np

import torch_dist_runner as R
import torch_pipe_runner as PR
from torch_pipe_runner import CASES as _PIPE_CASES

# -- models (either package) --------------------------------------------------

# ops that work across the batch dim (rule A of the port's mesh step):
# each turns the batch-sharded h [B, 8] into a 2-D value
ACROSS_OPS = ["concat0", "split0", "slice0", "unsqueeze0", "transpose",
              "softmax0", "layer_norm0", "gather0", "matmul_tx", "mul0",
              "reshape0"]
ACROSS_B = 16


def build_across(fluid, op="softmax0"):
    """x → fc (a_w1, a_b1) → `op` across the batch dim → fc (a_w2, a_b2)
    → mean of squares, SGD: parameters on both sides of the op."""
    layers = fluid.layers
    rng = np.random.RandomState(3)
    init = fluid.initializer.NumpyArrayInitializer

    def attr(name, shape):
        w = (rng.rand(*shape).astype("float32") - 0.5) * 0.6
        return fluid.ParamAttr(name=name, initializer=init(w))

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", [16])
        h = layers.fc(x, 8, act="tanh", param_attr=attr("a_w1", (16, 8)),
                      bias_attr=attr("a_b1", (8,)))
        if op == "concat0":
            g = layers.concat([h, layers.scale(h, scale=2.0)], axis=0)
        elif op == "split0":
            a, b = layers.split(h, 2, dim=0)
            g = layers.elementwise_mul(a, b)
        elif op == "slice0":
            g = layers.slice(h, axes=[0], starts=[2], ends=[7])
        elif op == "unsqueeze0":
            g = layers.reduce_mean(layers.unsqueeze(h, [0]), dim=[1])
        elif op == "transpose":   # hᵀh / B
            g = layers.matmul(layers.transpose(h, [1, 0]), h,
                              alpha=1.0 / ACROSS_B)
        elif op == "softmax0":
            g = layers.softmax(h, axis=0)
        elif op == "layer_norm0":
            g = layers.layer_norm(h, begin_norm_axis=0, scale=False,
                                  shift=False)
        elif op == "gather0":
            idx = layers.assign(np.array([3, 0, 9, 14], "int64"))
            g = layers.gather(h, idx)
        elif op == "matmul_tx":   # hᵀh / B: a sum over the rows
            g = layers.matmul(h, h, transpose_x=True, alpha=1.0 / ACROSS_B)
        elif op == "mul0":        # W [4, B] · h: a contraction of dim 0
            wm = fluid.layer_helper.LayerHelper("mul0").create_parameter(
                attr("a_wm", (4, ACROSS_B)), [4, ACROSS_B])
            g = _op(fluid, "mul", {"X": [wm], "Y": [h]}, {"Out": "float32"},
                    {"x_num_col_dims": 1, "y_num_col_dims": 1})["Out"]
        elif op == "reshape0":    # a literal dim 0
            g = layers.reshape(h, [2, ACROSS_B * 4])
        else:
            raise ValueError(op)
        width = ACROSS_B * 4 if op == "reshape0" else 8
        g = layers.reshape(g, [-1, width])   # a static width for the fc
        out = layers.fc(g, 4, param_attr=attr("a_w2", (width, 4)),
                        bias_attr=attr("a_b2", (4,)))
        loss = layers.mean(layers.square(out))
        fluid.optimizer.SGD(0.5).minimize(loss)
    return main, startup, loss.name


def across_feed():
    return {"x": np.random.RandomState(0).rand(ACROSS_B, 16)
            .astype("float32")}


# the LoD ops of tests/test_sequence_ops.py and the beam ops of
# tests/test_lod_beam_pad.py, each on a batch of LOD_B rows with lengths
LOD_OPS = ["pool_sum", "pool_average", "pool_sqrt", "pool_max", "pool_last",
           "pool_first", "softmax", "reverse", "concat", "pad", "unpad",
           "conv", "slice", "erase", "expand_as", "enumerate", "reshape",
           "scatter", "topk_avg", "mask", "expand", "im2sequence", "beam"]
LOD_B, LOD_T, LOD_D = 8, 6, 4


def _op(fluid, type, inputs, outs, attrs=None):
    """Append `type` with `inputs` ({slot: [var]}) and fresh outputs
    `outs` ({slot: dtype}); returns {slot: var}."""
    helper = fluid.layer_helper.LayerHelper(type)
    got = {s: helper.create_variable_for_type_inference(dt)
           for s, dt in outs.items()}
    helper.append_op(type=type,
                     inputs={s: [v.name for v in vs]
                             for s, vs in inputs.items()},
                     outputs={s: [v.name] for s, v in got.items()},
                     attrs=attrs or {})
    return got


def build_lod(fluid, op="pool_sum"):
    """One LoD (or beam) op of LOD_OPS on fed padded values and their
    lengths, forward only. Returns (main, startup, its first output, every
    output)."""
    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", [LOD_T, LOD_D])
        x2 = layers.data("x2", [LOD_T])
        ln = layers.data("len", [], dtype="int64")
        ids = layers.data("ids", [LOD_T], dtype="int64")
        outs = []
        if op.startswith("pool_"):
            outs = [layers.sequence_pool(x, op[5:], length=ln)]
        elif op == "softmax":
            outs = [layers.sequence_softmax(x2, ln)]
        elif op == "reverse":
            outs = [layers.sequence_reverse(x, ln)]
        elif op == "concat":
            outs = [layers.sequence_concat([x, layers.scale(x, scale=2.0)])]
        elif op == "pad":
            pv = layers.assign(np.array(-1.0, "float32"))
            outs = list(layers.sequence_pad(x, pv, ln, maxlen=8))
        elif op == "unpad":
            outs = [layers.sequence_unpad(x, ln)]
        elif op == "conv":
            outs = [layers.sequence_conv(
                x, 3, filter_size=3, length=ln,
                param_attr=fluid.ParamAttr(
                    name="sc_w", initializer=fluid.initializer
                    .NumpyArrayInitializer(np.random.RandomState(4).rand(
                        3 * LOD_D, 3).astype("float32"))))]
        elif op == "slice":
            off = layers.cast(layers.scale(ln, scale=0.0, bias=1.0),
                              "int64")
            outs = [layers.sequence_slice(x, off, layers.cast(layers.scale(
                ln, scale=0.5), "int64"))]
        elif op == "erase":
            outs = list(layers.sequence_erase(ids, [2, 5], length=ln))
        elif op == "expand_as":
            outs = [layers.sequence_expand_as(x2, x, length=ln)]
        elif op == "enumerate":
            outs = [layers.sequence_enumerate(ids, 3, pad_value=0,
                                              length=ln)]
        elif op == "reshape":
            outs = [layers.sequence_reshape(x, 8, length=ln)]
        elif op == "scatter":
            upd = layers.data("upd", [3])
            sid = layers.data("sid", [3], dtype="int64")
            outs = [layers.sequence_scatter(x2, sid, upd,
                                            length=layers.cast(
                                                layers.scale(ln, scale=0.0,
                                                             bias=2.0),
                                                "int64"))]
        elif op == "topk_avg":
            outs = [layers.sequence_topk_avg_pooling(
                layers.transpose(x, [0, 2, 1]), [1, 3], length=ln)]
        elif op == "mask":
            outs = [layers.sequence_mask(ln, LOD_T, dtype="int32")]
        elif op == "expand":
            outs = [_op(fluid, "sequence_expand", {"X": [x2], "Y": [x]},
                        {"Out": "float32"})["Out"]]
        elif op == "im2sequence":
            img = layers.reshape(x, [-1, 1, LOD_T, LOD_D])
            outs = [_op(fluid, "im2sequence", {"X": [img]},
                        {"Out": "float32"},
                        {"kernels": [2, 2], "strides": [1, 1],
                         "paddings": [0, 0, 0, 0]})["Out"]]
        elif op == "beam":
            # two beam steps (row by row), stacked along a time dim 0 and
            # decoded (across the batch: the port runs it whole)
            s0 = layers.data("s0", [2, 5])
            s1 = layers.data("s1", [2, 5])
            pre = layers.data("pre", [2])
            id0, sc0, par0, fin0 = layers.beam_search(None, pre, s0, 2, 0)
            id1, sc1, par1, _ = layers.beam_search(
                id0, sc0, s1, 2, 0, pre_finished=layers.cast(fin0,
                                                             "int32"))
            steps = [layers.unsqueeze(v, [0]) for v in (id0, id1)]
            parents = [layers.unsqueeze(v, [0]) for v in (par0, par1)]
            outs = list(layers.beam_search_decode(
                layers.concat(steps, axis=0), layers.concat(parents, axis=0),
                sc1)) + [id1, sc1]
        else:
            raise ValueError(op)
    return (main, startup, outs[0].name) + tuple(v.name for v in outs)


def lod_feed():
    rng = np.random.RandomState(6)
    b, t, d = LOD_B, LOD_T, LOD_D
    return {"x": rng.randn(b, t, d).astype("float32"),
            "x2": rng.randn(b, t).astype("float32"),
            "len": rng.randint(1, t + 1, (b,)).astype("int64"),
            "ids": rng.randint(0, 7, (b, t)).astype("int64"),
            "upd": rng.randn(b, 3).astype("float32"),
            "sid": rng.randint(0, t, (b, 3)).astype("int64"),
            "s0": np.log(rng.dirichlet(np.ones(5), (b, 2)))
            .astype("float32"),
            "s1": np.log(rng.dirichlet(np.ones(5), (b, 2)))
            .astype("float32"),
            "pre": np.zeros((b, 2), "float32")}


def lod_feed_for(main):
    """The part of lod_feed that `main` reads."""
    names = {n for op in main.global_block().ops for n in op.input_names()}
    return {k: v for k, v in lod_feed().items() if k in names}


def build_moe(fluid, k=2, cf=4.0, experts=4, opt="adam"):
    """tests/test_moe.py's static-graph MoE blocks: the dense one of
    test_moe_layer_static_graph_trains (4 experts, k = 2, cf 4.0, Adam)
    and, with k = 1, 8 experts and SGD, the one of
    test_moe_layer_expert_parallel_matches_dense."""
    return R.build_moe_layer(fluid, k=k, cf=cf, experts=experts, opt=opt)


def build_seq_head(fluid, drop=0.0):
    """Tiny BERT's sequence output through a rule-A op of the head: a
    sequence_unpad → sequence_pool (row by row), the pooled rows weighted
    by their softmax along dim 0 (across the batch), then a fc; Adam.
    Parameters on both sides of the softmax."""
    bert = PR._bert(fluid)
    layers = fluid.layers
    cfg = bert.BertConfig(vocab_size=64, hidden_size=16, num_layers=1,
                          num_heads=2, ffn_size=32, max_position=16,
                          hidden_dropout=drop, attn_dropout=drop)
    T = 8
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        main.random_seed = startup.random_seed = 3
        src = layers.data("src_ids", [T], dtype="int64")
        pos = layers.data("pos_ids", [T], dtype="int64")
        sent = layers.data("sent_ids", [T], dtype="int64")
        mask = layers.data("input_mask", [T], dtype="float32")
        ln = layers.data("len", [], dtype="int64")
        neg = layers.scale(layers.elementwise_add(
            mask, layers.fill_constant([1], "float32", -1.0)), scale=10000.0)
        x = bert.embeddings(cfg, src, pos, sent, is_test=False)
        x = bert.encoder_layer(cfg, x, layers.unsqueeze(neg, [1]), 0,
                               is_test=False)
        pooled = layers.sequence_pool(layers.sequence_unpad(x, ln),
                                      "average", length=ln)
        # the softmax's weights over the batch rows times the rows
        p = layers.elementwise_mul(layers.softmax(pooled, axis=0), pooled)
        out = layers.fc(p, 4)
        loss = layers.mean(layers.square(out))
        fluid.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss.name


def seq_head_feed(B=8, T=8):
    feed = PR.seq_bert_feed(B, T)
    feed.pop("mlm_labels")
    feed["len"] = np.random.RandomState(2).randint(2, T + 1, (B,)).astype(
        "int64")
    return feed


def build_two_axes(fluid):
    """An MLP with a column-parallel weight on "tp" and a weight split
    over both axes ("mp" its rows, "tp" its columns), biases beside them;
    Adam."""
    rng = np.random.RandomState(8)
    init = fluid.initializer.NumpyArrayInitializer

    def attr(name, shape, spec=None):
        w = (rng.rand(*shape).astype("float32") - 0.5) * 0.5
        return fluid.ParamAttr(name=name, initializer=init(w),
                               shard_spec=spec)

    layers = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = layers.data("x", [16])
        y = layers.data("y", [1])
        h = layers.fc(x, 32, act="tanh",
                      param_attr=attr("m_w0", (16, 32), (None, "tp")),
                      bias_attr=attr("m_b0", (32,), ("tp",)))
        h = layers.fc(h, 16, act="tanh",
                      param_attr=attr("m_w1", (32, 16), ("mp", "tp")),
                      bias_attr=attr("m_b1", (16,)))
        out = layers.fc(h, 1, param_attr=attr("m_w2", (16, 1)))
        loss = layers.mean(layers.square(out - y))
        fluid.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss.name


def build_dp_spec(fluid):
    """tests/test_checkpoint.py's MLP with w0 sharded over the data axis by
    its spec ("dp", None); Adam."""
    main, startup = fluid.Program(), fluid.Program()
    init = fluid.initializer.NumpyArrayInitializer
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [16])
        y = fluid.layers.data("y", [1], dtype="int64")
        w0 = np.random.RandomState(5).rand(16, 8).astype("float32") * 0.1
        h = fluid.layers.fc(x, 8, act="relu", bias_attr=False,
                            param_attr=fluid.ParamAttr(
                                name="w0", initializer=init(w0),
                                shard_spec=("dp", None)))
        w1 = np.random.RandomState(6).rand(8, 4).astype("float32") * 0.1
        logits = fluid.layers.fc(h, 4, bias_attr=False,
                                 param_attr=fluid.ParamAttr(
                                     name="w1", initializer=init(w1)))
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.Adam(0.05).minimize(loss)
    return main, startup, loss.name


def mlp_feed():
    rng = np.random.RandomState(0)
    return {"x": rng.rand(32, 16).astype("float32"),
            "y": rng.rand(32, 1).astype("float32")}


PR.MODELS.update({"across": build_across, "lod": build_lod,
                  "moe": build_moe, "seq_head": build_seq_head,
                  "two_axes": build_two_axes, "dp_spec": build_dp_spec})


def jax_run(jfluid, model, feed, axes=None, data_axis=None, seq_axis=None,
            steps=3, state=None, **kw):
    """The JAX package's run of a model on one device (`axes` None) or on
    a mesh of the test process's devices: (losses, the build function's
    other names at the last step, every persistable after the steps)."""
    from paddle_tpu.core import unique_name as jn
    from paddle_tpu.parallel import make_mesh

    with jn.guard():
        main, startup, loss, other = PR.build(jfluid, model, **kw)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.TPUPlace())
        exe.run(startup)
        for n, v in (state or {}).items():
            scope.set_var(n, v)
        prog = main
        if axes is not None:
            prog = jfluid.CompiledProgram(main).with_mesh(
                make_mesh(axes), data_axis=data_axis, seq_axis=seq_axis)
        out = [exe.run(prog, feed=feed, fetch_list=[loss] + list(other))
               for _ in range(steps)]
        final = {v.name: np.asarray(scope.find_var(v.name))
                 for v in main.list_vars()
                 if v.persistable and scope.find_var(v.name) is not None}
    return ([float(np.asarray(o[0]).reshape(-1)[0]) for o in out],
            [np.asarray(v) for v in out[-1]] if out else [], final)


# -- cases (run on every rank) ------------------------------------------------

def case_gather_rows():
    """``collective.gather_rows`` over the world with rank r holding r + 1
    rows of a float value and of an int value: the whole values, the
    counts, and the float value's gradient of sum(whole · w) (w the same
    on every rank)."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.parallel.collective import gather_rows

    r = dist.get_rank()
    x = (torch.arange((r + 1) * 3, dtype=torch.float32).reshape(r + 1, 3)
         + 100.0 * r).requires_grad_()
    ids = torch.full((r + 1,), r, dtype=torch.int64)
    (wx, wi), counts = gather_rows([x, ids], dist.group.WORLD)
    w = torch.arange(wx.numel(), dtype=torch.float32).reshape(wx.shape)
    (wx * w).sum().backward()
    return (wx.detach().numpy(), wi.numpy(), counts, x.grad.numpy(),
            wi.requires_grad)


def case_global_dropout():
    """x → fc → concat along dim 0 (the batch gathered whole) → dropout
    0.5 → mean, one step under with_data_parallel on this rank's rows of a
    fixed batch: the dropout's output (global: the rank computes the
    whole batch's) and the fc weight after the step."""
    import torch.distributed as dist

    fluid, names = PR._port()
    with names.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            main.random_seed = startup.random_seed = 5
            x = fluid.layers.data("x", [8])
            h = fluid.layers.fc(x, 8, param_attr=fluid.ParamAttr(name="g_w"))
            g = fluid.layers.dropout(fluid.layers.concat([h, h], axis=0),
                                     0.5)
            loss = fluid.layers.mean(g)
            fluid.optimizer.SGD(0.1).minimize(loss)
    world, rank = dist.get_world_size(), dist.get_rank()
    feed = {"x": np.random.RandomState(0).rand(4 * world, 8)
            .astype("float32")}
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
        (out,) = exe.run(prog, feed=R.rows(feed, rank, world),
                         fetch_list=[g])
        return np.asarray(out), np.asarray(scope.find_var("g_w"))


CASES = dict(_PIPE_CASES)
CASES["gather_rows"] = case_gather_rows
CASES["global_dropout"] = case_global_dropout
CASES["tp"] = R.case_tp  # the TP_MODELS models on these meshes


def dropout_masks(model, **kw):
    """The Mask outputs of the `dropout` ops of the port's build of a
    model (the names every build under a fresh name guard gives)."""
    fluid, names = PR._port()
    with names.guard():
        main = PR.build(fluid, model, **kw)[0]
    return [op.outputs["Mask"][0] for op in main.global_block().ops
            if op.type == "dropout" and op.outputs.get("Mask")]
