"""Twins of tests/test_ir_and_inference.py and tests/test_ir_pass_neutrality.py
on the port, on the CPU: each pass's op set and numerics, the predictor's
round trip (feed, zero-copy handles, clone) and bf16 precision, BN folding,
and the bitwise neutrality of the default inference pipeline on the four
seed models' forward programs.

Held to the JAX package: every program is built in both packages under the
same unique names, and the port's program after a pass has the JAX
package's op sequence after that pass. Numerics against the JAX package
start both from the JAX package's initialized scope (rtol = atol = 1e-5,
f32; 2e-5 where BN is folded); the neutrality checks are bitwise within
the port, as the JAX tests are within the JAX package."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as jnames
from paddle_tpu_torch.core import unique_name as tnames

from _torch_twin import (_port_ints, cpu_config, fresh_observability,
                         fresh_port_state)

# One intra-op thread: tier-1 runs several xdist workers, and a second
# torch worker thread, started beside JAX's runtime in the same process, was
# seen to compute some batches of a CPU matmul ~1e-4 off.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield from fresh_port_state()


@pytest.fixture(autouse=True)
def _fresh_observability():
    yield from fresh_observability()


def _both(build):
    """`build(fluid)` in each package under a fresh unique-name guard:
    ((jax main, startup, out), (port main, startup, out))."""
    with jnames.guard():
        j = build(jfluid)
    with tnames.guard():
        t = build(tfluid)
    return j, t


def _types(program):
    return [op.type for op in program.global_block().ops]


def _mlp(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[16], dtype="float32")
        h = fluid.layers.fc(x, 32, act="relu")
        out = fluid.layers.fc(h, 4, act=None)
    return main, startup, out


def _run_from_jax(jprog, jstartup, tprog, tstartup, feed, jfetch, tfetch):
    """Run the JAX program from its startup and the port's from the JAX
    package's initialized scope; both fetches as numpy."""
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstartup)
        init = {v.name: np.array(jscope.find_var(v.name))
                for v in jprog.list_vars()
                if v.persistable and jscope.find_var(v.name) is not None}
        want = np.asarray(jexe.run(jprog, feed=feed, fetch_list=[jfetch])[0])
    tscope = tfluid.Scope()
    with tfluid.scope_guard(tscope):
        texe = tfluid.Executor(tfluid.CPUPlace())
        texe.run(tstartup)
        tfluid.io.load_params_from_numpy(_port_ints(tprog, init),
                                         scope=tscope)
        got = texe.run(tprog, feed=feed, fetch_list=[tfetch])[0]
    return want, got


def _run_port(main, startup, feed, fetch):
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        return exe.run(main, feed=feed, fetch_list=[fetch])[0]


# -- tests/test_ir_and_inference.py ----------------------------------------

def test_pass_registry_lists_standard_passes():
    from paddle_tpu import ir as jir
    from paddle_tpu_torch import ir

    have = ir.registered_passes()
    for name in ["dead_code_elimination_pass", "fc_fuse_pass",
                 "fuse_elewise_add_act_pass", "constant_folding_pass",
                 "memory_optimize_pass", "graph_viz_pass",
                 "delete_dropout_op_pass", "int8_quantize_pass"]:
        assert name in have
    assert set(have) <= set(jir.registered_passes())


def test_graph_topology_and_consumers():
    from paddle_tpu_torch import ir

    (jmain, _, _), (main, _, _) = _both(_mlp)
    g = ir.Graph(main.global_block())
    order = g.topology_sort()
    assert [o.type for o in order] == _types(main) == _types(jmain)
    first_relu_out = [op for op in g.ops if op.type == "relu"][0].output(
        "Out")[0]
    assert g.num_consumers(first_relu_out) == 1


def test_dce_removes_unused_branch():
    from paddle_tpu import ir as jir
    from paddle_tpu_torch import ir

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[8], dtype="float32")
            kept = fluid.layers.fc(x, 4)
            dead = fluid.layers.fc(x, 9)
        return main, kept, dead

    (jmain, jkept, _), (main, kept, dead) = _both(build)
    n_before = len(main.global_block().ops)
    ir.apply_pass(main, "dead_code_elimination_pass", keep=[kept.name])
    jir.apply_pass(jmain, "dead_code_elimination_pass", keep=[jkept.name])
    assert len(main.global_block().ops) < n_before
    names = {n for op in main.global_block().ops for n in op.output_names()}
    assert kept.name in names
    assert dead.name not in names
    assert _types(main) == _types(jmain)


def test_fc_fuse_pass_numerics():
    from paddle_tpu import ir as jir
    from paddle_tpu_torch import ir

    (jmain, jstartup, jout), (main, startup, out) = _both(_mlp)
    x = np.random.RandomState(0).randn(4, 16).astype(np.float32)
    ref = _run_port(main.clone(), startup.clone(), {"x": x}, out.name)

    ir.apply_pass(main, "fc_fuse_pass")
    jir.apply_pass(jmain, "fc_fuse_pass")
    types = _types(main)
    assert types == _types(jmain)
    assert "fused_fc" in types and "mul" not in types and "relu" not in types
    fused = [op for op in main.global_block().ops if op.type == "fused_fc"]
    assert any(op.attr("activation_type") == "relu" for op in fused)
    got = _run_port(main, startup, {"x": x}, out.name)
    np.testing.assert_allclose(ref, got, **TOL)
    want, got = _run_from_jax(jmain, jstartup, main, startup, {"x": x},
                              jout.name, out.name)
    np.testing.assert_allclose(got, want, **TOL)


def test_fuse_passes_keep_fetched_intermediates():
    from paddle_tpu_torch import ir

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[8], dtype="float32")
        y = tfluid.layers.data("y", shape=[8], dtype="float32")
        s = tfluid.layers.elementwise_add(x, y)
        out = tfluid.layers.relu(s)
    ir.apply_pass(main, "fuse_elewise_add_act_pass",
                  keep=[s.name, out.name])
    names = {n for op in main.global_block().ops for n in op.output_names()}
    assert s.name in names and out.name in names
    rng = np.random.RandomState(2)
    xv = rng.randn(2, 8).astype(np.float32)
    yv = rng.randn(2, 8).astype(np.float32)
    got = _run_port(main, startup, {"x": xv, "y": yv}, s.name)
    np.testing.assert_allclose(got, xv + yv, rtol=1e-6)


def test_fc_fuse_rejects_nonvector_bias():
    """elementwise_add with a per-row (axis=0) bias does not fc-fuse. The
    mul and the add are appended as ops (layers.create_parameter and
    layers.mul are ROADMAP A12)."""
    from paddle_tpu_torch import ir
    from paddle_tpu_torch.layer_helper import LayerHelper
    from paddle_tpu_torch.param_attr import ParamAttr

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        blk = main.global_block()
        x = tfluid.layers.data("x", shape=[-1, 6], dtype="float32",
                               append_batch_size=False)
        w = LayerHelper("create_parameter").create_parameter(
            ParamAttr(name="w_nb"), [6, 3], "float32")
        b = tfluid.layers.data("b", shape=[-1], dtype="float32",
                               append_batch_size=False)
        m = blk.create_var(name="m_nb", dtype="float32")
        out = blk.create_var(name="out_nb", dtype="float32")
        blk.append_op("mul", {"X": [x.name], "Y": [w.name]},
                      {"Out": [m.name]},
                      {"x_num_col_dims": 1, "y_num_col_dims": 1})
        blk.append_op("elementwise_add", {"X": [m.name], "Y": [b.name]},
                      {"Out": [out.name]}, {"axis": 0})
    ir.apply_pass(main, "fc_fuse_pass", fetch_names=[out.name])
    assert "fused_fc" not in _types(main)


def test_fuse_elewise_add_act_numerics():
    from paddle_tpu import ir as jir
    from paddle_tpu_torch import ir

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[8], dtype="float32")
            y = fluid.layers.data("y", shape=[8], dtype="float32")
            s = fluid.layers.elementwise_add(x, y)
            out = fluid.layers.relu(s)
        return main, startup, out

    (jmain, jstartup, jout), (main, startup, out) = _both(build)
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(3, 8).astype(np.float32),
            "y": rng.randn(3, 8).astype(np.float32)}
    ref = _run_port(main.clone(), startup.clone(), feed, out.name)
    ir.apply_pass(main, "fuse_elewise_add_act_pass")
    jir.apply_pass(jmain, "fuse_elewise_add_act_pass")
    types = _types(main)
    assert types == _types(jmain)
    assert "fused_elemwise_activation" in types and "relu" not in types
    got = _run_port(main, startup, feed, out.name)
    np.testing.assert_allclose(ref, got, rtol=1e-6)
    want, got = _run_from_jax(jmain, jstartup, main, startup, feed,
                              jout.name, out.name)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_constant_folding_pass():
    from paddle_tpu import ir as jir
    from paddle_tpu_torch import ir

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[4], dtype="float32")
            c1 = fluid.layers.fill_constant([4], "float32", 2.0)
            c2 = fluid.layers.fill_constant([4], "float32", 3.0)
            csum = fluid.layers.elementwise_add(c1, c2)
            out = fluid.layers.elementwise_add(x, csum)
        return main, startup, out

    (jmain, _, jout), (main, startup, out) = _both(build)
    ir.apply_pass(main, "constant_folding_pass")
    ir.apply_pass(main, "dead_code_elimination_pass", keep=[out.name])
    jir.apply_pass(jmain, "constant_folding_pass")
    jir.apply_pass(jmain, "dead_code_elimination_pass", keep=[jout.name])
    types = _types(main)
    assert types == _types(jmain)
    assert "assign_value" in types
    assert types.count("elementwise_add") == 1
    got = _run_port(main, startup, {"x": np.ones((2, 4), np.float32)},
                    out.name)
    np.testing.assert_allclose(got, np.full((2, 4), 6.0), rtol=1e-6)


def test_delete_dropout_and_memory_plan():
    from paddle_tpu import ir as jir
    from paddle_tpu_torch import ir

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[8], dtype="float32")
            h = fluid.layers.fc(x, 8, act="relu")
            d = fluid.layers.dropout(h, dropout_prob=0.5)
            out = fluid.layers.fc(d, 2)
        return main, startup, out

    (jmain, _, jout), (main, _, out) = _both(build)
    ir.apply_pass(main, "delete_dropout_op_pass")
    jir.apply_pass(jmain, "delete_dropout_op_pass")
    assert "dropout" not in _types(main)
    assert _types(main) == _types(jmain)
    ir.apply_pass(main, "memory_optimize_pass", fetch_names=[out.name])
    jir.apply_pass(jmain, "memory_optimize_pass", fetch_names=[jout.name])
    plan = main._memory_plan
    assert plan["n_temporaries"] > 0
    assert plan["n_temporaries"] == jmain._memory_plan["n_temporaries"]
    assert "x" in main._donatable_feeds


def test_graph_viz_pass(tmp_path):
    from paddle_tpu_torch import ir

    with tnames.guard():
        main, _, _ = _mlp(tfluid)
    path = str(tmp_path / "g.dot")
    ir.apply_pass(main, "graph_viz_pass", path=path)
    dot = open(path).read()
    assert "digraph" in dot and "mul" in dot


def _save_with_jax(tmp_path, name, build, feed, train_steps=0):
    """Build with the JAX package, optionally train it, save it as an
    inference model; (model dir, the JAX executor's test-mode output)."""
    with jnames.guard():
        main, startup, out, train_feed = build(jfluid)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        for i in range(train_steps):
            exe.run(main, feed=train_feed(i), fetch_list=[out.name])
        ref = np.asarray(exe.run(main.clone(for_test=True), feed=feed,
                                 fetch_list=[out.name])[0])
        d = str(tmp_path / name)
        jfluid.io.save_inference_model(d, list(feed), [out], exe, main)
    return d, out.name, ref


def test_predictor_round_trip(tmp_path):
    from paddle_tpu_torch import inference

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[16], dtype="float32")
            h = fluid.layers.fc(x, 32, act="relu")
            h = fluid.layers.dropout(h, dropout_prob=0.3)
            out = fluid.layers.fc(h, 4, act="softmax")
        return main, startup, out, None

    xv = np.random.RandomState(3).randn(5, 16).astype(np.float32)
    d, out_name, ref = _save_with_jax(tmp_path, "model", build, {"x": xv})

    pred = inference.create_predictor(cpu_config(d))
    assert pred.get_input_names() == ["x"]
    assert pred.get_output_names() == [out_name]
    got = pred.run({"x": xv})[0]
    np.testing.assert_allclose(ref, got, **TOL)

    # zero-copy handle style
    h_in = pred.get_input_handle("x")
    h_in.copy_from_cpu(xv)
    assert h_in.shape() == [5, 16]
    pred.run()
    h_out = pred.get_output_handle(out_name)
    np.testing.assert_allclose(ref, h_out.copy_to_cpu(), **TOL)
    assert h_out.shape() == [5, 4]
    # old spellings, and reshape of a filled input
    h_in2 = pred.get_input_tensor("x")
    h_in2.copy_from_cpu(xv.reshape(-1))
    h_in2.reshape([5, 16])
    np.testing.assert_allclose(pred.run()[0], got, rtol=0, atol=0)
    np.testing.assert_allclose(
        pred.get_output_tensor(out_name).copy_to_cpu(), got, rtol=0, atol=0)

    clone = pred.clone()
    np.testing.assert_allclose(ref, clone.run({"x": xv})[0], **TOL)
    assert clone._state is pred._state or all(
        clone._state[k] is pred._state[k] for k in pred._state)

    # the old API names
    assert inference.AnalysisConfig is inference.Config
    old = inference.create_paddle_predictor(cpu_config(d))
    np.testing.assert_allclose(old.run({"x": xv})[0], got, rtol=0, atol=0)


def test_predictor_bf16_precision(tmp_path):
    from paddle_tpu_torch import inference

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[8], dtype="float32")
            out = fluid.layers.fc(x, 4)
        return main, startup, out, None

    xv = np.random.RandomState(0).randn(2, 8).astype(np.float32)
    d, _, ref = _save_with_jax(tmp_path, "m", build, {"x": xv})
    cfg = cpu_config(d)
    cfg.enable_tpu(precision=inference.PrecisionType.Bfloat16)
    pred = inference.create_predictor(cfg)
    assert all(v.dtype == torch.bfloat16 for v in pred._state.values())
    f32 = inference.create_predictor(cpu_config(d)).run({"x": xv})[0]
    np.testing.assert_allclose(f32, ref, **TOL)
    bf16 = pred.run({"x": xv})[0]
    np.testing.assert_allclose(f32, np.asarray(bf16, np.float32),
                               rtol=0.05, atol=0.05)


def test_conv_bn_fuse_pass_numerics(tmp_path):
    """BN folded into the conv weights by the port's pipeline: the port's
    predictor matches the JAX package's test-mode executor run of the
    trained model (rtol = atol = 2e-5) and has no batch_norm op."""
    from paddle_tpu_torch import inference

    rng = np.random.RandomState(7)
    train = [rng.rand(4, 3, 8, 8).astype("float32") for _ in range(3)]

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[3, 8, 8], dtype="float32")
            h = fluid.layers.conv2d(x, 8, 3, padding=1, bias_attr=False)
            h = fluid.layers.batch_norm(h, act="relu")
            h = fluid.layers.conv2d(h, 4, 3, padding=1, bias_attr=False)
            h = fluid.layers.batch_norm(h)
            out = fluid.layers.reduce_mean(h, dim=[2, 3])
        return main, startup, out, lambda i: {"x": train[i]}

    xv = rng.rand(5, 3, 8, 8).astype("float32")
    d, _, ref = _save_with_jax(tmp_path, "convbn", build, {"x": xv},
                               train_steps=3)
    pred = inference.create_predictor(cpu_config(d))
    got = pred.run({"x": xv})[0]
    np.testing.assert_allclose(ref, got, rtol=2e-5, atol=2e-5)
    types = _types(pred._program)
    assert "batch_norm" not in types, types
    assert types.count("conv2d") == 2


# -- tests/test_ir_pass_neutrality.py --------------------------------------

def _assert_pipeline_bitwise(build, feed, prune_feeds=None):
    """The default inference pipeline over the port's forward program is
    bitwise neutral (same weights, same feed), and leaves the JAX
    package's op sequence. Returns the port's pass report."""
    from paddle_tpu import inference as jinf
    from paddle_tpu.ir import PassPipeline as JPipeline
    from paddle_tpu_torch.inference import Config
    from paddle_tpu_torch.ir import PassPipeline

    def forward(fluid, main, fetch_name):
        if prune_feeds is not None:
            return main._prune_for_inference(prune_feeds, [fetch_name])
        return main.clone(for_test=True)

    (jmain, _, jfetch), (main, startup, fetch) = _both(build)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        fwd = forward(tfluid, main, fetch)
        (ref,) = exe.run(fwd, feed=feed, fetch_list=[fetch])
        opt = fwd.clone(for_test=True)
        PassPipeline(Config().pass_builder(), record=False).run(
            opt, keep=[fetch], fetch_names=[fetch])
        (got,) = exe.run(opt, feed=feed, fetch_list=[fetch])
    np.testing.assert_array_equal(ref, got)
    jopt = forward(jfluid, jmain, jfetch).clone(for_test=True)
    JPipeline(jinf.Config().pass_builder(), record=False).run(
        jopt, keep=[jfetch], fetch_names=[jfetch])
    assert _types(opt) == _types(jopt)
    report = opt._pass_report
    assert [r["pass"] for r in report["passes"]], "pipeline ran no passes"
    for rec in report["passes"]:
        assert rec["neutrality"] in ("bitwise", "precision", "annotation")
    return report


def test_bert_forward_pipeline_bitwise():
    def build(fluid):
        from importlib import import_module
        bert = import_module(f"{fluid.__name__}.models.bert")
        cfg = bert.BertConfig(vocab_size=64, hidden_size=16, num_layers=1,
                              num_heads=2, ffn_size=32, max_position=16,
                              hidden_dropout=0.1, attn_dropout=0.1)
        main, startup, feeds, loss = bert.build_pretrain_program(
            cfg, 2, 8, optimizer_factory=None, is_test=True)
        return main, startup, loss.name

    rng = np.random.RandomState(0)
    feed = {
        "src_ids": rng.randint(0, 64, (2, 8)).astype("int64"),
        "pos_ids": np.tile(np.arange(8), (2, 1)).astype("int64"),
        "sent_ids": np.zeros((2, 8), "int64"),
        "input_mask": np.ones((2, 8), "float32"),
        "mlm_labels": rng.randint(0, 64, (2, 8, 1)).astype("int64"),
    }
    report = _assert_pipeline_bitwise(build, feed)
    assert "delete_dropout_op_pass" in {r["pass"] for r in report["passes"]}


def test_resnet_forward_pipeline_bitwise():
    def build(fluid):
        from importlib import import_module
        resnet = import_module(f"{fluid.__name__}.models.resnet")
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            img = fluid.layers.data("img", [3, 32, 32])
            out = resnet.resnet(img, depth=50, num_classes=10, is_test=True)
        return main, startup, out.name

    feed = {"img": np.random.RandomState(1)
            .randn(2, 3, 32, 32).astype("float32") * 0.1}
    _assert_pipeline_bitwise(build, feed)


def test_deepfm_forward_pipeline_bitwise():
    def build(fluid):
        from importlib import import_module
        deepfm = import_module(f"{fluid.__name__}.models.deepfm")
        main, startup, feeds, loss, prob = deepfm.build_train_program(
            vocab_size=64, num_fields=4, num_dense=4, embed_dim=8,
            hidden_sizes=(16, 8))
        return main, startup, prob.name

    rng = np.random.RandomState(2)
    feed = {"sparse_ids": rng.randint(0, 64, (4, 4)).astype("int64"),
            "dense": rng.randn(4, 4).astype("float32")}
    _assert_pipeline_bitwise(build, feed,
                             prune_feeds=["sparse_ids", "dense"])


def test_nmt_forward_pipeline_bitwise():
    def build(fluid):
        from importlib import import_module
        nmt = import_module(f"{fluid.__name__}.models.transformer_nmt")
        cfg = nmt.TransformerConfig(src_vocab=32, tgt_vocab=32, d_model=16,
                                    n_heads=2, d_ff=32, n_enc=1, n_dec=1,
                                    dropout=0.1, max_len=16)
        main, startup, feeds, loss = nmt.build_train_program(
            cfg, src_len=8, tgt_len=8, is_test=True)
        return main, startup, loss.name

    rng = np.random.RandomState(3)
    causal = np.triu(np.full((8, 8), -1e4, np.float32), 1)[None, None]
    feed = {
        "src_ids": rng.randint(1, 32, (2, 8)).astype("int64"),
        "tgt_ids": rng.randint(1, 32, (2, 8)).astype("int64"),
        "lbl_ids": rng.randint(1, 32, (2, 8, 1)).astype("int64"),
        "src_mask": np.zeros((2, 1, 1, 8), "float32"),
        "tgt_mask": np.broadcast_to(causal, (2, 1, 8, 8)).copy(),
    }
    _assert_pipeline_bitwise(
        build, feed,
        prune_feeds=["src_ids", "tgt_ids", "lbl_ids", "src_mask",
                     "tgt_mask"])


def test_each_bitwise_pass_individually_neutral():
    from paddle_tpu import ir as jir
    from paddle_tpu_torch import ir

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            ids = fluid.layers.data("ids", [3], dtype="int64")
            x = fluid.layers.data("x", [8])
            emb = fluid.layers.embedding(ids, size=[32, 8])
            e = fluid.layers.reshape(emb, [-1, 24])
            h = fluid.layers.concat([e, x], axis=1)
            h = fluid.layers.fc(h, 16, act="relu")
            h = fluid.layers.dropout(h, dropout_prob=0.3)
            fluid.layers.fc(h, 5)  # never fetched
            out = fluid.layers.fc(h, 4, act="softmax")
        return main, startup, out

    rng = np.random.RandomState(4)
    feed = {"ids": rng.randint(0, 32, (2, 3)).astype("int64"),
            "x": rng.randn(2, 8).astype("float32")}
    bitwise = [n for n in ir.registered_passes()
               if getattr(ir.get_pass(n), "neutrality", "bitwise")
               == "bitwise"]
    assert {"fc_fuse_pass", "constant_folding_pass",
            "dead_code_elimination_pass", "dead_var_elimination_pass",
            "fuse_elewise_add_act_pass",
            "delete_dropout_op_pass"} <= set(bitwise)
    for name in bitwise:
        assert getattr(jir.get_pass(name), "neutrality", "bitwise") \
            == "bitwise", name

    (jmain, _, jout), (main, startup, out) = _both(build)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        fwd = main.clone(for_test=True)
        jfwd = jmain.clone(for_test=True)
        (ref,) = exe.run(fwd, feed=feed, fetch_list=[out.name])
        for name in bitwise:
            opt = fwd.clone(for_test=True)
            ir.apply_pass(opt, name, keep=[out.name], fetch_names=[out.name])
            jopt = jfwd.clone(for_test=True)
            jir.apply_pass(jopt, name, keep=[jout.name],
                           fetch_names=[jout.name])
            assert _types(opt) == _types(jopt), name
            (got,) = exe.run(opt, feed=feed, fetch_list=[out.name])
            np.testing.assert_array_equal(
                ref, got, err_msg=f"{name} broke bitwise neutrality")


def test_dead_var_elimination_prunes_unreferenced_vars():
    from paddle_tpu_torch import ir

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [8])
        kept = tfluid.layers.fc(x, 4)
        tfluid.layers.fc(x, 9)
    blk = main.global_block()
    ir.apply_pass(main, "dead_code_elimination_pass", keep=[kept.name])
    n_vars = len(blk.vars)
    ir.apply_pass(main, "dead_var_elimination_pass", keep=[kept.name])
    assert len(blk.vars) < n_vars
    assert "x" in blk.vars and kept.name in blk.vars
    live = {n for op in blk.ops for n in op.input_names()} | \
           {n for op in blk.ops for n in op.output_names()}
    assert live <= set(blk.vars)


def test_layout_assignment_annotates_tpu_tiling():
    """layout_assignment_pass is pure annotation: the same plan as the JAX
    package's."""
    from paddle_tpu import ir as jir
    from paddle_tpu_torch import ir

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [17])
            out = fluid.layers.fc(x, 3)
        return main, startup, out

    (jmain, _, jout), (main, _, out) = _both(build)
    ops_before = _types(main)
    ir.apply_pass(main, "layout_assignment_pass", keep=[out.name])
    jir.apply_pass(jmain, "layout_assignment_pass", keep=[jout.name])
    assert _types(main) == ops_before
    plan = main._layout_plan
    assert plan["padded_bytes"] >= plan["natural_bytes"] > 0
    assert 0.0 < plan["waste_fraction"] < 1.0
    assert plan["matmul_ops"], "fc matmul should be recorded"
    rec = plan["matmul_ops"][0]
    assert rec["k"] == 17 and not rec["k_aligned"]
    assert rec["n"] == 3 and not rec["n_aligned"]
    assert plan == jmain._layout_plan
