"""The whole serving slice: one tiny BERT saved by the JAX package, served
by the JAX Predictor and by the port's Predictor on the CPU.

Model: 2 layers, hidden 128, 2 heads (d = 64), ffn 256, vocab 512, T = 128,
B = 2. Outputs agree at rtol = atol = 1e-4: layer_norm and the matmuls sum
in other orders in the two packages, over two layers."""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import inference as jinf
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.core.dtypes import to_numpy
from paddle_tpu_torch.models import bert as tbert

# One intra-op thread: tier-1 runs several xdist workers, and a second
# torch worker thread, started beside JAX's runtime in the same process, was
# seen to compute some batches of a CPU matmul ~1e-4 off.
torch.set_num_threads(1)

T, B = 128, 2
TOL = dict(rtol=1e-4, atol=1e-4)
# int8: the same tolerance as f32. The int8 fcs quantize activations that
# layer_norm and the matmuls formed in either package's own order, so an
# activation within an ulp of a rounding boundary may round to the next
# int8 step in one package only.
INT8_TOL = TOL
FEEDS = ["src_ids", "pos_ids", "sent_ids", "input_mask"]


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """Fresh default programs, scope and unique names of the port."""
    from paddle_tpu_torch.core import program as prog_mod
    from paddle_tpu_torch.core import scope as scope_mod
    from paddle_tpu_torch.core import unique_name

    old = (prog_mod._main_program, prog_mod._startup_program,
           scope_mod._global_scope, scope_mod._current_scope)
    prog_mod._main_program = prog_mod.Program()
    prog_mod._startup_program = prog_mod.Program()
    scope_mod._global_scope = scope_mod._current_scope = scope_mod.Scope()
    with unique_name.guard():
        yield
    (prog_mod._main_program, prog_mod._startup_program,
     scope_mod._global_scope, scope_mod._current_scope) = old


def _build(fluid, bert):
    cfg = bert.BertConfig(vocab_size=512, hidden_size=128, num_layers=2,
                          num_heads=2, ffn_size=256, max_position=T)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        feeds = [fluid.layers.data(n, [T], dtype=dt) for n, dt in zip(
            FEEDS, ("int64", "int64", "int64", "float32"))]
        out = bert.bert_encoder(cfg, *feeds, is_test=True)
    return main, startup, out


def _feed(n=B, seed=0):
    rng = np.random.RandomState(seed)
    mask = np.ones((n, T), "float32")
    mask[0, 100:] = 0.0
    return {"src_ids": rng.randint(0, 512, (n, T)).astype("int64"),
            "pos_ids": np.tile(np.arange(T, dtype="int64"), (n, 1)),
            "sent_ids": (rng.rand(n, T) > 0.5).astype("int64"),
            "input_mask": mask}


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """The tiny BERT built, initialized and saved by the JAX package:
    (model dir, {param name: numpy array}, the JAX Executor's output of the
    unoptimized program)."""
    from paddle_tpu.core import unique_name as jnames

    d = str(tmp_path_factory.mktemp("bert_jax"))
    with jnames.guard():
        main, startup, out = _build(jfluid, jbert)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        jfluid.io.save_inference_model(d, FEEDS, [out], exe,
                                       main_program=main)
        (ref,) = exe.run(main, feed=_feed(), fetch_list=[out])
        params = {p.name: np.asarray(scope.find_var(p.name))
                  for p in main.all_parameters()}
    return d, params, ref


def _port_predictor(d, precision=None):
    cfg = tinf.Config(d)
    cfg.disable_gpu()
    return tinf.create_predictor(cfg, precision=precision)


def test_port_predictor_serves_the_jax_saved_model(jax_model, monkeypatch):
    d, _, _ = jax_model
    feed = _feed()
    (want,) = jinf.create_predictor(jinf.Config(d)).run(feed)
    (got,) = _port_predictor(d).run(feed)
    assert got.shape == (B, T, 128) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    # the interpret-mode Pallas kernels serving the JAX side agree too
    fa = importlib.import_module(
        "paddle_tpu.ops.pallas_kernels.flash_attention")
    monkeypatch.setattr(fa, "FORCE_PALLAS_INTERPRET", True)
    (want_pallas,) = jinf.create_predictor(jinf.Config(d)).run(feed)
    np.testing.assert_allclose(got, want_pallas, **TOL)


def test_same_optimized_program_and_pass_report(jax_model):
    d, _, _ = jax_model
    jp = jinf.create_predictor(jinf.Config(d))
    tp = _port_predictor(d)
    ops = lambda p: [op.type for op in p._program.global_block().ops]
    assert ops(tp) == ops(jp)
    assert set(ops(tp)) == {
        "lookup_table", "elementwise_add", "layer_norm", "assign",
        "fill_constant", "scale", "unsqueeze", "fused_fc", "split",
        "flash_attention"}
    names = [r["pass"] for r in tp.pass_report["passes"]]
    assert names == [r["pass"] for r in jp.pass_report["passes"]]
    assert names == tinf.Config().pass_builder().all_passes()


def test_port_built_program_from_jax_params(jax_model, tmp_path):
    """A program the port's DSL built, filled with the JAX parameters by
    load_params_from_numpy: its Executor matches the JAX Executor on the
    unoptimized program, and once saved and served, the JAX Predictor."""
    d, params, ref = jax_model
    main, _, out = _build(tfluid, tbert)
    scope = tfluid.Scope()
    tfluid.io.load_params_from_numpy(params, scope=scope)
    exe = tfluid.Executor(tfluid.CPUPlace())
    (got,) = exe.run(main, feed=_feed(), fetch_list=[out], scope=scope)
    np.testing.assert_allclose(got, ref, **TOL)

    with tfluid.scope_guard(scope):
        tfluid.io.save_inference_model(str(tmp_path), FEEDS, [out], exe,
                                       main_program=main)
    feed = _feed(seed=1)
    (want,) = jinf.create_predictor(jinf.Config(d)).run(feed)
    (served,) = _port_predictor(str(tmp_path)).run(feed)
    np.testing.assert_allclose(served, want, **TOL)
    # and the JAX Predictor serves the directory the port saved
    (jax_served,) = jinf.create_predictor(jinf.Config(str(tmp_path))).run(feed)
    np.testing.assert_allclose(jax_served, want, **TOL)


def test_run_padded_and_clone(jax_model):
    d, _, _ = jax_model
    feed = {k: v[:1] for k, v in _feed().items()}
    (want,) = jinf.create_predictor(jinf.Config(d)).run_padded(feed, 2)
    pred = _port_predictor(d)
    (got,) = pred.run_padded(feed, 2)
    assert got.shape == (1, T, 128)
    np.testing.assert_allclose(got, want, **TOL)
    twin = pred.clone()
    assert twin._state is pred._state   # weights shared, not copied
    (again,) = twin.run_padded(feed, 2)
    np.testing.assert_array_equal(again, got)
    with pytest.raises(ValueError, match="exceed the bucket"):
        pred.run_padded(_feed(), 1)


def test_bf16_predictor_close_to_f32(jax_model):
    d, _, _ = jax_model
    feed = _feed()
    (f32,) = _port_predictor(d).run(feed)
    bf16_pred = _port_predictor(d, precision="bfloat16")
    assert all(t.dtype == torch.bfloat16 for t in bf16_pred._state.values())
    (bf16,) = bf16_pred.run(feed)
    assert np.isfinite(bf16).all()
    assert np.linalg.norm(bf16 - f32) / np.linalg.norm(f32) < 5e-2


def _op_descs(pred):
    return [(op.type, op.inputs, op.outputs, op.attrs)
            for op in pred._program.global_block().ops]


def test_int8_is_not_ported_yet(jax_model):
    """int8 serving is ported (the test keeps the name it had while int8
    raised): with the JAX package's activation scales the port rewrites
    the same program (the fused_fc ops and the three embedding tables)
    into bitwise the same int8 state; its outputs
    agree with the JAX int8 Predictor's at INT8_TOL; the port's own
    calibration takes the JAX package's gate decision with a delta within
    1e-4. An unknown precision still raises."""
    from paddle_tpu_torch.ir import PassPipeline

    d, _, _ = jax_model
    samples = [_feed(seed=s) for s in range(2)]
    jcfg = jinf.Config(d)
    jcfg.enable_int8(samples)
    jp = jinf.create_predictor(jcfg)
    assert jp.quant_meta["fc"] and len(jp.quant_meta["tables"]) == 3

    tp = _port_predictor(d)
    tp._program = PassPipeline(
        ["int8_quantize_pass", "dead_var_elimination_pass"]).run(
        tp._program, state=tp._state,
        act_scales=jp.quant_meta["act_scales"],
        keep=tp._fetch_names, fetch_names=tp._fetch_names)
    assert _op_descs(tp) == _op_descs(jp)
    assert sorted(tp._state) == sorted(jp._state)
    for k, v in jp._state.items():
        if k.endswith(("@int8", "@wscale", "@int8_rows")):
            np.testing.assert_array_equal(to_numpy(tp._state[k]),
                                          np.asarray(v), err_msg=k)
    feed = _feed(seed=5)
    (want,) = jp.run(feed)
    (got,) = tp.run(feed)
    np.testing.assert_allclose(got, np.asarray(want), **INT8_TOL)

    cfg = tinf.Config(d)
    cfg.disable_gpu()
    cfg.enable_int8(samples)
    own = tinf.create_predictor(cfg)
    assert abs(own.quant_meta["accuracy_delta"]
               - jp.quant_meta["accuracy_delta"]) <= 1e-4
    with pytest.raises(ValueError, match="unknown precision"):
        _port_predictor(d, precision="fp31")
