"""ResNet serving (``resnet(is_test=True)``) through the port's
``inference.create_predictor``, whose ``conv_bn_fuse_pass`` folds every
inference batch norm into the conv before it, against the JAX package, on
the CPU.

- A reduced ResNet (7x7 stem, two bottlenecks, 32x32, B = 2) saved by the
  JAX package with random BN statistics: the port's Predictor equals the
  JAX Predictor (rtol = atol = 1e-4), optimizes to the same op list, and
  equals the unfused ``is_test`` program on the port's Executor within
  the pass's stated precision neutrality (the folded weights re-round:
  rtol = atol = 1e-4).
- ResNet-50 with the space-to-depth stem, 32x32, B = 2, saved by the port:
  served, it equals the port's unfused Executor and the JAX Executor on
  the JAX package's copy of the program (rtol = atol = 1e-4). The JAX
  Predictor cannot serve it: its cost model takes ``int(None)`` of the
  batch dim that ``pad`` leaves unknown (the port's takes the batch).
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import inference as jinf
from paddle_tpu.core import unique_name as jnames
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.core import unique_name as tnames
from paddle_tpu_torch.models import resnet as tresnet

from _torch_twin import fresh_port_state

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _fresh_port_state(monkeypatch):
    # the unfused graph: conv2d + batch_norm pairs for the pass to fold
    monkeypatch.delenv("PDTPU_CONV_BN_FUSION", raising=False)
    yield from fresh_port_state()


def _reduced(fluid, resnet):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", [3, 32, 32])
        x = resnet.conv_bn(img, 64, 7, stride=2, act="relu", name="stem",
                           is_test=True)
        x = resnet.bottleneck(x, 16, 1, "b0", is_test=True)
        x = resnet.bottleneck(x, 32, 2, "b1", is_test=True)
        x = fluid.layers.pool2d(x, global_pooling=True, pool_type="avg")
        out = fluid.layers.fc(x, 10, param_attr=fluid.ParamAttr(name="fc.w"),
                              bias_attr=fluid.ParamAttr(name="fc.b"))
    return main, startup, out


def _s2d50(fluid, resnet):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", [3, 32, 32])
        out = resnet.resnet(img, 50, 10, is_test=True, stem_s2d=True)
    return main, startup, out


def _bn_stats(names, shape_of, seed=3):
    """Random running statistics (a served model is trained: mean and var
    are not 0 and 1), one array per BN var."""
    rng = np.random.RandomState(seed)
    out = {}
    for n in names:
        if n.endswith(".bn.mean"):
            out[n] = (0.1 * rng.randn(*shape_of(n))).astype("float32")
        elif n.endswith(".bn.var"):
            out[n] = (0.5 + rng.rand(*shape_of(n))).astype("float32")
    return out


def _feed(seed=0):
    return {"img": np.random.RandomState(seed).randn(2, 3, 32, 32).astype(
        "float32")}


def _port_predictor(d):
    cfg = tinf.Config(d)
    cfg.disable_gpu()
    return tinf.create_predictor(cfg)


def test_reduced_resnet_served_by_both_predictors(tmp_path):
    d = str(tmp_path / "jax")
    with jnames.guard():
        jmain, jstart, jout = _reduced(jfluid, jresnet)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jstart)
        persist = [v.name for v in jmain.list_vars() if v.persistable]
        for n, a in _bn_stats(persist, lambda n: np.asarray(
                jscope.find_var(n)).shape).items():
            jscope.set_var(n, a)
        jfluid.io.save_inference_model(d, ["img"], [jout], exe,
                                       main_program=jmain)
        state = {n: np.asarray(jscope.find_var(n)) for n in persist}
    feed = _feed()
    jpred = jinf.create_predictor(jinf.Config(d))
    tpred = _port_predictor(d)
    (want,) = jpred.run(feed)
    (got,) = tpred.run(feed)
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, **TOL)
    ops = [op.type for op in tpred._program.global_block().ops]
    assert ops == [op.type for op in jpred._program.global_block().ops]
    assert "batch_norm" not in ops and ops.count("conv2d") == 8
    assert "conv_bn_fuse_pass" in [r["pass"] for r in
                                   tpred.pass_report["passes"]]
    # the unfused is_test program on the port's Executor
    with tnames.guard():
        tmain, _, tout = _reduced(tfluid, tresnet)
    scope = tfluid.Scope()
    tfluid.io.load_params_from_numpy(state, scope=scope)
    (unfused,) = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=feed, fetch_list=[tout], scope=scope)
    np.testing.assert_allclose(got, unfused, **TOL)


def test_s2d_resnet50_served_with_conv_bn_fuse(tmp_path):
    with jnames.guard():
        jmain, jstart, jout = _s2d50(jfluid, jresnet)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        persist = [v.name for v in jmain.list_vars() if v.persistable]
        for n, a in _bn_stats(persist, lambda n: np.asarray(
                jscope.find_var(n)).shape).items():
            jscope.set_var(n, a)
        state = {n: np.asarray(jscope.find_var(n)) for n in persist}
        feed = _feed(1)
        (want,) = jexe.run(jmain, feed=feed, fetch_list=[jout])
    with tnames.guard():
        tmain, _, tout = _s2d50(tfluid, tresnet)
    scope = tfluid.Scope()
    tfluid.io.load_params_from_numpy(state, scope=scope)
    exe = tfluid.Executor(tfluid.CPUPlace())
    (unfused,) = exe.run(tmain, feed=feed, fetch_list=[tout], scope=scope)
    np.testing.assert_allclose(unfused, want, **TOL)
    d = str(tmp_path / "port")
    with tfluid.scope_guard(scope):
        tfluid.io.save_inference_model(d, ["img"], [tout], exe,
                                       main_program=tmain)
    pred = _port_predictor(d)
    (got,) = pred.run(feed)
    np.testing.assert_allclose(got, unfused, **TOL)
    ops = [op.type for op in pred._program.global_block().ops]
    assert ops[:3] == ["pad", "space_to_depth", "conv2d"]
    assert "batch_norm" not in ops and ops.count("conv2d") == 53
    assert os.path.exists(os.path.join(d, "__model__"))
