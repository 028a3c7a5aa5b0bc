"""The port's fused batch norm and fused 1×1-conv + batch norm against the
JAX package's Pallas kernels, on the CPU: twins of tests/test_fused_bn.py.

The same numpy inputs go through the port's plain path (the kernels' plain
versions, which a CPU tensor takes) and through ``paddle_tpu``'s
``fused_bn`` in interpret mode (``FORCE_PALLAS_INTERPRET``, set and restored
here as the JAX tests do). Tolerances are the JAX tests' own: fused BN y
atol 1e-5, mean atol 1e-5, var atol 1e-4 rtol 1e-5; conv+BN y atol 1e-5,
mean atol 1e-6, var atol 1e-5 rtol 1e-5; every grad atol 2e-4 rtol 1e-4.
The sums are taken in other orders (and without the TPU's lane fold), so
they agree within these, not bit for bit. The `cuda` test needs a card and
skips here; chip_smoke.py holds the kernels to their plain versions on the
card at ResNet-50's shapes."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.executor import ExecContext as JaxCtx
from paddle_tpu.ops.pallas_kernels import fused_bn as jbn
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core import unique_name as tnames
from paddle_tpu_torch.core.executor import ExecContext as TorchCtx
from paddle_tpu_torch.ops.kernels import fused_bn as tbn

# One intra-op thread: a second torch worker thread beside JAX's runtime in
# one xdist worker was seen to compute some CPU matmuls ~1e-4 off.
torch.set_num_threads(1)

GRAD_TOL = dict(atol=2e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _interpret():
    old = jbn.FORCE_PALLAS_INTERPRET
    jbn.FORCE_PALLAS_INTERPRET = True
    yield
    jbn.FORCE_PALLAS_INTERPRET = old


@pytest.fixture()
def _env():
    """Set environment switches for one test, restored after it."""
    saved = {}

    def set_(name, value):
        saved.setdefault(name, os.environ.get(name))
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value

    yield set_
    for name, value in saved.items():
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value


def _t(a, grad=False):
    t = torch.tensor(np.asarray(a))
    return t.requires_grad_() if grad else t


def _close(port, jax_val, err_msg="", **tol):
    np.testing.assert_allclose(np.asarray(port.detach().float()),
                               np.asarray(jax_val, np.float32),
                               err_msg=err_msg, **tol)


def _port_vjp(fn, args, dy):
    """fn(*args) → (y, mean, var); grads of Σ y·dy w.r.t. every arg."""
    ts = [_t(a, grad=True) for a in args]
    y, m, v = fn(*ts)
    gs = torch.autograd.grad((y * _t(dy)).sum(), ts)
    return y, m, v, gs


# -- fused BN (rows 7-9) -----------------------------------------------------

@pytest.mark.parametrize("shape,act", [
    ((4, 16, 8, 32), "relu"),
    ((4, 16, 8, 32), ""),
    ((2, 32, 16, 16), "relu"),
])
def test_fused_bn_forward_and_grads(shape, act):
    rng = np.random.RandomState(0)
    n, c, h, w = shape
    x = rng.randn(*shape).astype("float32") * 1.5 + 0.3
    scale = rng.rand(c).astype("float32") + 0.5
    bias = rng.randn(c).astype("float32") * 0.2
    dy = rng.randn(*shape).astype("float32")

    def loss_j(x, s, b):
        y, m, v = jbn.fused_bn_act(x, s, b, 1e-5, act, False)
        return jnp.sum(y * dy), (y, m, v)

    (_, (yj, mj, vj)), gj = jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    yt, mt, vt, gt = _port_vjp(
        lambda x, s, b: tbn.fused_bn_act(x, s, b, 1e-5, act, False),
        (x, scale, bias), dy)

    assert not mt.requires_grad and not vt.requires_grad
    _close(yt, yj, atol=1e-5)
    _close(mt, mj, atol=1e-5)
    _close(vt, vj, atol=1e-4, rtol=1e-5)
    for a, b, nm in zip(gt, gj, ("dx", "dscale", "dbias")):
        _close(a, b, err_msg=nm, **GRAD_TOL)


def test_fused_bn_residual_grad():
    rng = np.random.RandomState(1)
    shape = (2, 16, 8, 16)
    x = rng.randn(*shape).astype("float32")
    res = rng.randn(*shape).astype("float32")
    scale = rng.rand(16).astype("float32") + 0.5
    bias = np.zeros((16,), "float32")
    dy = rng.randn(*shape).astype("float32")

    def loss_j(x, s, b, r):
        y, _, _ = jbn.fused_bn_act(x, s, b, 1e-5, "relu", True, r)
        return jnp.sum(y * dy)

    gj = jax.grad(loss_j, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, scale, bias, res)))
    *_, gt = _port_vjp(
        lambda x, s, b, r: tbn.fused_bn_act(x, s, b, 1e-5, "relu", True, r),
        (x, scale, bias, res), dy)
    for a, b, nm in zip(gt, gj, ("dx", "dscale", "dbias", "dres")):
        _close(a, b, err_msg=nm, **GRAD_TOL)


def test_batch_norm_layer_act_folding():
    """batch_norm(act='relu') folds the relu into the op (no separate relu
    op in the program) and produces relu'd output, as in the JAX package."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tnames.guard(), tfluid.program_guard(main, startup):
        xv = tfluid.layers.data("x", [8, 6, 6])
        out = tfluid.layers.batch_norm(xv, act="relu")
        tfluid.layers.mean(out)
    assert not any(op.type == "relu" for op in main.global_block().ops)
    bn_ops = [op for op in main.global_block().ops if op.type == "batch_norm"]
    assert bn_ops and bn_ops[0].attrs.get("act") == "relu"

    exe = tfluid.Executor(tfluid.CPUPlace())
    x = np.random.RandomState(0).randn(4, 8, 6, 6).astype("float32")
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        got = exe.run(main, feed={"x": x}, fetch_list=[out])[0]
    assert (got >= 0).all()
    ref = x - x.mean(axis=(0, 2, 3), keepdims=True)
    ref = ref / np.sqrt(x.var(axis=(0, 2, 3), keepdims=True) + 1e-5)
    np.testing.assert_allclose(got, np.maximum(ref, 0), atol=1e-4)


@pytest.mark.parametrize("mode", ["xla1", "xla2", "pallas", "pallas_stats"])
def test_batch_norm_modes_match_jax(mode, _env):
    """The batch_norm op in each PDTPU_BN_MODE against the JAX op: Y, the
    running-stat update, the saved statistics and the grads of Σ Y·dy, with
    the relu folded in. At (8, 64, 16, 16) the fused-BN gate passes (2048
    rows, 1024 after the TPU's lane fold), so the "pallas" modes really run
    the JAX package's interpret-mode kernels."""
    _env("PDTPU_BN_MODE", mode)
    rng = np.random.RandomState(2)
    shape = (8, 64, 16, 16)
    assert jbn.supports(shape, jnp.float32) and tbn.supports(shape, None)
    x = rng.randn(*shape).astype("float32") * 1.5 + 0.3
    scale = rng.rand(64).astype("float32") + 0.5
    bias = rng.randn(64).astype("float32") * 0.2
    mean = rng.randn(64).astype("float32") * 0.1
    var = rng.rand(64).astype("float32") + 0.5
    dy = rng.randn(*shape).astype("float32")
    attrs = {"epsilon": 1e-5, "momentum": 0.9, "act": "relu"}
    slots = ("Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance")

    jfn = jreg.get_op("batch_norm").fn

    def jrun(x, s, b):
        out = jfn(JaxCtx(None), {"X": [x], "Scale": [s], "Bias": [b],
                                 "Mean": [jnp.asarray(mean)],
                                 "Variance": [jnp.asarray(var)]}, attrs)
        return jnp.sum(out["Y"][0] * dy), out

    (_, jout), jg = jax.value_and_grad(jrun, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    ts = [_t(a, grad=True) for a in (x, scale, bias)]
    tout = treg.get_op("batch_norm").fn(
        TorchCtx("cpu"), {"X": [ts[0]], "Scale": [ts[1]], "Bias": [ts[2]],
                          "Mean": [_t(mean)], "Variance": [_t(var)]}, attrs)
    tg = torch.autograd.grad((tout["Y"][0] * _t(dy)).sum(), ts)
    for s in slots:
        _close(tout[s][0], jout[s][0], err_msg=s, atol=1e-5, rtol=1e-5)
    for a, b, nm in zip(tg, jg, ("dx", "dscale", "dbias")):
        _close(a, b, err_msg=nm, **GRAD_TOL)


# -- fused 1x1-conv + BN (rows 9-11) -----------------------------------------

@pytest.mark.parametrize("stride,act,with_res", [
    (1, "relu", True),
    (1, "", False),
    (2, "relu", False),
    (2, "", True),
])
def test_fused_conv_bn_parity(stride, act, with_res):
    """The port's fused conv+BN (plain versions of the kernels) against the
    JAX Pallas kernels in interpret mode: outputs, batch stats and all five
    grads."""
    rng = np.random.RandomState(0)
    n, ci, co, hw = 4, 16, 32, 16
    x = rng.randn(n, ci, hw, hw).astype("float32")
    w = (rng.randn(co, ci, 1, 1) * 0.1).astype("float32")
    scale = rng.rand(co).astype("float32") + 0.5
    bias = rng.randn(co).astype("float32") * 0.2
    hs = -(-hw // stride)
    res = (rng.randn(n, co, hs, hs).astype("float32") if with_res
           else None)
    dy = rng.randn(n, co, hs, hs).astype("float32")

    def loss_j(x, w, s, b, r):
        y, m, v = jbn.fused_conv_bn_act(x, w, s, b, 1e-5, act, stride,
                                        with_res, r)
        return jnp.sum(y * dy), (y, m, v)

    argnums = (0, 1, 2, 3, 4) if with_res else (0, 1, 2, 3)
    (_, (yj, mj, vj)), gj = jax.value_and_grad(
        loss_j, argnums=argnums, has_aux=True)(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
            jnp.asarray(bias), None if res is None else jnp.asarray(res))
    args = (x, w, scale, bias) + ((res,) if with_res else ())
    yt, mt, vt, gt = _port_vjp(
        lambda *a: tbn.fused_conv_bn_act(*a[:4], 1e-5, act, stride, with_res,
                                         *a[4:]), args, dy)

    _close(yt, yj, atol=1e-5)
    _close(mt, mj, atol=1e-6)
    _close(vt, vj, atol=1e-5, rtol=1e-5)
    for a, b, nm in zip(gt, gj, ("dx", "dw", "dscale", "dbias", "dres")):
        _close(a, b, err_msg=nm, **GRAD_TOL)


def test_supports_gates_match_jax():
    """Both gates answer as the JAX package's do, so the same ops take the
    kernels (including ResNet-50's shapes at B=128, 224², where every gate
    passes, and the 8 MiB weight limit taken with <=)."""
    bn_shapes = [(4, 16, 8, 32), (2, 32, 16, 16), (128, 64, 112, 112),
                 (128, 512, 7, 7), (8, 64, 16, 16), (1, 64, 8, 8),
                 (4, 60, 8, 8), (4, 384, 8, 8), (4, 8, 32, 32),
                 (4, 96, 16, 16), (2, 3, 4), (3, 64, 7, 7), (4, 9000, 8, 8)]
    for s in bn_shapes:
        assert tbn.supports(s, None) == jbn.supports(s, jnp.float32), s
    conv_cases = [((8, 64, 16, 16), (128, 64, 1, 1), 1),
                  ((8, 64, 16, 16), (128, 64, 3, 3), 1),
                  ((8, 64, 16, 16), (128, 64, 1, 1), 4),
                  ((8, 60, 16, 16), (128, 60, 1, 1), 1),
                  ((1, 64, 8, 8), (128, 64, 1, 1), 1),
                  ((128, 1024, 14, 14), (2048, 1024, 1, 1), 2),
                  ((128, 2048, 7, 7), (4096, 2048, 1, 1), 1),
                  ((128, 256, 56, 56), (64, 256, 1, 1), 1),
                  ((4, 16, 16, 16), (32, 16, 1, 1), 2),
                  ((2, 64, 31, 31), (64, 64, 1, 1), 2),
                  ((8, 64, 16, 16), (128, 32, 1, 1), 1)]
    for xs, ws, st in conv_cases:
        assert tbn.conv_bn_supports(xs, ws, st) == \
            jbn.conv_bn_supports(xs, ws, st), (xs, ws, st)
    assert tbn.conv_bn_supports((128, 1024, 14, 14), (2048, 1024, 1, 1), 2)
    assert not tbn.conv_bn_supports((128, 2048, 7, 7), (4096, 2048, 1, 1), 1)


def test_fused_conv_bn_op_matches_jax(_env):
    """The registered fused_conv_bn op (AMP weight cast aside, f32) with a
    residual: Y, the momentum blend of the running stats and the saved
    stats, in the kernel lowering and in the composition (`xla`)."""
    rng = np.random.RandomState(4)
    x = np.abs(rng.randn(4, 16, 16, 16)).astype("float32")
    w = (rng.randn(32, 16, 1, 1) * 0.2).astype("float32")
    scale = rng.rand(32).astype("float32") + 0.5
    bias = rng.randn(32).astype("float32") * 0.2
    mean = rng.randn(32).astype("float32") * 0.1
    var = rng.rand(32).astype("float32") + 0.5
    res = rng.randn(4, 32, 16, 16).astype("float32")
    attrs = {"stride": 1, "epsilon": 1e-5, "momentum": 0.9, "act": "relu"}
    for mode in ("pallas", "xla"):
        _env("PDTPU_CONV_BN_FUSION", mode)
        ins = {"Input": x, "Filter": w, "Scale": scale, "Bias": bias,
               "Mean": mean, "Variance": var, "Residual": res}
        jout = jreg.get_op("fused_conv_bn").fn(
            JaxCtx(None), {k: [jnp.asarray(v)] for k, v in ins.items()},
            attrs)
        tout = treg.get_op("fused_conv_bn").fn(
            TorchCtx("cpu"), {k: [_t(v)] for k, v in ins.items()}, attrs)
        for s in ("Y", "MeanOut", "VarianceOut", "SavedMean",
                  "SavedVariance"):
            _close(tout[s][0], jout[s][0], err_msg=f"{mode} {s}", atol=1e-5,
                   rtol=1e-5)


def _bottleneck_prog(fusion_mode, ci, filters, set_env):
    """x -> bottleneck(x) under PDTPU_CONV_BN_FUSION=fusion_mode (None =
    the unfused graph), built with the port's DSL; same param names either
    way."""
    from paddle_tpu_torch.models import resnet

    set_env("PDTPU_CONV_BN_FUSION", fusion_mode)
    main, startup = tfluid.Program(), tfluid.Program()
    with tnames.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [ci, 8, 8])
        y = resnet.bottleneck(x, filters, 1, "blk")
    return main, startup, y


def test_fused_conv_bn_e2e_bitwise_at_model_widths(_env):
    """Twin of the JAX contract that makes per-model enablement safe: a
    ResNet bottleneck at model widths (256->64->256) built with the fused
    op (its plain composition, `xla`) is bitwise identical to the unfused
    graph — both programs share one scope and one startup."""
    fused_main, fused_st, fy = _bottleneck_prog("xla", 256, 64, _env)
    unf_main, _unf_st, uy = _bottleneck_prog(None, 256, 64, _env)
    types_f = [op.type for op in fused_main.global_block().ops]
    types_u = [op.type for op in unf_main.global_block().ops]
    assert "fused_conv_bn" in types_f
    assert "fused_conv_bn" not in types_u
    _env("PDTPU_CONV_BN_FUSION", "xla")

    exe = tfluid.Executor(tfluid.CPUPlace())
    x = np.random.RandomState(3).randn(2, 256, 8, 8).astype("float32")
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(fused_st)                      # ONE init for both arms
        got_f = exe.run(fused_main, feed={"x": x}, fetch_list=[fy])[0]
        got_u = exe.run(unf_main, feed={"x": x}, fetch_list=[uy])[0]
    assert got_f.shape == (2, 256, 8, 8)
    np.testing.assert_array_equal(got_f, got_u)


def test_kernel_paths_reject_other_devices():
    """A wrapper takes the plain version only for a CPU tensor; a tensor on
    any other device (here "meta") raises instead of falling back."""
    x = torch.empty((4, 64, 8, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tbn.bn_stats(x)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tbn.conv_stats(x, torch.empty((32, 64, 1, 1), device="meta"))


# -- on the card -------------------------------------------------------------

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(dtype):
    """Each kernel against its plain version on the card, at a small
    stride-2 conv with a residual: f32 within 2e-5·max|plain|, bf16 within
    1e-2·max|plain|; statistics rtol 1e-5 (1e-4 in bf16)."""
    _cuda_or_skip()
    from paddle_tpu_torch.core.executor import cuda_device

    dev = cuda_device(0)
    dt = getattr(torch, dtype)
    gen = torch.Generator(dev).manual_seed(0)
    x = torch.randn(8, 64, 32, 32, generator=gen, device=dev).abs().to(dt)
    x = x.contiguous(memory_format=torch.channels_last)
    w = (torch.randn(128, 64, 1, 1, generator=gen, device=dev) * 0.1).to(dt)
    tol = 2e-5 if dtype == "float32" else 1e-2
    stol = 1e-5 if dtype == "float32" else 1e-4
    xs = x[:, :, ::2, ::2]
    y2, mean, var = tbn.conv_stats(xs, w)
    py2, pmean, pvar = tbn.conv_stats_plain(xs, w)
    torch.cuda.synchronize()
    assert (y2.float() - py2.float()).abs().max() <= \
        tol * py2.float().abs().max()
    torch.testing.assert_close(mean, pmean, rtol=stol, atol=0)
    torch.testing.assert_close(var, pvar, rtol=stol, atol=0)
