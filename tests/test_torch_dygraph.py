"""The port's dygraph mode held to the JAX package's: the twins of
tests/test_dygraph.py's twelve tests. Each scenario runs in both packages
on the same numpy inputs (the port on ``guard(place=CPUPlace())``); a
layer built in the JAX package gives its ``state_dict()`` to the port's
twin by structural order (the RNG streams differ by design), and every
number the JAX test computes is compared, rtol 1e-5 plus atol 1e-6 unless
a test says otherwise. Every one of the 19 ``dygraph.nn`` layers runs its
forward and one gradient against the JAX layer's.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import dygraph as jdy
from paddle_tpu.dygraph.tracer import trace_op as jtrace
from paddle_tpu.initializer import NumpyArrayInitializer as JNumpyInit
from paddle_tpu_torch import dygraph as tdy
from paddle_tpu_torch.dygraph.tracer import trace_op as ttrace
from paddle_tpu_torch.initializer import NumpyArrayInitializer as TNumpyInit

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


class Pkg:
    def __init__(self, fluid, dy, trace, guard, numpy_init):
        self.fluid, self.dy, self.trace = fluid, dy, trace
        self.guard, self.NumpyInit = guard, numpy_init


J = Pkg(jfluid, jdy, jtrace, lambda seed=0: jdy.guard(seed=seed),
        JNumpyInit)
T = Pkg(tfluid, tdy, ttrace,
        lambda seed=0: tdy.guard(tfluid.CPUPlace(), seed=seed), TNumpyInit)


def twin(scenario, states=None):
    """scenario(P, load) in the JAX package, then in the port. `load(layer)`
    is called right after each layer is built: in the JAX run it records
    the layer's state (into `states`, if given), in the port's run it
    copies the JAX layer's state into the port's by structural order.
    Returns (jax result, port result)."""
    states = [] if states is None else states
    jres = scenario(J, lambda layer: states.append(layer.state_dict()))
    return jres, port_run(scenario, states)


def port_run(scenario, states):
    """scenario(T, load) in the port, loading the JAX layers' `states`."""
    it = iter(states)

    def load(layer):
        sd = next(it)
        keys = list(layer.state_dict())
        assert len(keys) == len(sd), (keys, list(sd))
        layer.set_dict({k2: sd[k1] for k1, k2 in zip(sd, keys)})

    return scenario(T, load)


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


def _mean_loss(P, logits, label):
    ce = P.trace("softmax_with_cross_entropy",
                 {"Logits": [logits], "Label": [label]}, {})["Loss"][0]
    return P.trace("mean", {"X": [ce]}, {})["Out"][0]


# -- the twelve twins ----------------------------------------------------------

def test_to_variable_and_math():
    def run(P, load):
        with P.guard():
            x = P.dy.to_variable(np.array([[1.0, 2.0], [3.0, 4.0]],
                                          dtype="float32"))
            y = x * 2.0 + 1.0
            z = x @ P.dy.to_variable(np.eye(2, dtype="float32"))
            w = 1.5 - x / 2.0 - (-x) ** 2.0
            return y.numpy(), z.numpy(), w.numpy()

    (jy, jz, jw), (ty, tz, tw) = twin(run)
    np.testing.assert_allclose(ty, [[3, 5], [7, 9]])
    np.testing.assert_allclose(tz, [[1, 2], [3, 4]])
    for got, want in ((ty, jy), (tz, jz), (tw, jw)):
        close(got, want)


def test_backward_simple():
    xv = np.array([[1.0, 2.0, 3.0]], dtype="float32")

    def run(P, load):
        with P.guard():
            x = P.dy.to_variable(xv)
            x.stop_gradient = False
            y = x * x
            loss = P.trace("reduce_sum", {"X": [y]},
                           {"reduce_all": True})["Out"][0]
            loss.backward()
            return x.gradient

    jg, tg = twin(run)
    close(tg, 2 * xv, rtol=1e-6)
    close(tg, jg)


def test_linear_layer_train():
    def run(P, load):
        with P.guard():
            layer = P.dy.Linear(4, 1, bias_attr=False)
            load(layer)
            opt = P.fluid.optimizer.SGD(0.1)
            xv = np.ones((2, 4), dtype="float32")
            w0 = layer.weight.numpy()
            for _ in range(3):
                out = layer(P.dy.to_variable(xv))
                loss = P.trace("mean", {"X": [out]}, {})["Out"][0]
                loss.backward()
                opt.minimize(loss, parameter_list=layer.parameters())
                layer.clear_gradients()
            return w0, layer.weight.numpy()

    (jw0, jw1), (tw0, tw1) = twin(run)
    assert (tw1 < tw0).all()
    close(tw0, jw0)
    close(tw1, jw1)


def test_dygraph_mnist_mlp_converges():
    rng = np.random.RandomState(0)
    xs = rng.rand(128, 64).astype("float32")
    w_true = rng.rand(64, 1).astype("float32")
    ys = (xs @ w_true > w_true.sum() / 2).astype("int64")

    def run(P, load):
        with P.guard():
            class MLP(P.dy.Layer):
                def __init__(self):
                    super().__init__()
                    self.l1 = P.dy.Linear(64, 32, act="relu")
                    self.l2 = P.dy.Linear(32, 2)

                def forward(self, x):
                    return self.l2(self.l1(x))

            model = MLP()
            load(model)
            opt = P.fluid.optimizer.Adam(5e-3)
            losses = []
            for _ in range(40):
                loss = _mean_loss(P, model(P.dy.to_variable(xs)),
                                  P.dy.to_variable(ys))
                loss.backward()
                opt.minimize(loss, parameter_list=model.parameters())
                model.clear_gradients()
                losses.append(float(loss.numpy()))
            return losses

    jl, tl = twin(run)
    assert tl[-1] < tl[0] * 0.5, f"{tl[0]} -> {tl[-1]}"
    close(tl, jl, rtol=1e-5)


def test_dygraph_equals_static():
    """The same model and weights: the port's dygraph losses equal its
    static executor's (rtol 1e-6) and the JAX package's dygraph losses
    (rtol 1e-5)."""
    xv = np.random.RandomState(1).rand(4, 8).astype("float32")
    w_init = np.random.RandomState(2).rand(8, 3).astype("float32")
    yv = np.array([[0], [1], [2], [0]], dtype="int64")

    fluid = tfluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [8])
        label = fluid.layers.data("y", [1], dtype="int64")
        out = fluid.layers.fc(x, 3, bias_attr=False, param_attr=fluid.ParamAttr(
            name="w", initializer=TNumpyInit(w_init)))
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(out, label))
        fluid.optimizer.SGD(0.1).minimize(loss)
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        static_losses = [float(np.asarray(exe.run(
            main, feed={"x": xv, "y": yv}, fetch_list=[loss])[0]))
            for _ in range(5)]

    def run(P, load):
        with P.guard():
            layer = P.dy.Linear(8, 3, bias_attr=False,
                                param_attr=P.fluid.ParamAttr(
                                    initializer=P.NumpyInit(w_init)))
            opt = P.fluid.optimizer.SGD(0.1)
            losses = []
            for _ in range(5):
                l = _mean_loss(P, layer(P.dy.to_variable(xv)),
                               P.dy.to_variable(yv))
                l.backward()
                opt.minimize(l, parameter_list=layer.parameters())
                layer.clear_gradients()
                losses.append(float(l.numpy()))
            return losses

    jl, tl = twin(run)
    close(tl, static_losses, rtol=1e-6, atol=0)
    close(tl, jl)


def test_state_dict_save_load(tmp_path):
    """Save/load in the port, a JAX-written file loaded by the port and a
    port-written file loaded by the JAX package (parameters and an
    optimizer's state)."""
    with tdy.guard(tfluid.CPUPlace()):
        layer = tdy.Linear(4, 2)
        sd = layer.state_dict()
        tdy.save_dygraph(sd, str(tmp_path / "model"))
        para, _ = tdy.load_dygraph(str(tmp_path / "model"))
        layer2 = tdy.Linear(4, 2)
        keys1, keys2 = list(sd), list(layer2.state_dict())
        layer2.set_dict({k2: para[k1] for k1, k2 in zip(keys1, keys2)})
        sd2 = layer2.state_dict()
        for k1, k2 in zip(keys1, keys2):
            np.testing.assert_array_equal(sd[k1], sd2[k2])
    assert para is not None and len(para) == 2

    # JAX writes a layer and an optimizer state, the port reads them
    xv = np.ones((3, 4), "float32")
    with jdy.guard():
        jl = jdy.Linear(4, 2)
        jopt = jfluid.optimizer.Adam(0.1)
        loss = jtrace("mean", {"X": [jl(jdy.to_variable(xv))]}, {})["Out"][0]
        loss.backward()
        jopt.minimize(loss, parameter_list=jl.parameters())
        jdy.save_dygraph(jl.state_dict(), str(tmp_path / "jax"))
        jdy.save_dygraph(jopt.state_dict(), str(tmp_path / "jax"))
        jsd, jout = jl.state_dict(), jl(jdy.to_variable(xv)).numpy()
    para, opt_state = tdy.load_dygraph(str(tmp_path / "jax"))
    assert "@optimizer_state@" in opt_state
    with tdy.guard(tfluid.CPUPlace()):
        tl = tdy.Linear(4, 2)
        keys = list(tl.state_dict())
        tl.set_dict({k2: para[k1] for k1, k2 in zip(jsd, keys)})
        close(tl(tdy.to_variable(xv)).numpy(), jout)
        tdy.save_dygraph(tl.state_dict(), str(tmp_path / "port"))
        tsd = tl.state_dict()
    # and the reverse
    para, _ = jdy.load_dygraph(str(tmp_path / "port"))
    for k in tsd:
        np.testing.assert_array_equal(para[k], tsd[k])
    with jdy.guard():
        jl2 = jdy.Linear(4, 2)
        jl2.set_dict({k2: para[k1] for k1, k2 in zip(tsd, jl2.state_dict())})
        close(jl2(jdy.to_variable(xv)).numpy(), jout)


def test_batch_norm_layer_updates_stats():
    xv = np.random.RandomState(0).rand(8, 3, 4, 4).astype("float32") + 5.0

    def run(P, load):
        with P.guard():
            bn = P.dy.BatchNorm(3)
            load(bn)
            y = bn(P.dy.to_variable(xv))
            return bn._mean.numpy(), bn._variance.numpy(), y.numpy()

    (jm, jv, jy), (tm, tv, ty) = twin(run)
    assert np.abs(tm).sum() > 0  # moved toward the batch mean ~5
    close(tm, jm)
    close(tv, jv)
    # x ~ 5 + U(0, 1): the one-pass variance E[x²] − mean² of both packages
    # cancels ~8 bits (E[x²] / var ≈ 300), summed in other orders, so y is
    # held at rtol 1e-4
    close(ty, jy, rtol=1e-4)


def test_dygraph_jit_matches_eager():
    x = np.random.RandomState(0).rand(2, 6).astype("float32")

    def run(P, load):
        with P.guard():
            layer = P.dy.Linear(6, 3, act="tanh")
            load(layer)
            layer.eval()
            eager_out = layer(P.dy.to_variable(x)).numpy()
            jit_out = P.dy.jit(layer)(x).numpy()
            return eager_out, jit_out

    (je, jj), (te, tj) = twin(run)
    np.testing.assert_allclose(te, tj, rtol=1e-6, atol=0)
    close(te, je)
    close(tj, jj)


def test_dygraph_jit_writes_back_batch_norm_stats():
    """In training mode the jitted forward's new running statistics are
    written back to the buffers, as the eager forward's are."""
    xv = np.random.RandomState(0).rand(4, 3, 4, 4).astype("float32") + 2.0

    def run(P, load):
        with P.guard():
            bn = P.dy.BatchNorm(3)
            load(bn)
            fast = P.dy.jit(bn)
            y = fast(xv).numpy()
            return y, bn._mean.numpy(), bn._variance.numpy()

    for got, want in zip(*reversed(twin(run))):
        close(got, want, atol=1e-5)


def test_no_grad():
    def run(P, load):
        with P.guard():
            x = P.dy.to_variable(np.ones((2, 2), dtype="float32"))
            x.stop_gradient = False
            with P.dy.no_grad():
                y = x * 3.0
            z = x * 3.0

            @P.dy.no_grad()
            def triple(v):
                return v * 3.0

            return (y.stop_gradient, z.stop_gradient,
                    triple(x).stop_gradient, y.numpy())

    jr, tr = twin(run)
    assert tr[:3] == (True, False, True) == jr[:3]
    close(tr[3], jr[3])
    with tdy.guard(tfluid.CPUPlace()):
        x = tdy.to_variable(np.ones((2, 2), dtype="float32"))
        x.stop_gradient = False
        with tdy.no_grad():
            y = x * 3.0
        assert not y.value.requires_grad


def _rand(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype("float32")


def _evaluating(layer):
    layer.eval()
    return layer


# (case id, layer ctor(dy), forward inputs, the gradient held: "x" (the
# first input's), a parameter attribute name, or None in eval mode, where
# nothing is taped)
LAYER_CASES = [
    ("Linear", lambda dy: dy.Linear(5, 3, act="sigmoid"),
     [_rand((4, 5), 0)], "weight"),
    ("FC", lambda dy: dy.FC(5, 3), [_rand((2, 3, 5), 0)], "x"),
    ("Conv2D", lambda dy: dy.Conv2D(3, 4, 3, stride=2, padding=1,
                                    act="relu"),
     [_rand((2, 3, 8, 8), 0)], "weight"),
    ("Pool2D", lambda dy: dy.Pool2D(pool_size=3, pool_type="avg",
                                    pool_stride=2, pool_padding=1),
     [_rand((2, 3, 8, 8), 0)], "x"),
    ("BatchNorm", lambda dy: dy.BatchNorm(3, act="relu"),
     [_rand((4, 3, 5, 5), 0)], "weight"),
    ("Embedding", lambda dy: dy.Embedding([10, 4]),
     [np.array([[1], [3], [3], [9]], "int64")], "weight"),
    ("LayerNorm", lambda dy: dy.LayerNorm(6), [_rand((3, 6), 0)],
     "weight"),
    ("Dropout", lambda dy: dy.nn.Dropout(p=0.0), [_rand((3, 6), 0)], "x"),
    ("Dropout_eval", lambda dy: _evaluating(dy.nn.Dropout(p=0.5)),
     [_rand((3, 6), 0)], None),
    ("PRelu", lambda dy: dy.PRelu(mode="channel", channel=3),
     [_rand((2, 3, 4, 4), 0) - 0.5], "weight"),
    ("GRUUnit", lambda dy: dy.GRUUnit(12),
     [_rand((3, 12), 0), _rand((3, 4), 1)], "weight"),
    ("Conv2DTranspose", lambda dy: dy.nn.Conv2DTranspose(3, 5, 3),
     [_rand((2, 3, 8, 8), 0)], "weight"),
    ("Conv2DTranspose_output_size",
     lambda dy: dy.nn.Conv2DTranspose(3, 5, 3, output_size=16, stride=2),
     [_rand((2, 3, 7, 7), 0)], "weight"),
    ("Conv3D", lambda dy: dy.nn.Conv3D(3, 5, 3), [_rand((2, 3, 4, 8, 8), 0)],
     "weight"),
    ("Conv3DTranspose", lambda dy: dy.nn.Conv3DTranspose(3, 5, 3),
     [_rand((2, 3, 4, 8, 8), 0)], "weight"),
    ("BilinearTensorProduct", lambda dy: dy.nn.BilinearTensorProduct(4, 5, 6),
     [_rand((3, 4), 0), _rand((3, 5), 1)], "weight"),
    ("SequenceConv", lambda dy: dy.nn.SequenceConv(8, 16, filter_size=3,
                                                   act="tanh"),
     [_rand((2, 6, 8), 0), np.array([[6], [4]], "int64")], "weight"),
    ("RowConv", lambda dy: dy.nn.RowConv(8, future_context_size=2),
     [_rand((2, 6, 8), 0)], "weight"),
    ("GroupNorm", lambda dy: dy.nn.GroupNorm(6, groups=3),
     [_rand((2, 6, 4, 4), 0)], "weight"),
    ("GroupNorm_no_affine_nhwc", lambda dy: dy.nn.GroupNorm(
        6, groups=3, param_attr=False, bias_attr=False, data_layout="NHWC"),
     [_rand((2, 4, 4, 6), 0)], "x"),
    ("SpectralNorm", lambda dy: dy.nn.SpectralNorm([6, 4], power_iters=3),
     [_rand((6, 4), 0)], "x"),
    ("TreeConv", lambda dy: dy.nn.TreeConv(feature_size=5, output_size=4,
                                           max_depth=2),
     [_rand((1, 6, 5), 0),
      np.array([[[1, 2], [1, 3], [2, 4], [2, 5]]], "int32")], "weight"),
]


@pytest.mark.parametrize("case", LAYER_CASES, ids=[c[0] for c in LAYER_CASES])
def test_layer_forward_and_gradient_match_jax(case):
    _, ctor, inputs, grad_of = case

    def run(P, load):
        with P.guard():
            layer = ctor(P.dy)
            load(layer)
            xs = [P.dy.to_variable(a) for a in inputs]
            xs[0].stop_gradient = grad_of != "x"
            out = layer(*xs)
            out = out[0] if isinstance(out, tuple) else out
            cot = P.dy.to_variable(_rand(out.shape, 7))
            loss = P.trace("reduce_sum", {"X": [out * cot]},
                           {"reduce_all": True})["Out"][0]
            loss.backward()
            if grad_of is None:
                return out.numpy(), xs[0].gradient
            g = (xs[0] if grad_of == "x" else getattr(layer, grad_of)).gradient
            return out.numpy(), g

    (jo, jg), (to, tg) = twin(run)
    assert to.shape == jo.shape
    close(to, jo, msg="forward")
    if grad_of is None:
        assert tg is None and jg is None
    else:
        close(tg, jg, atol=1e-5, msg=f"gradient of {grad_of}")


def test_dygraph_layer_zoo_round2():
    """The JAX test's shape and value checks on the port (reference
    dygraph/nn.py Conv2DTranspose :1981, Conv3D :258, NCE :1579,
    BilinearTensorProduct :1881, SequenceConv :2216, RowConv :2306,
    GroupNorm :2382, SpectralNorm :2481, TreeConv :2581); NCE draws its
    negatives from the port's generator, so its cost is held to shape,
    finiteness and a finite gradient here (the op's values:
    tests/test_torch_dygraph_ops.py)."""
    rng = np.random.RandomState(0)
    with tdy.guard(tfluid.CPUPlace()):
        x4 = tdy.to_variable(rng.rand(2, 3, 8, 8).astype("float32"))
        assert tdy.nn.Conv2DTranspose(3, 5, 3)(x4).shape == (2, 5, 10, 10)
        x5 = tdy.to_variable(rng.rand(2, 3, 4, 8, 8).astype("float32"))
        assert tdy.nn.Conv3D(3, 5, 3)(x5).shape == (2, 5, 2, 6, 6)
        assert tdy.nn.Conv3DTranspose(3, 5, 3)(x5).shape == (2, 5, 6, 10, 10)

        nce = tdy.nn.NCE(num_total_classes=20, dim=6, num_neg_samples=4)
        cost = nce(tdy.to_variable(rng.rand(3, 6).astype("float32")),
                   tdy.to_variable(rng.randint(0, 20, (3, 1))))
        assert cost.shape == (3, 1) and np.isfinite(cost.numpy()).all()
        loss = ttrace("reduce_sum", {"X": [cost]}, {"reduce_all": True})[
            "Out"][0]
        loss.backward()
        assert np.isfinite(nce.weight.gradient).all()
        assert np.abs(nce.weight.gradient).sum() > 0

        gn = tdy.nn.GroupNorm(6, groups=3)
        out = gn(tdy.to_variable(rng.rand(2, 6, 4, 4).astype("float32")))
        got = out.numpy().reshape(2, 3, 2, 4, 4)
        np.testing.assert_allclose(got.mean(axis=(2, 3, 4)), 0, atol=1e-4)

        sn = tdy.nn.SpectralNorm([6, 4], power_iters=3)
        wn = sn(tdy.to_variable(rng.rand(6, 4).astype("float32")))
        s = np.linalg.svd(wn.numpy(), compute_uv=False)
        assert abs(s[0] - 1.0) < 0.15


def test_dygraph_layer_zoo_fixes():
    """GroupNorm with bias_attr=False and NHWC layout, Conv2DTranspose
    output_size, NCE rejects non-uniform samplers — in the port."""
    rng = np.random.RandomState(0)
    with tdy.guard(tfluid.CPUPlace()):
        gn = tdy.nn.GroupNorm(6, groups=3, param_attr=False, bias_attr=False)
        out = gn(tdy.to_variable(rng.rand(2, 6, 4, 4).astype("float32")))
        assert out.shape == (2, 6, 4, 4) and gn.parameters() == []
        gn2 = tdy.nn.GroupNorm(6, groups=3, data_layout="NHWC")
        out2 = gn2(tdy.to_variable(rng.rand(2, 4, 4, 6).astype("float32")))
        got = out2.numpy().transpose(0, 3, 1, 2).reshape(2, 3, 2, 4, 4)
        np.testing.assert_allclose(got.mean(axis=(2, 3, 4)), 0, atol=1e-4)
        ct = tdy.nn.Conv2DTranspose(3, 5, 3, output_size=16, stride=2)
        y = ct(tdy.to_variable(rng.rand(2, 3, 7, 7).astype("float32")))
        assert y.shape == (2, 5, 16, 16)
        with pytest.raises(NotImplementedError):
            tdy.nn.NCE(num_total_classes=10, dim=4, sampler="log_uniform")
        with pytest.raises(ValueError):
            tdy.nn.GroupNorm(6, groups=3, data_layout="NCDHW")


def test_eager_jit_cache_matches_direct_dispatch(monkeypatch):
    """The prepared-op cache (the PreparedOp analog) is numerically
    invisible: the same losses and parameters with PDTPU_EAGER_JIT=0
    (bitwise in the port), and both within tolerance of the JAX
    package's cached run."""
    from paddle_tpu_torch.ops import eager as teager

    monkeypatch.delenv("PDTPU_EAGER_JIT", raising=False)
    rng = np.random.RandomState(0)
    X = rng.rand(16, 8).astype("float32")
    Y = rng.rand(16, 1).astype("float32")

    def run(P, load):
        with P.guard(seed=9):
            m = P.dy.Linear(8, 4, act="tanh")
            load(m)
            head = P.dy.Linear(4, 1)
            load(head)
            opt = P.fluid.optimizer.Adam(0.05)
            params = m.parameters() + head.parameters()
            losses = []
            for _ in range(5):
                out = head(m(P.dy.to_variable(X)))
                d = P.trace("elementwise_sub",
                            {"X": [out], "Y": [P.dy.to_variable(Y)]},
                            {"axis": -1})["Out"][0]
                loss = P.trace("mean", {"X": [P.trace(
                    "square", {"X": [d]}, {})["Out"][0]]}, {})["Out"][0]
                losses.append(float(loss.numpy()))
                loss.backward()
                opt.minimize(loss, parameter_list=params)
                m.clear_gradients()
                head.clear_gradients()
            return losses, m.weight.numpy()

    teager._jit_cache.clear()
    states = []
    (jl, jw), (tl, tw) = twin(run, states)
    assert teager._jit_cache  # the cached path ran
    monkeypatch.setenv("PDTPU_EAGER_JIT", "0")
    teager._jit_cache.clear()
    dl, dw = port_run(run, states)
    assert not teager._jit_cache  # the direct path ran
    np.testing.assert_array_equal(tl, dl)
    np.testing.assert_array_equal(tw, dw)
    close(tl, jl)
    close(tw, jw)
