"""The ten ops the dygraph layer zoo traces that the port registers since
its dygraph slice, each against the JAX package's op on the same numpy
inputs: the forward outputs and the input gradients of a random cotangent
(``jax.vjp`` against ``torch.autograd.grad``), rtol 1e-5 plus atol 1e-6
(a gradient, which sums over the batch and the window in another order,
plus 1e-6 of its largest magnitude), one case a test. ``nce`` draws its
negatives from the run's generator, which differs from the JAX package's
PRNG by design: its loss and gradients are held to the JAX op's formula
evaluated on the negatives the port drew (``SampleLabels``), and the
negatives' range is checked.

Also the dygraph BatchNorm on the fused-BN kernel route
(``PDTPU_BN_MODE=pallas``; on the CPU the kernels' plain versions) held to
the JAX package's dygraph BatchNorm through its Pallas kernels in
interpret mode (forward, backward, running statistics), and a two-block
bottleneck net of narrow widths trained 3 steps in both packages' dygraph
modes (losses within 1e-4 relative, the state's change within 1e-3
relative L2).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import dygraph as jdy
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.executor import ExecContext as JaxCtx
from paddle_tpu.dygraph.tracer import trace_op as jtrace
from paddle_tpu_torch import dygraph as tdy
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.dtypes import to_numpy
from paddle_tpu_torch.core.executor import ExecContext as TorchCtx
from paddle_tpu_torch.dygraph.tracer import trace_op as ttrace

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _r(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


_EDGES = np.array([[[0, 1], [0, 2], [1, 3], [1, 4], [2, 5], [-1, -1]],
                   [[0, 1], [1, 2], [1, 3], [3, 4], [-1, -1], [-1, -1]]],
                  np.int32)

# (case id, op type, inputs, attrs, the output slot held, diff input slots)
OP_CASES = [
    ("conv2d_transpose", "conv2d_transpose",
     {"Input": [_r(2, 3, 5, 5)], "Filter": [_r(3, 4, 3, 3, seed=1)]},
     {"strides": [2, 2], "paddings": [1, 1]}, "Out", ("Input", "Filter")),
    ("conv2d_transpose_groups_output_size", "conv2d_transpose",
     {"Input": [_r(2, 4, 4, 4)], "Filter": [_r(4, 3, 3, 3, seed=1)]},
     {"strides": [2, 2], "paddings": [0, 0], "groups": 2,
      "output_size": [10, 10]}, "Out", ("Input", "Filter")),
    ("conv3d", "conv3d",
     {"Input": [_r(2, 3, 4, 6, 6)], "Filter": [_r(5, 3, 3, 3, 3, seed=1)]},
     {"strides": [1, 2, 1], "paddings": [1, 0, 1]}, "Out",
     ("Input", "Filter")),
    ("conv3d_transpose", "conv3d_transpose",
     {"Input": [_r(2, 3, 3, 4, 4)], "Filter": [_r(3, 2, 3, 3, 3, seed=1)]},
     {"strides": [1, 2, 2], "paddings": [1, 1, 1]}, "Out",
     ("Input", "Filter")),
    ("group_norm", "group_norm",
     {"X": [_r(2, 6, 4, 4)], "Scale": [_r(6, seed=1)],
      "Bias": [_r(6, seed=2)]}, {"groups": 3, "epsilon": 1e-5}, "Y",
     ("X", "Scale", "Bias")),
    ("group_norm_nhwc", "group_norm",
     {"X": [_r(2, 4, 4, 6)], "Scale": [_r(6, seed=1)]},
     {"groups": 2, "data_layout": "NHWC"}, "Y", ("X", "Scale")),
    ("prelu_all", "prelu", {"X": [_r(3, 4, 5)], "Alpha": [np.array(
        [0.25], np.float32)]}, {"mode": "all"}, "Out", ("X", "Alpha")),
    ("prelu_channel", "prelu", {"X": [_r(2, 3, 4, 4)],
                                "Alpha": [_r(3, seed=1)]},
     {"mode": "channel"}, "Out", ("X", "Alpha")),
    ("bilinear_tensor_product", "bilinear_tensor_product",
     {"X": [_r(3, 4)], "Y": [_r(3, 5, seed=1)],
      "Weight": [_r(6, 4, 5, seed=2)], "Bias": [_r(1, 6, seed=3)]}, {},
     "Out", ("X", "Y", "Weight", "Bias")),
    ("row_conv", "row_conv", {"X": [_r(2, 6, 8)], "Filter": [_r(3, 8,
                                                                seed=1)]},
     {}, "Out", ("X", "Filter")),
    ("spectral_norm", "spectral_norm",
     {"Weight": [_r(6, 4)], "U": [_r(6, seed=1)], "V": [_r(4, seed=2)]},
     {"dim": 0, "power_iters": 3, "eps": 1e-12}, "Out", ("Weight",)),
    ("spectral_norm_dim1", "spectral_norm",
     {"Weight": [_r(3, 5, 2)], "U": [_r(5, seed=1)], "V": [_r(6, seed=2)]},
     {"dim": 1, "power_iters": 2}, "Out", ("Weight",)),
    ("tree_conv", "tree_conv",
     {"NodesVector": [_r(2, 6, 5)], "EdgeSet": [_EDGES],
      "Filter": [_r(5, 3, 4, seed=1)]}, {"max_depth": 2}, "Out",
     ("NodesVector", "Filter")),
]

# the ten ops (tests/test_torch_ops.py's coverage reads this list)
DYGRAPH_OPS = ("conv2d_transpose", "conv3d", "group_norm",
               "conv3d_transpose", "prelu", "bilinear_tensor_product",
               "row_conv", "spectral_norm", "nce", "tree_conv")


def test_the_ten_ops_are_registered_in_both_packages():
    assert set(DYGRAPH_OPS) <= set(treg.registered_ops())
    assert set(DYGRAPH_OPS) <= set(jreg.registered_ops())
    assert {c[1] for c in OP_CASES} | {"nce"} == set(DYGRAPH_OPS)


@pytest.mark.parametrize("case", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_op_forward_and_gradient_match_jax(case):
    _, op_type, inputs, attrs, out_slot, diff = case
    flat = [(s, i) for s in diff for i in range(len(inputs[s]))]

    def jfn(*vals):
        ins = {s: [jnp.asarray(a) for a in v] for s, v in inputs.items()}
        for (s, i), v in zip(flat, vals):
            ins[s][i] = v
        return jreg.get_op(op_type).fn(JaxCtx(None), ins, attrs)[out_slot][0]

    want, vjp = jax.vjp(jfn, *[jnp.asarray(inputs[s][i]) for s, i in flat])
    cot = _r(*want.shape, seed=9)
    want_grads = vjp(jnp.asarray(cot))

    leaves = [torch.from_numpy(inputs[s][i].copy()).requires_grad_()
              for s, i in flat]
    tins = {s: [torch.from_numpy(a.copy()) for a in v]
            for s, v in inputs.items()}
    for (s, i), t in zip(flat, leaves):
        tins[s][i] = t
    got = treg.get_op(op_type).fn(TorchCtx("cpu"), tins, attrs)[out_slot][0]
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(cot))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    for (s, i), g, w in zip(flat, grads, want_grads):
        w = np.asarray(w)
        np.testing.assert_allclose(to_numpy(g), w, rtol=RTOL,
                                   atol=ATOL * (1.0 + np.abs(w).max()),
                                   err_msg=s)


def _nce_formula(x, w, b, samples, num_true, num_total, k):
    """The JAX op's uniform-sampler cost on given samples (jnp)."""
    logits = jnp.einsum("btd,bd->bt", w[samples], x) + b[samples]
    shift = jnp.log(k * (1.0 / num_total) + 1e-20)
    pos = jax.nn.softplus(-(logits[:, :num_true] - shift))
    neg = jax.nn.softplus(logits[:, num_true:] - shift)
    return (jnp.sum(pos, 1, keepdims=True) / num_true
            + jnp.sum(neg, 1, keepdims=True))


@pytest.mark.parametrize("num_true", [1, 2])
def test_nce_holds_the_jax_formula_on_the_ports_negatives(num_true):
    num_total, k, b, d = 20, 4, 5, 6
    x, w, bias = _r(b, d), _r(num_total, d, seed=1), _r(num_total, seed=2)
    label = np.random.RandomState(3).randint(0, num_total, (b, num_true))
    leaves = [torch.from_numpy(a.copy()).requires_grad_()
              for a in (x, w, bias)]
    ctx = TorchCtx("cpu", torch.Generator().manual_seed(5))
    out = treg.get_op("nce").fn(
        ctx, {"Input": [leaves[0]], "Weight": [leaves[1]],
              "Bias": [leaves[2]], "Label": [torch.from_numpy(label)]},
        {"num_total_classes": num_total, "num_neg_samples": k})
    samples = to_numpy(out["SampleLabels"][0])
    assert samples.shape == (b, num_true + k)
    np.testing.assert_array_equal(samples[:, :num_true], label)
    neg = samples[:, num_true:]
    assert neg.min() >= 0 and neg.max() < num_total
    cot = _r(b, 1, seed=4)
    want, vjp = jax.vjp(
        lambda *a: _nce_formula(*a, jnp.asarray(samples), num_true,
                                num_total, k),
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias))
    got = out["Cost"][0]
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(cot))
    for g, wg in zip(grads, vjp(jnp.asarray(cot))):
        np.testing.assert_allclose(to_numpy(g), np.asarray(wg), rtol=RTOL,
                                   atol=ATOL)
    # the JAX op itself gives a cost of the same shape from its own draws
    jout = jreg.get_op("nce").fn(
        JaxCtx(jax.random.PRNGKey(0)),
        {"Input": [jnp.asarray(x)], "Weight": [jnp.asarray(w)],
         "Bias": [jnp.asarray(bias)], "Label": [jnp.asarray(label)]},
        {"num_total_classes": num_total, "num_neg_samples": k})
    assert jout["Cost"][0].shape == tuple(got.shape)


# -- the dygraph BatchNorm on the fused-BN kernels' route ----------------------

@pytest.fixture
def bn_pallas(monkeypatch):
    """PDTPU_BN_MODE=pallas; the JAX package's fused BN in interpret mode;
    the port's fused_bn_act calls counted."""
    from paddle_tpu.ops.pallas_kernels import fused_bn as jbn
    from paddle_tpu_torch.ops.kernels import fused_bn as tbn

    monkeypatch.setenv("PDTPU_BN_MODE", "pallas")
    monkeypatch.setattr(jbn, "FORCE_PALLAS_INTERPRET", True)
    calls = []
    orig = tbn.fused_bn_act

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)

    monkeypatch.setattr(tbn, "fused_bn_act", counted)
    return calls


def test_dygraph_batch_norm_on_the_kernel_route_matches_jax(bn_pallas):
    from paddle_tpu_torch.ops.kernels import fused_bn as tbn

    shape = (2, 64, 32, 32)           # M = 2048, C = 64: fused_bn.supports
    assert tbn.supports(shape, torch.float32)
    xv = _r(*shape, seed=1) * 2.0 + 0.5
    cot = _r(*shape, seed=2)
    res = {}
    with jdy.guard(seed=1):
        bn = jdy.BatchNorm(64, act="relu")
        bn.set_dict({n: _r(*v.shape, seed=3) * 0.5 + (1.0 if "w" in n
                                                      else 0.0)
                     for n, v in bn.state_dict().items()
                     if not n.startswith("_")})
        init = bn.state_dict()
        x = jdy.to_variable(xv)
        x.stop_gradient = False
        y = bn(x)
        loss = jtrace("reduce_sum", {"X": [y * jdy.to_variable(cot)]},
                      {"reduce_all": True})["Out"][0]
        loss.backward()
        res["jax"] = (y.numpy(), x.gradient, bn.weight.gradient,
                      bn.bias.gradient, bn._mean.numpy(),
                      bn._variance.numpy())
    with tdy.guard(tfluid.CPUPlace(), seed=1):
        bn = tdy.BatchNorm(64, act="relu")
        keys = list(bn.state_dict())
        bn.set_dict({k2: init[k1] for k1, k2 in zip(init, keys)})
        x = tdy.to_variable(xv)
        x.stop_gradient = False
        y = bn(x)
        loss = ttrace("reduce_sum", {"X": [y * tdy.to_variable(cot)]},
                      {"reduce_all": True})["Out"][0]
        loss.backward()
        res["port"] = (y.numpy(), x.gradient, bn.weight.gradient,
                       bn.bias.gradient, bn._mean.numpy(),
                       bn._variance.numpy())
    assert bn_pallas == [shape]
    names = ("y", "dx", "dscale", "dbias", "mean", "variance")
    for name, got, want in zip(names, res["port"], res["jax"]):
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * scale,
                                   err_msg=name)


def _bottleneck_net(dy, width=32, out=64, classes=10):
    """A stem and two bottleneck blocks (1x1 → 3x3 → 1x1, identity
    shortcut), global pool, fc: the dygraph ResNet pattern at narrow
    widths."""

    class ConvBN(dy.Layer):
        def __init__(self, ci, co, k, act="relu"):
            super().__init__()
            self.conv = dy.Conv2D(ci, co, k, padding=(k - 1) // 2,
                                  bias_attr=False)
            self.bn = dy.BatchNorm(co, act=act)

        def forward(self, x):
            return self.bn(self.conv(x))

    class Block(dy.Layer):
        def __init__(self):
            super().__init__()
            self.a = ConvBN(out, width, 1)
            self.b = ConvBN(width, width, 3)
            self.c = ConvBN(width, out, 1, act=None)

        def forward(self, x):
            y = self.c(self.b(self.a(x)))
            return dy.tracer.trace_op("relu", {"X": [x + y]}, {})["Out"][0]

    class Net(dy.Layer):
        def __init__(self):
            super().__init__()
            self.stem = ConvBN(3, out, 3)
            self.b1 = Block()
            self.b2 = Block()
            self.pool = dy.Pool2D(pool_type="avg", global_pooling=True)
            self.fc = dy.Linear(out, classes)

        def forward(self, x):
            h = self.pool(self.b2(self.b1(self.stem(x))))
            h = dy.tracer.trace_op("reshape", {"X": [h]},
                                   {"shape": [h.shape[0], -1]})["Out"][0]
            return self.fc(h)

    return Net()


def _train_bottleneck(dy, fluid, trace, guard, init, steps=3):
    # B = 4 at 32²: M = 4096 rows, so every BatchNorm (C = 32, 64) passes
    # fused_bn.supports
    xv = np.random.RandomState(0).rand(4, 3, 32, 32).astype("float32")
    yv = np.random.RandomState(1).randint(0, 10, (4, 1)).astype("int64")
    with guard:
        net = _bottleneck_net(dy)
        init(net)
        opt = fluid.optimizer.Momentum(0.01, 0.9)
        losses = []
        for _ in range(steps):
            logits = net(dy.to_variable(xv))
            ce = trace("softmax_with_cross_entropy",
                       {"Logits": [logits], "Label": [dy.to_variable(yv)]},
                       {})["Loss"][0]
            loss = trace("mean", {"X": [ce]}, {})["Out"][0]
            loss.backward()
            opt.minimize(loss, parameter_list=net.parameters())
            net.clear_gradients()
            losses.append(float(loss.numpy()))
        return losses, net.state_dict()


def test_bottleneck_net_trains_like_jax_on_the_kernel_route(monkeypatch):
    from paddle_tpu_torch.ops.kernels import fused_bn as tbn

    monkeypatch.setenv("PDTPU_BN_MODE", "pallas")
    calls = []
    orig = tbn.fused_bn_act
    monkeypatch.setattr(tbn, "fused_bn_act",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    held = {}

    def jinit(net):
        held["init"] = net.state_dict()

    def tinit(net):
        keys = list(net.state_dict())
        net.set_dict({k2: held["init"][k1]
                      for k1, k2 in zip(held["init"], keys)})

    # the JAX package on the CPU: its batch_norm's plain reference
    jlosses, jstate = _train_bottleneck(jdy, jfluid, jtrace,
                                        jdy.guard(seed=2), jinit)
    tlosses, tstate = _train_bottleneck(
        tdy, tfluid, ttrace, tdy.guard(tfluid.CPUPlace(), seed=2), tinit)
    assert len(calls) == 7 * 3          # every BatchNorm, every step
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    # the change of the whole state (every parameter and running
    # statistic) within 1e-3 relative L2 of the JAX package's: a BN bias's
    # gradient nearly cancels over the batch, so its own change is held
    # only that far (measured 5.7e-3 relative, the same on either BN
    # route)
    want = np.concatenate([(jstate[k] - held["init"][k]).ravel()
                           for k in jstate])
    got = np.concatenate([(tstate[k2] - held["init"][k1]).ravel()
                          for k1, k2 in zip(jstate, tstate)])
    assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)
