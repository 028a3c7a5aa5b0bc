"""The port's sequence ops (``ops/sequence_ops.py``) and sequence layers
(``layers/sequence.py``) against the JAX package's, on the CPU: twins of
the 27 tests of ``tests/test_sequence_ops.py``.

Each op runs in both packages on the same numpy inputs and is held to the
JAX test's numpy reference (its tolerance) and to the JAX package's output
(rtol 1e-5, atol 1e-6; integer outputs equal). A gradient test holds the
port's autograd gradient of sum(output) to ``jax.grad`` of the JAX op
(rtol 1e-5, atol 1e-6). The layer pipeline trains in both packages from
the JAX package's initialized scope (losses rtol 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as jreg
from paddle_tpu.core.executor import ExecContext as JaxCtx
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.dtypes import to_numpy
from paddle_tpu_torch.core.executor import ExecContext as TorchCtx

from _torch_twin import fresh_port_state, run_both

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield from fresh_port_state()


def _mask(length, t):
    return (np.arange(t)[None, :] < length.reshape(-1, 1))


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def run_op(op_type, inputs, attrs, slots=("Out",)):
    """The op in both packages: {slot: port output as numpy}, after
    checking every slot against the JAX package's output."""
    want = jreg.get_op(op_type).fn(
        JaxCtx(None), {s: [jnp.asarray(a) for a in _as_list(v)]
                       for s, v in inputs.items()}, attrs)
    got = treg.get_op(op_type).fn(
        TorchCtx("cpu"), {s: [torch.from_numpy(np.array(a))
                              for a in _as_list(v)]
                          for s, v in inputs.items()}, attrs)
    out = {}
    for slot in slots:
        g, w = to_numpy(got[slot][0]), np.asarray(want[slot][0])
        assert g.shape == w.shape, (slot, g.shape, w.shape)
        if g.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=slot)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=slot)
        out[slot] = g
    return out


def check_output(op_type, inputs, attrs, expected, atol=1e-5):
    got = run_op(op_type, inputs, attrs, tuple(expected))
    for slot, exp in expected.items():
        np.testing.assert_allclose(got[slot], exp, atol=atol, rtol=1e-5,
                                   err_msg=f"{op_type} {slot}")


def check_grad(op_type, inputs, attrs, slot):
    """d sum(Out) / d inputs[slot]: the port's autograd against jax.grad
    of the JAX op."""
    def jfn(x):
        ins = {s: [jnp.asarray(a) for a in _as_list(v)]
               for s, v in inputs.items()}
        ins[slot] = [x]
        return jnp.sum(jreg.get_op(op_type).fn(JaxCtx(None), ins,
                                               attrs)["Out"][0])

    want = jax.grad(jfn)(jnp.asarray(inputs[slot]))
    ins = {s: [torch.from_numpy(np.array(a)) for a in _as_list(v)]
           for s, v in inputs.items()}
    x = ins[slot][0].requires_grad_()
    out = treg.get_op(op_type).fn(TorchCtx("cpu"), ins, attrs)["Out"][0]
    (got,) = torch.autograd.grad(out.sum(), [x])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


class TestSequenceMask:
    def test_mask(self):
        length = np.array([2, 0, 5], dtype="int32")
        got = run_op("sequence_mask", {"X": length},
                     {"maxlen": 6, "out_dtype": "int32"}, ("Y",))
        np.testing.assert_array_equal(got["Y"],
                                      _mask(length, 6).astype("int32"))
        assert got["Y"].dtype == np.int32


class TestSequencePool:
    def setup_method(self):
        rng = np.random.RandomState(7)
        self.x = rng.randn(3, 5, 4).astype("float32")
        self.length = np.array([2, 5, 1], dtype="int32")
        self.m = _mask(self.length, 5)[..., None]

    def _run(self, pooltype, exp, **kw):
        check_output("sequence_pool", {"X": self.x, "Length": self.length},
                     {"pooltype": pooltype}, {"Out": exp(self)}, **kw)

    def test_sum(self):
        self._run("SUM", lambda s: np.sum(s.x * s.m, axis=1))

    def test_average(self):
        self._run("AVERAGE", lambda s: np.sum(s.x * s.m, axis=1) /
                  s.length.reshape(-1, 1))

    def test_sqrt(self):
        self._run("SQRT", lambda s: np.sum(s.x * s.m, axis=1) /
                  np.sqrt(s.length.reshape(-1, 1)), atol=1e-4)

    def test_max(self):
        self._run("MAX", lambda s: np.max(
            np.where(s.m, s.x, -np.inf), axis=1))

    def test_last(self):
        self._run("LAST", lambda s: s.x[np.arange(3), s.length - 1])

    def test_first(self):
        self._run("FIRST", lambda s: s.x[:, 0])

    def test_sum_grad(self):
        check_grad("sequence_pool", {"X": self.x, "Length": self.length},
                   {"pooltype": "SUM"}, "X")


class TestSequenceSoftmax:
    def test_softmax(self):
        rng = np.random.RandomState(3)
        x = rng.randn(2, 6).astype("float32")
        length = np.array([4, 6], dtype="int32")
        m = _mask(length, 6)
        e = np.exp(np.where(m, x - np.max(np.where(m, x, -np.inf),
                                          axis=1, keepdims=True), -np.inf))
        exp = np.where(m, e / np.sum(e, axis=1, keepdims=True), 0.0)
        check_output("sequence_softmax", {"X": x, "Length": length}, {},
                     {"Out": exp.astype("float32")})


class TestSequenceReverse:
    def test_reverse_with_length(self):
        rng = np.random.RandomState(5)
        x = rng.randn(2, 4, 3).astype("float32")
        length = np.array([3, 4], dtype="int32")
        exp = x.copy()
        for b in range(2):
            exp[b, :length[b]] = x[b, :length[b]][::-1]
        got = run_op("sequence_reverse", {"X": x, "Length": length}, {},
                     ("Y",))
        np.testing.assert_allclose(got["Y"], exp, rtol=1e-6)


class TestSequenceConcat:
    def test_concat(self):
        rng = np.random.RandomState(0)
        a = rng.rand(2, 3, 4).astype("float32")
        b = rng.rand(2, 5, 4).astype("float32")
        check_output("sequence_concat", {"X": [a, b]}, {},
                     {"Out": np.concatenate([a, b], axis=1)})


class TestSequencePad:
    def test_pad_extend(self):
        rng = np.random.RandomState(2)
        x = rng.randn(2, 3, 2).astype("float32")
        length = np.array([2, 3], dtype="int32")
        pv = np.array(-1.0, dtype="float32")
        exp = np.full((2, 5, 2), -1.0, dtype="float32")
        for b in range(2):
            exp[b, :length[b]] = x[b, :length[b]]
        got = run_op("sequence_pad", {"X": x, "PadValue": pv,
                                      "Length": length},
                     {"padded_length": 5}, ("Out", "Length"))
        np.testing.assert_allclose(got["Out"], exp, rtol=1e-6)
        np.testing.assert_array_equal(got["Length"], length)

    def test_pad_truncate(self):
        x = np.arange(2 * 4, dtype="float32").reshape(2, 4)
        length = np.array([4, 2], dtype="int32")
        pv = np.array(0.0, dtype="float32")
        got = run_op("sequence_pad", {"X": x, "PadValue": pv,
                                      "Length": length},
                     {"padded_length": 3}, ("Out", "Length"))
        exp = x[:, :3].copy()
        exp[1, 2:] = 0.0
        np.testing.assert_allclose(got["Out"], exp)
        np.testing.assert_array_equal(got["Length"], [3, 2])


class TestSequenceUnpad:
    def test_unpad(self):
        x = np.random.RandomState(1).rand(2, 4, 3).astype("float32")
        length = np.array([1, 3], dtype="int32")
        check_output("sequence_unpad", {"X": x, "Length": length}, {},
                     {"Out": x * _mask(length, 4)[..., None]})

    def test_unpad_grad(self):
        x = np.random.RandomState(2).rand(2, 3, 2).astype("float32")
        length = np.array([2, 3], dtype="int32")
        check_grad("sequence_unpad", {"X": x, "Length": length}, {}, "X")


def _seq_conv_ref(x, filt, length, ctx_len, ctx_start):
    b, t, d = x.shape
    m = _mask(length, t)[..., None]
    xm = x * m
    win = np.zeros((b, t, ctx_len * d), dtype=x.dtype)
    for j in range(ctx_len):
        off = ctx_start + j
        for s in range(t):
            src = s + off
            if 0 <= src < t:
                win[:, s, j * d:(j + 1) * d] = xm[:, src]
    return (win @ filt) * m


class TestSequenceConv:
    def test_conv(self):
        rng = np.random.RandomState(11)
        x = rng.randn(2, 6, 3).astype("float32")
        filt = rng.randn(9, 4).astype("float32")
        length = np.array([4, 6], dtype="int32")
        check_output("sequence_conv",
                     {"X": x, "Filter": filt, "Length": length},
                     {"contextLength": 3, "contextStart": -1},
                     {"Out": _seq_conv_ref(x, filt, length, 3, -1)},
                     atol=1e-4)

    def test_conv_grad(self):
        rng = np.random.RandomState(12)
        x = rng.randn(2, 4, 2).astype("float32")
        filt = rng.randn(6, 3).astype("float32")
        length = np.array([3, 4], dtype="int32")
        check_grad("sequence_conv",
                   {"X": x, "Filter": filt, "Length": length},
                   {"contextLength": 3, "contextStart": -1}, "Filter")


class TestSequenceSlice:
    def test_slice(self):
        rng = np.random.RandomState(4)
        x = rng.randn(2, 5, 2).astype("float32")
        offset = np.array([1, 0], dtype="int32")
        length = np.array([2, 4], dtype="int32")
        exp = np.zeros_like(x)
        for b in range(2):
            exp[b, :length[b]] = x[b, offset[b]:offset[b] + length[b]]
        check_output("sequence_slice",
                     {"X": x, "Offset": offset, "Length": length}, {},
                     {"Out": exp})


class TestSequenceErase:
    def test_erase(self):
        x = np.array([[2, 1, 2, 3, 0], [5, 2, 2, 2, 1]], dtype="int32")
        length = np.array([4, 5], dtype="int32")
        got = run_op("sequence_erase", {"X": x, "Length": length},
                     {"tokens": [2]}, ("Out", "Length"))
        np.testing.assert_array_equal(
            got["Out"], [[1, 3, 0, 0, 0], [5, 1, 0, 0, 0]])
        np.testing.assert_array_equal(got["Length"], [2, 2])


class TestSequenceExpandAs:
    def test_expand_as(self):
        rng = np.random.RandomState(3)
        x = rng.rand(2, 3).astype("float32")
        y = rng.rand(2, 4, 3).astype("float32")
        length = np.array([2, 4], dtype="int32")
        exp = np.broadcast_to(x[:, None], (2, 4, 3)) * _mask(length,
                                                             4)[..., None]
        check_output("sequence_expand_as", {"X": x, "Y": y,
                                            "Length": length}, {},
                     {"Out": exp.astype("float32")})


class TestSequenceEnumerate:
    def test_enumerate(self):
        x = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], dtype="int32")
        length = np.array([3, 4], dtype="int32")
        got = run_op("sequence_enumerate", {"X": x, "Length": length},
                     {"win_size": 2, "pad_value": 0})
        np.testing.assert_array_equal(
            got["Out"], [[[1, 2], [2, 3], [3, 0], [0, 0]],
                         [[5, 6], [6, 7], [7, 8], [8, 0]]])


class TestSequenceReshape:
    def test_reshape(self):
        x = np.arange(2 * 4 * 6, dtype="float32").reshape(2, 4, 6)
        length = np.array([2, 4], dtype="int32")
        got = run_op("sequence_reshape", {"X": x, "Length": length},
                     {"new_dim": 3}, ("Out", "Length"))
        np.testing.assert_allclose(got["Out"], x.reshape(2, 8, 3))
        np.testing.assert_array_equal(got["Length"], [4, 8])


class TestSequenceScatter:
    def test_scatter(self):
        x = np.zeros((2, 6), dtype="float32")
        ids = np.array([[0, 2, 2], [5, 1, 0]], dtype="int32")
        upd = np.ones((2, 3), dtype="float32")
        length = np.array([3, 2], dtype="int32")
        check_output("sequence_scatter", {"X": x, "Ids": ids, "Updates": upd,
                                          "Length": length}, {},
                     {"Out": np.array([[1, 0, 2, 0, 0, 0],
                                       [0, 1, 0, 0, 0, 1]], "float32")})


class TestSequenceTopkAvgPooling:
    def test_topk_avg(self):
        rng = np.random.RandomState(9)
        x = rng.randn(2, 3, 5).astype("float32")
        length = np.array([4, 2], dtype="int32")
        topks = [1, 3]
        exp = np.zeros((2, 3 * len(topks)), dtype="float32")
        for b in range(2):
            for c in range(3):
                vals = np.sort(x[b, c, :length[b]])[::-1]
                for ki, k in enumerate(topks):
                    exp[b, c * len(topks) + ki] = vals[:min(k,
                                                            length[b])].mean()
        check_output("sequence_topk_avg_pooling", {"X": x, "Length": length},
                     {"topks": topks}, {"Out": exp})


class TestSequenceLayers:
    """The sequence layers wire into a trainable program, in both packages
    alike."""

    def test_seq_conv_pool_pipeline_trains(self):
        def build(pkg):
            layers = pkg.layers
            main, startup = pkg.Program(), pkg.Program()
            with pkg.program_guard(main, startup):
                x = layers.data("x", shape=[6, 8], dtype="float32")
                length = layers.data("len", shape=[], dtype="int32")
                label = layers.data("y", shape=[1], dtype="float32")
                h = layers.sequence_conv(x, num_filters=8, filter_size=3,
                                         length=length, act="relu")
                pooled = layers.sequence_pool(h, "max", length=length)
                pred = layers.fc(pooled, size=1)
                loss = layers.reduce_mean(layers.square(
                    layers.elementwise_sub(pred, label)))
                pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
            return main, startup, [loss]

        rng = np.random.RandomState(0)
        feed = {"x": rng.randn(4, 6, 8).astype("float32"),
                "len": np.array([3, 6, 2, 5], dtype="int32"),
                "y": rng.randn(4, 1).astype("float32")}
        (jouts, touts), _, _ = run_both(build, lambda i: feed, 5)
        tl = [float(o[0]) for o in touts]
        np.testing.assert_allclose(tl, [float(o[0]) for o in jouts],
                                   rtol=1e-5)
        assert tl[-1] < tl[0], f"sequence pipeline did not train: {tl}"


class TestIm2Sequence:
    @staticmethod
    def _ref(x, kh, kw, sh, sw, pads):
        n = x.shape[0]
        xp = np.pad(x, ((0, 0), (0, 0), (pads[0], pads[2]),
                        (pads[1], pads[3])))
        oh = (xp.shape[2] - kh) // sh + 1
        ow = (xp.shape[3] - kw) // sw + 1
        return np.stack([xp[i, :, oy * sh:oy * sh + kh,
                            ox * sw:ox * sw + kw].reshape(-1)
                         for i in range(n) for oy in range(oh)
                         for ox in range(ow)])

    def test_numeric(self):
        x = np.random.RandomState(0).randn(2, 3, 7, 5).astype("float32")
        attrs = {"kernels": [3, 2], "strides": [2, 1],
                 "paddings": [1, 0, 1, 0]}
        check_output("im2sequence", {"X": x}, attrs,
                     {"Out": self._ref(x, 3, 2, 2, 1, [1, 0, 1, 0])})

    def test_grad(self):
        x = np.random.RandomState(1).randn(1, 2, 5, 4).astype("float32")
        check_grad("im2sequence", {"X": x},
                   {"kernels": [2, 2], "strides": [1, 1],
                    "paddings": [0, 0, 0, 0]}, "X")
