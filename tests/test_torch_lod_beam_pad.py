"""The port's LoD types (``core/lod.py``), beam-search layers
(``layers/rnn.py`` over ``ops/beam_ops.py``) and the pad / space_to_depth
layers against the JAX package, on the CPU: twins of
``tests/test_api_parity.py::test_lod_tensor_roundtrip``, the two beam tests
of ``tests/test_control_flow_rnn.py`` and the space-to-depth check of
``tests/test_misc_ops.py``. Outputs are equal (ids, LoD) or within rtol
1e-6 (scores, pads) of the JAX package's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

from _torch_twin import fresh_port_state

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield from fresh_port_state()


def run_prog(fluid, build, feed):
    """Build a program with `build(fluid)` (returns its fetch vars) and run
    it once on the CPU."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        fetch = build(fluid)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        return [np.asarray(o) for o in exe.run(main, feed=feed,
                                               fetch_list=fetch)]


def run_both(build, feed):
    got = run_prog(tfluid, build, feed)
    want = run_prog(jfluid, build, feed)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if g.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6)
    return got


def test_lod_tensor_roundtrip():
    """create_lod_tensor parity and the bridge to the padded form: the
    port's LoDTensor holds what the JAX package's holds."""
    flat = np.arange(12, dtype="int64").reshape(6, 2)
    t = tfluid.create_lod_tensor(flat, [[2, 1, 3]])
    j = jfluid.create_lod_tensor(flat, [[2, 1, 3]])
    assert t.recursive_sequence_lengths() == [[2, 1, 3]]
    assert t.lod() == j.lod() == [[0, 2, 3, 6]]
    assert t.has_valid_recursive_sequence_lengths()
    padded, lens = t.to_padded()
    jpadded, jlens = j.to_padded()
    np.testing.assert_array_equal(padded, jpadded)
    np.testing.assert_array_equal(lens, jlens)
    assert padded.shape == (3, 3, 2)
    np.testing.assert_array_equal(lens, [2, 1, 3])
    np.testing.assert_array_equal(padded[0, :2], flat[:2])
    np.testing.assert_array_equal(padded[2], flat[3:6])
    assert padded[0, 2].sum() == 0

    r = tfluid.create_random_int_lodtensor([[2, 3]], [1], low=0, high=9)
    assert r.numpy().shape == (5, 1) and r.numpy().max() <= 9
    with pytest.raises(ValueError):
        tfluid.create_lod_tensor(flat, [[2, 2]])
    nested = tfluid.create_lod_tensor([[1, 2], [3]], [[2, 1]])
    np.testing.assert_array_equal(
        nested.numpy(), jfluid.create_lod_tensor([[1, 2], [3]],
                                                 [[2, 1]]).numpy())
    arr = tfluid.LoDTensorArray([t])
    assert len(arr) == 1 and arr[0] is t


def test_beam_search_step_and_decode():
    batch, beam, vocab = 1, 2, 5

    def build(fluid):
        scores = fluid.layers.data(name="s", shape=[batch, beam, vocab],
                                   dtype="float32", append_batch_size=False)
        pre = fluid.layers.data(name="p", shape=[batch, beam],
                                dtype="float32", append_batch_size=False)
        ids, sel, parent, fin = fluid.layers.beam_search(
            None, pre, scores, beam_size=beam, end_id=0)
        return [ids, sel, parent, fin]

    sv = np.log(np.array([[[.1, .5, .2, .1, .1],
                           [.3, .1, .4, .1, .1]]], "float32"))
    idv, selv, parv, finv = run_both(build, {
        "s": sv, "p": np.zeros((batch, beam), "float32")})
    assert set(map(tuple, np.stack([parv[0], idv[0]], -1))) == {(0, 1),
                                                                (1, 2)}
    assert not finv.any()


def test_beam_search_finished_beams_and_ties():
    """A finished beam carries only its end token at score 0; tied totals
    go to the lower flat index, as lax.top_k breaks them."""
    batch, beam, vocab = 2, 3, 4

    def build(fluid):
        scores = fluid.layers.data(name="s", shape=[batch, beam, vocab],
                                   dtype="float32", append_batch_size=False)
        pre = fluid.layers.data(name="p", shape=[batch, beam],
                                dtype="float32", append_batch_size=False)
        fin = fluid.layers.data(name="f", shape=[batch, beam],
                                dtype="int32", append_batch_size=False)
        return list(fluid.layers.beam_search(None, pre, scores,
                                             beam_size=beam, end_id=3,
                                             pre_finished=fin))

    s = np.log(np.full((batch, beam, vocab), 0.25, "float32"))
    s[1, 2, 1] = np.log(0.9)
    ids, sel, parent, fin = run_both(build, {
        "s": s, "p": np.array([[-1., -1., -1.], [-0.5, -2., -1.]],
                              "float32"),
        "f": np.array([[0, 1, 0], [0, 0, 1]], "int32")})
    assert ids.dtype == parent.dtype == np.int64
    # batch 0: beam 1 is finished at -1: its end token (3) wins outright
    assert (parent[0, 0], ids[0, 0]) == (1, 3) and fin[0, 0]
    # ties among the others break to the lower flat index
    assert list(parent[0, 1:]) == [0, 0] and list(ids[0, 1:]) == [0, 1]


def test_beam_search_decode_backtracks():
    """Hand-built 2-step beam history: decode follows the parent
    pointers."""
    batch, beam, steps = 1, 2, 2
    ids_np = np.array([[[3, 4]], [[7, 8]]], "int64")
    par_np = np.array([[[0, 1]], [[1, 0]]], "int64")
    scores_np = np.array([[0.5, 0.4]], "float32")

    def build(fluid):
        ids = fluid.layers.data(name="ids", shape=[steps, batch, beam],
                                dtype="int64", append_batch_size=False)
        par = fluid.layers.data(name="par", shape=[steps, batch, beam],
                                dtype="int64", append_batch_size=False)
        sc = fluid.layers.data(name="sc", shape=[batch, beam],
                               dtype="float32", append_batch_size=False)
        return list(fluid.layers.beam_search_decode(ids, par, sc))

    sv, ssv = run_both(build, {"ids": ids_np, "par": par_np,
                               "sc": scores_np})
    assert sv.shape == (batch, beam, steps)
    assert list(sv[0, 0]) == [4, 7]
    assert list(sv[0, 1]) == [3, 8]
    np.testing.assert_allclose(ssv, scores_np)


def test_pad_layers_and_space_to_depth():
    """pad (every dim), pad2d (constant, reflect, edge) and
    space_to_depth through the layers, with their static shapes; the
    space_to_depth shape check of test_misc_ops, and its inverse by
    numpy."""
    x = np.random.RandomState(5).randn(2, 3, 4, 4).astype("float32")

    def build(fluid):
        img = fluid.layers.data("x", [3, 4, 4])
        p = fluid.layers.pad(img, [0, 0, 1, 0, 2, 1, 0, 3], pad_value=0.5)
        outs = [p, fluid.layers.space_to_depth(img, 2)]
        for mode in ("constant", "reflect", "edge"):
            outs.append(fluid.layers.pad2d(img, [1, 2, 2, 1], mode=mode,
                                           pad_value=-1.0))
        assert tuple(p.shape) == (None, 4, 7, 7)
        assert tuple(outs[1].shape) == (-1, 12, 2, 2)
        return outs

    p, s2d, *p2 = run_both(build, {"x": x})
    np.testing.assert_array_equal(
        p, np.pad(x, [(0, 0), (1, 0), (2, 1), (0, 3)], constant_values=0.5))
    assert s2d.shape == (2, 12, 2, 2)
    back = s2d.reshape(2, 2, 2, 3, 2, 2).transpose(0, 3, 4, 1, 5, 2)
    np.testing.assert_array_equal(back.reshape(2, 3, 4, 4), x)
    for got, mode in zip(p2, ("constant", "reflect", "edge")):
        kw = {"constant_values": -1.0} if mode == "constant" else {}
        np.testing.assert_array_equal(got, np.pad(
            x, [(0, 0), (0, 0), (1, 2), (2, 1)], mode=mode, **kw))
