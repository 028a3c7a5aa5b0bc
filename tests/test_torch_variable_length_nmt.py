"""Variable-length NMT in the port against the JAX package, on the CPU:
twins of the bucketing and padding-invariance tests of
``tests/test_variable_length_nmt.py`` (the packing tests are twinned in
``tests/test_torch_nmt.py``).

- ``reader.bucket_by_sequence_length``: the port's batches equal the JAX
  package's, array for array, on single-field, multi-field, scalar-field
  and cross-length streams.
- Padding invariance (tiny Transformer, d_model 16, 2 heads, 1 + 1
  layers, dropout 0, ``is_test``): the same tokens padded to 8 and to 12
  give one loss (rtol 1e-5: the loss averages over the non-pad labels),
  junk tokens in the masked padding change nothing (rtol 1e-5), and the
  port's losses equal the JAX package's from its initialized scope (rtol
  1e-5).
- Bucketed training: one program a bucket shape (8 and 16), trained over a
  bucketed stream in both packages from the JAX package's initialized
  scopes: losses rtol 1e-4 (Adam over several steps) and falling in each
  bucket.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import reader as jrd
from paddle_tpu.core import unique_name as jnames
from paddle_tpu.models import transformer_nmt as jnmt
from paddle_tpu_torch import reader as trd
from paddle_tpu_torch.core import unique_name as tnames
from paddle_tpu_torch.models import transformer_nmt as tnmt

from _torch_twin import fresh_port_state

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield from fresh_port_state()


def _both(src, boundaries, batch_sizes, **kw):
    """The port's and the JAX package's batches of one stream."""
    out = []
    for rd in (trd, jrd):
        out.append(list(rd.bucket_by_sequence_length(
            src, boundaries, batch_sizes, **kw)()))
    got, want = out
    assert len(got) == len(want)
    for (gb, gl), (wb, wl) in zip(got, want):
        np.testing.assert_array_equal(gl, wl)
        gb = gb if isinstance(gb, tuple) else (gb,)
        wb = wb if isinstance(wb, tuple) else (wb,)
        for g, w in zip(gb, wb):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    return got


def test_bucket_by_sequence_length_groups_and_pads():
    samples = [[1] * L for L in (3, 5, 9, 4, 15, 2, 8)]
    batches = _both(lambda: iter(samples), [4, 8, 16], 2, pad_value=0)
    shapes = sorted(b.shape for b, lens in batches)
    assert (2, 4) in shapes and (2, 8) in shapes and (2, 16) in shapes
    for b, lens in batches:
        for row, L in zip(b, lens):
            assert row[:L].sum() == L
            assert row[L:].sum() == 0


def test_bucket_multi_field_samples():
    def src():
        yield ([1, 2, 3], [7, 8])
        yield ([4, 5], [9, 9, 9])

    ((f0, f1), lens), = _both(src, [4], 2, pad_value=-1)
    assert f0.shape == (2, 4) and f1.shape == (2, 4)
    np.testing.assert_array_equal(lens, [3, 2])
    assert (f0[0, 3:] == -1).all()


def test_bucket_scalar_and_cross_length_fields():
    def src():
        yield (np.array([1, 2, 3]), 1)
        yield (np.array([4, 5]), 0)

    ((ids, labs), lens), = _both(src, [4], 2)
    assert ids.shape == (2, 4) and labs.shape == (2,)

    def nmt_pairs():
        yield (np.array([1, 2]), np.array([5, 6, 7, 8, 9, 10]))
        yield (np.array([3]), np.array([6, 7]))

    ((srcs, tgts), lens), = _both(nmt_pairs, [4, 8], 2)
    assert srcs.shape == (2, 4) and tgts.shape == (2, 8)


def _masks(src_ids, tgt_ids, pad=0):
    b, ts = src_ids.shape
    tt = tgt_ids.shape[1]
    src_keep = (src_ids != pad).astype("float32")
    src_mask = ((src_keep - 1.0) * 1e4).reshape(b, 1, 1, ts)
    tgt_keep = (tgt_ids != pad).astype("float32")
    causal = np.tril(np.ones((tt, tt), "float32"))
    m = np.minimum(causal[None], tgt_keep[:, None, :])
    tgt_mask = ((m - 1.0) * 1e4).reshape(b, 1, tt, tt)
    return src_mask, tgt_mask


def _feed_for(src, tgt):
    lbl = np.concatenate([tgt[:, 1:], np.zeros((tgt.shape[0], 1), "int64")],
                         axis=1)[..., None]
    sm, tm = _masks(src, tgt)
    return {"src_ids": src, "tgt_ids": tgt, "lbl_ids": lbl,
            "src_mask": sm, "tgt_mask": tm}


def _cfg(nmt):
    return nmt.TransformerConfig(src_vocab=64, tgt_vocab=64, d_model=16,
                                 n_heads=2, d_ff=32, n_enc=1, n_dec=1,
                                 dropout=0.0, max_len=16)


def _jax_init(L, is_test, seed=11):
    """The JAX package's program at bucket L and its initialized state."""
    with jnames.guard():
        main, startup, _, loss = jnmt.build_train_program(
            _cfg(jnmt), src_len=L, tgt_len=L, is_test=is_test)
    startup.random_seed = seed
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    state = {v.name: np.array(scope.find_var(v.name))
             for v in main.list_vars()
             if v.persistable and scope.find_var(v.name) is not None}
    return main, loss, scope, state


def _port_prog(L, is_test):
    with tnames.guard():
        main, _, _, loss = tnmt.build_train_program(
            _cfg(tnmt), src_len=L, tgt_len=L, is_test=is_test)
    return main, loss


def test_nmt_padding_invariance():
    """The same tokens padded to 8 and to 12 give one is_test loss under
    shared parameters, junk in the masked padding changes nothing, and the
    port equals the JAX package on both paddings."""
    rng = np.random.RandomState(0)
    src8 = rng.randint(1, 64, (2, 8)).astype("int64")
    tgt8 = rng.randint(1, 64, (2, 8)).astype("int64")
    src12 = np.zeros((2, 12), "int64")
    src12[:, :8] = src8
    tgt12 = np.zeros((2, 12), "int64")
    tgt12[:, :8] = tgt8
    _, _, _, state = _jax_init(12, True)
    exe = tfluid.Executor(tfluid.CPUPlace())
    losses = {}
    for L, (s, t) in {8: (src8, tgt8), 12: (src12, tgt12)}.items():
        jmain, jloss, jscope, _ = _jax_init(L, True)
        with jfluid.scope_guard(jscope):
            for n, a in state.items():
                jscope.set_var(n, a)
            (jl,) = jfluid.Executor(jfluid.CPUPlace()).run(
                jmain, feed=_feed_for(s, t), fetch_list=[jloss])
        main, loss = _port_prog(L, True)
        scope = tfluid.Scope()
        tfluid.io.load_params_from_numpy(state, scope=scope)
        (tl,) = exe.run(main, feed=_feed_for(s, t), fetch_list=[loss],
                        scope=scope)
        np.testing.assert_allclose(float(tl), float(np.asarray(jl)),
                                   rtol=1e-5)
        losses[L] = float(tl)
    # the loss averages over the non-pad labels: padding does not move it
    np.testing.assert_allclose(losses[12], losses[8], rtol=1e-5)
    junk = src12.copy()
    junk[:, 8:] = 63
    feed = _feed_for(junk, tgt12)
    feed["src_mask"], feed["tgt_mask"] = _masks(src12, tgt12)
    main, loss = _port_prog(12, True)
    scope = tfluid.Scope()
    tfluid.io.load_params_from_numpy(state, scope=scope)
    (l_junk,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    np.testing.assert_allclose(float(l_junk), losses[12], rtol=1e-5)
    assert np.isfinite(list(losses.values())).all()


def test_nmt_bucketed_training_matches_jax():
    """Bucketed training: one program per bucket (8, 16), each started
    from the JAX package's initialized scope, over the same bucketed
    stream in both packages."""
    def gen():
        rng2 = np.random.RandomState(1)
        for _ in range(8):
            L = int(rng2.choice([5, 7, 11, 14]))
            yield (rng2.randint(1, 64, L).astype("int64"),
                   rng2.randint(1, 64, L).astype("int64"))

    progs = {}
    for L in (8, 16):
        jmain, jloss, jscope, state = _jax_init(L, False, seed=3 + L)
        progs[L] = (jmain, jloss, jscope, state) + _port_prog(L, False)
    curves = {L: ([], []) for L in progs}
    texe = tfluid.Executor(tfluid.CPUPlace())
    jexe = jfluid.Executor(jfluid.CPUPlace())
    tscopes = {}
    for L, (_, _, _, state, _, _) in progs.items():
        tscopes[L] = tfluid.Scope()
        tfluid.io.load_params_from_numpy(state, scope=tscopes[L])
    for _ in range(3):
        for (srcs, tgts), lens in trd.bucket_by_sequence_length(
                gen, [8, 16], batch_sizes=2, pad_value=0)():
            L = srcs.shape[1]
            jmain, jloss, jscope, _, tmain, tloss = progs[L]
            feed = _feed_for(srcs, tgts)
            with jfluid.scope_guard(jscope):
                (jl,) = jexe.run(jmain, feed=feed, fetch_list=[jloss])
            (tl,) = texe.run(tmain, feed=feed, fetch_list=[tloss],
                             scope=tscopes[L])
            curves[L][0].append(float(np.asarray(jl)))
            curves[L][1].append(float(tl))
    for L, (jc, tc) in curves.items():
        assert len(tc) >= 2, f"bucket {L} never ran"
        np.testing.assert_allclose(tc, jc, rtol=1e-4)
        assert tc[-1] < tc[0], (L, tc)
