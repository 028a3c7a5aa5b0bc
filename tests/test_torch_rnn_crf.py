"""Twins on the port, on the CPU, of tests/test_control_flow_rnn.py's
recurrent, CRF and beam tests, tests/test_book_models.py's two recurrent
book models, tests/test_contrib.py's recurrent tests (plus a
BeamSearchDecoder against the JAX decoder), and the semantic-role-labelling
``db_lstm`` of ``paddle_tpu_torch.models.label_semantic_roles`` at depth 2,
H = 8 over 30 words. Each builds the program in both packages, starts the
port from the JAX package's initialized scope and compares every fetch
(rtol 1e-5, atol 1e-6; ints equal) step for step, and keeps the JAX
test's own check."""
from itertools import product

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as jnames
from paddle_tpu_torch.core import unique_name as tnames
from paddle_tpu_torch.models import label_semantic_roles as srl

from _torch_twin import _port_ints, _state, fresh_port_state, run_both

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield from fresh_port_state()


def _data(fl, name, shape, dtype="float32"):
    return fl.layers.data(name=name, shape=shape, dtype=dtype,
                          append_batch_size=False)


def _close(jouts, touts, rtol=RTOL, atol=ATOL):
    assert len(jouts) == len(touts)
    for js, ts in zip(jouts, touts):
        assert len(js) == len(ts)
        for j, t in zip(js, ts):
            j, t = np.asarray(j), np.asarray(t)
            assert j.shape == t.shape, (j.shape, t.shape)
            if j.dtype.kind in "iub":
                np.testing.assert_array_equal(t, j)
            else:
                np.testing.assert_allclose(t, j, rtol=rtol, atol=atol)


def _twin(build, feeds, steps=None, rtol=RTOL, atol=ATOL):
    n = steps or len(feeds)
    (jouts, touts), _, _ = run_both(
        build, lambda i: feeds[min(i, len(feeds) - 1)], n)
    _close(jouts, touts, rtol, atol)
    return jouts, touts


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


# ---------------------------------------------------------------------------
# LSTM / GRU
# ---------------------------------------------------------------------------

def test_dynamic_lstm_matches_numpy():
    B, T, H = 2, 4, 3
    rng = np.random.RandomState(0)
    xv = rng.randn(B, T, 4 * H).astype("float32") * 0.5
    lv = np.array([3, 4], "int32")

    def build(fl):
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = _data(fl, "x", [B, T, 4 * H])
            length = _data(fl, "len", [B], "int32")
            hidden, cell = fl.layers.dynamic_lstm(
                x, size=4 * H, length=length, use_peepholes=False,
                param_attr=fl.ParamAttr(name="lw"),
                bias_attr=fl.ParamAttr(name="lb"))
        return main, startup, [hidden, cell, "lw", "lb"]

    _, ((hv, _, W, bias),) = _twin(build, [{"x": xv, "len": lv}])
    h = np.zeros((B, H), "float32")
    c = np.zeros((B, H), "float32")
    expect = np.zeros((B, T, H), "float32")
    for t in range(T):
        gi, gf, gc, go = np.split(xv[:, t, :] + h @ W + bias, 4, axis=-1)
        c_new = _sigmoid(gf) * c + _sigmoid(gi) * np.tanh(gc)
        h_new = _sigmoid(go) * np.tanh(c_new)
        m = (t < lv).astype("float32")[:, None]
        h = h_new * m + h * (1 - m)
        c = c_new * m + c * (1 - m)
        expect[:, t] = h
    assert np.allclose(hv, expect, atol=1e-4), np.abs(hv - expect).max()


def test_dynamic_gru_matches_numpy():
    B, T, H = 2, 3, 4
    xv = np.random.RandomState(1).randn(B, T, 3 * H).astype("float32") * 0.5

    def build(fl):
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = _data(fl, "x", [B, T, 3 * H])
            hidden = fl.layers.dynamic_gru(
                x, size=H, param_attr=fl.ParamAttr(name="gw"),
                bias_attr=fl.ParamAttr(name="gb"))
        return main, startup, [hidden, "gw", "gb"]

    _, ((hv, W, bias),) = _twin(build, [{"x": xv}])
    h = np.zeros((B, H), "float32")
    expect = np.zeros((B, T, H), "float32")
    for t in range(T):
        xg = xv[:, t, :2 * H] + bias[:2 * H]
        xc = xv[:, t, 2 * H:] + bias[2 * H:]
        u, r = np.split(_sigmoid(xg + h @ W[:, :2 * H]), 2, axis=-1)
        cand = np.tanh(xc + (r * h) @ W[:, 2 * H:])
        h = (1 - u) * h + u * cand
        expect[:, t] = h
    assert np.allclose(hv, expect, atol=1e-4)


def test_multilayer_bidirec_lstm():
    B, T, D, H = 2, 5, 6, 4

    def build(fl):
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = _data(fl, "x", [B, T, D])
            out, lh, lc = fl.layers.lstm(x, hidden_size=H, num_layers=2,
                                         is_bidirec=True)
        return main, startup, [out, lh, lc]

    xv = np.random.RandomState(0).randn(B, T, D).astype("float32")
    _, ((res, lhv, lcv),) = _twin(build, [{"x": xv}])
    assert res.shape == (B, T, 2 * H) and lhv.shape == (4, B, H)
    assert lcv.shape == (4, B, H)


# ---------------------------------------------------------------------------
# CRF
# ---------------------------------------------------------------------------

def _path_score(e, trans, path):
    start_w, end_w, pw = trans[0], trans[1], trans[2:]
    s = start_w[path[0]] + end_w[path[-1]]
    s += sum(e[t, path[t]] for t in range(len(path)))
    return s + sum(pw[path[t], path[t + 1]] for t in range(len(path) - 1))


def test_linear_chain_crf_matches_bruteforce():
    B, T, D = 2, 4, 3
    rng = np.random.RandomState(0)
    emv = rng.randn(B, T, D).astype("float32")
    labv = rng.randint(0, D, (B, T)).astype("int64")
    lenv = np.array([3, 4], "int32")

    def build(fl):
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            em = _data(fl, "em", [B, T, D])
            lab = _data(fl, "lab", [B, T], "int64")
            length = _data(fl, "len", [B], "int32")
            nll = fl.layers.linear_chain_crf(
                em, lab, length=length, param_attr=fl.ParamAttr(name="ct"))
        return main, startup, [nll, "ct"]

    _, ((out, trans),) = _twin(build, [{"em": emv, "lab": labv,
                                        "len": lenv}])
    for b in range(B):
        L = int(lenv[b])
        logz = np.log(np.sum(np.exp([_path_score(emv[b], trans, p)
                                     for p in product(range(D), repeat=L)])))
        gold = _path_score(emv[b], trans, labv[b, :L])
        assert abs(out[b, 0] - (logz - gold)) < 1e-4


def test_crf_decoding_matches_bruteforce():
    B, T, D = 2, 4, 3
    rng = np.random.RandomState(3)
    emv = rng.randn(B, T, D).astype("float32")
    lenv = np.array([4, 3], "int32")
    transv = rng.randn(D + 2, D).astype("float32")

    def build(fl):
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            em = _data(fl, "em", [B, T, D])
            length = _data(fl, "len", [B], "int32")
            path = fl.layers.crf_decoding(
                em, param_attr=fl.ParamAttr(
                    name="crf_trans",
                    initializer=fl.initializer.NumpyArrayInitializer(
                        transv)),
                length=length)
        return main, startup, [path]

    _, ((pv,),) = _twin(build, [{"em": emv, "len": lenv}])
    for b in range(B):
        L = int(lenv[b])
        best = max(product(range(D), repeat=L),
                   key=lambda c: _path_score(emv[b], transv, c))
        assert tuple(pv[b, :L]) == best, (b, pv[b], best)


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

def test_beam_search_step_and_decode():
    batch, beam, vocab = 1, 2, 5

    def step(fl):
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            scores = _data(fl, "s", [batch, beam, vocab])
            pre = _data(fl, "p", [batch, beam])
            ids, sel, parent, fin = fl.layers.beam_search(
                None, pre, scores, beam_size=beam, end_id=0)
        return main, startup, [ids, sel, parent, fin]

    sv = np.log(np.array([[[.1, .5, .2, .1, .1], [.3, .1, .4, .1, .1]]],
                         "float32"))
    _, ((idv, _, parv, _),) = _twin(
        step, [{"s": sv, "p": np.zeros((batch, beam), "float32")}])
    assert set(map(tuple, np.stack([parv[0], idv[0]], -1))) == \
        {(0, 1), (1, 2)}

    T = 2

    def decode(fl):
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            ids = _data(fl, "ids", [T, batch, beam], "int64")
            par = _data(fl, "par", [T, batch, beam], "int64")
            sc = _data(fl, "sc", [batch, beam])
            sent, sent_sc = fl.layers.beam_search_decode(ids, par, sc)
        return main, startup, [sent, sent_sc]

    scores_np = np.array([[0.5, 0.4]], "float32")
    _, ((sent, ssv),) = _twin(decode, [{
        "ids": np.array([[[3, 4]], [[7, 8]]], "int64"),
        "par": np.array([[[0, 1]], [[1, 0]]], "int64"), "sc": scores_np}])
    assert list(sent[0, 0]) == [4, 7] and list(sent[0, 1]) == [3, 8]
    assert np.allclose(ssv, scores_np)


# ---------------------------------------------------------------------------
# book models
# ---------------------------------------------------------------------------

def test_rnn_encoder_decoder():
    src_vocab, tgt_vocab, hid = 25, 20, 16
    rng = np.random.RandomState(0)

    def build(fl):
        L = fl.layers
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            src = L.data(name="src", shape=[6], dtype="int64")
            tgt_in = L.data(name="tgt_in", shape=[5], dtype="int64")
            tgt_out = L.data(name="tgt_out", shape=[5], dtype="int64")
            semb = L.embedding(src, size=[src_vocab, hid])
            enc = L.dynamic_gru(L.fc(semb, size=3 * hid, num_flatten_dims=2),
                                size=hid)
            enc_last = L.reduce_max(enc, dim=1)
            temb = L.embedding(tgt_in, size=[tgt_vocab, hid])
            dec = L.dynamic_gru(L.fc(temb, size=3 * hid, num_flatten_dims=2),
                                size=hid, h_0=enc_last)
            logits = L.fc(dec, size=tgt_vocab, num_flatten_dims=2)
            ce = L.softmax_with_cross_entropy(
                logits, L.reshape(tgt_out, shape=[-1, 5, 1]))
            loss = L.mean(ce)
            fl.optimizer.Adam(learning_rate=0.05).minimize(loss)
        return main, startup, [loss]

    batch = {"src": rng.randint(0, src_vocab, (8, 6)).astype("int64"),
             "tgt_in": rng.randint(0, tgt_vocab, (8, 5)).astype("int64"),
             "tgt_out": rng.randint(0, tgt_vocab, (8, 5)).astype("int64")}
    _, touts = _twin(build, [batch], steps=20)
    losses = [float(o[0]) for o in touts]
    assert losses[-1] < losses[0] * 0.5, losses


def _book_srl(fl, vocab, n_labels, hid, train):
    """tests/test_book_models.py::test_label_semantic_roles's two programs:
    training (train=True) and the decoding program over the same names."""
    L = fl.layers
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        word = L.data(name="word", shape=[6], dtype="int64")
        mark = L.data(name="mark", shape=[6], dtype="int64")
        wemb = L.embedding(word, size=[vocab, hid],
                           param_attr=fl.ParamAttr(name="wemb"))
        memb = L.embedding(mark, size=[2, hid],
                           param_attr=fl.ParamAttr(name="memb"))
        feat = L.concat([wemb, memb], axis=2)
        rnn, _ = L.dynamic_lstm(
            L.fc(feat, size=4 * hid, num_flatten_dims=2,
                 param_attr=fl.ParamAttr(name="proj_w"),
                 bias_attr=fl.ParamAttr(name="proj_b")),
            size=4 * hid, param_attr=fl.ParamAttr(name="lstm_w"),
            bias_attr=fl.ParamAttr(name="lstm_b"))
        emission = L.fc(rnn, size=n_labels, num_flatten_dims=2,
                        param_attr=fl.ParamAttr(name="emis_w"),
                        bias_attr=fl.ParamAttr(name="emis_b"))
        if not train:
            return main, startup, [L.crf_decoding(
                emission, param_attr=fl.ParamAttr(name="crfw"))]
        label = L.data(name="label", shape=[6], dtype="int64")
        loss = L.mean(L.linear_chain_crf(emission, label,
                                         param_attr=fl.ParamAttr(name="crfw")))
        fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, [loss]


def _train_then_decode(fl, train_build, decode_build, feeds, dfeed, init=None,
                       seed=3):
    """(losses, decode fetches, initial state) of `train_build` run over
    `feeds` from `init` (or the package's own startup) then
    `decode_build` in the same scope."""
    names = jnames if fl is jfluid else tnames
    with names.guard():
        main, startup, fetch = train_build(fl)
    with names.guard():
        dmain, _, dfetch = decode_build(fl)
    main.random_seed = startup.random_seed = seed
    scope = fl.Scope()
    with fl.scope_guard(scope):
        exe = fl.Executor(fl.CPUPlace())
        exe.run(startup)
        if init is None:
            init = _state(main, lambda n: (np.array(scope.find_var(n))
                                           if scope.find_var(n) is not None
                                           else None))
        else:
            fl.io.load_params_from_numpy(_port_ints(main, init), scope=scope)
        losses = [exe.run(main, feed=f, fetch_list=fetch) for f in feeds]
        dec = exe.run(dmain, feed=dfeed, fetch_list=dfetch)
    return losses, dec, init


def test_label_semantic_roles():
    vocab, n_labels, hid = 30, 7, 12
    rng = np.random.RandomState(0)
    batch = {"word": rng.randint(0, vocab, (4, 6)).astype("int64"),
             "mark": rng.randint(0, 2, (4, 6)).astype("int64"),
             "label": rng.randint(0, n_labels, (4, 6)).astype("int64")}
    args = (lambda fl: _book_srl(fl, vocab, n_labels, hid, True),
            lambda fl: _book_srl(fl, vocab, n_labels, hid, False),
            [batch] * 15, {"word": batch["word"], "mark": batch["mark"]})
    jl, jdec, init = _train_then_decode(jfluid, *args)
    tl, tdec, _ = _train_then_decode(tfluid, *args, init=init)
    _close(jl, tl)
    losses = [float(o[0]) for o in tl]
    assert losses[-1] < losses[0] * 0.9, losses
    np.testing.assert_array_equal(tdec[0], np.asarray(jdec[0]))
    path = tdec[0]
    assert path.shape[0] == 4 and path.min() >= 0 and path.max() < n_labels


# ---------------------------------------------------------------------------
# the SRL model of the port's model zoo, cut to depth 2, H = 8, 30 words
# ---------------------------------------------------------------------------

TINY_SRL = srl.SRLConfig(word_dict_len=30, pred_dict_len=10,
                         label_dict_len=7, word_dim=8, mark_dim=3,
                         hidden_dim=32, depth=2)


def test_tiny_srl_trains_and_decodes_like_jax():
    cfg = TINY_SRL
    feeds = [srl.make_batch(cfg, 4, seed=s, min_len=3, max_len=9)
             for s in range(3)]
    dfeed = srl.make_batch(cfg, 4, seed=11, min_len=3, max_len=9)
    args = (lambda fl: _srl_train(fl, cfg), lambda fl: _srl_decode(fl, cfg),
            feeds, dfeed)
    jl, jdec, init = _train_then_decode(jfluid, *args)
    tl, tdec, _ = _train_then_decode(tfluid, *args, init=init)
    _close(jl, tl)
    np.testing.assert_array_equal(tdec[0], np.asarray(jdec[0]))
    for j, t in zip(jdec[1:], tdec[1:]):
        np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=RTOL)
    n_inf, n_lab, n_cor = (int(np.asarray(v)[0]) for v in tdec[4:7])
    assert 0 <= n_cor <= min(n_inf, n_lab) and n_lab > 0
    # padded positions decode to 0
    for b, L in enumerate(dfeed["length"]):
        assert (tdec[0][b, L:] == 0).all()


def _srl_train(fl, cfg):
    main, startup, loss = srl.build_train_program(cfg, fl)
    return main, startup, [loss]


def _srl_decode(fl, cfg):
    prog, path, chunks = srl.build_decode_program(cfg, fl)
    return prog, None, [path, *chunks]


# ---------------------------------------------------------------------------
# contrib
# ---------------------------------------------------------------------------

def test_basic_lstm_gru_stacks_train():
    rng = np.random.RandomState(0)

    def build(fl):
        L = fl.layers
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = L.data("x", [6, 8])
            y = L.data("y", [1])
            out, last_h, last_c = fl.contrib.basic_lstm(x, None, None, 16,
                                                        num_layers=2)
            g_out, g_last = fl.contrib.basic_gru(x, None, 16,
                                                 bidirectional=True)
            feat = L.concat([L.reduce_mean(out, dim=1),
                             L.reduce_mean(g_out, dim=1)], axis=1)
            pred = L.fc(feat, 1, bias_attr=False)
            loss = L.mean(L.square_error_cost(pred, y))
            fl.optimizer.Adam(0.01).minimize(loss)
        return main, startup, [loss, out, g_out]

    feed = {"x": rng.rand(4, 6, 8).astype("float32"),
            "y": rng.rand(4, 1).astype("float32")}
    _, touts = _twin(build, [feed], steps=12)
    ls = [float(o[0]) for o in touts]
    assert ls[-1] < ls[0], ls
    assert touts[0][1].shape == (4, 6, 16)
    assert touts[0][2].shape == (4, 6, 32)   # bidirectional concat


def test_basic_lstm_init_and_last_state_contract():
    rng = np.random.RandomState(7)

    def build(fl):
        L = fl.layers
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = L.data("x", [5, 8])
            h0 = L.data("h0", [1, 12], append_batch_size=False)
            c0 = L.data("c0", [1, 12], append_batch_size=False)
            out, lh, lc = fl.contrib.basic_lstm(
                x, L.reshape(h0, [1, 2, 6]), L.reshape(c0, [1, 2, 6]), 6)
            out0, _, _ = fl.contrib.basic_lstm(x, None, None, 6)
        return main, startup, [out, lh, lc, out0]

    feed = {"x": rng.rand(2, 5, 8).astype("float32"),
            "h0": rng.rand(1, 12).astype("float32"),
            "c0": rng.rand(1, 12).astype("float32")}
    _, ((o, l_h, l_c, o0),) = _twin(build, [feed])
    assert l_h.shape == (1, 2, 6) and l_c.shape == (1, 2, 6)
    assert not np.allclose(o, o0)
    np.testing.assert_allclose(l_h[0], o[:, -1], rtol=1e-5, atol=1e-6)


def test_basic_units_dygraph():
    """The units' steps in both packages' dygraph modes, the port's units
    loaded with the JAX units' parameters (by structural order)."""
    from paddle_tpu import contrib as jcontrib
    from paddle_tpu import dygraph as jdy
    from paddle_tpu_torch import dygraph as tdy

    rng = np.random.RandomState(1)
    xv = rng.rand(2, 8).astype("float32")
    hv = rng.rand(2, 8).astype("float32")
    cv = rng.rand(2, 8).astype("float32")

    def run(contrib, dy, guard, states=None):
        with guard():
            lstm = contrib.BasicLSTMUnit(hidden_size=8)
            gru = contrib.BasicGRUUnit(hidden_size=8)
            if states is None:
                states = [lstm.state_dict(), gru.state_dict()]
            else:
                for layer, sd in zip((lstm, gru), states):
                    keys = list(layer.state_dict())
                    layer.set_dict({k2: sd[k1] for k1, k2 in zip(sd, keys)})
            x, h, c = (dy.to_variable(a) for a in (xv, hv, cv))
            nh, nc = lstm(x, h, c)
            nh2 = gru(x, h)
            return [v.numpy() for v in (nh, nc, nh2)], states

    want, states = run(jcontrib, jdy, jdy.guard)
    got, _ = run(tfluid.contrib, tdy, lambda: tdy.guard(tfluid.CPUPlace()),
                 [{k: np.asarray(v) for k, v in sd.items()}
                  for sd in states])
    for g, w in zip(got, want):
        assert g.shape == (2, 8)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_training_decoder():
    rng = np.random.RandomState(2)

    def build(fl):
        L = fl.layers
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            emb = L.data("emb", [5, 4])
            boot = L.data("boot", [8])
            cell = fl.contrib.StateCell(
                inputs={"x": None},
                states={"h": fl.contrib.InitState(init=boot)},
                out_state="h")

            @cell.register_updater
            def _update(sc):
                x, h = sc.get_input("x"), sc.get_state("h")
                sc.set_state("h", L.fc(
                    L.concat([x, h], axis=1), 8, act="tanh",
                    param_attr=fl.ParamAttr(name="dec_w"),
                    bias_attr=fl.ParamAttr(name="dec_b")))

            dec = fl.contrib.TrainingDecoder(cell)
            with dec.block():
                w = dec.step_input(emb)
                cell.compute_state(inputs={"x": w})
                dec.output(cell.get_state("h"))
            out = dec()
        return main, startup, [out, "dec_w", "dec_b"]

    ev = rng.rand(3, 5, 4).astype("float32")
    bv = rng.rand(3, 8).astype("float32")
    _, ((o, w_, b_),) = _twin(build, [{"emb": ev, "boot": bv}])
    assert o.shape == (3, 5, 8)
    h = bv
    for t in range(5):
        h = np.tanh(np.concatenate([ev[:, t], h], 1) @ w_ + b_)
        np.testing.assert_allclose(o[:, t], h, rtol=1e-4, atol=1e-5)


def test_beam_search_decoder():
    """BeamSearchDecoder unrolled 4 steps over a GRU-ish state cell, beam 3
    over 11 tokens: ids and scores equal to the JAX decoder's at the same
    weights."""
    batch, beam, vocab, hid, steps = 2, 3, 11, 6, 4

    def build(fl):
        L = fl.layers
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            boot = L.data("boot", [batch, beam, hid],
                          append_batch_size=False)
            init_ids = L.data("init_ids", [batch, beam], dtype="int64",
                              append_batch_size=False)
            init_scores = L.data("init_scores", [batch, beam],
                                 append_batch_size=False)
            cell = fl.contrib.StateCell(
                inputs={"x": None},
                states={"h": fl.contrib.InitState(init=boot)},
                out_state="h")

            @cell.register_updater
            def _update(sc):
                x, h = sc.get_input("x"), sc.get_state("h")
                sc.set_state("h", L.fc(
                    L.concat([x, h], axis=2), hid, act="tanh",
                    num_flatten_dims=2, param_attr=fl.ParamAttr(name="bw"),
                    bias_attr=fl.ParamAttr(name="bb")))

            def embed(ids):
                return {"x": L.embedding(
                    ids, size=[vocab, 5], param_attr=fl.ParamAttr(name="be"))}

            def score(h):   # the step's scores over the vocabulary
                return L.softmax(L.fc(h, vocab, num_flatten_dims=2,
                                      param_attr=fl.ParamAttr(name="sw"),
                                      bias_attr=fl.ParamAttr(name="sb")))

            dec = fl.contrib.BeamSearchDecoder(
                cell, init_ids, init_scores, target_dict_dim=vocab,
                word_dim=5, beam_size=beam, max_len=steps, end_id=0,
                embedding_fn=embed, score_fn=score)
            ids, scores = dec.decode()()
        return main, startup, [ids, scores]

    rng = np.random.RandomState(4)
    feed = {"boot": rng.randn(batch, beam, hid).astype("float32"),
            "init_ids": np.ones((batch, beam), "int64"),
            "init_scores": np.array([[0.0, -1e9, -1e9]] * batch, "float32")}
    _, ((ids, scores),) = _twin(build, [feed])
    assert ids.shape == (batch, beam, steps)
    assert (ids >= 0).all() and (ids < vocab).all()
