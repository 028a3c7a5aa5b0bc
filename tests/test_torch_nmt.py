"""The port's Transformer NMT builder and packing reader against the JAX
package's, on the CPU.

Structure: for bucketed, packed-dense and packed-sparse rows both DSLs emit
the same program (op types, slots, attrs, var descs) and the same parameter
names. Parity: a tiny packed-sparse config (d_model 32, 2 heads, d_ff 64,
1 + 1 layers, vocab 64, T = 32, B = 2, dropout 0) trained 3 Adam steps in
both packages from the JAX startup scope: losses within rtol 1e-5, every
parameter within rtol 1e-5 / atol 1e-6 (Adam divides each update by
sqrt(v), which can make a last-bit difference of a near-zero gradient
visible; measured well inside). Inside the port, packed-sparse and
packed-dense compute the same loss within 1e-5. The reader is the port's
own copy: twins of the JAX reader tests, and the same rows bit for bit."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import reader as jreader
from paddle_tpu.core import unique_name as jnames
from paddle_tpu.models import transformer_nmt as jnmt
from paddle_tpu_torch import reader as rd
from paddle_tpu_torch.core import unique_name as tnames
from paddle_tpu_torch.models import transformer_nmt as tnmt

# One intra-op thread: tier-1 runs several xdist workers, and a second
# torch worker thread, started beside JAX's runtime in the same process, was
# seen to compute some batches of a CPU matmul ~1e-4 off.
torch.set_num_threads(1)

T, B = 32, 2


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """Fresh default programs, scope and unique names of the port."""
    from paddle_tpu_torch.core import program as prog_mod
    from paddle_tpu_torch.core import scope as scope_mod

    old = (prog_mod._main_program, prog_mod._startup_program,
           scope_mod._global_scope, scope_mod._current_scope)
    prog_mod._main_program = prog_mod.Program()
    prog_mod._startup_program = prog_mod.Program()
    scope_mod._global_scope = scope_mod._current_scope = scope_mod.Scope()
    with tnames.guard():
        yield
    (prog_mod._main_program, prog_mod._startup_program,
     scope_mod._global_scope, scope_mod._current_scope) = old


def _cfg(nmt, dropout=0.0):
    return nmt.TransformerConfig(src_vocab=64, tgt_vocab=64, d_model=32,
                                 n_heads=2, d_ff=64, n_enc=1, n_dec=1,
                                 dropout=dropout, max_len=T)


def _stream(seed=0, n=40, max_sent=12):
    """A seeded WMT-like stream, the JAX bench's log-normal lengths cut to
    the tiny rows."""
    def gen():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            ls = int(np.clip(rng.lognormal(2.0, 0.5), 2, max_sent))
            lt = int(np.clip(ls * rng.uniform(0.8, 1.25), 2, max_sent))
            yield (rng.randint(1, 64, ls).astype("int32"),
                   rng.randint(1, 64, lt).astype("int32"))
    return gen


def _packed_feed(attn, t=T, b=B):
    rows = list(rd.pack_by_tokens(_stream(), t, t)())[:b]
    stack = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    feed = {"src_ids": stack["src_ids"], "tgt_ids": stack["tgt_ids"],
            "lbl_ids": stack["lbl_ids"][..., None],
            "src_pos": stack["src_pos"], "tgt_pos": stack["tgt_pos"]}
    if attn == "sparse":
        feed.update(src_seg=stack["src_seg"], tgt_seg=stack["tgt_seg"])
    else:
        em, dm, cm = rd.packed_attention_masks(stack["src_seg"],
                                               stack["tgt_seg"])
        feed.update(src_mask=em, tgt_mask=dm, cross_mask=cm)
    return feed


def _build(fluid, nmt, names, packed, attn, dropout=0.0):
    with names.guard():
        return nmt.build_train_program(_cfg(nmt, dropout), T, T,
                                       packed=packed, attn=attn)


def _ops(program):
    return [(op["type"], op["inputs"], op["outputs"], op["attrs"])
            for op in program.to_dict()["blocks"][0]["ops"]]


@pytest.mark.parametrize("packed,attn", [(False, "dense"), (True, "dense"),
                                         (True, "sparse")])
def test_same_program_as_jax(packed, attn):
    jmain, jstart, jfeeds, jloss = _build(jfluid, jnmt, jnames, packed, attn,
                                          dropout=0.1)
    tmain, tstart, tfeeds, tloss = _build(tfluid, tnmt, tnames, packed, attn,
                                          dropout=0.1)
    assert tfeeds == jfeeds and tloss.name == jloss.name
    for jp, tp in ((jmain, tmain), (jstart, tstart)):
        assert _ops(tp) == _ops(jp)
        assert tp.to_dict() == jp.to_dict()
    assert ([p.name for p in tmain.all_parameters()]
            == [p.name for p in jmain.all_parameters()])
    kinds = [op.type for op in tmain.global_block().ops]
    assert kinds.count("flash_attention_sparse") == (3 if attn == "sparse"
                                                     else 0)


def test_bad_attn_modes_raise():
    cfg = _cfg(tnmt)
    with pytest.raises(ValueError, match="'dense' or 'sparse'"):
        tnmt.build_train_program(cfg, T, T, packed=True, attn="flash")
    with pytest.raises(ValueError, match="requires packed=True"):
        tnmt.build_train_program(cfg, T, T, attn="sparse")


def _run_both(feed, steps):
    """3 Adam steps of the tiny packed-sparse program in each package from
    the JAX startup scope. Returns (losses, final parameters) per package."""
    results, state = [], None
    for fluid, nmt, names in ((jfluid, jnmt, jnames),
                              (tfluid, tnmt, tnames)):
        main, startup, _, loss = _build(fluid, nmt, names, True, "sparse")
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            if state is None:
                exe.run(startup)
                state = {v.name: np.asarray(scope.find_var(v.name))
                         for v in main.list_vars() if v.persistable
                         and scope.find_var(v.name) is not None}
            else:
                fluid.io.load_params_from_numpy(state, scope=scope)
            losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                      for _ in range(steps)]
            params = {p.name: np.asarray(scope.find_var(p.name))
                      for p in main.all_parameters()}
        results.append((losses, params))
    return results


def test_packed_sparse_training_matches_jax():
    feed = _packed_feed("sparse")
    # the rows hold several sentences and a pad tail, so tiles are skipped
    assert feed["src_seg"].max() > 1 and (feed["tgt_seg"] == 0).any()
    (jl, jp), (tl, tp) = _run_both(feed, steps=3)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    assert tp.keys() == jp.keys()
    for name in jp:
        np.testing.assert_allclose(tp[name], jp[name], rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_sparse_loss_equals_dense_loss():
    """Inside the port, from the same weights: the block-sparse op (exact
    zeros) and the dense additive -1e4 masks give the same loss."""
    losses, state = [], None
    exe = tfluid.Executor(tfluid.CPUPlace())
    for attn in ("sparse", "dense"):
        main, startup, _, loss = _build(tfluid, tnmt, tnames, True, attn)
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        if state is None:
            state = {p.name: scope.find_np(p.name)
                     for p in main.all_parameters()}
        else:
            tfluid.io.load_params_from_numpy(state, scope=scope)
        # the fetched loss is the one before this step's update
        losses.append(float(exe.run(main, feed=_packed_feed(attn),
                                    fetch_list=[loss], scope=scope)[0]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


# -- reader twins ------------------------------------------------------------

def test_pack_by_tokens_same_rows_as_jax():
    ours = list(rd.pack_by_tokens(_stream(n=200), T, T)())
    theirs = list(jreader.pack_by_tokens(_stream(n=200), T, T)())
    assert len(ours) == len(theirs) > 5
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    masks = rd.packed_attention_masks(
        np.stack([r["src_seg"] for r in ours]),
        np.stack([r["tgt_seg"] for r in ours]))
    jmasks = jreader.packed_attention_masks(
        np.stack([r["src_seg"] for r in theirs]),
        np.stack([r["tgt_seg"] for r in theirs]))
    for a, b in zip(masks, jmasks):
        np.testing.assert_array_equal(a, b)


def test_pack_by_tokens_edge_cases():
    """Oversized pairs are dropped (bucketing's rule), rows split exactly at
    budget boundaries, single-token targets (no trainable position) are
    skipped."""
    pairs = [
        (np.arange(1, 5), np.arange(1, 5)),       # fits
        (np.arange(1, 40), np.arange(1, 6)),      # src over budget → drop
        (np.arange(1, 3), np.array([7])),         # lt = 0 → drop
        (np.arange(1, 9), np.arange(1, 9)),       # fills the rest
        (np.arange(1, 6), np.arange(1, 6)),       # forces a new row
    ]
    rows = list(rd.pack_by_tokens(lambda: iter(pairs), 12, 12)())
    assert len(rows) == 2
    # row 0: pair 0 (src 4, tgt 3) + pair 3 (src 8, tgt 7) = src 12/12
    assert rows[0]["src_seg"].max() == 2
    assert (rows[0]["src_seg"] > 0).sum() == 12
    assert (rows[0]["tgt_seg"] > 0).sum() == 3 + 7
    # row 1: pair 4 alone
    assert rows[1]["src_seg"].max() == 1
    assert (rows[1]["src_seg"] > 0).sum() == 5
    # per-segment positions restart at 0
    assert rows[0]["src_pos"][4] == 0  # first token of segment 2
    # labels are the shifted targets
    np.testing.assert_array_equal(rows[1]["lbl_ids"][:4], np.arange(2, 6))


def test_packed_attention_masks_block_structure():
    """Masks are exactly block-diagonal by segment: no cross-sentence
    attention, pads see nothing and are seen by nothing."""
    src_seg = np.array([[1, 1, 2, 2, 0, 0]])
    tgt_seg = np.array([[1, 2, 2, 0]])
    em, dm, cm = rd.packed_attention_masks(src_seg, tgt_seg)
    keep_e = em[0, 0] == 0
    # src token 0 (seg1) attends seg1 only
    np.testing.assert_array_equal(keep_e[0], [1, 1, 0, 0, 0, 0])
    # pad column/row fully masked
    assert not keep_e[:, 4].any() and not keep_e[4].any()
    keep_c = cm[0, 0] == 0
    # tgt pos 1 (seg2) cross-attends src seg2 only
    np.testing.assert_array_equal(keep_c[1], [0, 0, 1, 1, 0, 0])
    keep_d = dm[0, 0] == 0
    # causal within segment: tgt 2 (seg2) sees tgt 1,2 but not seg1's 0
    np.testing.assert_array_equal(keep_d[2], [0, 1, 1, 0])


def _bucket_feed(src, tgt):
    """One sentence pair as a padded bucketed row with its additive masks."""
    lbl = np.concatenate([tgt[:, 1:], np.zeros((tgt.shape[0], 1), "int64")],
                         axis=1)[..., None]
    b, ts = src.shape
    tt = tgt.shape[1]
    src_mask = (((src != 0).astype("float32") - 1.0) * 1e4).reshape(b, 1, 1,
                                                                     ts)
    causal = np.tril(np.ones((tt, tt), "float32"))
    m = np.minimum(causal[None], (tgt != 0).astype("float32")[:, None, :])
    tgt_mask = ((m - 1.0) * 1e4).reshape(b, 1, tt, tt)
    return {"src_ids": src, "tgt_ids": tgt, "lbl_ids": lbl,
            "src_mask": src_mask, "tgt_mask": tgt_mask}


@pytest.mark.parametrize("attn", ["dense", "sparse"])
def test_packed_rows_match_separate_sentences(attn):
    """A packed row (segment masks or the block-sparse op, per-segment
    positions) computes the token-weighted loss the same sentences compute
    as separate padded rows, under the same parameters."""
    cfg = tnmt.TransformerConfig(src_vocab=64, tgt_vocab=64, d_model=16,
                                 n_heads=2, d_ff=32, n_enc=2, n_dec=2,
                                 dropout=0.0, max_len=32)
    rng = np.random.RandomState(3)
    pairs = [(rng.randint(1, 64, ls).astype("int64"),
              rng.randint(1, 64, lt).astype("int64"))
             for ls, lt in [(5, 6), (4, 4), (6, 5)]]
    ts = tt = 16
    (row,) = list(rd.pack_by_tokens(lambda: iter(pairs), ts, tt)())
    assert row["src_seg"].max() == 3
    feed = {"src_ids": row["src_ids"][None].astype("int64"),
            "tgt_ids": row["tgt_ids"][None].astype("int64"),
            "lbl_ids": row["lbl_ids"][None, :, None].astype("int64"),
            "src_pos": row["src_pos"][None].astype("int64"),
            "tgt_pos": row["tgt_pos"][None].astype("int64")}
    if attn == "sparse":
        feed.update(src_seg=row["src_seg"][None], tgt_seg=row["tgt_seg"][None])
    else:
        em, dm, cm = rd.packed_attention_masks(row["src_seg"][None],
                                               row["tgt_seg"][None])
        feed.update(src_mask=em, tgt_mask=dm, cross_mask=cm)
    exe = tfluid.Executor(tfluid.CPUPlace())
    pmain, pstart, _, ploss = tnmt.build_train_program(
        cfg, ts, tt, is_test=True, packed=True, attn=attn)
    pstart.random_seed = 7
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(pstart)
        packed_loss = float(exe.run(pmain, feed=feed, fetch_list=[ploss])[0])

    # the same sentences, each as its own padded row under the same seeded
    # init (parameter names are shared across the programs); a fresh scope
    # each, since the train program updates the parameters when run
    length = 8
    umain, ustart, _, uloss = tnmt.build_train_program(cfg, length, length,
                                                       is_test=True)
    ustart.random_seed = 7
    tok_losses = []
    for src, tgt in pairs:
        with tfluid.scope_guard(tfluid.Scope()):
            exe.run(ustart)
            s = np.zeros((1, length), "int64")
            s[0, :len(src)] = src
            t = np.zeros((1, length), "int64")
            t[0, :len(tgt)] = tgt
            li = float(exe.run(umain, feed=_bucket_feed(s, t),
                               fetch_list=[uloss])[0])
            tok_losses.append((li, len(tgt) - 1))
    expected = (sum(l * n for l, n in tok_losses)
                / sum(n for _, n in tok_losses))
    np.testing.assert_allclose(packed_loss, expected, rtol=2e-5, atol=1e-6)


def test_length_buckets():
    assert tnmt.length_buckets([3, 33, 64, 300]) == [32, 64, 64, 256]
    assert (tnmt.length_buckets([3, 33, 64, 300])
            == jnmt.length_buckets([3, 33, 64, 300]))
