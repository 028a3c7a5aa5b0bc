"""The port's tensor parallelism against the JAX package, on the CPU: the
port on 4 gloo ranks (one world for this file, ``torch_dist_runner.World``)
as a {"dp": 2, "tp": 2} mesh, the JAX package in this process on 4 of the
conftest's 8 virtual devices with a mesh of the same shape, and on one
device. The port's ranks start from the JAX startup's parameters.

Twins of tests/test_parallel.py's tensor-parallel tests (their tolerance
for the TP run against the unsharded one: losses rtol 5e-3, atol 1e-4),
tests/test_sparse_embedding.py's tp-sharded table and
tests/test_checkpoint.py's two mesh tests. The port is held to the JAX
package at the same mesh within 1e-5 relative (losses of a few steps;
the ranks sum row-parallel halves in another order than XLA) and to
itself across the tp ranks bitwise: every replicated persistable has the
same bytes on every rank after every step. Also the port's own checks:
the dropout op's slice of the whole mask, attention on a rank's heads,
the vocab-parallel lookup and cross entropy against the whole vocab, the
gather-whole rule on an op that declares nothing, ragged SelectedRows
across the data axis, DeepFM's vocab-sharded packed table, and what a tp
mesh refuses.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import torch_dist_runner as R

torch.set_num_threads(1)

N = 4
MESH = {"dp": 2, "tp": 2}
RTOL = 1e-5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One world of 4 ranks for the file, started again after a case
    failed (a failed case tears its world down)."""
    tmp = tmp_path_factory.mktemp("tp_world")
    live = {}

    def get():
        w = live.get("w")
        if w is None or not w.alive:
            w = live["w"] = R.World(N, tmp)
        return w

    yield get
    if "w" in live:
        live["w"].close()


def _losses(res):
    return [float(np.frombuffer(b, "float32").reshape(-1)[0])
            for b in res["losses"]]


def _dp_rows(feed, rank):
    """Rank r's rows of a {"dp": 2, "tp": 2} mesh: the tp ranks of one
    data row feed the same rows."""
    return R.rows(feed, rank // MESH["tp"], MESH["dp"])


def _port_tp(world, model, feed, steps=3, **kw):
    state = R.jax_state(jfluid, model, **kw.get("model_kw", {}))
    return world().run("tp", [dict(model=model, feed=_dp_rows(feed, r),
                                   axes=MESH, state=state, steps=steps,
                                   **kw) for r in range(N)])


def _assert_replicated_bitwise(res):
    """Every replicated persistable: the same bytes on every rank after
    every step (the dp sum and Megatron's f keep them so)."""
    for step in range(len(res[0]["hashes"])):
        for r in res[1:]:
            assert r["hashes"][step] == res[0]["hashes"][step], step
    assert res[0]["hashes"][0]


def _twin(world, model, feed, steps=3, jax_rtol=5e-3, **kw):
    ref, _ = R.jax_run(jfluid, model, feed, None, tp=False, steps=steps,
                       **kw.get("model_kw", {}))
    jtp, _ = R.jax_run(jfluid, model, feed, MESH, steps=steps,
                       **kw.get("model_kw", {}))
    np.testing.assert_allclose(ref, jtp, rtol=jax_rtol, atol=1e-4)
    res = _port_tp(world, model, feed, steps, **kw)
    for r in res:
        np.testing.assert_allclose(_losses(r), jtp, rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(_losses(r), ref, rtol=jax_rtol, atol=1e-4)
    _assert_replicated_bitwise(res)
    return res


# -- twins of tests/test_parallel.py -----------------------------------------

@pytest.mark.parametrize("flash", [True, False])
def test_tensor_parallel_bert_annotation_and_equality(world, flash):
    """TP=2 BERT (BertConfig(tp_axis="tp")) == the unsharded step; the
    port's slices are the Megatron specs the JAX package places. flash:
    the fused attention op on each rank's heads (BERT's fused qkv split
    gathered whole and re-sliced by heads); else the reshape / transpose /
    matmul / softmax chain on the heads dim."""
    res = _twin(world, "bert", R.tp_bert_feed(), model_kw={"flash": flash},
                fetch_state=False)
    from paddle_tpu.core import unique_name as jnames

    with jnames.guard():
        jmain, _, _ = R.build_tp_bert(jfluid, True, flash)
    specs = {p.name: tuple(p.shard_spec) for p in jmain.all_parameters()
             if getattr(p, "shard_spec", None)}
    assert len(specs) == 2 * 6 + 3
    info = res[0]["info"]
    for name, spec in specs.items():
        local, whole, _ = info[name]
        d = spec.index("tp")
        assert local[d] * 2 == whole[d], name


def test_tensor_parallel_nmt_equality(world):
    """TP=2 Transformer NMT through annotate_tp(main, NMT_RULES): separate
    q/k/v column shards fall on whole heads; the vocab-sharded embeddings
    and output projection."""
    _twin(world, "nmt", R.tp_nmt_feed(), fetch_state=False)


def test_annotate_tp_warns_on_zero_matches():
    from paddle_tpu_torch import parallel as tparallel
    import paddle_tpu_torch as tfluid

    for fluid, tpm in ((jfluid, R._tp_module(jfluid)),
                       (tfluid, tparallel.tensor_parallel)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [8])
            fluid.layers.fc(x, 4)
        with pytest.warns(UserWarning, match="matched ZERO"):
            assert tpm.annotate_tp(main, tpm.MEGATRON_RULES) == 0


def _both(build):
    import paddle_tpu_torch as tfluid
    from paddle_tpu_torch.core import unique_name as tnames

    out = []
    for fluid, guard in ((jfluid, jfluid.core.unique_name.guard),
                         (tfluid, tnames.guard)):
        with guard():
            out.append(build(fluid))
    return out


def test_structural_tp_derivation_matches_hand_rules():
    """derive_tp_specs reproduces the hand rules on BERT-base, Transformer-
    big and DeepFM at Criteo vocab, and the port's derivation equals the
    JAX package's on the same programs."""
    def models(fluid):
        m = R._models(fluid)
        cfg = m.bert.BertConfig(vocab_size=30522, hidden_size=768,
                                num_layers=2, num_heads=12, ffn_size=3072,
                                max_position=512, hidden_dropout=0.1,
                                attn_dropout=0.1, use_flash_attention=False)
        bmain = m.bert.build_pretrain_program(cfg, 2, 16)[0]
        nmain = m.transformer_nmt.build_train_program(
            m.transformer_nmt.TransformerConfig(), 16, 16)[0]
        dmain = m.deepfm.build_train_program(vocab_size=1_000_000,
                                             is_sparse=False)[0]
        tpm = R._tp_module(fluid)
        out = []
        for prog, rules in ((bmain, tpm.MEGATRON_RULES),
                            (nmain, tpm.NMT_RULES),
                            (dmain, tpm.DEEPFM_RULES)):
            for p in prog.all_parameters():
                p.shard_spec = None
            derived = {k: tuple(v)
                       for k, v in tpm.derive_tp_specs(prog).items()}
            tpm.annotate_tp(prog, rules)
            hand = {p.name: tuple(p.shard_spec)
                    for p in prog.all_parameters()
                    if getattr(p, "shard_spec", None)}
            out.append((derived, hand))
        return out

    jax_side, port_side = _both(models)
    for (jd, jh), (td, th) in zip(jax_side, port_side):
        assert td == th
        assert td == jd and th == jh


def test_structural_tp_transpose_and_inference_head():
    """A tied embedding head (matmul transpose_y=True) shards the vocab
    dim; a plain-softmax inference head still derives."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            ids = fluid.layers.data("ids", [8], dtype="int64")
            emb = fluid.layers.embedding(
                ids, [4096, 512], param_attr=fluid.ParamAttr(name="tied_emb"))
            h = fluid.layers.fc(emb, 512, num_flatten_dims=2, act="relu",
                                param_attr=fluid.ParamAttr(name="t.w"),
                                bias_attr=False)
            table = main.global_block().var("tied_emb")
            logits = fluid.layers.matmul(h, table, transpose_y=True)
            fluid.layers.softmax(logits)
        return R._tp_module(fluid).derive_tp_specs(
            main, min_embed_rows=1024, min_matmul_dim=256)

    jspecs, tspecs = _both(build)
    assert tspecs.get("tied_emb") == ("tp", None), tspecs
    assert {k: tuple(v) for k, v in tspecs.items()} == {
        k: tuple(v) for k, v in jspecs.items()}


# -- the port's own checks ---------------------------------------------------

def test_replicated_parameters_bitwise_equal_across_tp_ranks(world):
    """Adam on the TP BERT at hidden dropout 0.1: the tp ranks of a data
    row draw the same masks for replicated values (the generator is folded
    with the dp coordinate only), so every replicated parameter stays
    bitwise equal on every rank, step after step; the losses are the
    whole batch's on every rank."""
    state = R.jax_state(jfluid, "bert", opt="adam")
    feeds = [R.tp_bert_feed()] * 3
    res = world().run("tp", [dict(
        model="bert", feed=[_dp_rows(f, r) for f in feeds], axes=MESH,
        state=state, steps=3, fetch_state=False,
        model_kw={"opt": "adam"}) for r in range(N)])
    _assert_replicated_bitwise(res)
    for r in res[1:]:
        assert r["losses"] == res[0]["losses"]
    assert np.isfinite(_losses(res[0])).all()


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_tensor_parallel_under_zero_stages(world, stage):
    """ZeRO on the data axis of a dp2×tp2 mesh: the replicated parameters
    and their Adam state shard over dp (the tp slices and their state do
    not), and the losses and final parameters are bitwise stage off's."""
    state = R.jax_state(jfluid, "bert", opt="adam")
    feed = R.tp_bert_feed()

    def run(st):
        return world().run("tp", [dict(
            model="bert", feed=_dp_rows(feed, r), axes=MESH, state=state,
            steps=2, stage=st, model_kw={"opt": "adam"})
            for r in range(N)])

    off, on = run(0), run(stage)
    for a, b in zip(off, on):
        assert a["losses"] == b["losses"]
        for name, v in a["state"].items():
            np.testing.assert_array_equal(b["state"][name], v, err_msg=name)
    info = on[0]["info"]
    moment = "encoder_0.ln1.scale_AdamOptimizer_moment1"
    assert info[moment][2] is not None     # ZeRO-sharded over dp
    assert info["encoder_0.qkv.w_AdamOptimizer_moment1"][0][1] * 2 == \
        info["encoder_0.qkv.w_AdamOptimizer_moment1"][1][1]  # tp slice


def test_run_batched_and_train_scanned_on_a_tp_mesh(world):
    """Executor.run_batched and train_scanned (K = 2) take a program on a
    dp2×tp2 mesh as they take one on a dp mesh: their losses are bitwise
    those of the same steps through Executor.run."""
    state = R.jax_state(jfluid, "gather_mlp")
    rng = np.random.RandomState(8)
    feeds = [{"x": rng.rand(32, 16).astype("float32"),
              "y": rng.rand(32, 1).astype("float32")} for _ in range(4)]
    got = world().run("tp_batched", [dict(
        model="gather_mlp", feed_list=[_dp_rows(f, r) for f in feeds],
        axes=MESH, state=state) for r in range(N)])
    for runs in got:
        assert runs[0] == runs[1] == runs[2] == got[0][0]


def test_dropout_mask_is_the_slice_of_the_whole_mask():
    """The dropout op on a slice along dim d (a tp rank's part of an S
    value) draws the whole value's mask and keeps its slice: the tp = 2
    masks laid end to end equal tp = 1's bitwise."""
    from paddle_tpu_torch.core.executor import ExecContext
    from paddle_tpu_torch.core.mesh_step import TPShard
    from paddle_tpu_torch.core.registry import get_op

    x = torch.ones(4, 6, 8)
    attrs = {"dropout_prob": 0.3,
             "dropout_implementation": "upscale_in_train"}
    fn = get_op("dropout").fn

    def mask(dim=None, rank=0, n=1):
        ctx = ExecContext("cpu", torch.Generator().manual_seed(5))
        part = x if dim is None else x.chunk(n, dim)[rank]
        if dim is not None:
            ctx.tp_in = {"X": [TPShard(dim, rank, n, None)]}
        return fn(ctx, {"X": [part]}, attrs)["Mask"][0]

    whole = mask()
    assert 0 < float(whole.mean()) < 1
    for dim in (1, 2):
        got = torch.cat([mask(dim, r, 2) for r in range(2)], dim)
        assert torch.equal(got, whole)


def test_attention_dropout_on_a_head_slice_raises():
    """Attention dropout on a model-axis slice of the heads no longer
    raises: each rank's op draws its heads of the whole run's mask (the
    seed becomes the kernels' key with the rank's head offset), so the
    ranks' outputs laid end to end along the heads equal the whole-head
    op's, bitwise, at the same generator state."""
    from paddle_tpu_torch.core.executor import ExecContext
    from paddle_tpu_torch.core.mesh_step import TPShard
    from paddle_tpu_torch.core.registry import get_op

    g = torch.Generator().manual_seed(5)
    b, t, nh, d = 2, 64, 4, 16
    q, k, v = (torch.randn(b, t, nh * d, generator=g) for _ in range(3))
    fn = get_op("flash_attention").fn
    attrs = {"num_heads": nh, "dropout_prob": 0.1}

    def ctx(shard=None):
        c = ExecContext("cpu", torch.Generator().manual_seed(9))
        c.training = True
        c.tp_in = shard
        return c

    whole = fn(ctx(), {"Q": [q], "K": [k], "V": [v]}, attrs)["Out"][0]
    undropped = fn(ctx(), {"Q": [q], "K": [k], "V": [v]},
                   {"num_heads": nh})["Out"][0]
    assert not torch.equal(whole, undropped)
    parts = []
    for r in range(2):
        sh = {s: [TPShard(2, r, 2, None)] for s in "QKV"}
        local = {s: [x.chunk(2, -1)[r]] for s, x in zip("QKV", (q, k, v))}
        parts.append(fn(ctx(sh), local, {**attrs, "num_heads": nh // 2})
                     ["Out"][0])
    assert torch.equal(torch.cat(parts, -1), whole)


@pytest.mark.parametrize("op", ["flash_attention", "flash_attention_sparse"])
def test_attention_on_a_rank_heads_matches_the_whole(op):
    """Each rank's slice of q, k, v (whole heads) through the op with the
    head count its tp declaration gives: the slices of the whole-head
    plain result, laid end to end, bitwise."""
    from paddle_tpu_torch.core.executor import ExecContext
    from paddle_tpu_torch.core.registry import get_op

    g = torch.Generator().manual_seed(3)
    b, t, nh, d = 2, 64, 4, 16
    q, k, v = (torch.randn(b, t, nh * d, generator=g) for _ in range(3))
    opdef = get_op(op)
    ins = {"Q": [q], "K": [k], "V": [v]}
    if op == "flash_attention":
        ins["BiasQK"] = [torch.where(torch.rand(b, 1, t, generator=g) < 0.2,
                                     -1e4, 0.0)]
    else:
        seg = torch.tensor([[1] * 40 + [2] * 24, [1] * 64],
                           dtype=torch.int32)
        ins.update(QSeg=[seg], KSeg=[seg])
    attrs = {"num_heads": nh}
    whole = opdef.fn(ExecContext("cpu"), ins, attrs)["Out"][0]
    lay = {s: [2 if s in ("Q", "K", "V") else None] for s in ins}
    rule = opdef.tp(attrs, lay, {s: [tuple(x.shape[:-1]) + (
        x.shape[-1] // 2,) if s in "QKV" else tuple(x.shape)]
        for s, (x,) in ins.items()}, 2)
    assert rule.attrs == {"num_heads": nh // 2} and rule.out == {"Out": 2}
    parts = []
    for r in range(2):
        local = {s: [x.chunk(2, -1)[r]] if s in "QKV" else [x]
                 for s, (x,) in ins.items()}
        parts.append(opdef.fn(ExecContext("cpu"), local,
                              {**attrs, **rule.attrs})["Out"][0])
    torch.testing.assert_close(torch.cat(parts, -1), whole, rtol=1e-6,
                               atol=1e-6)


def test_sparse_attention_rows_are_independent():
    """flash_attention_sparse's segment descriptors are per row: a batch
    equals its rows run one by one (its dp=ROWS declaration)."""
    from paddle_tpu_torch.core.executor import ExecContext
    from paddle_tpu_torch.core.registry import get_op

    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(3, 64, 32, generator=g) for _ in range(3))
    seg = torch.tensor([[1] * 30 + [2] * 34, [1] * 64,
                        [1] * 10 + [2] * 20 + [0] * 34], dtype=torch.int32)
    fn = get_op("flash_attention_sparse").fn

    def run(sl):
        return fn(ExecContext("cpu"),
                  {"Q": [q[sl]], "K": [k[sl]], "V": [v[sl]],
                   "QSeg": [seg[sl]], "KSeg": [seg[sl]]},
                  {"num_heads": 2, "causal": True})["Out"][0]

    whole = run(slice(None))
    rows = torch.cat([run(slice(i, i + 1)) for i in range(3)])
    torch.testing.assert_close(rows, whole, rtol=1e-6, atol=1e-6)


def test_vocab_parallel_lookup_and_cross_entropy(world):
    """The world as a model axis of 4: the lookup's summands (zeros for
    ids outside a rank's rows, the padding row zero) sum to the whole
    table's rows; the vocab-parallel cross entropy (the global max taken
    before exp: these logits reach ±200, where exp overflows f32) equals
    the whole-vocab loss on every rank, and each rank's gradient is its
    slice of the whole one (rtol 1e-5)."""
    from paddle_tpu_torch.core.executor import ExecContext
    from paddle_tpu_torch.core.registry import get_op

    rng = np.random.RandomState(2)
    logits = (rng.randn(3, 5, 16) * 80).astype("float32")
    labels = rng.randint(0, 16, (3, 5, 1)).astype("int64")
    labels[0, 0, 0] = -100
    ids = rng.randint(0, 32, (3, 7)).astype("int64")
    ids[0, 0] = 3
    table = rng.randn(32, 6).astype("float32")
    got = world().run("vocab_parallel", dict(logits=logits, labels=labels,
                                             ids=ids, table=table))
    ctx = ExecContext("cpu")
    rows = get_op("lookup_table").fn(
        ctx, {"W": [torch.from_numpy(table)], "Ids": [torch.from_numpy(ids)]},
        {"padding_idx": 3})["Out"][0].numpy()
    x = torch.from_numpy(logits).requires_grad_()
    loss = get_op("softmax_with_cross_entropy").fn(
        ctx, {"Logits": [x], "Label": [torch.from_numpy(labels)]},
        {"ignore_index": -100})["Loss"][0]
    (loss * torch.arange(1, loss.numel() + 1).reshape(loss.shape)
     ).sum().backward()
    assert np.isfinite(loss.detach().numpy()).all()
    for r, o in enumerate(got):
        np.testing.assert_array_equal(o["rows"], rows)
        np.testing.assert_allclose(o["loss"], loss.detach().numpy(),
                                   rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(o["grad"], x.grad.numpy()[..., 4 * r:
                                                             4 * r + 4],
                                   rtol=RTOL, atol=1e-6)


def test_undeclared_op_gathers_its_slice_whole(world):
    """A column-parallel fc's sliced output meets layer_norm, which declares
    nothing for a slice: the mesh step gathers it whole (its backward takes
    the rank's slice). Losses and every updated parameter against the JAX
    package at the same mesh and on one device (rtol 1e-5)."""
    feed = R.unit_mlp_feed()
    names = ["gw0", "gb0", "gw1"]
    ref, jst = R.jax_run(jfluid, "gather_mlp", feed, None, tp=False,
                         fetch=names)
    jtp, _ = R.jax_run(jfluid, "gather_mlp", feed, MESH, fetch=names)
    res = _port_tp(world, "gather_mlp", feed)
    for r in res:
        np.testing.assert_allclose(_losses(r), jtp, rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(_losses(r), ref, rtol=RTOL, atol=1e-6)
        for n in names:
            np.testing.assert_allclose(r["state"][n], jst[n], rtol=1e-4,
                                       atol=1e-6)
    assert res[0]["info"]["gw0"][0] == (16, 16)
    _assert_replicated_bitwise(res)


def test_selected_rows_with_ragged_row_counts(world):
    """SelectedRows gradients whose row counts differ across the data
    ranks: the counts are gathered first, every rank gets every rank's
    rows in rank order."""
    counts = [3, 0, 5, 1]
    got = world().run("selected_rows", dict(counts=counts, height=500))
    want = np.concatenate([np.arange(c) + 100 * r
                           for r, c in enumerate(counts)])
    for ids, rows, height in got:
        np.testing.assert_array_equal(ids, want)
        np.testing.assert_array_equal(rows, np.repeat(want[:, None], 3, 1))
        assert height == 500


def test_sparse_embedding_with_tp_sharded_table(world):
    """tests/test_sparse_embedding.py's twin: a vocab-split table over the
    tp axis with SelectedRows gradients (each rank keeps its rows' ids,
    offset to local slots; the dp ranks' rows gathered) == the unsharded
    run (rtol 1e-4, the JAX test's); the final table against the JAX
    package's at the same mesh."""
    feed = R.sparse_table_feed()
    ref, jref = R.jax_run(jfluid, "sparse_table", feed, None, tp=False,
                          steps=4, fetch=["table"])
    jtp, jtab = R.jax_run(jfluid, "sparse_table", feed, MESH, steps=4,
                          fetch=["table"])
    np.testing.assert_allclose(ref, jtp, rtol=1e-4)
    res = _port_tp(world, "sparse_table", feed, steps=4)
    for r in res:
        np.testing.assert_allclose(_losses(r), jtp, rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(r["state"]["table"], jtab["table"],
                                   rtol=1e-4, atol=1e-6)
    assert res[0]["info"]["table"][:2] == ((32, 8), (64, 8))
    _assert_replicated_bitwise(res)


@pytest.mark.parametrize("packed", [True, False])
def test_deepfm_vocab_sharded_table(world, packed):
    """DeepFM(shard_axis="tp") on sparse Adagrad: the packed fm_t table
    (the JAX package computes it on a dp×tp mesh too; each rank updates
    its row shard through the fused row update with local slots) or the
    unpacked fm_w1/fm_emb pair. Losses against the JAX package at the
    same mesh (rtol 1e-5) and on one device."""
    feed = R.tp_deepfm_feed()
    kw = {"packed": packed}
    ref, _ = R.jax_run(jfluid, "deepfm", feed, None, tp=False, **kw)
    jtp, _ = R.jax_run(jfluid, "deepfm", feed, MESH, **kw)
    res = _port_tp(world, "deepfm", feed, model_kw=kw, fetch_state=False)
    for r in res:
        np.testing.assert_allclose(_losses(r), jtp, rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(_losses(r), ref, rtol=RTOL, atol=1e-6)
    table = "fm_t" if packed else "fm_emb"
    assert res[0]["info"][table][0][0] * 2 == R.DEEPFM_V
    _assert_replicated_bitwise(res)


def test_tp_mesh_refusals(world):
    """As the JAX package: a dim its axis does not divide (BERT's 30,522-
    row vocabulary over tp = 4) and a spec naming an axis the mesh lacks
    raise ValueError at the run; a second model axis (no spec names either
    axis: both compute replicated) and a sequence axis beside the model
    axis (tp BERT on sp2×tp2) run, with the plain run's losses."""
    got = world().run("tp_surface")[0]
    assert got["vocab_30522_tp4"].startswith("ValueError")
    assert "30522" in got["vocab_30522_tp4"]
    assert "divisible by 4" in got["vocab_30522_tp4"]
    assert got["axis_missing"].startswith("ValueError")
    assert "not found in mesh" in got["axis_missing"]
    assert got["pp"] == got["pp_plain"]
    np.testing.assert_allclose(got["seq_axis"], got["seq_axis_plain"],
                               rtol=1e-5, atol=1e-6)


# -- twins of tests/test_checkpoint.py ---------------------------------------

def test_save_dp8_restore_dp4tp2_loss_continuity(world, tmp_path):
    """The port at dp = 4 saves after 3 steps; a fresh scope under dp2×tp2
    (w0 sliced over tp) restores it and runs 4 more: the 7 losses equal an
    uninterrupted dp = 4 run (rtol 5e-4, the JAX test's) and the JAX
    package's same schedule at dp = 4 → dp2×tp2 (rtol 1e-5)."""
    feed = R.ckpt_mlp_feed()
    state = R.jax_state(jfluid, "ckpt_mlp", tp=False)
    ref = world().run("tp", [dict(model="ckpt_mlp", feed=R.rows(feed, r, N),
                                  axes={"dp": N}, tp=False, state=state,
                                  steps=7, fetch_state=False)
                             for r in range(N)])
    ck = str(tmp_path / "ck")
    a = world().run("tp", [dict(model="ckpt_mlp", feed=R.rows(feed, r, N),
                                axes={"dp": N}, tp=False, state=state,
                                steps=3, save=ck, fetch_state=False)
                           for r in range(N)])
    b = world().run("tp", [dict(model="ckpt_mlp", feed=_dp_rows(feed, r),
                                axes=MESH, restore=ck, steps=4,
                                fetch_state=False) for r in range(N)])
    assert all(r["restored"] == 7 for r in b)
    got = _losses(a[0]) + _losses(b[0])
    np.testing.assert_allclose(got, _losses(ref[0]), rtol=5e-4, atol=1e-6)
    jref, _ = R.jax_run(jfluid, "ckpt_mlp", feed, {"dp": N}, tp=False,
                        steps=7)
    np.testing.assert_allclose(got, jref, rtol=RTOL, atol=1e-6)
    for r in b:
        assert r["losses"] == b[0]["losses"]
    assert b[0]["info"]["w0"][:2] == ((16, 4), (16, 8))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_RUNNER = os.path.join(os.path.dirname(__file__), "torch_dist_ckpt_runner.py")
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    return {k: v for k, v in os.environ.items()
            if not k.startswith(("PADDLE_", "XLA_", "JAX_"))}


def _run_single(mode, ckdir):
    out = subprocess.run([sys.executable, "-u", _RUNNER, mode, ckdir],
                         capture_output=True, text=True, timeout=180,
                         env=_env(), cwd=_ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _run_cluster(mode, ckdir, logdir):
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc", "2", "--started_port", str(_free_port()),
         "--log_dir", str(logdir), _RUNNER, mode, ckdir],
        capture_output=True, text=True, timeout=240, env=_env(), cwd=_ROOT)
    logs = {}
    for rank in range(2):
        text = (logdir / f"workerlog.{rank}").read_text()
        assert out.returncode == 0, f"rank{rank} log:\n{text[-2000:]}"
        logs[rank] = json.loads([ln for ln in text.splitlines()
                                 if ln.startswith("{")][-1])
    return logs


def test_shard_parallel_checkpoint_across_process_counts(tmp_path):
    """2-process save → 1-process restore and 1-process save → 2-process
    restore through the port's launcher: each rank of the {"dp": 1,
    "tp": 2} mesh writes its slice of w_tp to its own shard file and
    index (no gather on save); a restore assembles it under either count.
    The weight's sums against the JAX package's runner in one process."""
    ck1 = tmp_path / "ck_2to1"
    logs = _run_cluster("--save", str(ck1), tmp_path / "log_save")
    for r in range(2):
        assert (ck1 / f"ckpt-7.shards-{r}.pkl").exists()
        idx = json.loads((ck1 / f"ckpt-7.index-{r}.json").read_text())
        assert len(idx["w_tp"]["shards"]) == 1
        assert idx["w_tp"]["shards"][0]["bounds"] == [[0, 16],
                                                      [4 * r, 4 * r + 4]]
    np.testing.assert_allclose(logs[0]["wsum"], logs[1]["wsum"], rtol=0)
    got = _run_single("--restore", str(ck1))
    assert got["step"] == 7
    np.testing.assert_allclose(got["wsum"], logs[0]["wsum"], rtol=1e-6)
    assert np.isfinite(got["loss"])

    ck2 = tmp_path / "ck_1to2"
    saved = _run_single("--save", str(ck2))
    logs2 = _run_cluster("--restore", str(ck2), tmp_path / "log_restore")
    for r in range(2):
        assert logs2[r]["step"] == 7
        np.testing.assert_allclose(logs2[r]["wsum"], saved["wsum"],
                                   rtol=1e-6)
    assert logs2[0]["loss"] == logs2[1]["loss"]
    np.testing.assert_allclose(logs2[0]["loss"], got["loss"], rtol=1e-5)
    # the JAX package's run of the same model, one device, 2 steps
    _, jw = R.jax_run(jfluid, "w_tp", R.w_tp_feed(), None, tp=False,
                      steps=2, fetch=["w_tp"])
    np.testing.assert_allclose(saved["wsum"], float(jw["w_tp"].astype(
        np.float64).sum()), rtol=1e-5)
