"""The port's sequence axis (``with_mesh(seq_axis=)``) and attention
dropout on a slice of the heads or of the rows, on the CPU: the port on 4
gloo ranks (one world for this file, ``torch_dist_runner.World`` serving
``torch_pipe_runner``'s cases), the JAX package in this process.

Twin of tests/test_parallel.py's
test_seq_axis_gspmd_sequence_parallel_loss_equality (its tolerance: rtol
2e-5, atol 1e-6): the JAX package at dp2×sp4 on the conftest's 8 virtual
devices, the port at dp2×sp2, each rank feeding its dp rows whole along T
(the mesh step slices dim 1). Also the port's own checks, each against
the port's plain run at the same seed (the RNG streams differ from the
JAX package's): BERT with the fused attention and dropout 0.1 under sp =
2 and under tp = 2 (the masks equal the unsharded run's), the attention
calls' query lengths under sp (each rank's half, against every key), the
plain dropout masks with head and row offsets laid end to end against
the whole one, bitwise, and check_feeds on the sequence dim.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import torch_dist_runner as R
import torch_pipe_runner as PR

torch.set_num_threads(1)

N = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_world")
    live = {}

    def get():
        w = live.get("w")
        if w is None or not w.alive:
            w = live["w"] = R.World(N, tmp, cases="torch_pipe_runner")
        return w

    yield get
    if "w" in live:
        live["w"].close()


def test_seq_axis_gspmd_sequence_parallel_loss_equality(world):
    """with_mesh(seq_axis=...) shards the sequence dim of the feeds over
    the sp axis: the same losses as unsharded."""
    feed = PR.seq_bert_feed()
    jref, _ = PR.jax_run(jfluid, "seq_bert", feed, axes={"dp": 2, "sp": 4},
                         data_axis="dp", steps=2)
    jsp, _ = PR.jax_run(jfluid, "seq_bert", feed, axes={"dp": 2, "sp": 4},
                        data_axis="dp", seq_axis="sp", steps=2)
    np.testing.assert_allclose(jsp, jref, rtol=2e-5, atol=1e-6)
    state = PR.jax_state(jfluid, "seq_bert")
    # rank = 2·dp + sp
    res = world().run("pipe", [dict(
        model="seq_bert", feed=R.rows(feed, r // 2, 2),
        axes={"dp": 2, "sp": 2}, data_axis="dp", seq_axis="sp",
        state=state, steps=2) for r in range(N)])
    for r in res:
        np.testing.assert_allclose(r["losses"], jsp, rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(r["losses"], jref, rtol=2e-5, atol=1e-6)
    for r in res[1:]:
        assert r["hashes"] == res[0]["hashes"]


@pytest.mark.parametrize("drop", [0.0, 0.1])
def test_seq_axis_flash_attention_with_dropout(world, drop):
    """BERT with the fused attention under sp = 2 (the dp dim computes
    replicated): each rank's queries (8 of 16) attend to every key, and
    with attention and hidden dropout 0.1 the losses equal the plain run's
    at the same seed (every mask is the unsharded run's)."""
    kw = {"flash": True, "drop": drop, "opt": "adam", "layers_n": 2}
    feed = PR.seq_bert_feed(T=16)
    state = PR.jax_state(jfluid, "seq_bert", **kw)
    plain = PR.case_pipe("seq_bert", feed, state=state, model_kw=kw,
                         probe=True)
    assert plain["attention"] == [(16, 16)]
    res = world().run("pipe", dict(
        model="seq_bert", feed=feed, axes={"dp": 2, "sp": 2},
        seq_axis="sp", state=state, model_kw=kw, probe=True))
    for r in res:
        assert r["attention"] == [(8, 16)]
        np.testing.assert_allclose(r["losses"], plain["losses"], rtol=1e-5,
                                   atol=1e-6)
        assert r["hashes"] == res[0]["hashes"]
    if drop:
        undropped = PR.case_pipe("seq_bert", feed, state=state,
                                 model_kw={**kw, "drop": 0.0})
        assert undropped["losses"][0] != plain["losses"][0]


def test_tp_bert_attention_dropout_matches_plain(world):
    """tp = 2 BERT (fused attention on each rank's 2 of 4 heads) with
    attention and hidden dropout 0.1: the losses equal the port's plain
    run at the same seed, and the replicated parameters stay bitwise
    equal across the ranks."""
    kw = {"flash": True, "drop": 0.1, "opt": "adam", "layers_n": 2,
          "tp_axis": "tp"}
    feed = PR.seq_bert_feed(T=16)
    state = PR.jax_state(jfluid, "seq_bert", **kw)
    plain = PR.case_pipe("seq_bert", feed, state=state, model_kw=kw)
    res = world().run("pipe", dict(model="seq_bert", feed=feed,
                                   axes={"dp": 2, "tp": 2}, state=state,
                                   model_kw=kw))
    for r in res:
        np.testing.assert_allclose(r["losses"], plain["losses"], rtol=1e-5,
                                   atol=1e-6)
        assert r["hashes"] == res[0]["hashes"]


@pytest.mark.parametrize("split", ["heads", "rows", "heads_and_rows"])
def test_dropout_offsets_lay_end_to_end_to_the_whole_mask(split):
    """The plain keep masks of tp = 2 (heads), sp = 2 (rows) and a 2×2 grid
    of both, drawn with the kernels' key offsets and laid end to end, equal
    the unsharded mask bitwise; the default key draws the plain seed's
    mask."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    seed = torch.tensor([0x1234_5678_9ABC], dtype=torch.int64)
    b, nh, tq, tk = 2, 4, 24, 40
    whole = fa.dropout_keep_mask(seed, 0.1, b, nh, tq, tk)
    assert torch.equal(whole, fa.dropout_keep_mask(fa.dropout_key(seed), 0.1,
                                                   b, nh, tq, tk))
    assert torch.equal(whole, fa.dropout_keep_mask(int(seed), 0.1, b, nh,
                                                   tq, tk))
    if split == "heads":
        parts = [fa.dropout_keep_mask(fa.dropout_key(seed, nh, 2 * r), 0.1,
                                      b, 2, tq, tk) for r in range(2)]
        got = torch.cat(parts, 1)
    elif split == "rows":
        parts = [fa.dropout_keep_mask(fa.dropout_key(seed, 0, 0, 12 * r),
                                      0.1, b, nh, 12, tk) for r in range(2)]
        got = torch.cat(parts, 2)
    else:
        got = torch.cat([
            torch.cat([fa.dropout_keep_mask(
                fa.dropout_key(seed, nh, 2 * h, 12 * r), 0.1, b, 2, 12, tk)
                for r in range(2)], 2) for h in range(2)], 1)
    assert torch.equal(got, whole)


def test_seq_axis_feed_check(world):
    """A feed whose dim 1 the sequence axis does not divide raises
    ValueError on every rank before the step's first exchange."""
    got = world().run("seq_feed_check")
    for g in got:
        assert g is not None and "divisible by its size 2" in g
