"""Ops across the batch dim on a data axis (rule A of the port's mesh
step, ``core/registry.py``), the LoD and beam ops on a dp = 4 mesh, and
``layers.moe_ffn`` off the data axis, on the CPU: the port on 4 gloo ranks
(one world for this file, ``torch_dist_runner.World`` serving
``torch_mesh_runner``'s cases), each rank fed its own rows, against the
JAX package in this process on a mesh of the same shape (the conftest's
virtual CPU devices) fed the whole batch.

Tolerance rtol 1e-5, atol 1e-6 (losses, updated parameters and fetched
values); integer outputs equal. Replicated parameters stay bitwise equal
across the ranks after every step.

- the gather itself with a different row count on every rank, forward
  and backward, against numpy (exact), and a dropout after it drawing one
  mask on every rank;
- every dim-0 case (concat, split, slice, unsqueeze, transpose, softmax,
  layer_norm, gather along dim 0, a matmul and a mul that contract dim 0,
  a reshape with a literal dim 0): the losses and the parameters on both
  sides of the op after 3 SGD steps (a gradient counted once a rank, not
  dp times);
- a tiny BERT's sequence output through sequence_unpad → sequence_pool and
  a softmax along dim 0 (Adam);
- the LoD ops of tests/test_sequence_ops.py and the beam ops of
  tests/test_lod_beam_pad.py with their lengths, as cases of one test;
- tests/test_moe.py's dense moe_ffn block (test_moe_layer_static_graph
  _trains) at dp = 4, and its expert-parallel block on {"dp": 2, "ep": 2}
  at capacity factors 8.0 and 1.25 (which tokens drop depends on the
  split: the JAX package's chunks of the global token order).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import torch_dist_runner as R
import torch_mesh_runner as M
from paddle_tpu.core import unique_name as jnames

torch.set_num_threads(1)

N = 4
RTOL, ATOL = 1e-5, 1e-6
DP = {"dp": N}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("across_world")
    live = {}

    def get():
        w = live.get("w")
        if w is None or not w.alive:
            w = live["w"] = R.World(N, tmp, cases="torch_mesh_runner")
        return w

    get()  # the ranks start while the first JAX reference compiles
    yield get
    if "w" in live:
        live["w"].close()


def _replicated_bitwise(res):
    for step in range(len(res[0]["hashes"])):
        for r in res[1:]:
            assert r["hashes"][step] == res[0]["hashes"][step], step
    assert res[0]["hashes"][0]


def _port_and_jax(world, model, feed, axes, rows, steps=3, **kw):
    """The port's ranks (rank r fed ``rows(r)``) and the JAX package on
    the same mesh, fed the whole batch, both from the JAX startup's
    state."""
    state = M.jax_run(jfluid, model, feed, steps=0, **kw)[2]
    w = world()
    w.submit("pipe", [dict(model=model, feed=rows(r), axes=axes,
                           data_axis="dp", model_kw=kw, steps=steps,
                           state=state, logical=True, fetch_other=True)
                      for r in range(N)])
    jax = M.jax_run(jfluid, model, feed, axes=axes, data_axis="dp",
                    steps=steps, state=state, **kw)
    return w.collect("pipe"), jax


def _close(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=err_msg)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=err_msg)


def test_gather_rows_carries_each_ranks_row_count(world):
    """The rule-A gather with ranks that hold 1, 2, 3 and 4 rows (an
    output whose dim 0 depends on the data): every rank gets the rows in
    rank order and the counts; the backward sums each rank's cotangent
    (a part of the global one) and keeps the rank's rows, so rank r's
    gradient is 4 · w at its rows."""
    res = world().run("gather_rows")
    whole = np.concatenate([np.arange((r + 1) * 3, dtype="float32")
                            .reshape(r + 1, 3) + 100.0 * r
                            for r in range(N)])
    ids = np.concatenate([np.full(r + 1, r) for r in range(N)])
    w = np.arange(whole.size, dtype="float32").reshape(whole.shape)
    start = 0
    for r, (wx, wi, counts, grad, int_grad) in enumerate(res):
        np.testing.assert_array_equal(wx, whole)
        np.testing.assert_array_equal(wi, ids)
        assert counts == [[q + 1, q + 1] for q in range(N)]
        np.testing.assert_array_equal(grad, N * w[start:start + r + 1])
        assert not int_grad
        start += r + 1


def test_dropout_after_the_gather_draws_one_mask(world):
    """A dropout on the global value a concat along dim 0 made (the whole
    batch on every rank) draws from the stream every rank of the data
    axis shares, as the JAX package's one program draws one mask: every
    rank holds the same output, about half of it dropped, and the same
    updated weight."""
    res = world().run("global_dropout")
    out, w = res[0]
    assert out.shape == (2 * 4 * N, 8)
    assert 0.3 < float((out == 0).mean()) < 0.7
    for o, wr in res[1:]:
        np.testing.assert_array_equal(o, out)
        np.testing.assert_array_equal(wr, w)


@pytest.mark.parametrize("op", M.ACROSS_OPS)
def test_op_across_the_batch_dim_matches_jax(world, op):
    """A batch-sharded value through `op` along dim 0: the port gathers
    its rows whole, runs the op on the whole batch and sums each gradient
    once; losses and the parameters before and after the op equal the JAX
    package's at dp = 4."""
    feed = M.across_feed()
    res, (jl, _, js) = _port_and_jax(
        world, "across", feed, DP, lambda r: R.rows(feed, r, N), op=op)
    names = [n for n in js if n.startswith("a_")]
    assert {"a_w1", "a_b1", "a_w2", "a_b2"} <= set(names)
    for r in res:
        np.testing.assert_allclose(r["losses"], jl, rtol=RTOL, atol=ATOL)
        for n in names:
            _close(r["state"][n], js[n], n)
    _replicated_bitwise(res)


def test_bert_head_across_the_batch(world):
    """Tiny BERT → sequence_unpad → sequence_pool (row by row, with each
    rank's lengths) → softmax along dim 0 (across the batch) → fc, Adam,
    at dp = 4: losses and every parameter (the encoder's before the
    softmax, the head's after it) equal the JAX package's."""
    feed = M.seq_head_feed()
    state = M.jax_run(jfluid, "seq_head", feed, steps=0)[2]
    w = world()
    w.submit("pipe", [dict(model="seq_head", feed=R.rows(feed, r, N),
                           axes=DP, data_axis="dp", state=state, steps=2,
                           logical=True) for r in range(N)])
    jl, _, js = M.jax_run(jfluid, "seq_head", feed, axes=DP, data_axis="dp",
                          steps=2, state=state)
    res = w.collect("pipe")
    for r in res:
        np.testing.assert_allclose(r["losses"], jl, rtol=RTOL, atol=ATOL)
        for n, v in js.items():
            if n in r["state"] and v.dtype.kind == "f":
                _close(r["state"][n], v, n)
    _replicated_bitwise(res)


@pytest.mark.parametrize("op", M.LOD_OPS)
def test_lod_and_beam_ops_on_a_dp4_mesh(world, op):
    """Each rank feeds its rows and their lengths; the fetched outputs,
    gathered in rank order, equal the JAX package's on the whole batch
    (the LoD ops and a beam step work row by row, the beam decode reads
    steps stacked along dim 0 and runs on the whole batch)."""
    with jnames.guard():
        main = M.build_lod(jfluid, op)[0]
    feed = M.lod_feed_for(main)
    res, (_, jout, _) = _port_and_jax(
        world, "lod", feed, DP, lambda r: R.rows(feed, r, N), steps=1,
        op=op)
    for r in res:
        assert len(r["fetched"]) == len(jout) - 1
        for i, (g, want) in enumerate(zip(r["fetched"], jout[1:])):
            _close(g, want, f"{op} output {i}")


def test_dense_moe_on_a_dp4_mesh(world):
    """tests/test_moe.py:153's block (4 experts, k = 2, cf 4.0, Adam) at dp
    = 4 routes the whole batch, as the JAX package's global program does:
    the capacity and the aux loss are the global batch's; losses and every
    parameter after 3 steps equal the JAX package's."""
    feed = R.moe_feed(seed=0)
    res, (jl, _, js) = _port_and_jax(world, "moe", feed, DP,
                                     lambda r: R.rows(feed, r, N))
    for r in res:
        np.testing.assert_allclose(r["losses"], jl, rtol=RTOL, atol=ATOL)
        for n, v in js.items():
            if "moe" in n:
                _close(r["state"][n], v, n)
    _replicated_bitwise(res)


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_expert_parallel_moe_beside_the_data_axis(world, cf):
    """tests/test_moe.py:179's block (8 experts, k = 1, SGD) on {"dp": 2,
    "ep": 2}: the rank at ep coordinate j routes chunk j of the global
    token order, expert-parallel over ep; losses and parameters equal the
    JAX package's on the same mesh, at ample capacity and at cf 1.25,
    where tokens drop."""
    axes = {"dp": 2, "ep": 2}
    feed = R.moe_feed()
    kw = dict(k=1, cf=cf, experts=8, opt="sgd")
    # rank = 2·dp + ep
    res, (jl, _, js) = _port_and_jax(
        world, "moe", feed, axes, lambda r: R.rows(feed, r // 2, 2), **kw)
    for r in res:
        np.testing.assert_allclose(r["losses"], jl, rtol=RTOL, atol=ATOL)
        for n, v in js.items():
            if "moe" in n:
                _close(r["state"][n], v, n)
    _replicated_bitwise(res)
    if cf == 8.0:
        dense = M.jax_run(jfluid, "moe", feed, **kw)[0]
        np.testing.assert_allclose(jl, dense, rtol=RTOL, atol=ATOL)
