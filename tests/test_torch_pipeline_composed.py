"""The port's composed dp×tp×pp program and pp×dp pipeline against the JAX
package, on the CPU: the port on 8 gloo ranks (one world for this file,
``torch_dist_runner.World`` serving ``torch_pipe_runner``'s cases), the
JAX package in this process on the conftest's 8 virtual devices, at the
same meshes.

Twins of tests/test_parallel.py's test_composed_dp_tp_pp_single_program
(its tolerance against the plain program: rtol 5e-3, atol 1e-4) and of
tests/test_pipeline_optimizer.py's test_pipeline_pp2_dp4_loss_equality
(rtol 2e-5). The port starts from the JAX startup's parameters; within
each pipeline stage the tensor-parallel layouts apply (the mesh step's
hooks run inside the stage's sub-block). Also the port's own checks:
every replicated persistable is bitwise equal across the tp and pp
groups (and the dp replicas) after every step, and each stage value is
held by the ranks of one pp coordinate.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import torch_dist_runner as R
import torch_pipe_runner as PR

torch.set_num_threads(1)

N = 8


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("composed_world")
    live = {}

    def get():
        w = live.get("w")
        if w is None or not w.alive:
            w = live["w"] = R.World(N, tmp, cases="torch_pipe_runner")
        return w

    yield get
    if "w" in live:
        live["w"].close()


def _replicated_bitwise(res):
    for step in range(len(res[0]["hashes"])):
        for r in res[1:]:
            assert r["hashes"][step] == res[0]["hashes"][step], step
    assert res[0]["hashes"][0]


def _stages_owned(res, pp_of):
    staged = res[0]["stages"][0]
    assert staged
    for name in staged:
        owners = {pp_of(r) for r, got in enumerate(res)
                  if name in got["stages"][1]}
        assert len(owners) == 1, name


def test_composed_dp_tp_pp_single_program(world):
    """ONE program over a dp×tp×pp mesh at 8 ranks: the GPipe schedule on
    pp, each rank's rows on dp and Megatron tp inside every stage; losses
    equal the plain single-device program's."""
    kw = dict(tp_axis="tp", lr=0.05, micro=2, pipe_data_axis="dp")
    feed = PR.composed_feed()
    jref, _ = PR.jax_run(jfluid, "pipe_bert", feed, pp_cut=False, lr=0.05)
    axes = {"dp": 2, "tp": 2, "pp": 2}
    jgot, _ = PR.jax_run(jfluid, "pipe_bert", feed, axes=axes,
                         data_axis="dp", **kw)
    np.testing.assert_allclose(jref, jgot, rtol=5e-3, atol=1e-4)
    state = PR.jax_state(jfluid, "pipe_bert", **kw)
    # rank = 4·dp + 2·tp + pp
    res = world().run("pipe", [dict(
        model="pipe_bert", feed=R.rows(feed, r // 4, 2), axes=axes,
        data_axis="dp", state=state, model_kw=kw) for r in range(N)])
    for r in res:
        np.testing.assert_allclose(r["losses"], jgot, rtol=5e-3, atol=1e-4)
        np.testing.assert_allclose(r["losses"], jref, rtol=5e-3, atol=1e-4)
    _replicated_bitwise(res)
    _stages_owned(res, lambda r: r % 2)
    assert "pipeline" in res[0]["types"]


def test_pipeline_pp2_dp4_loss_equality(world):
    """PP=2 × DP=4 composition on the whole 8-rank mesh: each rank feeds
    its dp rows."""
    feed = PR.pipe_bert_feed()
    jref, _ = PR.jax_run(jfluid, "pipe_bert", feed, pp_cut=False)
    axes = {"dp": 4, "pp": 2}
    jpp, _ = PR.jax_run(jfluid, "pipe_bert", feed, axes=axes,
                        data_axis="dp", pipe_data_axis="dp")
    np.testing.assert_allclose(jref, jpp, rtol=2e-5, atol=1e-6)
    state = PR.jax_state(jfluid, "pipe_bert", pipe_data_axis="dp")
    # rank = 2·dp + pp
    res = world().run("pipe", [dict(
        model="pipe_bert", feed=R.rows(feed, r // 2, 4), axes=axes,
        data_axis="dp", state=state, model_kw={"pipe_data_axis": "dp"})
        for r in range(N)])
    for r in res:
        np.testing.assert_allclose(r["losses"], jpp, rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(r["losses"], jref, rtol=2e-5, atol=1e-6)
    _replicated_bitwise(res)
    _stages_owned(res, lambda r: r % 2)
