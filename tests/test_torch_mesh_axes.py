"""Layouts on several mesh axes at once, parameters sharded by spec off
the model axis and a global-norm clip across pipeline stages, on the CPU:
the port on 8 gloo ranks (one world for this file,
``torch_dist_runner.World`` serving ``torch_mesh_runner``'s cases), the
JAX package in this process on the conftest's 8 virtual devices, at the
same meshes.

- the whole of tests/test_parallel.py's
  test_seq_axis_gspmd_sequence_parallel_loss_equality (its tolerance:
  rtol 2e-5, atol 1e-6), with its reference run on {"dp": 2, "sp": 4}
  without ``seq_axis`` (the sp dim computes replicated);
- tiny BERT with the fused attention on dp2×tp2×sp2 (heads sliced on tp,
  query rows on sp) against the JAX package (rtol 1e-5, atol 1e-6), and
  with attention and hidden dropout 0.1 on tp2×sp2 against the port's
  plain run at the same seed: the losses within rtol 1e-5 and the hidden
  dropout masks bitwise;
- pipelined tiny BERT on dp2×pp2×sp2 (each stage on its ranks' slice of
  the sequence) against the JAX package on the same mesh (rtol 2e-5,
  atol 1e-6) and against the port's plain program (tests/test_parallel.py's
  composed test's tolerance, rtol 5e-3, atol 1e-4: the pipeline's
  microbatches sum the gradients in another order);
- an MLP with a weight on a "tp" axis and one on a second model axis
  "mp" and "tp" at once (losses rtol 1e-5, atol 1e-6; the parameters
  after 3 Adam steps rtol 1e-4, atol 1e-5: the ranks sum their gradient
  parts in another order than one device, and Adam's normalized step
  carries that to the parameters at gradients near zero), through a
  checkpoint of the slices restored into the plain executor (bitwise);
- a parameter whose spec names the data axis, saved at dp = 8 and
  restored onto dp4×tp2: the 7 losses equal the JAX package's
  uninterrupted run;
- ``PipelineOptimizer`` + ``GradientClipByGlobalNorm`` (the factor below
  1 in every step) at pp = 2 against the JAX package (rtol 1e-5) and the
  port's plain executor with the same clip: every rank sums the stages'
  squared norms in the plain program's order, but each stage's gradient
  is the sum of its microbatches' (the plain backward's is one batch's),
  so the norm differs in its last bits and the clip factor carries that
  to every parameter: losses rtol 1e-6 (without the clip they are
  bitwise), the updated parameters within 1e-3 relative L2, the
  pipeline's limit.

Replicated persistables stay bitwise equal across the ranks after every
step.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import torch_dist_runner as R
import torch_mesh_runner as M
import torch_pipe_runner as PR

torch.set_num_threads(1)

N = 8


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_axes_world")
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


def _replicated_bitwise(res, group=None):
    group = group or list(range(len(res)))
    for step in range(len(res[0]["hashes"])):
        for r in group[1:]:
            assert res[r]["hashes"][step] == res[group[0]]["hashes"][step]
    assert res[group[0]]["hashes"][0]


def test_seq_axis_gspmd_sequence_parallel_loss_equality(world):
    """with_mesh(seq_axis=...) shards the sequence dim of the feeds over
    the sp axis: the same losses as the unsharded run, where the sp dim
    computes replicated; the port on both meshes equals the JAX
    package's."""
    feed = PR.seq_bert_feed()
    state = PR.jax_state(jfluid, "seq_bert")
    axes = {"dp": 2, "sp": 4}
    w = world()
    # rank = 4·dp + sp
    w.submit("pipe", [dict(model="seq_bert", feed=R.rows(feed, r // 4, 2),
                           axes=axes, data_axis="dp", state=state, steps=2)
                      for r in range(N)])
    jref, _ = PR.jax_run(jfluid, "seq_bert", feed, axes=axes,
                         data_axis="dp", steps=2, state=state)
    ref = w.collect("pipe")
    w.submit("pipe", [dict(model="seq_bert", feed=R.rows(feed, r // 4, 2),
                           axes=axes, data_axis="dp", seq_axis="sp",
                           state=state, steps=2) for r in range(N)])
    jsp, _ = PR.jax_run(jfluid, "seq_bert", feed, axes=axes,
                        data_axis="dp", seq_axis="sp", steps=2, state=state)
    got = w.collect("pipe")
    np.testing.assert_allclose(jsp, jref, rtol=2e-5, atol=1e-6)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(a["losses"], jref, rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(b["losses"], a["losses"], rtol=2e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(b["losses"], jsp, rtol=2e-5, atol=1e-6)
    _replicated_bitwise(ref)
    _replicated_bitwise(got)


def test_bert_on_dp_tp_sp_matches_jax(world):
    """Tiny BERT, fused attention on a rank's 2 of 4 heads (tp) and 8 of 16
    query rows (sp) at once, every rank's rows of the batch on dp: the
    losses equal the JAX package's on the same mesh."""
    kw = {"flash": True, "opt": "adam", "layers_n": 1, "tp_axis": "tp"}
    feed = PR.seq_bert_feed(T=16)
    state = PR.jax_state(jfluid, "seq_bert", **kw)
    axes = {"dp": 2, "tp": 2, "sp": 2}
    w = world()
    # rank = 4·dp + 2·tp + sp
    w.submit("pipe", [dict(model="seq_bert", feed=R.rows(feed, r // 4, 2),
                           axes=axes, data_axis="dp", seq_axis="sp",
                           state=state, model_kw=kw, probe=True)
                      for r in range(N)])
    jl, _ = PR.jax_run(jfluid, "seq_bert", feed, axes=axes, data_axis="dp",
                       seq_axis="sp", state=state, **kw)
    res = w.collect("pipe")
    for r in res:
        assert r["attention"] == [(8, 16)]
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5, atol=1e-6)
    _replicated_bitwise(res)


def test_tp_sp_dropout_masks_equal_the_plain_run(world):
    """tp2×sp2 BERT (the dp dim computes replicated) at attention and
    hidden dropout 0.1: every rank's attention mask is its block of the
    unsharded run's (the kernels' key carries both offsets), so the losses
    equal the port's plain run at the same seed, and the hidden dropout
    masks, gathered, equal the plain run's bitwise."""
    kw = {"flash": True, "drop": 0.1, "opt": "adam", "layers_n": 2,
          "tp_axis": "tp"}
    feed = PR.seq_bert_feed(T=16)
    state = PR.jax_state(jfluid, "seq_bert", **kw)
    masks = M.dropout_masks("seq_bert", **kw)
    assert masks
    w = world()
    w.submit("pipe", dict(model="seq_bert", feed=feed,
                          axes={"dp": 2, "tp": 2, "sp": 2}, seq_axis="sp",
                          state=state, model_kw=kw, fetch=masks, steps=2))
    plain = PR.case_pipe("seq_bert", feed, state=state, model_kw=kw,
                         fetch=masks, steps=2)
    res = w.collect("pipe")
    for r in res:
        np.testing.assert_allclose(r["losses"], plain["losses"], rtol=1e-5,
                                   atol=1e-6)
        for got, want in zip(r["fetched"], plain["fetched"]):
            np.testing.assert_array_equal(got, want)
    _replicated_bitwise(res)


def test_pipeline_beside_a_sequence_axis(world):
    """Pipelined tiny BERT on dp2×pp2×sp2: each stage runs on its ranks'
    slice of the sequence, and the microbatch exchange pairs the ranks of
    one sp coordinate; the losses equal the JAX package's on the same
    mesh, and the plain program's within the pipeline's tolerance."""
    kw = dict(lr=0.05, micro=2, pipe_data_axis="dp")
    feed = PR.composed_feed()
    state = PR.jax_state(jfluid, "pipe_bert", **kw)
    axes = {"dp": 2, "pp": 2, "sp": 2}
    w = world()
    # rank = 4·dp + 2·pp + sp
    w.submit("pipe", [dict(model="pipe_bert", feed=R.rows(feed, r // 4, 2),
                           axes=axes, data_axis="dp", seq_axis="sp",
                           state=state, model_kw=kw) for r in range(N)])
    jgot, _ = PR.jax_run(jfluid, "pipe_bert", feed, axes=axes,
                         data_axis="dp", seq_axis="sp", **kw)
    plain = PR.case_pipe("pipe_bert", feed, state=state,
                         model_kw={**kw, "pp_cut": False})
    res = w.collect("pipe")
    for r in res:
        np.testing.assert_allclose(r["losses"], jgot, rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(r["losses"], plain["losses"], rtol=5e-3,
                                   atol=1e-4)
    _replicated_bitwise(res)


def test_second_model_axis(world, tmp_path):
    """An MLP with a column-parallel weight on "tp" and one split over
    "mp" and "tp" at once (dp2×tp2×mp2): losses and every updated
    parameter equal the JAX package's on the same mesh; a checkpoint of
    the slices (each rank's block in logical coordinates) restores into
    the plain executor as the mesh's whole values, bitwise."""
    feed = M.mlp_feed()
    axes = {"dp": 2, "tp": 2, "mp": 2}
    state = M.jax_run(jfluid, "two_axes", feed, steps=0)[2]
    ck = str(tmp_path / "ck")
    w = world()
    w.submit("pipe", [dict(model="two_axes", feed=R.rows(feed, r // 4, 2),
                           axes=axes, data_axis="dp", state=state,
                           logical=True, save=ck) for r in range(N)])
    jl, _, js = M.jax_run(jfluid, "two_axes", feed, axes=axes,
                          data_axis="dp", state=state)
    res = w.collect("pipe")
    for r in res:
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5, atol=1e-6)
        for n in ("m_w0", "m_b0", "m_w1", "m_b1", "m_w2"):
            np.testing.assert_allclose(r["state"][n], js[n], rtol=1e-4,
                                       atol=1e-5, err_msg=n)
    _replicated_bitwise(res)
    back = PR.case_pipe("two_axes", feed, restore=ck, steps=0, logical=True)
    assert back["restored"] == 3
    for n, v in res[0]["state"].items():
        np.testing.assert_array_equal(back["state"][n], v, err_msg=n)


def test_spec_on_the_data_axis_through_a_checkpoint(world, tmp_path):
    """w0's spec ("dp", None) shards it over the data axis (ZeRO stage 3 on
    its dim 0): after 3 steps at dp = 8 each rank holds 2 of its 16 rows,
    a checkpoint records them in logical coordinates, and a fresh scope on
    dp4×tp2 restores it and runs 4 more steps: the 7 losses equal the JAX
    package's uninterrupted run at dp = 8 (and its dp4×tp2 run after the
    same restore point)."""
    feed = M.mlp_feed()
    feed["y"] = np.random.RandomState(1).randint(0, 4, (32, 1)).astype(
        "int64")
    ck = str(tmp_path / "ck")
    w = world()
    w.submit("pipe", [dict(model="dp_spec", feed=R.rows(feed, r, N),
                           axes={"dp": N}, data_axis="dp", steps=3,
                           save=ck, logical=True) for r in range(N)])
    jl, _, _ = M.jax_run(jfluid, "dp_spec", feed, axes={"dp": N},
                         data_axis="dp", steps=7)
    a = w.collect("pipe")
    assert a[0]["stages"] == ([], [], 0)
    b = w.run("pipe", [dict(model="dp_spec", feed=R.rows(feed, r // 2, 4),
                            axes={"dp": 4, "tp": 2}, data_axis="dp",
                            restore=ck, steps=4) for r in range(N)])
    assert all(r["restored"] == 3 for r in b)
    for ra, rb in zip(a, b):
        np.testing.assert_allclose(ra["losses"] + rb["losses"], jl,
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a[0]["state"]["w0"].shape, (16, 8))
    _replicated_bitwise(b)


def test_pipeline_optimizer_with_global_norm_clip(world):
    """PipelineOptimizer(Adam, GradientClipByGlobalNorm) at pp = 2: the sum
    of the squared norms reads both stages' gradients; each rank brings
    the other stage's in one all-gather and sums them in the program's
    order. The losses equal the port's plain executor's within rtol 1e-6
    (the module docstring says why not bitwise) and the JAX package's on
    the same mesh within rtol 1e-5; every stage value (from its owner)
    equals the plain run's within 1e-3 relative L2."""
    kw = {"opt": "adam", "lr": 0.01, "clip": 0.05}
    feed = PR.pipe_bert_feed()
    state = PR.jax_state(jfluid, "pipe_bert", **kw)
    axes = {"dp": 4, "pp": 2}
    w = world()
    w.submit("pipe", dict(model="pipe_bert", feed=feed, axes=axes,
                          state=state, model_kw=kw, logical=True))
    plain = PR.case_pipe("pipe_bert", feed, state=state, model_kw=kw,
                         logical=True)
    jl, _ = PR.jax_run(jfluid, "pipe_bert", feed, axes=axes, state=state,
                       **kw)
    unclipped = PR.case_pipe("pipe_bert", feed, state=state,
                             model_kw={**kw, "clip": None})
    res = w.collect("pipe")
    assert unclipped["losses"][1] != plain["losses"][1]
    for r in res:
        np.testing.assert_allclose(r["losses"], plain["losses"], rtol=1e-6,
                                   atol=0)
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5, atol=1e-6)
        for n, v in plain["state"].items():
            got = np.asarray(r["state"][n], np.float64)
            want = np.asarray(v, np.float64)
            err = np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30)
            assert err < 1e-3, (n, err)
    _replicated_bitwise(res)


@pytest.mark.parametrize("axes", [{"dp": 2, "tp": 2, "sp": 2},
                                  {"dp": 4, "tp": 2}],
                         ids=["dp2xtp2", "dp4xtp2"])
def test_zero_shards_tp_sliced_state_over_dp(world, axes, tmp_path):
    """ZeRO on a tp-sliced parameter's optimizer state (tiny BERT with
    Megatron specs, Adam): at stages 1–3 each rank holds that state cut
    over the data axis too, 1/(dp·tp) of it along a dim of its slice that
    no model axis cuts (the JAX package holds it at 1/dp), so a rank's
    state bytes fall, and the update runs on that part, so the step's
    peak of live bytes (``planner._PeakBytes``, the state it starts from
    included) falls at least as far; the losses stay bitwise those of
    stage off at the same mesh. (An "sp" dim without seq_axis computes
    replicated.)"""
    dp, tp = axes["dp"], axes["tp"]
    names = ("dp", "tp", "sp")
    feed = R.tp_bert_feed()

    def run(stage, **kw):
        per = []
        for r in range(N):
            coord = np.unravel_index(r, [axes[k] for k in names if k in axes])
            per.append(dict(model="bert", feed=R.rows(feed, int(coord[0]),
                                                      dp),
                            axes=axes, stage=stage, fetch_state=False,
                            model_kw={"opt": "adam"}, **kw))
        return world().run("tp", per)

    base = run(0, peak=True)
    bytes0 = base[0]["state_bytes"]
    for stage in (1, 2, 3):
        got = run(stage, peak=True)
        for r in range(N):
            assert got[r]["losses"] == base[r]["losses"], (stage, r)
        info = got[0]["info"]
        cut = [n for n, (loc, glob, _) in info.items()
               if "_moment" in n and int(np.prod(loc)) * dp * tp
               == int(np.prod(glob))]
        assert cut, "no tp-sliced moment is cut over the data axis"
        assert got[0]["state_bytes"] < bytes0, (stage, got[0]["state_bytes"],
                                                bytes0)
        for r in range(N):
            was, now = base[r], got[r]
            assert was["peak_bytes"] - now["peak_bytes"] >= \
                was["state_bytes"] - now["state_bytes"], (stage, r, was, now)
    # the cut slices go through a checkpoint (each rank its piece) and a
    # stage-off run resumes from them bitwise
    ck = str(tmp_path / "ck")
    run(1, save=ck)
    resumed = run(0, restore=ck, steps=1)
    longer = run(0, steps=4)
    assert resumed[0]["losses"][0] == longer[0]["losses"][3]
