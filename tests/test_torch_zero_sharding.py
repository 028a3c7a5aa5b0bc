"""ZeRO stages 1–3 of the port's data-parallel step against the JAX
package, on the CPU: the port on 4 gloo ranks (``torch_dist_runner.World``,
one world of 4 for this file and one of 2 for a restore), the JAX package
in this process on 4 of the conftest's 8 virtual devices.

Twins of tests/test_zero_sharding.py (all of it) and of the stage-3 tests
of tests/test_stage3_sharding.py. The port's own stages are held BITWISE
to its stage off at the same world size (each gradient is reduced by the
same reduce-scatter in every stage, ``core/mesh_step.py``); the port
against the JAX package at dp=4 within rtol 1e-5, atol 1e-6 (the ranks sum
in another order than XLA). The shard extents, the padded leaves
(``_zero_padded``, zero pad rows) and the replicated scalars are the JAX
package's. Buffer donation has no counterpart in eager torch (a designed
divergence, ROADMAP §C): its twins hold that a step raises no warning and
that the state each rank holds stays the same size from step to step. The
two subprocess smokes start their 4 ranks through the port's
``distributed.launch`` on a free port, with a timeout. Sharded checkpoints
are written per rank and restored into 1, 2 and 4 ranks and by the JAX
package's ``Checkpointer``.
"""
import json
import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import torch_dist_runner as R
from paddle_tpu.core import unique_name as jnames

torch.set_num_threads(1)

DP = 4
OPTS = ["adagrad", "adam", "momentum", "sgd"]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("worlds")
    live = {}

    def get(n=DP):
        w = live.get(n)
        if w is None or not w.alive:
            w = live[n] = R.World(n, tmp)
        return w

    yield get
    for w in live.values():
        w.close()


def _jax(opt="adam", stage=0, steps=4, build=R.build_zero_mlp,
         feed=None):
    """The JAX package at dp=4: (startup state, losses, program, scope)."""
    import jax

    with jnames.guard():
        main, startup, loss = (build(jfluid, opt) if build is
                               R.build_zero_mlp else build(jfluid))
    feed = feed or R.zero_mlp_feed()
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        state = {v.name: np.asarray(scope.find_var(v.name))
                 for v in main.list_vars() if v.persistable}
        bs = jfluid.BuildStrategy()
        bs.sharding_strategy = stage
        prog = jfluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss, build_strategy=bs, places=jax.devices()[:DP])
        losses = [float(np.asarray(exe.run(prog, feed=feed,
                                           fetch_list=[loss])[0]))
                  for _ in range(steps)]
    return state, losses, main, scope


def _port(worlds, stage, opt="adam", state=None, steps=4, model="zero_mlp",
          feed=None, **kw):
    feed = feed or R.zero_mlp_feed()
    return worlds().run("train", [dict(
        model=model, feed=R.rows(feed, r, DP), stage=stage, opt=opt,
        state=state, steps=steps, **kw) for r in range(DP)])


def _floats(res):
    return [float(np.frombuffer(b, "float32")[0]) for b in res["losses"]]


def _opt_state_names(main):
    return [v.name for v in main.global_block().vars.values()
            if getattr(v, "is_optimizer_state", False)]


# -- stage 1 ----------------------------------------------------------------

def test_stage1_shard_sizes(worlds):
    state, _, jmain, jscope = _jax("adam", stage=1, steps=1)
    out = _port(worlds, 1, state=state, steps=1)
    checked = 0
    for name in _opt_state_names(jmain):
        var = jmain.global_block().vars[name]
        shape = tuple(var.shape)
        n = int(np.prod(shape or (1,)))
        if n <= 1 or getattr(var, "zero_shardable", True) is False:
            continue
        jshard = jscope.find_var(name).addressable_shards[0].data.shape
        for r, res in enumerate(out):
            local, glob, axis = res["info"][name]
            assert axis is not None, name
            assert all(s == d or s <= -(-d // DP)
                       for s, d in zip(local, shape)), (name, local, shape)
            assert math.prod(local) < n, (name, local)
            assert local == tuple(jshard), (name, local, jshard)
        checked += 1
    assert checked >= 6


def test_stage1_keeps_scalar_state_replicated(worlds):
    state, _, jmain, jscope = _jax("adam", stage=1, steps=1)
    out = _port(worlds, 1, state=state, steps=1)[0]
    pows = [n for n in _opt_state_names(jmain) if "beta" in n and "pow" in n]
    assert pows
    for name in pows:
        assert jscope.find_var(name).sharding.is_fully_replicated
        assert out["info"][name][2] is None, name


@pytest.mark.parametrize("opt", OPTS)
def test_stage1_losses_bitwise_match_unsharded(worlds, opt):
    state, jlosses, _, _ = _jax(opt)
    base = _port(worlds, 0, opt, state)
    shard = _port(worlds, 1, opt, state)
    assert len(base[0]["losses"]) == 4
    for i, (a, b) in enumerate(zip(base[0]["losses"], shard[0]["losses"])):
        assert a == b, f"{opt} step {i}: {a.hex()} != {b.hex()}"
    np.testing.assert_allclose(_floats(shard[0]), jlosses, rtol=1e-5,
                               atol=1e-6)


def test_stage2_losses_match_unsharded(worlds):
    state, jlosses, _, _ = _jax("adam", stage=2)
    base = _port(worlds, 0, state=state)
    shard = _port(worlds, 2, state=state)
    assert base[0]["losses"] == shard[0]["losses"]
    np.testing.assert_allclose(_floats(shard[0]), jlosses, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_one_element_shards_keep_scalar_state_whole(worlds, stage):
    """A 4-element bias at dp=4 shards to one element a rank, the size of
    Adam's beta powers: the powers stay whole [1] values and the losses
    and parameters are bitwise those of stage off (and within the JAX
    tolerance of the JAX package at dp=4)."""
    state, jlosses, _, _ = _jax(build=R.build_narrow)
    base = _port(worlds, 0, model="narrow", state=state)
    got = _port(worlds, stage, model="narrow", state=state)
    assert got[0]["losses"] == base[0]["losses"]
    np.testing.assert_allclose(_floats(got[0]), jlosses, rtol=1e-5,
                               atol=1e-6)
    for name, (local, glob, axis) in got[0]["info"].items():
        if "pow" in name:
            assert local == glob == (1,) and axis is None, name
    for name, want in base[0]["state"].items():
        np.testing.assert_array_equal(got[0]["state"][name], want, name)
    assert got[0]["info"]["nb0_AdamOptimizer_moment1"][0] == (1,)


def test_stage1_donation_holds_across_steps(worlds):
    out = _port(worlds, 1, steps=3)
    for res in out:
        assert len(res["losses"]) == 3
        donate = [w for w in res["warnings"] if "donat" in w.lower()]
        assert not donate and not res["warnings"], res["warnings"]
        assert len(set(res["gauge_steps"])) == 1, res["gauge_steps"]


def test_stage1_memory_gauge_reports_reduction(worlds):
    unsharded = _port(worlds, 0, steps=1)[0]["state_bytes"]
    sharded = _port(worlds, 1, steps=1)[0]["state_bytes"]
    assert unsharded > 0 and sharded > 0
    assert sharded < unsharded, (sharded, unsharded)


def test_sharded_save_roundtrips_through_unsharded_load(worlds, tmp_path):
    ck = str(tmp_path / "zck")
    w = worlds()
    feed = R.zero_mlp_feed()
    w.run("ckpt_save", [dict(dirname=ck, feed=R.rows(feed, r, DP),
                             state=None, stage=1) for r in range(DP)])
    got = {}
    for stage in (0, 1):
        res = w.run("ckpt_restore", [dict(dirname=ck,
                                          feed=R.rows(feed, r, DP),
                                          stage=stage) for r in range(DP)])
        got[stage] = res[0]["loss"]
    assert got[0] == got[1], (got[0].hex(), got[1].hex())


def test_parallel_executor_surfaces_sharding_strategy(worlds):
    state, _, _, _ = _jax("sgd", steps=0)
    out = worlds().run("parallel_executor", [dict(
        feed=R.rows(R.zero_mlp_feed(), r, DP), state=state, stage=1)
        for r in range(DP)])
    for res in out:
        assert res["sharding_strategy"] == 1
        assert res["device_count"] == DP
        assert res["gauge"] == DP
        assert np.isfinite(float(np.asarray(res["loss"]).reshape(-1)[0]))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_smoke(*args):
    """4 ranks of torch_zero_smoke_runner.py through the port's launcher,
    on a free port and within a timeout; rank 0's JSON report."""
    runner = os.path.join(os.path.dirname(__file__),
                          "torch_zero_smoke_runner.py")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PADDLE_", "XLA_", "JAX_"))}
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc", str(DP), "--started_port", str(_free_port()), runner,
         *args], capture_output=True, text=True, timeout=240, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_zero_smoke_subprocess():
    report = _launch_smoke()
    assert report["device_count"] == DP
    assert report["losses_off"] == report["losses_stage1"]
    assert report["max_shard_frac"] <= (1.0 / DP) + 0.05
    assert report["state_bytes_stage1"] < report["state_bytes_off"]


def test_amp_found_inf_is_global_under_zero(worlds):
    """float16 AMP with dynamic loss scaling: one rank's rows overflow the
    scaled loss in step 2. The found-inf test sees the global gradients in
    every stage (at stages 2 and 3, where each rank holds a gradient shard,
    update_loss_scaling gets them gathered), so every rank skips that
    update and backs the scale off together, bitwise as at stage off."""
    rng = np.random.RandomState(4)
    steps = []
    for i in range(3):
        f = {"x": rng.rand(32, 16).astype("float32"),
             "y": rng.rand(32, 1).astype("float32")}
        if i == 1:
            f["x"][-8:] *= 3e4   # the last rank's rows only
        steps.append(f)
    out = {}
    for stage in (0, 2, 3):
        out[stage] = worlds().run("amp_fp16", [dict(
            feed=[R.rows(f, r, DP) for f in steps], stage=stage)
            for r in range(DP)])
    base = out[0][0]
    assert base["scales"][0] == 2.0 ** 15
    assert base["scales"][1] < base["scales"][0]   # the overflow step
    for stage, res in out.items():
        for r in res:
            assert r["losses"] == base["losses"], stage
            assert r["scales"] == base["scales"], stage
            for name, want in base["params"].items():
                np.testing.assert_array_equal(r["params"][name], want)


# -- stage 3 ----------------------------------------------------------------

def _trainable(main):
    return [(n, v) for n, v in main.global_block().vars.items()
            if getattr(v, "trainable", False) and v.persistable]


def test_stage3_param_shards_split_over_dp(worlds):
    state, _, jmain, jscope = _jax("adam", stage=3, steps=1)
    out = _port(worlds, 3, state=state, steps=1)[0]
    sharded = 0
    for name, v in _trainable(jmain):
        n = int(np.prod(tuple(v.shape) or (1,)))
        if n < DP:
            continue
        local, glob, axis = out["info"][name]
        fracs = [s / g for s, g in zip(local, glob)]
        assert min(fracs) <= (1.0 / DP) + 1e-9, (name, local, glob)
        jarr = jscope.find_var(name)
        assert glob == tuple(jarr.shape), (name, glob, jarr.shape)
        assert local == tuple(jarr.addressable_shards[0].data.shape)
        sharded += 1
    assert sharded >= 4


def test_stage3_padded_nondivisible_leaves(worlds):
    state, _, jmain, jscope = _jax("sgd", stage=3, steps=4)
    out = _port(worlds, 3, "sgd", state)[0]
    padded = out["padded"]
    assert padded.get("zb1") == (13,)
    assert padded.get("zw2") == (13, 1)
    assert padded == dict(getattr(jmain, "_zero_padded", {}))
    assert out["info"]["zb1"][1] == (16,)
    host = out["whole"]["zb1"]
    assert host.shape == (16,)
    assert np.all(host[13:] == 0)
    assert np.isfinite(host[:13]).all()
    np.testing.assert_allclose(host, np.asarray(jscope.find_var("zb1")),
                               rtol=1e-5, atol=1e-6)
    # the logical value, pad dropped, is what a plain read sees
    assert out["state"]["zb1"].shape == (13,)


def test_stage3_scalar_leaf_replicated(worlds):
    out = _port(worlds, 3, "sgd", steps=1)[0]
    assert out["info"]["zb2"][2] is None


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_stage3_losses_bitwise_vs_unsharded(worlds, opt):
    state, jlosses, _, _ = _jax(opt, stage=3)
    base = _port(worlds, 0, opt, state)
    s3 = _port(worlds, 3, opt, state)
    assert base[0]["losses"] == s3[0]["losses"]
    np.testing.assert_allclose(_floats(s3[0]), jlosses, rtol=1e-5,
                               atol=1e-6)


def test_stage3_donation_preserved(worlds):
    for res in _port(worlds, 3, steps=3):
        assert not res["warnings"], res["warnings"]
        assert len(set(res["gauge_steps"])) == 1, res["gauge_steps"]


def test_stage3_checkpoint_roundtrip(worlds, tmp_path):
    """Save under stage 3 (each rank its slices), restore into off /
    stage1 / stage3 on 4 ranks: the next step is bitwise the one the saving
    run took after the save."""
    ck = str(tmp_path / "s3")
    w = worlds()
    feed = R.zero_mlp_feed()
    saved = w.run("ckpt_save", [dict(dirname=ck, feed=R.rows(feed, r, DP),
                                     state=None, stage=3, steps=3)
                                for r in range(DP)])
    assert [f for f in saved[0]["files"] if "shards" in f]
    cont = saved[0]["next"]
    for stage in (0, 1, 3):
        res = w.run("ckpt_restore", [dict(dirname=ck,
                                          feed=R.rows(feed, r, DP),
                                          stage=stage) for r in range(DP)])
        assert res[0]["loss"] == cont, f"restore into stage {stage} diverged"


def test_stage3_plus_full_remat_bitwise(worlds):
    feed = R.unit_mlp_feed()
    full = _port(worlds, 3, model="unit_mlp", feed=feed, steps=3,
                 remat="full")
    none = _port(worlds, 0, model="unit_mlp", feed=feed, steps=3,
                 remat="none")
    assert full[0]["losses"] == none[0]["losses"]


def test_stage3_smoke_subprocess():
    report = _launch_smoke("--stage3")
    assert report["device_count"] == DP
    assert report["losses_off"] == report["losses_stage3"]
    assert report["max_param_shard_frac"] <= (1.0 / DP) + 0.05
    assert report["state_bytes_stage3"] < report["state_bytes_off"]


# -- sharded checkpoints across world sizes ---------------------------------

def test_sharded_save_restores_into_one_and_two_ranks_and_jax(worlds,
                                                              tmp_path):
    """A stage-3 save from 4 ranks (per-rank shard files in logical
    coordinates) restores into one process, into 2 ranks and into the JAX
    package, each holding the saved values bit for bit; the next step of
    each continues the saving run's (bitwise on 4 ranks, rtol 1e-5 on 1
    and 2). The save leaves the torch generator out: the JAX package
    cannot read one."""
    ck = str(tmp_path / "x")
    feed = R.zero_mlp_feed()
    saved = worlds().run("ckpt_save", [dict(
        dirname=ck, feed=R.rows(feed, r, DP), state=None, stage=3,
        drop_rng=True) for r in range(DP)])[0]
    cont = float(np.frombuffer(saved["next"], "float32")[0])
    one = R.case_ckpt_restore(ck, feed, 0)
    two = worlds(2).run("ckpt_restore", [dict(
        dirname=ck, feed=R.rows(feed, r, 2), stage=2) for r in range(2)])
    for got in (one, two[0], two[1]):
        for name, want in saved["saved"].items():
            np.testing.assert_array_equal(got["restored"][name], want,
                                          err_msg=name)
        np.testing.assert_allclose(
            float(np.frombuffer(got["loss"], "float32")[0]), cont,
            rtol=1e-5)
    with jnames.guard():
        jmain, _, _ = R.build_zero_mlp(jfluid)
    scope = jfluid.Scope()
    assert jfluid.parallel.Checkpointer(ck).restore(program=jmain,
                                                    scope=scope) == 2
    for name, want in saved["saved"].items():
        np.testing.assert_array_equal(np.asarray(scope.find_var(name)),
                                      want, err_msg=name)
