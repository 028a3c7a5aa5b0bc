"""The port's remat surface: remat units and single ops under
torch.utils.checkpoint, through CompiledProgram (BuildStrategy.remat_policy)
and through the plain Executor (PDTPU_REMAT_POLICY, PDTPU_REMAT_OPS).

Twins of the remat tests of tests/test_stage3_sharding.py: across policies
the port's losses are BITWISE equal to one another; against the JAX
package's `_run_policy` (an 8-device CPU mesh there, one device here) they
are held at rtol 1e-5 (the two packages sum in other orders). A region's
dropout draws are taken once and replayed in its recompute: the mask-replay
test holds a "full" run of a two-layer tiny BERT at dropout 0.1 bitwise to
a run whose checkpoint calls the function directly (the same draws, no
recompute), and to the run without remat. The tiny-BERT parity test holds
"minimal" to the JAX package's "minimal" at test_torch_training.py's f32
tolerances (losses rtol 1e-4; gradients rtol 1e-4, atol 1e-6).
`test_stage3_*` are twinned on 4 ranks in test_torch_zero_sharding.py;
`saveable_names` (kept named values, the rest recomputed) is held to the
run without remat bitwise here and in test_torch_cluster.py."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as jnames
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.core import executor as texec
from paddle_tpu_torch.core import unique_name as tnames
from paddle_tpu_torch.models import bert as tbert

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_port_state(monkeypatch):
    from paddle_tpu_torch.core import program as prog_mod
    from paddle_tpu_torch.core import scope as scope_mod

    for k in ("PDTPU_REMAT_POLICY", "PDTPU_REMAT_OPS", "PDTPU_FUSE_UPDATES"):
        monkeypatch.delenv(k, raising=False)
    old = (prog_mod._main_program, prog_mod._startup_program,
           scope_mod._global_scope, scope_mod._current_scope)
    prog_mod._main_program = prog_mod.Program()
    prog_mod._startup_program = prog_mod.Program()
    scope_mod._global_scope = scope_mod._current_scope = scope_mod.Scope()
    with tnames.guard():
        yield
    (prog_mod._main_program, prog_mod._startup_program,
     scope_mod._global_scope, scope_mod._current_scope) = old


def _unit_mlp(seed=3):
    """tests/test_stage3_sharding.py's dropout-free MLP, whose hidden blocks
    are remat units, built with the port's DSL from the same numbers."""
    rng = np.random.RandomState(seed)

    def attr(name, shape):
        w = (rng.rand(*shape).astype("float32") - 0.5) * 0.2
        return tfluid.ParamAttr(
            name=name, initializer=tfluid.initializer.NumpyArrayInitializer(w))

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [16])
        y = tfluid.layers.data("y", [1])
        h = x
        for i in range(3):
            with tfluid.remat_unit(f"blk_{i}"):
                h = tfluid.layers.fc(h, 32, act="tanh",
                                     param_attr=attr(f"rw{i}",
                                                     (h.shape[-1], 32)),
                                     bias_attr=attr(f"rb{i}", (32,)))
        out = tfluid.layers.fc(h, 1, param_attr=attr("rwo", (32, 1)),
                               bias_attr=attr("rbo", (1,)))
        loss = tfluid.layers.mean(tfluid.layers.square(
            tfluid.layers.elementwise_sub(out, y)))
        tfluid.optimizer.Adam(0.01).minimize(loss)
    rng = np.random.RandomState(5)
    feed = {"x": rng.rand(32, 16).astype("float32"),
            "y": rng.rand(32, 1).astype("float32")}
    return main, startup, feed, loss


def _run_policy(policy, steps=3, compiled=True):
    """Loss bytes of `steps` steps of `_unit_mlp` under `policy` (through
    CompiledProgram, or the plain Executor when compiled=False)."""
    main, startup, feed, loss = _unit_mlp()
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        prog = main
        if compiled:
            bs = tfluid.BuildStrategy()
            bs.remat_policy = policy
            prog = tfluid.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name, build_strategy=bs)
        out = [exe.run(prog, feed=feed, fetch_list=[loss])[0].tobytes()
               for _ in range(steps)]
    (plan,) = [p for k, p in exe._cache.items() if k[0] == id(main)]
    return out, plan


def _regions(plan):
    return [r for kind, r in plan.items if kind == "region"]


def test_remat_policies_bitwise_on_dropout_free_model():
    ref, plan = _run_policy("none")
    assert not _regions(plan)
    for policy in ("minimal", "full"):
        got, plan = _run_policy(policy)
        assert got == ref, policy
        units = [r for r in _regions(plan) if len(r.ops) > 1]
        assert len(units) == 3 and {r.decision for r in units} == {policy}


def test_remat_policies_match_the_jax_package():
    from test_stage3_sharding import _run_policy as jax_run_policy

    jax_losses = [np.frombuffer(b, np.float32)
                  for b in jax_run_policy("full")]
    for policy in ("none", "full"):
        port = [np.frombuffer(b, np.float32) for b in _run_policy(policy)[0]]
        np.testing.assert_allclose(port, jax_losses, rtol=1e-5)


def test_remat_predicate_policy_bitwise():
    pred = lambda unit: "full" if unit.endswith("_1") else "minimal"  # noqa: E731
    got, plan = _run_policy(pred)
    assert got == _run_policy("none")[0]
    assert [r.decision for r in _regions(plan)] == ["minimal", "full",
                                                    "minimal"]


def test_remat_predicate_can_opt_units_out():
    got, plan = _run_policy(lambda unit: False)
    assert got == _run_policy("none")[0]
    assert not _regions(plan)


def test_remat_policy_rejects_unknown_string():
    from paddle_tpu_torch.core.compiler import resolve_remat
    with pytest.raises(ValueError):
        resolve_remat("everything")


def test_remat_unit_attr_tagging():
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        x = tfluid.layers.data("x", [4])
        with tfluid.remat_unit("u0"):
            h = tfluid.layers.fc(x, 4, act="relu")
        tfluid.layers.fc(h, 1)
    tagged = [op.attrs.get("__remat_unit__")
              for op in main.global_block().ops]
    assert "u0" in tagged            # ops inside the scope are tagged
    assert tagged[-1] is None        # ops outside are not


@pytest.mark.parametrize("env", [("PDTPU_REMAT_POLICY", "full"),
                                 ("PDTPU_REMAT_POLICY", "minimal"),
                                 ("PDTPU_REMAT_OPS", "tanh"),
                                 ("PDTPU_REMAT_OPS", "1")])
def test_env_remat_on_the_plain_executor_bitwise(monkeypatch, env):
    ref, _ = _run_policy(None, compiled=False)
    monkeypatch.setenv(*env)
    got, plan = _run_policy(None, compiled=False)
    assert got == ref
    regions = _regions(plan)
    assert regions
    if env[0] == "PDTPU_REMAT_OPS":  # single ops, no unit grouping
        assert all(len(r.ops) == 1 for r in regions)
        if env[1] == "tanh":
            assert [r.ops[0].type for r in regions] == ["tanh"] * 3


def test_remat_env_read_when_a_plan_is_prepared(monkeypatch):
    """A changed PDTPU_REMAT_POLICY takes effect on a new plan only, as the
    JAX package reads it when it builds a step."""
    main, startup, feed, loss = _unit_mlp()
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        exe.run(main, feed=feed, fetch_list=[loss])
        monkeypatch.setenv("PDTPU_REMAT_POLICY", "full")
        exe.run(main, feed=feed, fetch_list=[loss])
        (plan,) = [p for k, p in exe._cache.items() if k[0] == id(main)]
        assert not _regions(plan)
        main._bump_version()
        exe.run(main, feed=feed, fetch_list=[loss])
        plans = [p for k, p in exe._cache.items() if k[0] == id(main)]
        assert len(plans) == 2 and _regions(plans[1])


# -- the tiny BERT -------------------------------------------------------------
B, T = 2, 16


def _bert_cfg(bert, dropout):
    return bert.BertConfig(vocab_size=128, hidden_size=64, num_layers=2,
                           num_heads=2, ffn_size=128, max_position=T,
                           hidden_dropout=dropout, attn_dropout=dropout,
                           use_flash_attention=True)


def _bert_feed(seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 128, (B, T, 1)).astype("int64")
    labels[0, :5] = -100
    mask = np.ones((B, T), "float32")
    mask[1, 12:] = 0.0
    return {"src_ids": rng.randint(0, 128, (B, T)).astype("int64"),
            "pos_ids": np.tile(np.arange(T, dtype="int64"), (B, 1)),
            "sent_ids": (rng.rand(B, T) > 0.5).astype("int64"),
            "input_mask": mask, "mlm_labels": labels}


def _bert_build(fluid, bert, dropout):
    """The tiny BERT pretraining program (Adam), fetching the loss and every
    parameter gradient."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        cfg = _bert_cfg(bert, dropout)
        feeds = [fluid.layers.data(n, [T], dtype=dt) for n, dt in zip(
            ("src_ids", "pos_ids", "sent_ids", "input_mask"),
            ("int64", "int64", "int64", "float32"))]
        labels = fluid.layers.data("mlm_labels", [T, 1], dtype="int64")
        seq = bert.bert_encoder(cfg, *feeds)
        loss = bert.bert_pretrain_loss(cfg, seq, labels, feeds[3])
        fluid.optimizer.Adam(1e-3).minimize(loss)
    params = sorted(p.name for p in main.all_parameters())
    return main, startup, [loss.name] + [p + "@GRAD" for p in params]


def _port_bert(policy, dropout, steps=2, init=None):
    with tnames.guard():
        main, startup, fetch = _bert_build(tfluid, tbert, dropout)
    main.random_seed = 7
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        if init is not None:
            tfluid.io.load_params_from_numpy(init, scope=scope)
        bs = tfluid.BuildStrategy()
        bs.remat_policy = policy
        prog = tfluid.CompiledProgram(main).with_data_parallel(
            build_strategy=bs)
        return [exe.run(prog, feed=_bert_feed(), fetch_list=fetch)
                for _ in range(steps)]


def _bitwise(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert [x.tobytes() for x in ra] == [x.tobytes() for x in rb]


def test_dropout_masks_replay_in_the_recompute(monkeypatch):
    """At dropout 0.1 under "full" each encoder layer is one checkpointed
    region whose function runs twice a step (forward, recompute); its
    gradients equal, bit for bit, a run whose checkpoint calls the function
    once directly, and the run without remat."""
    real = texec.torch_checkpoint.checkpoint
    calls = []

    def counting(fn, *a, **k):
        def counted(*v):
            calls.append(1)
            return fn(*v)
        return real(counted, *a, **k)

    monkeypatch.setattr(texec.torch_checkpoint, "checkpoint", counting)
    full = _port_bert("full", 0.1)
    n_regions = len(calls) // 2
    assert n_regions >= 2 * 2 and len(calls) == 2 * n_regions
    monkeypatch.setattr(texec.torch_checkpoint, "checkpoint",
                        lambda fn, *a, **k: fn(*a))
    direct = _port_bert("full", 0.1)
    _bitwise(full, direct)
    monkeypatch.setattr(texec.torch_checkpoint, "checkpoint", real)
    _bitwise(full, _port_bert("none", 0.1))
    _bitwise(full, _port_bert("minimal", 0.1))
    assert full[0][0].tobytes() != _port_bert("full", 0.0)[0][0].tobytes()


def test_tiny_bert_minimal_matches_jax(monkeypatch):
    """"minimal" (the matmul outputs saved, the rest recomputed) on the
    port against the JAX package's "minimal" (PDTPU_REMAT_POLICY on its
    plain executor), dropout 0, from the JAX startup state."""
    with jnames.guard():
        jmain, jstartup, fetch = _bert_build(jfluid, jbert, 0.0)
    monkeypatch.setenv("PDTPU_REMAT_POLICY", "minimal")
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(jstartup)
        init = {v.name: np.asarray(scope.find_var(v.name))
                for v in jmain.list_vars() if v.persistable
                and scope.find_var(v.name) is not None}
        jruns = [exe.run(jmain, feed=_bert_feed(), fetch_list=fetch)
                 for _ in range(2)]
    monkeypatch.delenv("PDTPU_REMAT_POLICY")
    truns = _port_bert("minimal", 0.0, init=init)
    np.testing.assert_allclose([r[0] for r in truns], [r[0] for r in jruns],
                               rtol=1e-4)
    for j, t in zip(jruns[0][1:], truns[0][1:]):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6)


def test_multi_device_surface_raises_naming_a9():
    """Remat saveable_names runs and keeps stage off's losses; an sp dim
    without seq_axis computes replicated, as in the JAX package (checked
    on a stand-in for a mesh's named dims, as with_mesh reads them: no
    model, sequence or pipeline axis); two places
    need a world of two processes; a ZeRO stage on one device shards
    nothing (the losses are stage off's, as the JAX package's on a
    one-device mesh)."""
    import types

    main, startup, feed, loss = _unit_mlp()
    dims = types.SimpleNamespace(mesh_dim_names=("dp", "sp"), shape=(1, 2))
    prog = tfluid.CompiledProgram(main).with_mesh(dims, data_axis="dp")
    assert prog._mesh is dims and prog._data_axis == "dp"
    assert (prog._model_axes, prog._seq_axis, prog._pp_axis) == ([], None,
                                                                 None)
    with pytest.raises(RuntimeError, match="distributed.launch"):
        tfluid.CompiledProgram(main).with_data_parallel(
            places=[tfluid.CPUPlace(), tfluid.CPUPlace()])
    from paddle_tpu_torch.core.compiler import resolve_remat
    spec = resolve_remat("full", saveable_names=["fc_0.tmp_0"])
    assert spec.saveable_names == ("fc_0.tmp_0",)
    assert spec.token == ("full", ("fc_0.tmp_0",))
    exe = tfluid.Executor(tfluid.CPUPlace())
    losses = {}
    for stage in (tfluid.ShardingStrategy.off, tfluid.ShardingStrategy.stage3):
        scope = tfluid.Scope()
        with tfluid.scope_guard(scope):
            exe.run(startup)
            bs = tfluid.BuildStrategy()
            bs.remat_policy = "full"
            bs.sharding_strategy = stage
            prog = tfluid.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name, build_strategy=bs)
            losses[stage] = exe.run(prog, feed=feed,
                                    fetch_list=[loss])[0].tobytes()
    assert losses[tfluid.ShardingStrategy.off] == losses[
        tfluid.ShardingStrategy.stage3]
    # remat with named residuals (`saving_named` marks the ops that write
    # them, `_names_saveable` saves those): bitwise the losses of stage off
    bs = tfluid.BuildStrategy()
    bs.remat_policy = "full"
    bs.remat_saveable_names = ["fc_0.tmp_0"]
    prog = tfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, build_strategy=bs)
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        got = exe.run(prog, feed=feed, fetch_list=[loss])[0].tobytes()
    assert got == losses[tfluid.ShardingStrategy.off]
