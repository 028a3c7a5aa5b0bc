"""Twins of tests/test_inference_compiler.py on the port, on the CPU: the
pass report, CompiledProgram.with_inference_optimize, int8 post-training
quantization (calibrate → rewrite → gate), the fleet registry's int8 gate,
int8 PS-lookup serving with delta-push requantization, and multi-tenant
co-hosting. The models are the JAX test's, saved by the JAX package.

Held to the JAX package: with the JAX package's activation scales the
port's rewritten program has the same ops and attributes and bitwise the
same int8 weights and scales, its outputs agree within 1e-6 of the largest
output, and the port's own calibration takes the same gate decision with a
delta within 1e-4. (The perf-ledger lines of the JAX test,
`test_predictor_pass_report_lands_in_ledger`'s last assertion, wait for
the ledger: ROADMAP A10.)"""
import numpy as np
import pytest
import torch

from paddle_tpu import inference as jinf
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.core.dtypes import dtype_str, to_numpy

from _torch_twin import cpu_config, fresh_observability, fresh_port_state
from test_inference_compiler import (CAP, CLASSES, D, F, IN_DIM, MULT, V,
                                     _samples, _save_ctr, _save_mlp)

# One intra-op thread: tier-1 runs several xdist workers, and a second
# torch worker thread, started beside JAX's runtime in the same process, was
# seen to compute some batches of a CPU matmul ~1e-4 off.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield from fresh_port_state()


@pytest.fixture(autouse=True)
def _fresh_observability():
    yield from fresh_observability()


@pytest.fixture(scope="module")
def mlp_dir(tmp_path_factory):
    from paddle_tpu.core import program as prog_mod
    from paddle_tpu.core import scope as scope_mod

    old = (prog_mod._main_program, prog_mod._startup_program,
           scope_mod._global_scope, scope_mod._current_scope)
    prog_mod._main_program = prog_mod.Program()
    prog_mod._startup_program = prog_mod.Program()
    scope_mod._global_scope = scope_mod.Scope()
    scope_mod._current_scope = scope_mod._global_scope
    try:
        return _save_mlp(str(tmp_path_factory.mktemp("tinfc") / "mlp"))
    finally:
        (prog_mod._main_program, prog_mod._startup_program,
         scope_mod._global_scope, scope_mod._current_scope) = old


def _int8_cfg(model_dir, samples, **kw):
    cfg = cpu_config(model_dir)
    cfg.enable_int8(samples, **kw)
    return cfg


# -- pass pipeline ---------------------------------------------------------

def test_predictor_pass_report_lands_in_ledger(mlp_dir):
    pred = tinf.create_predictor(cpu_config(mlp_dir))
    report = pred.pass_report
    assert report is not None
    names = [r["pass"] for r in report["passes"]]
    for expected in ("fc_fuse_pass", "dead_code_elimination_pass",
                     "dead_var_elimination_pass", "layout_assignment_pass",
                     "memory_optimize_pass"):
        assert expected in names, names
    for rec in report["passes"]:
        for key in ("neutrality", "ops_before", "ops_after",
                    "flops_delta", "bytes_delta", "wall_ms"):
            assert key in rec, rec
    fc = next(r for r in report["passes"] if r["pass"] == "fc_fuse_pass")
    assert fc["ops_before"] > fc["ops_after"]
    assert report["ops_total_removed"] >= (
        fc["ops_before"] - fc["ops_after"])
    assert report["label"].startswith("infer:")
    assert pred._program._layout_plan["matmul_ops"]
    # the same passes, in the same order, with the same op counts as the
    # JAX package's report
    jreport = jinf.create_predictor(jinf.Config(mlp_dir)).pass_report
    assert [(r["pass"], r["ops_before"], r["ops_after"])
            for r in report["passes"]] == [
        (r["pass"], r["ops_before"], r["ops_after"])
        for r in jreport["passes"]]


def test_compiled_program_inference_optimize_runs_pipeline():
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import compiler

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [IN_DIM])
        h = fluid.layers.fc(x, 32, act="relu")
        out = fluid.layers.fc(h, CLASSES)  # noqa: F841
    cp = compiler.CompiledProgram(main).with_inference_optimize(
        tinf.Config())
    ops = [op.type for op in cp._program.global_block().ops]
    assert "fused_fc" in ops
    assert cp._program._pass_report["passes"]
    # no config: only frozen to the test-mode graph
    cp2 = compiler.CompiledProgram(main).with_inference_optimize()
    assert "fused_fc" not in [op.type
                              for op in cp2._program.global_block().ops]


# -- int8 post-training quantization ---------------------------------------

def test_int8_quantizes_and_matches_fp32(mlp_dir):
    samples = _samples()
    p32 = tinf.create_predictor(cpu_config(mlp_dir))
    p8 = tinf.create_predictor(_int8_cfg(mlp_dir, samples))

    ops = [op.type for op in p8._program.global_block().ops]
    assert ops.count("quantized_fc") == 2 and "fused_fc" not in ops
    dtypes = {k: dtype_str(v.dtype) for k, v in p8._state.items()}
    assert [k for k in dtypes if k.endswith("@int8")]
    assert all(dtypes[k] == "int8" for k in dtypes if k.endswith("@int8"))
    assert not [k for k, d in dtypes.items()
                if d == "float32" and k.endswith(".w_0")]

    meta = p8.quant_meta
    assert meta["precision"] == "int8"
    assert meta["samples"] == len(samples)
    assert 0.0 <= meta["accuracy_delta"] <= meta["accuracy_budget"]
    assert meta["fc"] and meta["act_scales"]

    for f in samples:
        ref = p32.run(f)[0]
        got = p8.run(f)[0]
        assert float(np.mean(np.abs(got - ref))) <= 0.05 * (
            float(np.mean(np.abs(ref))) + 1e-8)

    assert "int8_quantize_pass" in [r["pass"]
                                    for r in p8.pass_report["passes"]]

    c = p8.clone()
    assert c.quant_meta is p8.quant_meta
    np.testing.assert_array_equal(p8.run(samples[0])[0],
                                  c.run(samples[0])[0])


def _op_descs(program):
    return [(op.type, op.inputs, op.outputs, op.attrs)
            for op in program.global_block().ops]


def test_int8_rewrite_matches_jax(mlp_dir):
    """With the JAX package's activation scales the port's pass rewrites
    the same program, bitwise the same int8 state; outputs agree; the
    port's own calibration takes the JAX package's gate decision."""
    from paddle_tpu_torch.ir import PassPipeline

    samples = _samples()
    jp = jinf.create_predictor(_jax_int8_cfg(mlp_dir, samples))
    tp = tinf.create_predictor(cpu_config(mlp_dir))
    tp._program = PassPipeline(
        ["int8_quantize_pass", "dead_var_elimination_pass"]).run(
        tp._program, state=tp._state,
        act_scales=jp.quant_meta["act_scales"],
        keep=tp._fetch_names, fetch_names=tp._fetch_names)
    assert _op_descs(tp._program) == _op_descs(jp._program)
    assert sorted(tp._state) == sorted(jp._state)
    for k, v in jp._state.items():
        want = np.asarray(v)
        got = to_numpy(tp._state[k])
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for f in samples:
        want = np.asarray(jp.run(f)[0])
        got = tp.run(f)[0]
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()))

    own = tinf.create_predictor(_int8_cfg(mlp_dir, samples)).quant_meta
    assert abs(own["accuracy_delta"]
               - jp.quant_meta["accuracy_delta"]) <= 1e-4
    assert own["act_scales"] == pytest.approx(jp.quant_meta["act_scales"],
                                              rel=1e-6)


def _jax_int8_cfg(model_dir, samples, **kw):
    cfg = jinf.Config(model_dir)
    cfg.enable_int8(samples, **kw)
    return cfg


def test_int8_accuracy_gate_rejects_over_budget(mlp_dir):
    with pytest.raises(tinf.QuantizationError, match="accuracy gate"):
        tinf.create_predictor(_int8_cfg(mlp_dir, _samples(),
                                        accuracy_budget=1e-9))
    # the JAX package refuses the same budget
    with pytest.raises(jinf.QuantizationError, match="accuracy gate"):
        jinf.create_predictor(_jax_int8_cfg(mlp_dir, _samples(),
                                            accuracy_budget=1e-9))


def test_int8_without_calibration_stream_raises(mlp_dir):
    with pytest.raises(tinf.QuantizationError, match="calibration stream"):
        tinf.create_predictor(cpu_config(mlp_dir), precision="int8")
    with pytest.raises(ValueError, match="at least one sample"):
        cpu_config(mlp_dir).enable_int8([])


def test_int8_with_nothing_to_quantize_raises(tmp_path):
    """A program with no matmul or embedding: both packages refuse."""
    import paddle_tpu as jfluid

    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        x = jfluid.layers.data("x", [IN_DIM])
        out = jfluid.layers.relu(jfluid.layers.scale(x, 2.0))
    exe = jfluid.Executor(jfluid.CPUPlace())
    d = str(tmp_path / "noquant")
    jfluid.io.save_inference_model(d, ["x"], [out], exe, main)
    for make, cfg in ((jinf.create_predictor, _jax_int8_cfg(d, _samples())),
                      (tinf.create_predictor, _int8_cfg(d, _samples()))):
        with pytest.raises(ValueError, match="nothing to quantize"):
            make(cfg)


def test_unknown_precision_raises_not_silent_fp32(mlp_dir):
    with pytest.raises(ValueError, match="unknown precision"):
        tinf.create_predictor(cpu_config(mlp_dir), precision="fp31")
    with pytest.raises(ValueError, match="unknown precision"):
        tinf.Config(mlp_dir).enable_tpu(precision="in8")
    for ok in ("fp32", "float32", "bf16", "int8", "i8"):
        assert tinf._resolve_precision(ok) == jinf._resolve_precision(ok)


# -- registry promotion gate -----------------------------------------------

def test_registry_gates_int8_promotion(mlp_dir):
    from paddle_tpu_torch.serving import fleet

    reg = fleet.ModelRegistry()
    with pytest.raises(ValueError, match="no calibration metadata"):
        reg.register("q-bad", mlp_dir, precision="int8")
    with pytest.raises(ValueError, match="exceeds budget"):
        reg.register("q-worse", mlp_dir, precision="int8",
                     calibration={"accuracy_delta": 0.2,
                                  "accuracy_budget": 0.05, "samples": 4})
    mv = reg.register("q-ok", mlp_dir, precision="int8",
                      calibration={"accuracy_delta": 0.008,
                                   "accuracy_budget": 0.05, "samples": 4})
    assert mv.meta["calibration"]["accuracy_delta"] == 0.008
    reg.register("f32", mlp_dir)
    assert len(reg) == 2


# -- quantized PS-lookup serving + delta-push requantization ---------------

def test_ps_lookup_int8_delta_push_requantizes(tmp_path):
    import jax.numpy as jnp

    from paddle_tpu.ops.deferred_rows import pack_rows
    from paddle_tpu_torch.inference.quant import requantize_packed_rows
    from paddle_tpu_torch.ps import RangeSpec, ShardedTable

    vis = np.random.RandomState(7).uniform(-1, 1, (V, D)).astype("float32")
    full = np.zeros((V, D * MULT), "float32")
    full[:, :D] = vis
    packed = np.asarray(pack_rows(jnp.asarray(full)))
    dense = _save_ctr(str(tmp_path / "local"), V, packed=packed)
    _save_ctr(str(tmp_path / "ps"), CAP, dense=dense)
    table_scale = float(np.max(np.abs(vis)))

    rng = np.random.RandomState(3)
    samples = [{"ids": rng.randint(0, CAP, (2, F)).astype(np.int64)}
               for _ in range(3)]
    table = ShardedTable.build_in_process(
        "tb", RangeSpec.even(V, 3), full_rows=packed)
    try:
        base = tinf.create_predictor(_int8_cfg(
            str(tmp_path / "ps"), samples, accuracy_budget=10.0,
            table_scales={"tb": table_scale}))
        ops = [op.type for op in base._program.global_block().ops]
        assert "quantized_lookup_table" in ops
        ps = tinf.PsLookupPredictor(
            base, [tinf.PsLookupBinding("tb", table, ["ids"])],
            cache_rows_per_table=32)
        q = ps._quant["tb"]
        cache = ps._caches["tb"]
        assert str(cache.dtype) == "int8"

        ref = tinf.create_predictor(cpu_config(str(tmp_path / "local")))
        ids = rng.randint(0, V, (2, F)).astype(np.int64)
        o_ref = ref.run({"ids": ids})[0]
        o_ps = ps.run({"ids": ids})[0]
        assert float(np.abs(o_ref - o_ps).max()) < 0.05

        touched = np.unique(ids.reshape(-1))
        nvis = np.random.RandomState(9).uniform(
            -1, 1, (touched.size, D)).astype("float32")
        nrows = np.zeros((touched.size, D * MULT), "float32")
        nrows[:, :D] = nvis
        new_packed = np.asarray(pack_rows(jnp.asarray(nrows)))
        assert ps.apply_delta("tb", touched, new_packed) == touched.size

        got, miss = cache.lookup(touched)
        assert not miss.any()
        want = requantize_packed_rows(new_packed, q["dt"], q["scale"])
        np.testing.assert_array_equal(got, want)
        raw = new_packed[:, :q["dt"]].astype(np.int8)
        assert not np.array_equal(got, raw)

        o2 = ps.run({"ids": ids})[0]
        assert float(np.abs(o2 - o_ps).max()) > 1e-6
        # the JAX package's int8 serving of the same ids after the same
        # delta gives the same outputs
        from paddle_tpu.ps import RangeSpec as JSpec
        from paddle_tpu.ps import ShardedTable as JTable
        jtable = JTable.build_in_process("tb", JSpec.even(V, 3),
                                         full_rows=packed)
        try:
            jps = jinf.PsLookupPredictor(
                jinf.create_predictor(_jax_int8_cfg(
                    str(tmp_path / "ps"), samples, accuracy_budget=10.0,
                    table_scales={"tb": table_scale})),
                [jinf.PsLookupBinding("tb", jtable, ["ids"])],
                cache_rows_per_table=32)
            jps.run({"ids": ids})
            jps.apply_delta("tb", touched, new_packed)
            np.testing.assert_allclose(
                o2, np.asarray(jps.run({"ids": ids})[0]), rtol=1e-6,
                atol=1e-7)
        finally:
            jtable.close()
    finally:
        table.close()


# -- multi-tenant co-hosting -----------------------------------------------

def _two_model_registry(tmp_path):
    from paddle_tpu_torch.serving import fleet

    reg = fleet.ModelRegistry()
    reg.register("v1", _save_mlp(str(tmp_path / "v1"), seed=1))
    reg.register("v2", _save_mlp(str(tmp_path / "v2"), seed=2))
    return reg


def test_multi_tenant_fleet_routing_and_slo(tmp_path):
    from paddle_tpu_torch.serving import fleet

    reg = _two_model_registry(tmp_path)
    ref1 = tinf.create_predictor(cpu_config(reg.resolve("v1").model_dir))
    ref2 = tinf.create_predictor(cpu_config(reg.resolve("v2").model_dir))
    tenants = {
        "ads": {"version": "v1", "weight": 2.0, "slo_p99_ms": 5000.0},
        "feed": {"version": "v2", "weight": 1.0, "slo_p99_ms": 5000.0},
        "search": {"version": "v1", "weight": 1.0, "slo_p99_ms": 5000.0},
    }
    fl = fleet.ServingFleet(
        reg, replicas=4, buckets=(1, 2, 4),
        server_kwargs={"max_batch_delay_ms": 1.0},
        health_interval_s=0.1, tenants=tenants, device="cpu")
    with fl:
        by_tenant = {}
        for r in fl.replicas:
            by_tenant.setdefault(r.tenant, []).append(r.version)
        assert sorted(len(v) for v in by_tenant.values()) == [1, 1, 2]
        assert set(by_tenant) == set(tenants)
        assert set(by_tenant["feed"]) == {"v2"}

        rng = np.random.RandomState(0)
        feeds = [rng.randn(2, IN_DIM).astype(np.float32)
                 for _ in range(6)]
        for x in feeds:
            o_ads = fl.infer({"x": x}, tenant="ads")[0]
            o_feed = fl.infer({"x": x}, tenant="feed")[0]
            np.testing.assert_array_equal(o_ads, ref1.run({"x": x})[0])
            np.testing.assert_array_equal(o_feed, ref2.run({"x": x})[0])
            fl.infer({"x": x}, tenant="search")

        stats = fl.tenant_stats()
        assert set(stats) == set(tenants)
        for name, st in stats.items():
            assert st["requests"] >= 6, (name, st)
            assert st["p99_ms"] is not None
            assert st["slo_ok"] is True, (name, st)
        assert stats["ads"]["share"] == 2 * stats["feed"]["share"]

        with pytest.raises(ValueError, match="unknown tenant"):
            fl.infer({"x": feeds[0]}, tenant="video")


def test_tenant_throttling_and_isolation(tmp_path):
    from paddle_tpu_torch.serving import fleet
    from paddle_tpu_torch.serving.fleet import TenantThrottledError

    reg = _two_model_registry(tmp_path)
    fl = fleet.ServingFleet(
        reg, replicas=2, buckets=(1, 2, 4),
        server_kwargs={"max_batch_delay_ms": 1.0},
        health_interval_s=0.1,
        tenants={"a": {"version": "v1", "weight": 1.0},
                 "b": {"version": "v1", "weight": 1.0}},
        tenant_capacity=2, device="cpu")
    x = np.zeros((1, IN_DIM), np.float32)
    with fl:
        fl.infer({"x": x}, tenant="a")
        fl.router._tenant_out["a"] = 1
        with pytest.raises(TenantThrottledError):
            fl.submit({"x": x}, tenant="a")
        assert fl.tenant_stats()["a"]["throttled"] == 1
        assert fl.infer({"x": x}, tenant="b")[0].shape == (1, CLASSES)
        fl.router._tenant_out["a"] = 0
        fl.infer({"x": x}, tenant="a")


def test_tenant_rollout_swaps_only_that_partition(tmp_path):
    from paddle_tpu_torch.serving import fleet

    reg = _two_model_registry(tmp_path)
    fl = fleet.ServingFleet(
        reg, replicas=2, buckets=(1, 2, 4),
        server_kwargs={"max_batch_delay_ms": 1.0},
        health_interval_s=0.1,
        tenants={"a": {"version": "v1", "weight": 1.0},
                 "b": {"version": "v1", "weight": 1.0}}, device="cpu")
    with fl:
        report = fl.rollout("v2", tenant="a")
        assert all(name.startswith("a/")
                   for name in report["replicas"]), report
        versions = {r.tenant: r.version for r in fl.replicas}
        assert versions == {"a": "v2", "b": "v1"}
