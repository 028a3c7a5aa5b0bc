"""The port's perf-attribution ledger, calibration cache and roofline CLI,
on the CPU: twins of tests/test_perf.py (less its ``test_gate_*`` tests,
whose bench gate is not ported), on the same inputs as the JAX package.

Where the JAX package reads XLA's ``cost_analysis``, the port counts one
dispatch under a ``TorchDispatchMode`` (the ``counted`` source): a matmul's
flops equal XLA's and its bytes equal XLA's ``memory_analysis`` (arguments
plus output). The analytic IR walk, ``attribute()``, the calibration
cache's placeholder / cache / recalibrate cycle, the eager op-profile
export and the roofline tables of a canned trace are held equal to the JAX
package's. Then the port's own cases: a ``torch.profiler``-style trace
(device events by ``cat``, demangled names) gives the right kernel table
and joins the hand kernels' declared counts, and the counted source counts
once per plan (a replayed step registers nothing)."""
import gzip
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.observability import calibrate as jcalibrate
from paddle_tpu.observability import perf as jperf
from paddle_tpu.tools import roofline as jroofline
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import unique_name as tnames
from paddle_tpu_torch.observability import calibrate, perf
from paddle_tpu_torch.observability.registry import get_registry
from paddle_tpu_torch.observability.steps import get_step_profiler
from paddle_tpu_torch.tools import roofline

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_ledger():
    perf.get_ledger().reset()
    yield
    perf.get_ledger().reset()


def _tiny_train_program(fluid, width=8):
    main_p, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_p, startup):
        x = fluid.layers.data("x", [width], dtype="float32")
        y = fluid.layers.fc(x, size=4)
        loss = fluid.layers.reduce_mean(y * y)
        fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return main_p, startup, loss


def _port_program(width=8):
    with tnames.guard():
        return _tiny_train_program(tfluid, width)


# -- the counted source (XLA's cost_analysis in the JAX package) -----------

def test_counted_source_matmul_matches_xla_cost():
    import jax
    import jax.numpy as jnp

    compiled = jax.jit(lambda a, b: a @ b).lower(
        jnp.ones((64, 32)), jnp.ones((32, 16))).compile()
    xla = jperf.cost_from_executable(compiled)
    a, b = torch.ones(64, 32), torch.ones(32, 16)
    with perf.counting() as c:
        a @ b
    cost = c.cost()
    assert cost["flops"] == xla["flops"] == 2 * 64 * 32 * 16
    # args + out, as the JAX package's memory_analysis counts them
    assert cost["bytes_accessed"] == jperf.memory_from_executable(compiled) \
        == (64 * 32 + 32 * 16 + 64 * 16) * 4


def test_counted_source_rejects_empty_and_adds_declared_kernels():
    from paddle_tpu_torch.observability import kernel_counts

    with perf.counting() as c:
        torch.empty(4)                 # an allocation moves nothing
    assert c.cost() is None
    assert perf.get_ledger().register("0xbeef", "s",
                                      counted=c.cost()) is None
    with perf.counting() as c:
        kernel_counts.declare("k[f32]", ("k_kernel",), 10.0, 20.0)
        kernel_counts.declare("k[f32]", ("k_kernel",), 1.0, torch.tensor(2.0))
    assert c.cost()["flops"] == 11.0 and c.cost()["bytes_accessed"] == 22.0
    assert c.kernels == {"k[f32]": {"kernels": ["k_kernel"], "calls": 2,
                                    "flops": 11.0, "bytes": 22.0}}
    assert not kernel_counts.active()  # the collector is gone after the block


def test_analytic_cost_counts_matmul_flops_and_backward():
    feed = {"x": np.ones((4, 8), dtype=np.float32)}
    jmain, _, _ = _tiny_train_program(jfluid)
    tmain, _, _ = _port_program()
    cost = perf.analytic_cost(tmain, feed)
    assert cost == jperf.analytic_cost(jmain, feed)
    assert cost["flops"] == pytest.approx(3 * 2 * 4 * 8 * 4)
    fwd_p, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(fwd_p, startup):
        x = tfluid.layers.data("x", [8], dtype="float32")
        tfluid.layers.fc(x, size=4)
    assert perf.analytic_cost(fwd_p, feed)["flops"] == pytest.approx(
        2 * 4 * 8 * 4)


# -- attribute() math ---------------------------------------------------------

def _calibs(mm=100.0, stream=1000.0, peak=200e12):
    return [mod.Calibration(device_kind="test", on_tpu=True,
                            matmul_tflops=mm, stream_gbs=stream,
                            peak_flops=peak, source="measured")
            for mod in (jcalibrate, calibrate)]


def test_attribute_known_numbers():
    jc, tc = _calibs()
    att = perf.attribute(flops=1e12, bytes_accessed=1e9, seconds=0.5,
                         calib=tc)
    assert att == jperf.attribute(flops=1e12, bytes_accessed=1e9,
                                  seconds=0.5, calib=jc)
    assert att["achieved_tflops"] == pytest.approx(2.0)
    assert att["mfu"] == pytest.approx(1e12 / 0.5 / 200e12)
    assert att["roofline_fraction"] == pytest.approx(0.01 / 0.5)
    assert att["bound"] == "matmul"


def test_attribute_memory_bound_and_uncapped_fraction():
    jc, tc = _calibs()
    att = perf.attribute(bytes_accessed=4e9, seconds=0.002, calib=tc)
    assert att == jperf.attribute(bytes_accessed=4e9, seconds=0.002,
                                  calib=jc)
    assert att["bound"] == "memory"
    assert att["roofline_fraction"] == pytest.approx(2.0)


# -- ledger + dispatch sites --------------------------------------------------

def _train(main_p, startup, loss, steps=3, batch=2):
    feed = {"x": np.ones((batch, 8), dtype=np.float32)}
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        for _ in range(steps):
            exe.run(main_p, feed=feed, fetch_list=[loss])
    return exe


def test_executor_run_registers_and_sets_gauges():
    main_p, startup, loss = _port_program()
    _train(main_p, startup, loss)
    key = f"0x{id(main_p):x}"
    mine = {k: v for k, v in perf.get_ledger().snapshot().items()
            if k.startswith(key)}
    assert mine, f"no ledger entry for {key}"
    entry = next(iter(mine.values()))
    assert entry["source"] == "counted"
    # the forward mm and the weight gradient's (x, a feed, takes none)
    assert entry["flops"] == pytest.approx(2 * 2 * 2 * 8 * 4)
    series = get_registry().snapshot()
    for g in ("perf/mfu", "perf/roofline_fraction", "perf/achieved_tflops",
              "perf/achieved_gbs"):
        assert any(k.startswith(g + "{") and key in k for k in series), g


def test_step_records_carry_achieved_tflops():
    main_p, startup, loss = _port_program()
    _train(main_p, startup, loss)
    key = f"0x{id(main_p):x}"
    recs = [r for r in get_step_profiler().records()
            if r.get("program") == key and not r.get("compile")]
    assert recs and any("achieved_tflops" in r for r in recs)


def test_counted_source_counts_once_per_plan():
    """The count runs inside the plan's first run only: a replayed step
    registers nothing and leaves the entry as it was."""
    main_p, startup, loss = _port_program()
    feed = {"x": np.ones((2, 8), dtype=np.float32)}
    exe = tfluid.Executor(tfluid.CPUPlace())
    calls = []
    real = perf.counting

    def spy():
        calls.append(1)
        return real()

    perf.counting = spy
    try:
        with tfluid.scope_guard(tfluid.Scope()):
            exe.run(startup)
            exe.run(main_p, feed=feed, fetch_list=[loss])
            first = dict(perf.get_ledger().snapshot())
            n_first = len(calls)
            for _ in range(3):
                exe.run(main_p, feed=feed, fetch_list=[loss])
    finally:
        perf.counting = real
    assert n_first == 2                  # the startup run and main's first
    assert len(calls) == n_first         # replays count nothing
    snap = perf.get_ledger().snapshot()
    assert set(snap) == set(first)
    for k, v in snap.items():
        assert v["flops"] == first[k]["flops"]


def test_scan_driver_registers_whole_scan_cost():
    main_p, startup, loss = _port_program()
    feed = {"x": np.ones((2, 8), dtype=np.float32)}
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        exe.train_scanned(main_p, reader=lambda: iter([feed] * 8),
                          scan_steps=4, fetch_list=[loss])
    entries = [v for k, v in perf.get_ledger().snapshot().items()
               if k.startswith(f"0x{id(main_p):x}") and v["steps"] == 4]
    assert entries, "no steps=4 scan entry registered"
    assert entries[0]["flops"] == pytest.approx(4 * 2 * 2 * 2 * 8 * 4)


def test_ledger_disabled_by_env(monkeypatch):
    monkeypatch.setenv("PDTPU_PERF_LEDGER", "0")
    assert not perf.enabled() and not jperf.enabled()
    main_p, _, _ = _port_program()
    out = perf.get_ledger().register("0xdead", "sig", program=main_p,
                                     feed={"x": np.ones((2, 8), "f4")})
    assert out is None
    assert perf.get_ledger().snapshot() == {}


def test_trace_cost_off_falls_back_to_analytic(monkeypatch):
    monkeypatch.setenv("PDTPU_PERF_TRACE_COST", "0")
    main_p, startup, loss = _port_program()
    _train(main_p, startup, loss, steps=1)
    (entry,) = [v for k, v in perf.get_ledger().snapshot().items()
                if k.startswith(f"0x{id(main_p):x}")]
    assert entry["source"] == "analytic"


def test_planner_estimate_plan_predicts_flops_and_bytes():
    from paddle_tpu_torch import planner

    main_p, startup, loss = _port_program()
    feed = {"x": np.ones((8, 8), dtype=np.float32)}
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        plan = planner.estimate_plan(planner.Plan(0, "none", 1), main_p,
                                     feed, loss.name, place=tfluid.CPUPlace())
    assert plan.source == "measured"
    assert plan.predicted_flops and plan.predicted_flops > 0
    assert plan.predicted_bytes_accessed and plan.predicted_bytes_accessed > 0
    assert plan.to_dict()["predicted_flops"] == plan.predicted_flops


def test_predictor_registers_and_attributes(tmp_path):
    """Predictor.run: a signature's first run is counted into the ledger,
    a warm run sets the perf gauges of that entry."""
    main_p, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main_p, startup):
        x = tfluid.layers.data("x", [8], dtype="float32")
        y = tfluid.layers.fc(x, size=4)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        tfluid.io.save_inference_model(str(tmp_path), ["x"], [y], exe,
                                       main_program=main_p)
    from _torch_twin import cpu_config
    from paddle_tpu_torch import inference

    pred = inference.create_predictor(cpu_config(str(tmp_path)))
    feed = {"x": np.ones((3, 8), np.float32)}
    pred.run(feed)
    key = f"0x{id(pred._program):x}"
    (entry,) = [v for k, v in perf.get_ledger().snapshot().items()
                if k.startswith(key)]
    assert entry["source"] == "counted"
    assert entry["flops"] == pytest.approx(2 * 3 * 8 * 4)
    pred.run(feed)
    assert "last" in perf.get_ledger().snapshot()[
        next(k for k in perf.get_ledger().snapshot() if k.startswith(key))]


# -- calibration cache ----------------------------------------------------------

def test_calibration_cache_miss_write_hit_and_recalibrate(
        tmp_path, monkeypatch):
    monkeypatch.setenv("PDTPU_CALIBRATION_DIR", str(tmp_path))
    calibrate.reset()
    try:
        c1 = calibrate.get_calibration()
        assert c1.source == "placeholder"
        assert c1.floors == (1.0, 10.0)
        assert c1.peak_flops == 1e12
        path = calibrate.cache_path()
        assert os.path.exists(path) and str(tmp_path) in path
        assert calibrate.get_calibration() is c1
        calibrate.reset()
        c2 = calibrate.get_calibration()
        assert c2.source == "cache" and c2.floors == c1.floors
        doc = json.load(open(path))
        doc["matmul_tflops"] = 42.5
        json.dump(doc, open(path, "w"))
        calibrate.reset()
        assert calibrate.get_calibration().matmul_tflops == 42.5
        c3 = calibrate.get_calibration(recalibrate=True)
        assert c3.source == "placeholder" and c3.matmul_tflops == 1.0
        assert json.load(open(path))["matmul_tflops"] == 1.0
        os.replace(path, calibrate.cache_path(device_kind="other-chip"))
        calibrate.reset()
        assert calibrate.get_calibration().source == "placeholder"
    finally:
        calibrate.reset()
    # the JAX package's placeholder floors and CPU peak, and the card's
    # datasheet rates where the JAX package had its TPU's
    assert calibrate.measure_floors(False) == jcalibrate.measure_floors(False)
    assert calibrate.peak_flops(False) == jcalibrate.peak_flops(False)
    assert calibrate.peak_flops(True) == 989e12
    assert calibrate.cache_path(device_kind="NVIDIA H100 80GB HBM3",
                                host="h").endswith(
        "NVIDIA_H100_80GB_HBM3_h.json")


# -- eager op profile export ------------------------------------------------------

def test_export_op_profile_reaches_registry():
    from paddle_tpu_torch import profiler as prof

    timer = prof._OpTimer()
    timer.times["op_perf_test_a"] = 0.25
    timer.counts["op_perf_test_a"] = 3
    timer.times["op_perf_test_b"] = 0.5
    timer.counts["op_perf_test_b"] = 1
    prof.export_op_profile(timer)
    reg = get_registry()
    assert reg.gauge("eager/op_ms", op="op_perf_test_a").value == \
        pytest.approx(250.0)
    assert reg.counter("eager/op_calls", op="op_perf_test_a").value == 3
    assert reg.counter("eager/op_calls", op="op_perf_test_b").value == 1
    prof.export_op_profile(timer)
    assert reg.gauge("eager/op_ms", op="op_perf_test_a").value == \
        pytest.approx(500.0)
    from paddle_tpu import profiler as jprof
    assert timer.summary() == _jax_summary(jprof, timer)


def _jax_summary(jprof, timer):
    jt = jprof._OpTimer()
    jt.times.update(timer.times)
    jt.counts.update(timer.counts)
    return jt.summary()


# -- roofline CLI ---------------------------------------------------------------

def _canned_trace(kernels):
    """The JAX test's chrome trace: TPU process metadata and an 'XLA Ops'
    thread; kernels = [(name, dur_us, bytes, flops), ...]."""
    ev = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "pid": 1, "tid": 2, "name": "thread_name",
         "args": {"name": "XLA Ops"}},
        {"ph": "M", "pid": 9, "name": "process_name",
         "args": {"name": "python host"}},
        {"ph": "X", "pid": 9, "tid": 1, "name": "hostwork", "dur": 99999.0},
    ]
    ts = 0.0
    for name, dur, by, fl in kernels:
        ev.append({"ph": "X", "pid": 1, "tid": 2, "name": name, "ts": ts,
                   "dur": dur, "args": {"bytes_accessed": by,
                                        "model_flops": fl}})
        ts += dur
    return {"traceEvents": ev}


def test_kernel_table_math_and_tail():
    tr = _canned_trace([("fusion.1", 1000.0, 1e9, 5e8),
                        ("fusion.2", 2000.0, 1e9, 0.0),
                        ("tiny.3", 10.0, 1e6, 0.0)])
    tab = roofline.kernel_table(tr, floors=(100.0, 500.0), cutoff_ms=0.5)
    assert tab == jroofline.kernel_table(tr, floors=(100.0, 500.0),
                                         cutoff_ms=0.5)
    assert tab["device_ms_per_step"] == pytest.approx(3.01)
    assert [r["kernel"] for r in tab["kernels"]] == ["fusion.2", "fusion.1"]
    top = {r["kernel"]: r for r in tab["kernels"]}
    assert top["fusion.1"]["util_vs_bound"] == pytest.approx(2.0)
    assert tab["tail"]["n_kernel_names"] == 1


def test_roofline_cli_json_and_diff(tmp_path, capsys):
    a = tmp_path / "a.trace.json.gz"
    with gzip.open(a, "wt") as f:
        json.dump(_canned_trace([("fusion.1", 1000.0, 1e9, 0.0),
                                 ("fusion.2", 500.0, 5e8, 0.0)]), f)
    b = tmp_path / "b.trace.json"
    b.write_text(json.dumps(_canned_trace(
        [("fusion.1", 2000.0, 1e9, 0.0), ("fusion.9", 100.0, 1e8, 0.0)])))
    docs = {}
    for key, mod in (("jax", jroofline), ("port", roofline)):
        assert mod.main([str(a), "--json", "--matmul-tflops", "100",
                         "--stream-gbs", "500", "--cutoff-ms", "0.2"]) == 0
        one = json.loads(capsys.readouterr().out)
        assert mod.main([str(a), "--diff", str(b), "--json",
                         "--matmul-tflops", "100", "--stream-gbs", "500",
                         "--cutoff-ms", "0.05"]) == 0
        docs[key] = (one, json.loads(capsys.readouterr().out))
        assert mod.main([str(tmp_path / "missing.json")]) == 2
    assert docs["port"] == docs["jax"]
    one, diff = docs["port"]
    assert one["floors"]["source"] == "flags"
    movers = {m["kernel"]: m for m in diff["diff"]["movers"]}
    assert movers["fusion.1"]["delta_ms"] == pytest.approx(1.0)
    assert "fusion.2" in diff["diff"]["only_in_a"]
    assert "fusion.9" in diff["diff"]["only_in_b"]


# -- torch.profiler traces ----------------------------------------------------

def torch_style_trace(kernels, host_ops=()):
    """A torch.profiler chrome trace: host ops (cat cpu_op) on the process
    pid, device work (cat kernel / gpu_memcpy) on the card's pid, one tid a
    stream, demangled names; kernels = [(name, cat, dur_us), ...]."""
    ev = [{"ph": "M", "pid": 1234, "name": "process_name",
           "args": {"name": "python3"}},
          {"ph": "M", "pid": 0, "name": "process_name",
           "args": {"name": "python3"}},
          {"ph": "M", "pid": 0, "tid": 7, "name": "thread_name",
           "args": {"name": "stream 7"}}]
    for name, dur in host_ops:
        ev.append({"ph": "X", "cat": "cpu_op", "pid": 1234, "tid": 1234,
                   "name": name, "ts": 0.0, "dur": dur})
    ts = 0.0
    for name, cat, dur in kernels:
        ev.append({"ph": "X", "cat": cat, "pid": 0, "tid": 7, "name": name,
                   "ts": ts, "dur": dur,
                   "args": {"External id": 1, "correlation": 2}})
        ts += dur
    return {"traceEvents": ev, "deviceProperties": [{"name": "H100"}]}


FWD = "void fa::flash_fwd_bf16_kernel<64>(fa::FwdParams)"
DQ = "void fa::flash_bwd_dq_bf16_kernel<64>(fa::BwdParams)"
DKV = "void fa::flash_bwd_dkv_bf16_kernel<64>(fa::BwdParams)"
DELTA = "void fa::flash_bwd_delta_kernel<__nv_bfloat16, 64>(fa::D)"
GEMM = "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNT"


def test_torch_trace_kernel_table_keys_on_device_cats():
    tr = torch_style_trace(
        [(FWD, "kernel", 1000.0), (FWD, "kernel", 1000.0),
         (GEMM, "kernel", 3000.0), ("Memcpy HtoD (Pageable -> Device)",
                                    "gpu_memcpy", 500.0)],
        host_ops=[("aten::mm", 99999.0), ("cudaLaunchKernel", 5.0)])
    tab = roofline.kernel_table(tr, floors=(989.0, 3350.0), steps=2,
                                cutoff_ms=0.0)
    rows = {r["kernel"]: r for r in tab["kernels"]}
    # host ops never count; the hand kernel reads by its label
    assert set(rows) == {"flash_fwd_bf16_kernel<64>", GEMM,
                         "Memcpy HtoD (Pageable -> Device)"}
    assert rows["flash_fwd_bf16_kernel<64>"]["calls"] == 2
    assert rows["flash_fwd_bf16_kernel<64>"]["ms"] == pytest.approx(1.0)
    assert tab["device_ms_per_step"] == pytest.approx(2.75)
    # a trace without the cats: the JAX package's rule, every X event
    bare = {"traceEvents": [e for e in tr["traceEvents"]
                            if e.get("cat") != "kernel"
                            and e.get("cat") != "gpu_memcpy"]}
    assert {r["kernel"] for r in roofline.kernel_table(
        bare, (1.0, 1.0), cutoff_ms=0.0)["kernels"]} == {
        "aten::mm", "cudaLaunchKernel"}


def test_declared_counts_join_the_kernel_rows(tmp_path):
    """A session's declared counts (one forward and one backward row) join
    the trace's kernels by base name: the forward's single kernel row gets
    its bytes and flops, and each declared row sums its kernels' time."""
    tr = torch_style_trace([(FWD, "kernel", 100.0), (DELTA, "kernel", 10.0),
                            (DQ, "kernel", 150.0), (DKV, "kernel", 240.0)])
    d = tmp_path / "s"
    d.mkdir()
    (d / "h_1_2.pt.trace.json").write_text(json.dumps(tr))
    declared = {
        "flash_attention_fwd[bf16]": {
            "kernels": ["flash_fwd_bf16_kernel"], "calls": 1,
            "flops": 4e9, "bytes": 2e8},
        "flash_attention_bwd[bf16]": {
            "kernels": ["flash_bwd_delta_kernel", "flash_bwd_dq_bf16_kernel",
                        "flash_bwd_dkv_bf16_kernel"], "calls": 1,
            "flops": 1e10, "bytes": 4e8}}
    (d / "h_1_2.pt.declared.json").write_text(json.dumps(declared))
    tab = roofline.kernel_table(roofline.load_trace(str(d)),
                                floors=(989.0, 3350.0), cutoff_ms=0.0)
    fwd_row = next(r for r in tab["kernels"]
                   if r["kernel"] == "flash_fwd_bf16_kernel<64>")
    assert fwd_row["tfs"] == pytest.approx(40.0)    # 4e9 / 100 us
    assert fwd_row["gbs"] == pytest.approx(2000.0)
    hand = {h["name"]: h for h in tab["hand_kernels"]}
    bwd = hand["flash_attention_bwd[bf16]"]
    assert bwd["ms"] == pytest.approx(0.4)
    assert bwd["calls"] == 3 and bwd["launches"] == 1
    assert bwd["tfs"] == pytest.approx(25.0)        # 1e10 / 400 us
    assert bwd["util_vs_bound"] == pytest.approx(
        max(1000.0 / 3350.0, 25.0 / 989.0), abs=1e-3)


def test_profiler_session_writes_a_trace_roofline_reads(tmp_path):
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.tools import timeline

    a = torch.randn(256, 256)
    d = str(tmp_path / "prof")
    with profiler.profiler(profile_path=d):
        for _ in range(2):
            (a @ a).relu_()
    files = timeline.find_session_traces(d)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    tr = roofline.load_trace(d)
    assert tr["declaredCounts"] == {}      # no hand kernel on the CPU
    tab = roofline.kernel_table(tr, (1.0, 10.0), steps=2, cutoff_ms=0.0)
    assert any(r["kernel"] == "aten::mm" and r["calls"] == 2
               for r in tab["kernels"])
