"""The port's op micro-bench harness on the CPU: twins of
tests/test_op_bench.py (a single op through the real executor, the CLI
and config file, an int-input op, a profiler session converted by the
timeline tool), and the two A/B cells of the hand kernels. On the CPU the
cells' kernel arms run the plain versions, so their numbers are compared
with the JAX package's interpret-mode cell only as keys and shapes (never
as times); each arm's output is held to the plain arm's: the conv+BN
forward within 1e-5 and the sparse / dense attention forwards within
1e-6 (f32, same math)."""
import json

import torch

import paddle_tpu_torch as tfluid
from paddle_tpu.tools import op_bench as jbench
from paddle_tpu_torch.tools import op_bench

torch.set_num_threads(1)

CPU = tfluid.CPUPlace()
KEYS = {"op", "mean_us", "min_us", "p50_us", "compile_ms", "repeat"}


def test_bench_single_op():
    res = op_bench.bench_op(
        "matmul", {"X": {"shape": [64, 64]}, "Y": {"shape": [64, 64]}},
        repeat=5, warmup=1, place=CPU)
    jres = jbench.bench_op(
        "matmul", {"X": {"shape": [64, 64]}, "Y": {"shape": [64, 64]}},
        repeat=5, warmup=1)
    assert set(res) == set(jres) == KEYS
    assert res["op"] == "matmul"
    assert res["mean_us"] > 0 and res["min_us"] <= res["mean_us"]
    assert res["compile_ms"] > 0


def test_bench_cli_and_config(tmp_path, capsys):
    cfg = [{"op": "relu", "inputs": {"X": {"shape": [128, 128]}},
            "repeat": 3}]
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    op_bench.main(["--config", str(path), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["op"] == "relu" and out["repeat"] == 3
    op_bench.main(["--op", "elementwise_add", "--device", "cpu",
                   "--input", "X=32x32", "--input", "Y=32x32",
                   "--repeat", "3"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["op"] == "elementwise_add"


def test_bench_int_input_op():
    res = op_bench.bench_op(
        "lookup_table",
        {"W": {"shape": [64, 8]}, "Ids": {"shape": [16, 1], "dtype": "int64"}},
        repeat=3, warmup=1, place=CPU)
    assert res["mean_us"] > 0


def test_timeline_conversion(tmp_path):
    """A profiler session's log dir → one chrome-trace file."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.tools import timeline

    logdir = str(tmp_path / "trace")
    with profiler.profiler(profile_path=logdir):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert timeline.find_session_traces(logdir)
    out = str(tmp_path / "timeline.json")
    timeline.main(["--logdir", logdir, "--out", out])
    trace = json.load(open(out))
    assert "traceEvents" in trace
    assert any(e.get("name") == "aten::mm" for e in trace["traceEvents"])


def _cells_equal_in_form(port, jax_cell):
    assert set(port) - {"dtype", "device", "max_abs_err", "max_abs_ref",
                        "within_tol", "tol"} == \
        set(jax_cell) - {"interpret"}
    for k in ("shape", "bench"):
        assert port[k] == jax_cell[k]
    assert set(port["arms"]) == {
        a.replace("pallas", "kernel").replace("xla", "plain")
        for a in jax_cell["arms"]}
    for arm in port["arms"].values():
        assert set(arm) == {"median_ms", "iqr_ms", "n_segments"}
        assert arm["median_ms"] > 0


def test_fused_conv_bn_cell():
    kw = dict(batch=2, ci=64, co=128, hw=32, n_seg=1)
    res = op_bench.bench_fused_conv_bn(device="cpu", tol=1e-5, **kw)
    _cells_equal_in_form(res, jbench.bench_fused_conv_bn(**kw))
    assert res["max_abs_err"]["fwd"] <= 1e-5
    # the backward holds to the plain one relative to its gradients' size
    assert set(res["max_abs_err"]["bwd"]) == {"dx", "dw", "dscale",
                                              "dbias"}
    assert all(res["within_tol"].values()), res["within_tol"]


def test_block_sparse_attn_cell():
    kw = dict(batch=1, t=128, hidden=128, num_heads=2, avg_sent=24,
              n_seg=1)
    res = op_bench.bench_block_sparse_attn(device="cpu", tol=1e-5, **kw)
    _cells_equal_in_form(res, jbench.bench_block_sparse_attn(**kw))
    assert all(res["within_tol"].values()), res["within_tol"]
    assert res["max_abs_err"]["sparse_fwd"] <= 1e-6
    assert res["max_abs_err"]["dense_fwd"] <= 1e-6
    assert 0.0 < res["fill_rate"] <= 1.0

