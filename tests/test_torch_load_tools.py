"""The port's two load tools on the CPU (``--device cpu``): twins of the
JAX package's serving_bench tests (tests/test_serving.py's smoke,
tests/test_serving_fleet.py's SLO gate exit codes, tests/
test_observability.py's metrics/trace sidecars and introspection scrape),
asserting what they assert and nothing about speed, and a pipeline_bench
test: its two arms agree bitwise and its synchronous losses equal the
JAX package's tool's sync arm from the same initial state (the JAX
package has no test of its tool)."""
import json

import numpy as np
import pytest
import torch

from paddle_tpu_torch import inference
from paddle_tpu_torch.tools import pipeline_bench as pb
from paddle_tpu_torch.tools import serving_bench as sb

from _torch_twin import (alarm_timeout, cpu_config, fresh_observability,
                         fresh_port_state)
from test_serving import BUCKETS, IN_DIM

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield from fresh_port_state()


@pytest.fixture(autouse=True)
def _fresh_observability():
    yield from fresh_observability()


@pytest.fixture(autouse=True)
def _limit():
    yield from alarm_timeout(120)


@pytest.fixture(scope="module")
def predictor(tmp_path_factory):
    """The JAX test's model, saved by the JAX package, served by the
    port on the CPU."""
    import paddle_tpu as fluid
    from paddle_tpu.core import program as prog_mod

    old = prog_mod._main_program, prog_mod._startup_program
    prog_mod._main_program = prog_mod.Program()
    prog_mod._startup_program = prog_mod.Program()
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [IN_DIM])
            h = fluid.layers.fc(x, 8, act="relu")
            out = fluid.layers.fc(h, 3, act="softmax")
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            d = str(tmp_path_factory.mktemp("tload") / "model")
            fluid.io.save_inference_model(d, ["x"], [out], exe, main)
    finally:
        prog_mod._main_program, prog_mod._startup_program = old
    return inference.create_predictor(cpu_config(d))


def test_serving_bench_smoke(predictor):
    rows = [np.random.RandomState(i).rand(1, IN_DIM).astype(np.float32)
            for i in range(16)]
    seq = sb.bench_sequential(predictor, rows)
    served = sb.bench_served(predictor, rows, concurrency=8,
                             buckets=BUCKETS, batch_delay_ms=1.0)
    for r in (seq, served):
        assert r["requests"] == 16
        assert r["throughput_rps"] > 0
        assert r["p50_ms"] <= r["p99_ms"]
    assert served["errors"] == 0
    assert served["metrics"]["serving/requests"] == 16


def test_serving_bench_slo_gate_exit_codes():
    common = ["--requests", "12", "--concurrency", "4", "--in-dim", "8",
              "--hidden", "16", "--buckets", "1,2,4", "--replicas", "2",
              "--skip-sequential", "--device", "cpu"]
    assert sb.main(common + ["--slo-p99-ms", "60000"]) == 0
    assert sb.main(common + ["--slo-p99-ms", "0.000001"]) == 2


def _bench_main(args):
    from paddle_tpu_torch.core import program as prog_mod

    old = prog_mod._main_program, prog_mod._startup_program
    prog_mod._main_program = prog_mod.Program()
    prog_mod._startup_program = prog_mod.Program()
    try:
        return sb.main(["--requests", "8", "--concurrency", "4",
                        "--buckets", "2,4", "--batch-delay-ms", "1",
                        "--in-dim", "6", "--hidden", "8", "--layers", "1",
                        "--skip-sequential", "--device", "cpu"] + args)
    finally:
        prog_mod._main_program, prog_mod._startup_program = old


def test_serving_bench_dumps_metrics_and_trace(tmp_path):
    mpath, tpath = str(tmp_path / "m.json"), str(tmp_path / "t.json")
    assert _bench_main(["--metrics-out", mpath, "--trace-out", tpath]) == 0
    with open(mpath) as f:
        loaded = json.load(f)
    assert "executor/cache_misses" in loaded
    assert loaded["serving/requests"] >= 8
    assert loaded["bench/served"]["requests"] == 8
    with open(tpath) as f:
        trace = json.load(f)
    assert any(e.get("name", "").startswith("serving/dispatch")
               for e in trace["traceEvents"])


def test_serving_bench_with_introspection_scrape(tmp_path):
    from paddle_tpu_torch.observability import http as ihttp

    ihttp.stop_introspection()
    mpath = str(tmp_path / "m.json")
    try:
        rc = _bench_main(["--introspect-port", "0", "--metrics-out", mpath])
    finally:
        ihttp.stop_introspection()
    assert rc == 0
    with open(mpath) as f:
        scrape = json.load(f)["bench/introspection"]
    assert scrape["/metrics"]["status"] == 200
    assert scrape["/metrics"]["bytes"] > 0
    assert scrape["/healthz"]["status"] == 200


def test_serving_bench_needs_the_card_or_the_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        sb.build_predictor(in_dim=4, hidden=8, layers=1)
    with pytest.raises(RuntimeError):
        pb.run_pipeline_bench(steps=2, batch=4, dim=8, depth=1)


def _jax_sync_losses(steps, batch, dim, depth):
    """The JAX tool's sync arm (its program, its data) and the initial
    state it starts from."""
    import paddle_tpu as jfluid
    from paddle_tpu.tools import pipeline_bench as jpb

    main, startup, loss = jpb._build(batch, dim, depth)
    rng = np.random.RandomState(0)
    data = [{"x": rng.randn(batch, dim).astype("float32"),
             "label": rng.randint(0, 10, (batch, 1)).astype("int32")}
            for _ in range(steps)]
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        init = {p.name: np.array(scope.find_var(p.name))
                for p in main.all_parameters()}
        losses = [float(np.asarray(exe.run(main, feed=f,
                                           fetch_list=[loss])[0]).ravel()[0])
                  for f in data]
    return losses, init


def test_pipeline_bench_arms_agree_and_match_jax():
    steps, batch, dim, depth = 4, 8, 16, 2
    want, init = _jax_sync_losses(steps, batch, dim, depth)
    res = pb.run_pipeline_bench(steps=steps, batch=batch, dim=dim,
                                depth=depth, device="cpu", init_state=init)
    assert res["outputs_identical"] is True
    assert res["steps"] == steps
    assert res["sync_steps_per_s"] > 0 and res["pipelined_steps_per_s"] > 0
    np.testing.assert_allclose(res["sync_losses"], want, rtol=1e-5,
                               atol=1e-6)
