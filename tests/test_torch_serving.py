"""Twins of tests/test_serving.py on the port, on the CPU: dynamic batching
over the port's Predictor (bucket-padded results equal to the unbatched
Predictor's within rtol = atol = 1e-6 across ragged sizes), backpressure,
deadlines, warmup over every bucket, metrics, drain and its /healthz
state, and the precision knob. The model is the JAX test's, saved by the
JAX package. (`test_serving_bench_smoke` has its twin in
tests/test_torch_load_tools.py; `test_run_batched_rejects_mismatched_feed_keys`
has its twin in tests/test_torch_scan_driver.py.)"""
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch import inference, serving

from _torch_twin import cpu_config, fresh_observability, fresh_port_state
from test_serving import BUCKETS, CLASSES, IN_DIM, _rows

# One intra-op thread: tier-1 runs several xdist workers, and a second
# torch worker thread, started beside JAX's runtime in the same process, was
# seen to compute some batches of a CPU matmul ~1e-4 off.
torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield from fresh_port_state()


@pytest.fixture(autouse=True)
def _fresh_observability():
    yield from fresh_observability()


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
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
            out = fluid.layers.fc(h, CLASSES, act="softmax")
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            d = str(tmp_path_factory.mktemp("tserving") / "model")
            fluid.io.save_inference_model(d, ["x"], [out], exe, main)
        return d
    finally:
        prog_mod._main_program, prog_mod._startup_program = old


@pytest.fixture(scope="module")
def predictor(model_dir):
    return inference.create_predictor(cpu_config(model_dir))


# -- run_padded / batcher correctness --------------------------------------

def test_run_padded_matches_unbatched_across_ragged_sizes(predictor):
    for n in (1, 2, 3, 4, 5, 7, 8):
        x = _rows(n, seed=n)
        ref = predictor.run({"x": x})[0]
        b = serving.bucket_for(n, BUCKETS)
        got = predictor.run_padded({"x": x}, b)[0]
        assert got.shape == (n, CLASSES)
        np.testing.assert_allclose(got, ref, **TOL)


def test_run_padded_validates_feed(predictor):
    with pytest.raises(ValueError, match="leading batch"):
        predictor.run_padded({"x": np.zeros((0, IN_DIM), np.float32)}, 4)
    with pytest.raises(ValueError, match="exceed"):
        predictor.run_padded({"x": _rows(9)}, 8)


def test_server_equivalence_ragged_requests(predictor, model_dir):
    """Concurrent ragged requests batched through the server return what
    per-request unbatched runs return, and what the JAX package's
    Predictor returns (rtol = atol = 1e-5)."""
    from paddle_tpu import inference as jinf

    sizes = [1, 3, 5, 2, 7, 1, 4]
    feeds = [_rows(n, seed=10 + i) for i, n in enumerate(sizes)]
    refs = [predictor.run({"x": f})[0] for f in feeds]
    server = serving.InferenceServer(predictor, buckets=BUCKETS,
                                     max_batch_delay_ms=5.0)
    with server:
        futs = [server.submit({"x": f}) for f in feeds]
        outs = [f.result(timeout=30)[0] for f in futs]
    jpred = jinf.create_predictor(jinf.Config(model_dir))
    for n, f, ref, got in zip(sizes, feeds, refs, outs):
        assert got.shape == (n, CLASSES)
        np.testing.assert_allclose(got, ref, **TOL)
        np.testing.assert_allclose(got, np.asarray(jpred.run({"x": f})[0]),
                                   rtol=1e-5, atol=1e-5)


def test_oversized_request_chains_buckets(predictor):
    x = _rows(21, seed=99)  # 21 > max bucket 8 -> 8 + 8 + 8(pad 3)
    ref = predictor.run({"x": x})[0]
    server = serving.InferenceServer(predictor, buckets=BUCKETS)
    with server:
        got = server.infer({"x": x})[0]
    np.testing.assert_allclose(got, ref, **TOL)


def test_bucket_for():
    assert serving.bucket_for(1, BUCKETS) == 2
    assert serving.bucket_for(2, BUCKETS) == 2
    assert serving.bucket_for(5, BUCKETS) == 8
    assert serving.bucket_for(9, BUCKETS) is None


# -- backpressure / timeout / shutdown -------------------------------------

def test_backpressure_rejects_when_queue_full(predictor):
    server = serving.InferenceServer(predictor, buckets=BUCKETS,
                                     max_queue_size=2)
    server.submit({"x": _rows(1)})
    server.submit({"x": _rows(1)})
    with pytest.raises(serving.QueueFullError):
        server.submit({"x": _rows(1)})
    assert server.metrics.counter("serving/rejected").value == 1
    server.stop(drain=False)


def test_timeout_path(predictor):
    server = serving.InferenceServer(predictor, buckets=BUCKETS)
    expired = server.submit({"x": _rows(1)}, timeout_ms=1.0)
    fresh = server.submit({"x": _rows(2)})
    time.sleep(0.05)
    with server:
        with pytest.raises(TimeoutError):
            expired.result(timeout=30)
        assert fresh.result(timeout=30)[0].shape == (2, CLASSES)
    assert server.metrics.counter("serving/timeouts").value == 1


def test_graceful_shutdown_drains_queue(predictor):
    server = serving.InferenceServer(predictor, buckets=BUCKETS)
    feeds = [_rows(2, seed=40 + i) for i in range(10)]
    futs = [server.submit({"x": f}) for f in feeds]
    server.start()
    server.stop()
    for f, feed in zip(futs, feeds):
        assert f.done()
        np.testing.assert_allclose(f.result()[0],
                                   predictor.run({"x": feed})[0], **TOL)
    with pytest.raises(serving.ServerClosedError):
        server.submit({"x": feeds[0]})


def test_stop_without_drain_fails_pending(predictor):
    server = serving.InferenceServer(predictor, buckets=BUCKETS)
    fut = server.submit({"x": _rows(1)})
    server.stop(drain=False)
    with pytest.raises(serving.ServerClosedError):
        fut.result(timeout=5)


def test_stop_reports_completed_vs_rejected(predictor):
    server = serving.InferenceServer(predictor, buckets=BUCKETS)
    server.start()
    futs = [server.submit({"x": _rows(2, seed=i)}) for i in range(8)]
    report = server.stop()
    assert report["completed"] == report["pending"]
    assert report["rejected"] == 0
    assert all(f.done() and f.exception() is None for f in futs)
    assert server.stop() == report
    assert server.state == "stopped"

    server2 = serving.InferenceServer(predictor, buckets=BUCKETS)
    for i in range(3):
        server2.submit({"x": _rows(1, seed=i)})
    report2 = server2.stop(drain=False)
    assert report2 == {"pending": 3, "completed": 0, "rejected": 3}


def test_draining_shows_degraded_on_healthz(predictor):
    server = serving.InferenceServer(predictor, buckets=BUCKETS)
    server.start()
    assert server.health()["status"] == "ok"
    assert server.state in ("idle", "serving")
    seen = {}
    t = threading.Thread(target=lambda: seen.setdefault(
        "report", server.stop(grace_ms=300)))
    t.start()
    time.sleep(0.1)
    h = server.health()
    assert h["state"] == "draining"
    assert h["status"] == "degraded"
    assert any("draining" in c["detail"] for c in h["checks"].values())
    fut = server.submit({"x": _rows(1)})
    t.join()
    assert fut.result(timeout=5)[0].shape == (1, CLASSES)
    assert seen["report"]["rejected"] == 0
    assert server.health()["state"] == "stopped"


# -- precision knob ----------------------------------------------------------

def test_predictor_bf16_parity(predictor):
    cfg = predictor._config
    bf = inference.create_predictor(cfg, precision="bf16")
    assert all(v.dtype == torch.bfloat16 for v in bf._state.values())
    x = _rows(4, seed=5)
    ref = predictor.run({"x": x})[0]
    got = np.asarray(bf.run({"x": x})[0], np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.02)
    assert bf.clone()._precision == bf._precision
    assert inference.create_predictor(cfg, precision="float32")._precision \
        == inference.PrecisionType.Float32
    assert inference.create_predictor(cfg, precision="half")._precision \
        == inference.PrecisionType.Bfloat16
    with pytest.raises(ValueError, match="unknown precision"):
        inference.create_predictor(cfg, precision="int3")


# -- warmup -----------------------------------------------------------------

def test_warmup_compiles_all_buckets(predictor):
    """Every (signature x bucket) runs before traffic: the predictor's
    record of served signatures holds one entry a bucket, and serving after
    warmup adds none (no request is the first at its shape)."""
    pred = predictor.clone()  # fresh signature record, shared weights
    assert len(pred._cache) == 0
    report = serving.warmup(pred, BUCKETS, example_feed={"x": _rows(1)})
    assert report["compiled"] == len(BUCKETS)
    assert len(pred._cache) == len(BUCKETS)
    assert report["signature"] == (("x", (IN_DIM,), "float32"),)
    report2 = serving.warmup(pred, BUCKETS, example_feed={"x": _rows(1)})
    assert report2["compiled"] == 0
    assert report2["cached"] == len(BUCKETS)
    server = serving.InferenceServer(pred, buckets=BUCKETS)
    with server:
        for n in (1, 3, 5):
            server.infer({"x": _rows(n, seed=n)})
    assert len(pred._cache) == len(BUCKETS)
    assert sorted(s[0][1][0] for s in pred._cache) == list(BUCKETS)


# -- metrics -----------------------------------------------------------------

def test_metrics_snapshot_sanity(predictor):
    server = serving.InferenceServer(predictor, buckets=BUCKETS,
                                     max_batch_delay_ms=1.0)
    with server:
        for i in range(6):
            server.infer({"x": _rows(2, seed=i)})
    snap = server.metrics.snapshot()
    assert snap["serving/requests"] == 6
    assert snap["serving/latency_ms"]["count"] == 6
    assert snap["serving/latency_ms"]["p50"] is not None
    assert snap["serving/latency_ms"]["p50"] <= snap["serving/latency_ms"]["p99"]
    assert 1 <= snap["serving/batches"] <= 6
    assert snap["serving/batch_rows"]["count"] == snap["serving/batches"]
    assert snap["serving/bucket"]["max"] in BUCKETS
    assert snap["serving/queue_depth"] == 0
    report = server.metrics.report()
    assert "serving/requests" in report and "serving/latency_ms" in report


def test_histogram_percentiles():
    h = serving.Histogram("t")
    for v in range(1, 101):
        h.observe(float(v))
    assert h.percentile(50) == pytest.approx(50, abs=1)
    assert h.percentile(99) == pytest.approx(99, abs=1)
    s = h.snapshot()
    assert s["count"] == 100 and s["min"] == 1 and s["max"] == 100


def test_dispatch_is_a_record_event_span(predictor):
    """Each bucket dispatch is a profiler.record_event region: a host span
    in the tracer's chrome-trace export, named by its bucket."""
    from paddle_tpu_torch.observability.tracer import get_tracer

    tracer = get_tracer()
    was = tracer.enabled
    tracer.clear()
    tracer.enabled = True
    try:
        server = serving.InferenceServer(predictor, buckets=BUCKETS)
        with server:
            server.infer({"x": _rows(3)})
        names = [e["name"] for e in tracer.export_chrome_trace()[
            "traceEvents"] if e.get("ph") == "B"]
    finally:
        tracer.enabled = was
        tracer.clear()
    assert "serving/dispatch" in names
    assert "serving/dispatch_b4" in names
