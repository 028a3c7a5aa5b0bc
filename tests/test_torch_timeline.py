"""The port's trace toolbox and profiler session API on the CPU: twins of
tests/test_observability.py's timeline, profiler-session and flight-render
tests, tests/test_aux.py's debugger and record_event tests, and
tests/test_fleet_observability.py's fleet merge. The timeline functions
are held equal to the JAX package's on the same traces (the port's copy
differs only in how a profiler log dir is read: a ``torch.profiler``
session writes chrome traces itself, so there is no XPlane to convert)."""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.tools import timeline as jtl
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import profiler
from paddle_tpu_torch.tools import timeline as tl

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _tracer_on():
    tracer = obs.get_tracer()
    was = tracer.enabled
    tracer.enabled = True
    tracer.clear()
    yield
    tracer.enabled = was
    tracer.clear()


SYNTH = {"traceEvents": [
    {"name": "step", "ph": "B", "ts": 0, "pid": 1, "tid": 1},
    {"name": "op", "ph": "B", "ts": 100, "pid": 1, "tid": 1},
    {"name": "op", "ph": "E", "ts": 600, "pid": 1, "tid": 1},
    {"name": "step", "ph": "E", "ts": 1000, "pid": 1, "tid": 1},
    {"name": "op", "ph": "X", "ts": 0, "dur": 2000, "pid": 1, "tid": 2},
    {"name": "stray_end", "ph": "E", "ts": 5, "pid": 9, "tid": 9},
]}


def test_timeline_summary_on_synthetic_trace():
    stats = tl.summarize(SYNTH)
    assert stats == jtl.summarize(SYNTH)
    assert stats["step"] == {"count": 1, "total_ms": 1.0,
                             "avg_ms": 1.0, "max_ms": 1.0}
    assert stats["op"]["count"] == 2
    assert stats["op"]["total_ms"] == pytest.approx(2.5)
    assert "stray_end" not in stats
    table = tl.format_summary(stats)
    assert table == jtl.format_summary(stats)
    assert table.splitlines()[1].startswith("op")


def test_timeline_merge_remaps_pids():
    a = {"traceEvents": [
        {"name": "x", "ph": "X", "ts": 0, "dur": 10, "pid": 7, "tid": 1}]}
    b = {"traceEvents": [
        {"name": "y", "ph": "X", "ts": 0, "dur": 20, "pid": 7, "tid": 1}]}
    merged = tl.merge_traces([a, b], names=["host", "device"])
    assert merged == jtl.merge_traces([a, b], names=["host", "device"])
    xs = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
    assert xs[0]["pid"] != xs[1]["pid"]


def test_timeline_cli_merge_and_summary(tmp_path, capsys):
    with obs.trace_span("cli_span"):
        pass
    p1 = str(tmp_path / "a.json")
    obs.get_tracer().export_chrome_trace(p1)
    p2 = str(tmp_path / "b.json")
    with open(p2, "w") as f:
        json.dump({"traceEvents": [{"name": "dev", "ph": "X", "ts": 0,
                                    "dur": 50, "pid": 0, "tid": 0}]}, f)
    out = str(tmp_path / "merged.json")
    tl.main([p1, p2, "--out", out, "--summary"])
    printed = capsys.readouterr().out
    assert "cli_span" in printed and "dev" in printed
    with open(out) as f:
        merged = json.load(f)
    assert {"cli_span", "dev"} <= {e.get("name")
                                   for e in merged["traceEvents"]}


def test_timeline_merges_a_profiler_session_with_the_host_trace(
        tmp_path, capsys):
    """--logdir reads a session's newest trace; merged beside the host
    tracer's export, both tracks are in one file."""
    d = str(tmp_path / "prof")
    with profiler.profiler(profile_path=d):
        with obs.trace_span("host_step"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    p1 = str(tmp_path / "host.json")
    obs.get_tracer().export_chrome_trace(p1)
    out = str(tmp_path / "all.json")
    tl.main([p1, "--logdir", d, "--out", out, "--summary"])
    assert "aten::mm" in capsys.readouterr().out
    names = {e.get("name") for e in json.load(open(out))["traceEvents"]}
    assert {"host_step", "aten::mm"} <= names
    with pytest.raises(FileNotFoundError):
        tl.find_session_traces(str(tmp_path / "empty"))


# -- profiler session guards -------------------------------------------------

def test_stop_profiler_without_start_raises_clear_error():
    from paddle_tpu import profiler as jprofiler

    for mod in (profiler, jprofiler):
        with pytest.raises(RuntimeError, match="matching start_profiler"):
            mod.stop_profiler()


def test_nested_profiler_rejected_with_clear_error(tmp_path):
    d = str(tmp_path / "prof")
    with profiler.profiler(profile_path=d):
        with pytest.raises(RuntimeError, match="already active"):
            profiler.start_profiler(log_dir=str(tmp_path / "nested"))
        torch.ones(8) + 1
    assert not profiler.busy()
    # the session closed cleanly: a fresh one can start
    with profiler.profiler(profile_path=d):
        pass
    assert len(tl.find_session_traces(d)) == 2
    # the shims: cuda_profiler is a no-op; op_profiler times the dygraph
    # tracer's ops (none here) and can run beside a session
    with profiler.cuda_profiler("x.out"):
        pass
    with profiler.op_profiler() as timer:
        pass
    assert dict(timer.counts) == {}
    profiler.reset_profiler()


# -- timeline --flight renderer -----------------------------------------------

FLIGHT = {
    "pid": 123,
    "exception": {"type": "OutOfMemoryError",
                  "message": "CUDA out of memory: 1.5G over"},
    "context": {"where": "Executor.run"},
    "device_memory": {"cuda:0": {"bytes_in_use": 15_000_000_000,
                                 "peak_bytes_in_use": 15_800_000_000,
                                 "bytes_limit": 16_000_000_000}},
    "steps": [
        {"step": 41, "wall_ms": 12.5, "compile": False, "sig": "ab12",
         "queue_depth": 3, "h2d_ms": 0.4,
         "mem_bytes_in_use": 14_000_000_000},
        {"step": 42, "wall_ms": 480.0, "compile": False, "sig": "ab12",
         "anomaly": "slow_step", "deviation": 92.1},
    ],
    "events": [{"level": "warning", "message": "slow step: step=42"}],
}


def test_timeline_renders_flight_dump(tmp_path, capsys):
    path = tmp_path / "flight.json"
    path.write_text(json.dumps(FLIGHT))
    tl.main(["--flight", str(path)])
    out = capsys.readouterr().out
    assert out.strip() == jtl.format_flight(FLIGHT)
    assert "OutOfMemoryError during Executor.run (pid 123)" in out
    assert "slow_step (92.1x sigma)" in out
    assert "15.00GB" in out and "limit=16.00GB" in out
    assert "slow step: step=42" in out


# -- fleet merge ----------------------------------------------------------------

def test_merge_fleet_traces_aligns_clocks_and_links():
    client = {"traceEvents": [
        {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
         "args": {"name": "client host"}},
        {"name": "fleet/rpc/infer", "ph": "B", "ts": 100.0, "pid": 1,
         "tid": 7, "args": {"rpc": "client", "trace_id": "t1",
                            "span_id": "c1"}},
        {"name": "fleet/rpc/infer", "ph": "E", "ts": 200.0, "pid": 1,
         "tid": 7}]}
    server = {"traceEvents": [
        {"name": "serve/infer", "ph": "B", "ts": 5120.0, "pid": 1,
         "tid": 9, "args": {"rpc": "server", "trace_id": "t1",
                            "span_id": "s1", "parent_id": "c1"}},
        {"name": "serve/infer", "ph": "E", "ts": 5180.0, "pid": 1,
         "tid": 9}]}
    merged = tl.merge_fleet_traces([client, server], ["client", "server"])
    assert merged == jtl.merge_fleet_traces([client, server],
                                            ["client", "server"])
    evs = merged["traceEvents"]
    (srv_b,) = [e for e in evs if e.get("name") == "serve/infer"
                and e.get("ph") == "B"]
    assert srv_b["ts"] == pytest.approx(120.0)
    flows = [e for e in evs if e.get("cat") == "rpc"]
    assert {e["ph"] for e in flows} == {"s", "f"}
    assert len({e["pid"] for e in evs if e.get("ph") in ("B", "E")}) == 2


# -- aux: debugger and record_event ----------------------------------------------

def test_debugger_dot_and_summary():
    outs = {}
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [4])
            fluid.layers.fc(x, 2)
            outs[fluid.__name__] = (fluid.debugger.program_to_dot(main),
                                    fluid.debugger.program_summary(main))
    dot, summary = outs["paddle_tpu_torch"]
    assert "digraph" in dot and "mul" in dot
    assert "block 0" in summary
    assert dot.count("->") == outs["paddle_tpu"][0].count("->")
    assert tfluid.net_drawer.draw_graph(None, main).startswith("digraph")


def test_profiler_record_event():
    with tfluid.profiler.record_event("test_region"):
        _ = torch.ones(4) + 1
    names = {e.get("name") for e in
             obs.get_tracer().export_chrome_trace()["traceEvents"]}
    assert "test_region" in names
    np.testing.assert_array_equal(_, np.full(4, 2.0, np.float32))
