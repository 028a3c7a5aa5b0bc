"""The port's Program IR, DSL and Executor against the JAX package's.

The two DSLs must emit the same op sequence (types, slots, attrs) and the
same var descs for one model, so a model directory saved by either loads in
the other; the port must never import JAX or the JAX package."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.models import bert as tbert

# One intra-op thread: tier-1 runs several xdist workers, and a second
# torch worker thread, started beside JAX's runtime in the same process, was
# seen to compute some batches of a CPU matmul ~1e-4 off.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """Fresh default programs, scope and unique names of the port."""
    from paddle_tpu_torch.core import program as prog_mod
    from paddle_tpu_torch.core import scope as scope_mod
    from paddle_tpu_torch.core import unique_name

    old = (prog_mod._main_program, prog_mod._startup_program,
           scope_mod._global_scope, scope_mod._current_scope)
    prog_mod._main_program = prog_mod.Program()
    prog_mod._startup_program = prog_mod.Program()
    scope_mod._global_scope = scope_mod._current_scope = scope_mod.Scope()
    with unique_name.guard():
        yield
    (prog_mod._main_program, prog_mod._startup_program,
     scope_mod._global_scope, scope_mod._current_scope) = old


def _tiny_cfg(bert, flash=True):
    return bert.BertConfig(vocab_size=64, hidden_size=32, num_layers=2,
                           num_heads=2, ffn_size=48, max_position=16,
                           use_flash_attention=flash)


def _build(fluid, bert, flash=True, is_test=False):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        feeds = [fluid.layers.data(n, [16], dtype=dt) for n, dt in (
            ("src_ids", "int64"), ("pos_ids", "int64"), ("sent_ids", "int64"),
            ("input_mask", "float32"))]
        out = bert.bert_encoder(_tiny_cfg(bert, flash), *feeds,
                                is_test=is_test)
    return main, startup, out


def _canon(d):
    return json.loads(json.dumps(d, sort_keys=True))


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("is_test", [False, True])
def test_same_program_as_jax_dsl(flash, is_test):
    from paddle_tpu.core import unique_name as jnames
    from paddle_tpu_torch.core import unique_name as tnames

    with jnames.guard():
        jmain, jstartup, jout = _build(jfluid, jbert, flash, is_test)
    with tnames.guard():
        tmain, tstartup, tout = _build(tfluid, tbert, flash, is_test)
    assert tout.name == jout.name
    for jp, tp in ((jmain, tmain), (jstartup, tstartup)):
        jd, td = _canon(jp.to_dict()), _canon(tp.to_dict())
        assert [o["type"] for o in td["blocks"][0]["ops"]] == \
            [o["type"] for o in jd["blocks"][0]["ops"]]
        assert td == jd


def test_to_dict_round_trips_and_reads_jax_programs():
    tmain, tstartup, _ = _build(tfluid, tbert)
    for p in (tmain, tstartup):
        d = _canon(p.to_dict())
        assert _canon(tfluid.Program.from_dict(d).to_dict()) == d
    jmain, _, _ = _build(jfluid, jbert)
    jd = _canon(jmain.to_dict())
    assert _canon(tfluid.Program.from_dict(jd).to_dict()) == jd


def test_clone_for_test_and_prune():
    main, _, out = _build(tfluid, tbert, is_test=False)
    test_prog = main.clone(for_test=True)
    drop = [op for op in test_prog.global_block().ops if op.type == "dropout"]
    assert drop and all(op.attrs["is_test"] for op in drop)
    assert not any(op.attrs["is_test"] for op in main.global_block().ops
                   if op.type == "dropout")
    pruned = main._prune_for_inference(["src_ids", "pos_ids", "sent_ids",
                                        "input_mask"], [out.name])
    last = pruned.global_block().ops[-1]
    assert last.type == "layer_norm" and last.output("Y") == [out.name]
    assert "dropout" in {op.type for op in pruned.global_block().ops}


def _fc_program():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [4], dtype="float32")
        y = tfluid.layers.fc(x, 3, act="gelu")
    return main, startup, y


def test_executor_runs_startup_and_forward_on_cpu():
    main, startup, y = _fc_program()
    runs = []
    for _ in range(2):
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        xv = np.random.RandomState(0).randn(5, 4).astype("float32")
        (out,) = exe.run(main, feed={"x": xv}, fetch_list=[y], scope=scope)
        w = scope.find_np(main.all_parameters()[0].name)
        b = scope.find_np(main.all_parameters()[1].name)
        ref = torch.nn.functional.gelu(torch.from_numpy(xv @ w + b)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
        runs.append(w)
    # the startup program draws from a generator seeded by random_seed
    np.testing.assert_array_equal(runs[0], runs[1])


@pytest.mark.parametrize("feed,err,match", [
    ({"x": np.zeros((5, 3), "float32")}, ValueError, "shape mismatch at dim 1"),
    ({"x": np.zeros((5,), "float32")}, ValueError, "rank mismatch"),
    ({"x": "not a number"}, (TypeError, ValueError), "cannot convert"),
])
def test_executor_feed_errors(feed, err, match):
    main, startup, y = _fc_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    with pytest.raises(err, match=match):
        exe.run(main, feed=feed, fetch_list=[y])


def test_int64_feeds_stay_int64():
    """The port keeps int64 ids as they are (the JAX package narrows them
    to int32)."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        ids = tfluid.layers.data("ids", [3], dtype="int64")
        emb = tfluid.layers.embedding(ids, [10, 4])
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    out, fetched_ids = exe.run(main, feed={"ids": np.array([[0, 3, 1]])},
                               fetch_list=[emb, ids])
    assert out.shape == (1, 3, 4)
    assert fetched_ids.dtype == np.int64


def test_port_imports_neither_jax_nor_the_jax_package(tmp_path):
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.models.bert, "
            "paddle_tpu_torch.models.resnet, "
            "paddle_tpu_torch.models.transformer_nmt, "
            "paddle_tpu_torch.models.deepfm, paddle_tpu_torch.ps, "
            "paddle_tpu_torch.faults, "
            "paddle_tpu_torch.observability.tracer, "
            "paddle_tpu_torch.ops.deferred_rows, "
            "paddle_tpu_torch.ops.kernels.sparse_adagrad, "
            "paddle_tpu_torch.reader, "
            "paddle_tpu_torch.ops.kernels.build, "
            "paddle_tpu_torch.ops.kernels.fused_bn, "
            "paddle_tpu_torch.ops.kernels.flash_attention_sparse, "
            "paddle_tpu_torch.layers.metric_op, paddle_tpu_torch.optimizer, "
            "paddle_tpu_torch.contrib.mixed_precision, "
            "paddle_tpu_torch.core.backward, paddle_tpu_torch.flags, "
            "paddle_tpu_torch.core.compiler, paddle_tpu_torch.dataio.handle, "
            "paddle_tpu_torch.observability.steps, "
            "paddle_tpu_torch.observability.watchdog, "
            "paddle_tpu_torch.observability.flight, "
            "paddle_tpu_torch.metrics, paddle_tpu_torch.evaluator, "
            "paddle_tpu_torch.average, paddle_tpu_torch.models.lenet, "
            "paddle_tpu_torch.layers.learning_rate_scheduler, "
            "paddle_tpu_torch.layers.control_flow, "
            "paddle_tpu_torch.layers.math_op_patch, "
            "paddle_tpu_torch.ops.control_flow_ops, "
            "paddle_tpu_torch.ops.rnn_ops, paddle_tpu_torch.ops.crf_ops, "
            "paddle_tpu_torch.ops.coverage_ops, "
            "paddle_tpu_torch.contrib.decoder, "
            "paddle_tpu_torch.contrib.layers, "
            "paddle_tpu_torch.models.label_semantic_roles, "
            "paddle_tpu_torch.tools.serving_bench, "
            "paddle_tpu_torch.tools.pipeline_bench, "
            "paddle_tpu_torch.parallel, paddle_tpu_torch.parallel.checkpoint, "
            "paddle_tpu_torch.dataio.loader, paddle_tpu_torch.native, "
            "paddle_tpu_torch.compat, "
            "paddle_tpu_torch.compat.reference_format, "
            "paddle_tpu_torch.data_feeder, paddle_tpu_torch.data_feed_desc, "
            "paddle_tpu_torch.dataset, paddle_tpu_torch.dataset.factory, "
            "paddle_tpu_torch.layers.coverage, paddle_tpu_torch.io, "
            "paddle_tpu_torch.inference, paddle_tpu_torch.core.lod, "
            "paddle_tpu_torch.ops.sequence_ops, paddle_tpu_torch.ops.beam_ops, "
            "paddle_tpu_torch.ops.misc_ops, paddle_tpu_torch.layers.sequence, "
            "paddle_tpu_torch.layers.rnn, paddle_tpu_torch.core.executor, "
            "paddle_tpu_torch.ops.quant_ops, paddle_tpu_torch.inference.quant, "
            "paddle_tpu_torch.inference.ps_lookup, paddle_tpu_torch.profiler, "
            "paddle_tpu_torch.observability.context, "
            "paddle_tpu_torch.observability.http, "
            "paddle_tpu_torch.observability.federate, "
            "paddle_tpu_torch.ps.transport, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.serving.batcher, "
            "paddle_tpu_torch.serving.metrics, "
            "paddle_tpu_torch.serving.server, "
            "paddle_tpu_torch.serving.warmup, "
            "paddle_tpu_torch.serving.fleet, "
            "paddle_tpu_torch.serving.fleet.registry, "
            "paddle_tpu_torch.serving.fleet.replica, "
            "paddle_tpu_torch.serving.fleet.router, "
            "paddle_tpu_torch.serving.fleet.fleet, "
            "paddle_tpu_torch.serving.fleet.worker, "
            "paddle_tpu_torch.ps.dynamic, paddle_tpu_torch.ps.health, "
            "paddle_tpu_torch.ps.table, paddle_tpu_torch.ps.tier, "
            "paddle_tpu_torch.ps.hot_cache, paddle_tpu_torch.streaming, "
            "paddle_tpu_torch.streaming.dataset, "
            "paddle_tpu_torch.streaming.delta_push, "
            "paddle_tpu_torch.streaming.trainer, "
            "paddle_tpu_torch.data_generator, paddle_tpu_torch.tools, "
            "paddle_tpu_torch.tools.ps_admin, paddle_tpu_torch.dygraph, "
            "paddle_tpu_torch.dygraph.parallel, "
            "paddle_tpu_torch.dygraph_grad_clip, "
            "paddle_tpu_torch.ops.eager, paddle_tpu_torch.ops.vision_ops, "
            "paddle_tpu_torch.ops.sampled_ops, "
            "paddle_tpu_torch.ops.parity_ops, "
            "paddle_tpu_torch.tools.op_bench; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    _worker_imports_neither(str(tmp_path / "mlp"))
    _pserver_and_ps_admin_load_neither_torch_nor_jax(tmp_path)


def _pserver_and_ps_admin_load_neither_torch_nor_jax(tmp_path):
    """The port's pserver runner and ``python -m
    paddle_tpu_torch.tools.ps_admin`` run where torch and JAX cannot be
    imported: a directory first on PYTHONPATH holds ``torch``, ``jax``
    and ``paddle_tpu`` packages whose import raises. The runner serves;
    ps_admin's ping, meta, stats, dump-health and fleet answer with exit
    code 0."""
    poison = tmp_path / "poison"
    for name in ("torch", "jax", "paddle_tpu"):
        (poison / name).mkdir(parents=True)
        (poison / name / "__init__.py").write_text(
            f"raise ImportError('{name} must not be imported here')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(poison), REPO]))
    runner = os.path.join(REPO, "tests", "torch_ps_server_runner.py")
    proc = subprocess.Popen([sys.executable, runner, "--table", "tb:0:32"],
                            cwd=str(tmp_path), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        ep = proc.stdout.readline().strip()
        assert ep, proc.stderr.read()
        for cmd in ("ping", "meta", "stats", "dump-health", "fleet"):
            res = subprocess.run(
                [sys.executable, "-m", "paddle_tpu_torch.tools.ps_admin",
                 cmd, "--endpoints", ep, "--json"],
                cwd=str(tmp_path), env=env, capture_output=True, text=True,
                timeout=120)
            assert res.returncode == 0, (cmd, res.stdout, res.stderr)
            assert res.stdout.strip(), cmd
        doc = json.loads(res.stdout)
        assert doc["ok"] and doc["targets"][0]["role"] == "pserver"
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


def _worker_imports_neither(model_dir):
    """The serving fleet's worker, run as the subprocess a ProcessReplica
    starts, serves one request and stops without loading JAX or the JAX
    package."""
    import socket

    from paddle_tpu_torch.ps.transport import _recv_msg, _send_msg

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [4])
        out = tfluid.layers.fc(x, 2)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        tfluid.io.save_inference_model(model_dir, ["x"], [out], exe, main)
    code = ("import atexit, runpy, sys; atexit.register(lambda: print("
            "'BAD', sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')), flush=True)); "
            f"sys.argv = ['worker', '--model-dir', {model_dir!r}, "
            "'--device', 'cpu', '--buckets', '1,2']; "
            "runpy.run_module('paddle_tpu_torch.serving.fleet.worker', "
            "run_name='__main__')")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("PDTPU_FLEET_WORKER_READY"), line
        port = int(line.rsplit("=", 1)[1])
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
            _send_msg(s, {"op": "infer",
                          "feed": {"x": np.ones((2, 4), np.float32)}})
            assert _recv_msg(s)["out"][0].shape == (2, 2)
            _send_msg(s, {"op": "stop"})
            assert _recv_msg(s)["ok"]
        rest, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0
    assert "BAD []" in rest, rest
