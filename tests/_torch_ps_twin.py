"""Shared pieces of the port's PS-tier twins (``test_torch_ps_*.py``,
``test_torch_streaming.py``): the tiny packed-Adagrad program of
``tests/test_ps_embedding.py`` built in the port, its single-table
baseline and tier runs on the CPU, and the comparisons the twins state.

The JAX side of every comparison is the JAX package's own test helpers
(``test_ps_embedding._packed_baseline`` / ``_ps_run``) on the same numpy
inputs."""
import os
import subprocess
import sys

import numpy as np
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.ops.kernels import sparse_adagrad as fsa
from paddle_tpu_torch.ps import (PsEmbeddingTier, PsTableBinding, RangeSpec,
                                 ShardedTable)

import test_ps_embedding as tpe

V, D, B, F = tpe.V, tpe.D, tpe.B, tpe.F
MULT, CAP, LANES = tpe.MULT, tpe.CAP, tpe.LANES
SPECS = [RangeSpec.even(V, 1), RangeSpec.even(V, 2), RangeSpec.even(V, 4),
         RangeSpec(V, [0, 17, 40, V])]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(ROOT, "tests", "torch_ps_server_runner.py")

# loopback-tuned knobs of the JAX chaos tests (tests/test_ps_faults.py)
FAST_RETRY = {"PDTPU_PS_RETRIES": "40", "PDTPU_PS_RETRY_BACKOFF_MS": "20",
              "PDTPU_PS_TIMEOUT": "5"}


def fast_retry(monkeypatch):
    for k, v in FAST_RETRY.items():
        monkeypatch.setenv(k, v)


rand_rows = tpe._rand_rows
feeds = tpe._feeds


def build_program(vocab_rows, pkg=tfluid):
    """The JAX test's program (``_build_program``) in `pkg`."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        ids = pkg.layers.data("ids", [F], dtype="int64")
        emb = pkg.layers.embedding(
            ids, [vocab_rows, D * MULT], is_sparse=True, row_pack=True,
            param_attr=pkg.ParamAttr(
                name="tb", initializer=pkg.initializer.RowPackInitializer(
                    D, D * MULT, -1.0, 1.0)))
        emb = pkg.layers.slice(emb, axes=[2], starts=[0], ends=[D])
        loss = pkg.layers.reduce_sum(pkg.layers.square(emb))
        pkg.optimizer.Adagrad(
            0.1, packed_rows={"rows_per_step": CAP}).minimize(loss)
    return main, startup, loss


def tiny_program():
    """The JAX test's ``_tiny_program`` (one fc + SGD) in the port."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [4])
        y = tfluid.layers.fc(x, 2, bias_attr=False,
                             param_attr=tfluid.ParamAttr(name="w"))
        loss = tfluid.layers.mean(y)
        tfluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup


def init_packed():
    """The JAX test's ``_init_packed`` table, packed by the port."""
    vis = np.random.RandomState(7).uniform(-1, 1, (V, D)).astype("float32")
    rows = np.zeros((V, D * MULT), "float32")
    rows[:, :D] = vis
    return fsa.i16(fsa.pack_rows(torch.from_numpy(rows))).numpy().view(
        np.uint16)


def packed_baseline(feeds_):
    """Single-table packed Adagrad in the port: (losses, final table)."""
    main, startup, loss = build_program(V)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    tfluid.io.load_params_from_numpy({"tb": init_packed()}, scope=scope)
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in feeds_]
    return losses, scope.find_np("tb")


def ps_run(feeds_, table, pull_ahead, push_depth, hot_rows=0,
           on_step=None, ck=None, save_base=False):
    """The port's tier over `table` on the CPU: (losses, final table).
    `ck` with `save_base` writes the step-0 recovery base and attaches
    the checkpointer; `on_step(step)` runs before each step."""
    main, startup, loss = build_program(hot_rows + CAP)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    if ck is not None and save_base:
        ck.save(0, program=main, scope=scope, blocking=True,
                ps_tables={table.name: table})
    tier = PsEmbeddingTier(main, [PsTableBinding("tb", table, ["ids"])],
                           pull_ahead=pull_ahead, push_depth=push_depth,
                           hot_rows=hot_rows, place=tfluid.CPUPlace())
    if ck is not None:
        tier.attach_checkpointer(ck)
    losses = []
    try:
        for step, prep in enumerate(tier.steps(lambda: iter(feeds_))):
            if on_step is not None:
                on_step(step)
            (lv,) = tier.run_step(exe, prep, fetch_list=[loss], scope=scope)
            losses.append(float(lv))
        tier.flush()
        final = table.dump_full()
    finally:
        tier.close()
    return losses, final


def assert_tables_close(a, b, orig=None, ulps=2):
    """Packed [rows, 128] u16 tables of the two packages after the same
    training, held as ``tests/test_torch_sparse_adagrad.py`` holds the
    Adagrad update: the accumulator lanes within `ulps` units in the last
    place, and each parameter within `ulps` units of the larger of the
    parameter and its total change from `orig` (where the change nearly
    cancels the parameter, one ulp of the change is many of the result).
    The spare lanes are equal."""
    vis = D
    fa = np.ascontiguousarray(a).view(np.float32)
    fb = np.ascontiguousarray(b).view(np.float32)
    assert fa.shape == fb.shape
    ga = fa[:, vis:vis * MULT].view(np.int32).astype(np.int64)
    gb = fb[:, vis:vis * MULT].view(np.int32).astype(np.int64)
    worst = int(np.abs(ga - gb).max(initial=0))
    assert worst <= ulps, f"accumulators differ by {worst} ulp"
    o = (init_packed() if orig is None else orig).view(np.float32)[:, :vis]
    pa, pb = fa[:, :vis], fb[:, :vis]
    change = np.abs(o.astype(np.float64) - pa).astype(np.float32)
    unit = np.maximum(np.spacing(np.abs(pa)), np.spacing(change))
    units = float((np.abs(pa.astype(np.float64) - pb) / unit).max(
        initial=0))
    assert units <= ulps, f"parameters differ by {units} units"
    np.testing.assert_array_equal(a[:, 2 * vis * MULT:],
                                  b[:, 2 * vis * MULT:])


def launch_pserver(tables, port=0, delay_ms=0.0, env_extra=None,
                   runner=RUNNER):
    """Start the port's pserver runner: (process, endpoint)."""
    cmd = [sys.executable, runner, "--port", str(port)]
    for t in tables:
        cmd += ["--table", t]
    if delay_ms:
        cmd += ["--delay-ms", str(delay_ms)]
    env = dict(os.environ)
    env.pop("PDTPU_FAULT_SPEC", None)
    env.update(env_extra or {})
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    ep = proc.stdout.readline().strip()
    if not ep:
        proc.wait(timeout=30)
        raise RuntimeError("pserver runner died at boot: "
                           + (proc.stderr.read() or "")[-500:])
    return proc, ep


def stop_all(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=30)
        for f in (p.stdout, p.stderr):
            if f is not None:
                f.close()


def in_process_table(spec, rows=None):
    return ShardedTable.build_in_process(
        "tb", spec, full_rows=init_packed() if rows is None else rows)
