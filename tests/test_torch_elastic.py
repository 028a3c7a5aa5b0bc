"""Elastic / preemption-aware training in the port (the twin of
tests/test_elastic.py, all 5 of its tests): a port trainer subprocess
(tests/torch_elastic_runner.py, on the CPU) is SIGTERMed mid-run,
relaunched, and must resume from its last durable checkpoint with loss
continuity vs an uninterrupted run.

The chaos matrix kills the trainer at the checkpoint writer's commit edges
(``PDTPU_FAULT_SPEC``: bundle write, bundle rename, shard write — the
port's ``ckpt.*`` fault points carry the JAX package's names) and corrupts
committed bundles; every cell must resume from a *verified* checkpoint and
the stitched loss trajectory must match an uninterrupted reference,
bitwise over the stateful reader. The tensor-parallel mode runs the
trainer as a 2-rank gloo group through ``distributed.launch``.

Against the JAX package: each uninterrupted reference's 12 losses equal
the JAX package's run of the same program and inputs in this process
(rtol 1e-5: the two packages' matmuls and reductions round differently;
the tensor-parallel one on the JAX package's dp4×tp2 mesh).
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
RUNNER = os.path.join(HERE, "torch_elastic_runner.py")

STEPS = 12
BATCHES_PER_EPOCH = 4  # must match torch_elastic_runner.BATCHES_PER_EPOCH


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(ckpt, steps=STEPS, delay=0.0, extra_args=(), env_extra=None,
            capture_stderr=False):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PADDLE_", "JAX_", "XLA_"))}
    env.pop("PDTPU_FAULT_SPEC", None)
    if env_extra:
        env.update(env_extra)
    cmd = [RUNNER, "--ckpt", ckpt, "--steps", str(steps),
           "--save-interval", "2", "--step-delay", str(delay), *extra_args]
    if "--tp" in extra_args:  # one rank a process, rank 0 prints
        cmd = ["-m", "paddle_tpu_torch.distributed.launch", "--nproc",
               extra_args[list(extra_args).index("--tp") + 1],
               "--started_port", str(_free_port())] + cmd
    return subprocess.Popen(
        [sys.executable, *cmd], cwd=os.path.dirname(HERE),
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE if capture_stderr else subprocess.DEVNULL,
        text=True, env=env)


def _parse(out):
    losses = {}
    nxt = None
    for line in out.splitlines():
        parts = line.split()
        if len(parts) == 3 and parts[0] == "step":
            try:
                losses[int(parts[1])] = float(parts[2])
            except ValueError:
                pass  # line torn by an injected mid-print crash
        elif len(parts) == 2 and parts[0] == "done":
            nxt = int(parts[1])
    return losses, nxt


def _jax_losses(mode):
    """The JAX package's 12 losses of the runner's program and inputs."""
    import paddle_tpu as jfluid
    import torch_elastic_runner as ER
    from paddle_tpu.core import unique_name as jn

    with jn.guard():
        main_p, startup, loss = ER.build(jfluid, 2 if mode == "tp" else 0)
    out = []
    with jfluid.scope_guard(jfluid.Scope()):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        prog = main_p
        if mode == "tp":
            from paddle_tpu.parallel import make_mesh
            prog = jfluid.CompiledProgram(main_p).with_mesh(
                make_mesh({"dp": 4, "tp": 2}))
        if mode == "reader":
            feeds = [f for e in range(STEPS // BATCHES_PER_EPOCH)
                     for f in ER.reader(e)]
        else:
            feeds = [ER.fixed_feed()] * STEPS
        for f in feeds:
            (lv,) = exe.run(prog, feed=f, fetch_list=[loss])
            out.append(float(np.asarray(lv)))
    return out


@pytest.fixture(scope="module")
def ref_reader(tmp_path_factory):
    """Uninterrupted 12-step reference over the stateful epoch-aware
    reader — the bitwise ground truth for every --reader resume test."""
    p = _launch(str(tmp_path_factory.mktemp("ref_reader")),
                extra_args=("--reader",))
    out, _ = p.communicate(timeout=300)
    assert p.returncode == 0, out
    losses, nxt = _parse(out)
    assert nxt == STEPS and len(losses) == STEPS
    np.testing.assert_allclose([losses[i] for i in range(STEPS)],
                               _jax_losses("reader"), rtol=1e-5)
    return losses


@pytest.fixture(scope="module")
def ref_tp(tmp_path_factory):
    """Uninterrupted 12-step reference with a tensor-parallel weight (the
    mode whose checkpoints carry per-rank shard files)."""
    p = _launch(str(tmp_path_factory.mktemp("ref_tp")),
                extra_args=("--tp", "2"))
    out, _ = p.communicate(timeout=300)
    assert p.returncode == 0, out
    losses, nxt = _parse(out)
    assert nxt == STEPS and len(losses) == STEPS
    np.testing.assert_allclose([losses[i] for i in range(STEPS)],
                               _jax_losses("tp"), rtol=1e-5)
    return losses


def test_preempt_resume_loss_continuity(tmp_path):
    steps = STEPS

    # uninterrupted reference run
    p = _launch(str(tmp_path / "ref"), steps=steps)
    out, _ = p.communicate(timeout=300)
    assert p.returncode == 0, out
    ref_losses, nxt = _parse(out)
    assert nxt == steps and len(ref_losses) == steps
    np.testing.assert_allclose([ref_losses[i] for i in range(steps)],
                               _jax_losses("fixed"), rtol=1e-5)

    # preempted run: SIGTERM after the 4th step line appears
    ck = str(tmp_path / "el")
    p = _launch(ck, steps=steps, delay=0.25)
    seen = 0
    t0 = time.time()
    lines = []
    while seen < 4 and time.time() - t0 < 240:
        line = p.stdout.readline()
        if not line:
            break
        lines.append(line)
        if line.startswith("step "):
            seen += 1
    assert seen >= 4, "".join(lines)
    p.send_signal(signal.SIGTERM)
    out, _ = p.communicate(timeout=120)
    assert p.returncode == 0  # graceful: final checkpoint written
    losses_a, resume_at = _parse("".join(lines) + out)
    assert resume_at is not None and 4 <= resume_at < steps

    # heartbeat file recorded the last completed step
    hb = open(os.path.join(ck, "heartbeat")).read().split()
    assert int(hb[0]) == resume_at

    # relaunch: resumes at resume_at, finishes the remaining steps
    p = _launch(ck, steps=steps)
    out, _ = p.communicate(timeout=300)
    assert p.returncode == 0, out
    losses_b, nxt = _parse(out)
    assert nxt == steps
    assert min(losses_b) == resume_at  # first step after resume

    # loss continuity: the stitched trajectory equals the uninterrupted one
    stitched = dict(losses_a)
    stitched.update(losses_b)
    for i in range(steps):
        np.testing.assert_allclose(stitched[i], ref_losses[i], rtol=1e-5,
                                   err_msg=f"step {i}")


def test_sigterm_mid_epoch_resume_is_bitwise_identical(tmp_path, ref_reader):
    """ROADMAP item 5 acceptance: SIGTERM mid-epoch over a STATEFUL reader,
    relaunch, and the stitched loss trajectory is bitwise-identical to an
    uninterrupted run — possible only because run_elastic checkpoints the
    DeviceLoader's (epoch, cursor) and the resumed loader replays exactly
    the batches the killed run never consumed."""
    ck = str(tmp_path / "el")
    p = _launch(ck, delay=0.25, extra_args=("--reader",))
    seen = 0
    t0 = time.time()
    lines = []
    while seen < 5 and time.time() - t0 < 240:
        line = p.stdout.readline()
        if not line:
            break
        lines.append(line)
        if line.startswith("step "):
            seen += 1
    assert seen >= 5, "".join(lines)
    p.send_signal(signal.SIGTERM)
    out, _ = p.communicate(timeout=120)
    assert p.returncode == 0
    losses_a, resume_at = _parse("".join(lines) + out)
    # the signal lands within a step or two of the 5th line: squarely
    # inside epoch 1 (epochs are BATCHES_PER_EPOCH=4 steps)
    assert resume_at is not None and 5 <= resume_at <= 7, resume_at
    assert resume_at % BATCHES_PER_EPOCH != 0  # genuinely mid-epoch

    hb = open(os.path.join(ck, "heartbeat")).read().split()
    assert int(hb[0]) == resume_at

    p = _launch(ck, extra_args=("--reader",))
    out, _ = p.communicate(timeout=300)
    assert p.returncode == 0, out
    losses_b, nxt = _parse(out)
    assert nxt == STEPS
    assert min(losses_b) == resume_at

    stitched = dict(losses_a)
    stitched.update(losses_b)
    for i in range(STEPS):
        assert stitched[i] == ref_reader[i], (
            f"step {i}: {stitched[i]!r} != {ref_reader[i]!r} — resume is "
            "not bitwise-deterministic over the stateful reader")


# chaos matrix: (fault spec, runner mode, expected resume step, bitwise?)
# - bundle_write crash@2: dies during the SECOND save (step 4) after the
#   bundle tmp is written but before its rename — step 4 never commits,
#   resume must come from step 2;
# - rename crash@2: dies after the bundle rename but before the manifest
#   commit record — the step-4 bundle is complete (atomic rename), so the
#   fallback walk may trust it and resume at 4;
# - shard_write crash@2 (tensor-parallel mode): dies after a per-rank
#   shard tmp write, before any of step 4's files commit — resume from 2.
CHAOS_CELLS = [
    ("bundle", "ckpt.bundle_write:crash@2", ("--reader",), 2, True),
    ("rename", "ckpt.rename:crash@2", ("--reader",), 4, True),
    ("shard", "ckpt.shard_write:crash@2", ("--tp", "2"), 2, False),
]


@pytest.mark.parametrize("spec,mode,resume_expected,exact",
                         [c[1:] for c in CHAOS_CELLS],
                         ids=[c[0] for c in CHAOS_CELLS])
def test_chaos_matrix_crash_resumes_from_verified_checkpoint(
        spec, mode, resume_expected, exact, tmp_path, ref_reader, ref_tp):
    from paddle_tpu_torch import faults

    ref = ref_reader if "--reader" in mode else ref_tp
    ck = str(tmp_path / "ck")
    p = _launch(ck, extra_args=mode, env_extra={"PDTPU_FAULT_SPEC": spec})
    out, _ = p.communicate(timeout=300)
    assert p.returncode == faults.CRASH_EXIT_CODE, out
    losses_a, nxt = _parse(out)
    assert nxt is None  # killed mid-run, not completed

    # relaunch with no faults: must resume from the newest checkpoint that
    # VERIFIES, never from the torn step the crash left behind
    p = _launch(ck, extra_args=mode)
    out, _ = p.communicate(timeout=300)
    assert p.returncode == 0, out
    losses_b, nxt = _parse(out)
    assert nxt == STEPS
    assert min(losses_b) == resume_expected

    stitched = dict(losses_a)
    stitched.update(losses_b)
    for i in range(STEPS):
        if exact:
            assert stitched[i] == ref[i], f"step {i}"
        else:
            np.testing.assert_allclose(stitched[i], ref[i], rtol=1e-6,
                                       err_msg=f"step {i}")


def test_corrupt_latest_bundle_falls_back_to_older_verified(tmp_path,
                                                            ref_reader):
    """The 4th bundle write (the final step-8 save) is corrupted AFTER its
    hash was recorded — the write 'succeeds', the file is committed, and
    only the manifest knows. The relaunch must detect the mismatch, warn
    naming the bad file, and fall back to the step-6 checkpoint."""
    ck = str(tmp_path / "ck")
    p = _launch(ck, steps=8, extra_args=("--reader",),
                env_extra={"PDTPU_FAULT_SPEC": "ckpt.bundle_write:corrupt@4"})
    out, _ = p.communicate(timeout=300)
    assert p.returncode == 0, out  # corruption is silent at write time
    losses_a, nxt = _parse(out)
    assert nxt == 8
    for i in range(8):
        assert losses_a[i] == ref_reader[i], f"step {i}"

    p = _launch(ck, steps=STEPS, extra_args=("--reader",),
                capture_stderr=True)
    out, err = p.communicate(timeout=300)
    assert p.returncode == 0, err
    losses_b, nxt = _parse(out)
    assert nxt == STEPS
    assert min(losses_b) == 6, (out, err)  # fell back past corrupt step 8
    assert "ckpt-8" in err and "sha256 mismatch" in err, err
    for i in range(6, STEPS):
        assert losses_b[i] == ref_reader[i], f"step {i}"


def test_healthz_reports_elastic_checks_and_wedge(tmp_path, monkeypatch):
    """While run_elastic runs, /healthz must expose elastic/checkpoint
    (degraded while an async save is in flight) and elastic/progress
    (failing — HTTP 503 — once no step completes for PDTPU_WEDGE_TIMEOUT);
    off the main thread the PreemptionGuard degradation is visible on the
    elastic/guard_degraded gauge; on exit both checks unregister."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import faults
    from paddle_tpu_torch.distributed import run_elastic
    from paddle_tpu_torch.observability.http import (IntrospectionServer,
                                                     run_health_checks)
    from paddle_tpu_torch.observability.registry import get_registry

    monkeypatch.setenv("PDTPU_WEDGE_TIMEOUT", "0.25")

    main_p, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_p, startup):
        x = fluid.layers.data("x", [4])
        loss = fluid.layers.mean(fluid.layers.fc(x, 4))
        fluid.optimizer.SGD(0.1).minimize(loss)
    feed = {"x": np.ones((2, 4), np.float32)}

    srv = IntrospectionServer(port=0).start()
    faults.clear()
    # every save's bundle write stalls 250 ms: a wide, deterministic
    # "save in flight" window for the degraded assertion
    faults.install("ckpt.bundle_write", "delay_ms", value=250.0)
    release = threading.Event()
    result = []

    def healthz():
        try:
            r = urllib.request.urlopen(srv.url + "/healthz", timeout=5)
            return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)

        def step_fn(i):
            exe.run(main_p, feed=feed, fetch_list=[loss])
            if i == 5:
                release.wait(timeout=30)  # wedge: no step completes

        th = threading.Thread(target=lambda: result.append(
            run_elastic(step_fn, str(tmp_path / "hc"), 8, save_interval=1,
                        program=main_p, place=fluid.CPUPlace())))
        th.start()
        try:
            saw_degraded = saw_failing = False
            deadline = time.time() + 30
            while (time.time() < deadline
                   and not (saw_degraded and saw_failing)):
                code, body = healthz()
                checks = body.get("checks", {})
                ck = checks.get("elastic/checkpoint", {})
                if ck.get("status") == "degraded":
                    saw_degraded = True
                pg = checks.get("elastic/progress", {})
                if pg.get("status") == "failing":
                    saw_failing = True
                    assert code == 503 and body["status"] == "failing"
                time.sleep(0.02)
            assert saw_degraded, "never saw an in-flight save as degraded"
            assert saw_failing, "wedged step never turned /healthz failing"
            # run_elastic is on a worker thread here, so its guard cannot
            # install signal handlers — the degradation must be LOUD
            assert get_registry().gauge("elastic/guard_degraded").value == 1
        finally:
            release.set()
            th.join(timeout=120)
            faults.clear()
            srv.stop()

    assert result == [8]
    _, checks = run_health_checks()
    assert not any(k.startswith("elastic/") for k in checks), checks
