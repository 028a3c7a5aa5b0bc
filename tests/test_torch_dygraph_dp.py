"""tests/test_dist_cluster.py's test_two_process_dygraph_data_parallel in
the port: the dygraph DataParallel recipe (scale_loss → backward →
apply_collective_grads → minimize) on two processes started through the
port's ``distributed.launch`` on a gloo group reproduces the one-process
dygraph run when both ranks feed the same batch (each rank's losses within
rtol 1e-5), and the one-process run holds the JAX package's dygraph run at
the same seed and weights (rtol 1e-5, atol 1e-7). The runner is
tests/torch_dist_dygraph_runner.py.
"""
import json
import os
import socket

import numpy as np
import pytest

from _torch_twin import alarm_timeout

RUNNER = os.path.join(os.path.dirname(__file__), "torch_dist_dygraph_runner.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_losses(steps=4):
    """The JAX runner's one-process loop (tests/dist_dygraph_runner.py
    build_and_run(dp=False)), in this process; returns (losses, the
    initial weight)."""
    import paddle_tpu as fluid
    from paddle_tpu import dygraph
    from paddle_tpu.dygraph.tracer import trace_op

    rng = np.random.RandomState(0)
    X = rng.rand(32, 16).astype("float32")
    Y = (X @ rng.rand(16, 1)).astype("float32")
    with dygraph.guard(seed=3):
        model = dygraph.Linear(16, 1, bias_attr=False)
        w0 = model.weight.numpy()
        opt = fluid.optimizer.SGD(0.1)
        losses = []
        for _ in range(steps):
            out = model(dygraph.to_variable(X))
            diff = trace_op("elementwise_sub",
                            {"X": [out], "Y": [dygraph.to_variable(Y)]},
                            {"axis": -1})["Out"][0]
            sq = trace_op("square", {"X": [diff]}, {})["Out"][0]
            loss = trace_op("mean", {"X": [sq]}, {})["Out"][0]
            losses.append(float(np.asarray(loss.value)))
            loss.backward()
            opt.minimize(loss, parameter_list=model.parameters())
            model.clear_gradients()
    return losses, w0


@pytest.fixture(autouse=True)
def _time_limit():
    """The test's own limit, as the JAX test's subprocess has one."""
    yield from alarm_timeout(300)


def test_two_process_dygraph_data_parallel(tmp_path):
    import torch_dist_dygraph_runner as runner
    from paddle_tpu_torch.distributed import launch

    jax_losses, w0 = _jax_losses()
    wfile = str(tmp_path / "w0.npy")
    np.save(wfile, w0)
    local, _ = runner.build_and_run(False, w0)
    assert local[-1] < local[0] * 0.7  # it actually trains
    np.testing.assert_allclose(local, jax_losses, rtol=1e-5, atol=1e-7)

    env_backup = dict(os.environ)
    for k in list(os.environ):
        if k.startswith(("PADDLE_", "XLA_", "JAX_")):
            del os.environ[k]
    try:
        procs, fds = launch.start_procs(
            2, RUNNER, ["--weight", wfile], started_port=_free_port(),
            log_dir=str(tmp_path))
        try:
            rc = launch.wait_procs(procs, fds)
        except TimeoutError:
            launch._stop(procs)
            raise
    finally:
        os.environ.clear()
        os.environ.update(env_backup)
    for rank in range(2):
        text = (tmp_path / f"workerlog.{rank}").read_text()
        assert rc == 0, f"rank{rank} log:\n{text[-2000:]}"
        got = json.loads([l for l in text.splitlines()
                          if l.startswith("{")][-1])
        assert got["rank"] == rank
        np.testing.assert_allclose(got["losses"], local, rtol=1e-5, atol=0,
                                   err_msg=f"rank {rank} diverged from "
                                           f"single-process dygraph")
        assert got["allreduce_bytes"] == 16 * 4  # one f32 [16, 1] gradient
