"""Two-process dygraph DataParallel trainer of the port (the counterpart of
tests/dist_dygraph_runner.py; reference dygraph/parallel.py:84
DataParallel + imperative/nccl_context.cc, the test_dist_base localhost
edition).

Launched by tests/test_torch_dygraph_dp.py through
``paddle_tpu_torch.distributed.launch`` (PADDLE_TRAINER_* env); each rank
joins a gloo group (``parallel.env.init_parallel_env(device="cpu")``) and
runs the reference recipe scale_loss → backward → apply_collective_grads →
minimize on the JAX runner's model (Linear 16 → 1, no bias, SGD 0.1, a
square loss), every rank feeding the same batch, so the group's mean
gradient is the one-process gradient. ``--weight FILE`` gives the initial
weight (a ``.npy``), so the run can start where the JAX package's does.
Prints one JSON line: {"rank": r, "losses": [...], "allreduce_bytes": n};
``--local`` runs one process with no group (rank -1). Imports torch and
the port only.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def build_and_run(dp: bool, weight, steps=4):
    """The JAX runner's loop; returns (losses, all-reduce bytes a step)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.dygraph.tracer import trace_op

    rng = np.random.RandomState(0)
    X = rng.rand(32, 16).astype("float32")
    Y = (X @ rng.rand(16, 1)).astype("float32")

    with dygraph.guard(fluid.CPUPlace(), seed=3):
        model = dygraph.Linear(16, 1, bias_attr=False)
        model.set_dict({"weight": weight})
        wrapped = dygraph.DataParallel(model) if dp else model
        opt = fluid.optimizer.SGD(0.1)
        losses = []
        for _ in range(steps):
            out = wrapped(dygraph.to_variable(X))
            diff = trace_op("elementwise_sub",
                            {"X": [out], "Y": [dygraph.to_variable(Y)]},
                            {"axis": -1})["Out"][0]
            sq = trace_op("square", {"X": [diff]}, {})["Out"][0]
            loss = trace_op("mean", {"X": [sq]}, {})["Out"][0]
            losses.append(float(loss.numpy()))
            if dp:
                wrapped.scale_loss(loss).backward()
                wrapped.apply_collective_grads()
            else:
                loss.backward()
            opt.minimize(loss, parameter_list=model.parameters())
            model.clear_gradients()
        return losses, (wrapped.last_allreduce_bytes if dp else 0)


def main():
    args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
    weight = np.load(args["--weight"])
    if "--local" in sys.argv:
        losses, _ = build_and_run(False, weight)
        print(json.dumps({"rank": -1, "losses": losses}), flush=True)
        return
    from paddle_tpu_torch.parallel import env as penv

    assert penv.init_parallel_env(device="cpu"), "no process group"
    assert penv.get_world_size() == 2, penv.get_world_size()
    losses, nbytes = build_and_run(True, weight)
    print(json.dumps({"rank": penv.get_rank(), "losses": losses,
                      "allreduce_bytes": nbytes}), flush=True)


if __name__ == "__main__":
    main()
