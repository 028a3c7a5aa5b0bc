"""Two-process localhost-cluster trainer of the port (the counterpart of
tests/dist_mlp_runner.py and tests/dist_shuffle_runner.py; reference
test_dist_base.py:61 TestDistRunnerBase.run_trainer).

Launched by tests/test_torch_cluster.py through
``paddle_tpu_torch.distributed.launch`` (PADDLE_TRAINER_* env); each rank
joins a gloo group (``fleet.init(PaddleCloudRoleMaker(device="cpu"))``)
and prints one JSON line:

- default: ``{"rank": r, "losses": [...]}`` of 4 steps of the JAX
  runner's MLP through ``fleet.distributed_optimizer(...).minimize`` and
  ``fleet.main_program``, every rank feeding the same batch;
- ``--shuffle``: ``{"rank": r, "ids": [...]}``, the record ids this rank
  holds after ``InMemoryDataset.global_shuffle`` (rank r loads records
  40·r … 40·r + 39).

``--local`` runs the MLP in one process with no group (the reference).
The model builder takes the package, so the test builds the same program
with the JAX package. Imports torch and the port only.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def build(fluid):
    """The JAX runner's model: fc 16→4 (no bias) from a fixed weight,
    softmax cross entropy, SGD. Returns (main, startup, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [16])
        y = fluid.layers.data("y", [1], dtype="int64")
        w = np.random.RandomState(5).rand(16, 4).astype("float32") * 0.1
        logits = fluid.layers.fc(
            x, 4, bias_attr=False,
            param_attr=fluid.ParamAttr(
                name="w", initializer=fluid.initializer.NumpyArrayInitializer(
                    w)))
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
    return main, startup, loss


def feed():
    rng = np.random.RandomState(0)
    return {"x": rng.rand(32, 16).astype("float32"),
            "y": rng.randint(0, 4, (32, 1)).astype("int64")}


def local_losses(fluid, steps=4):
    """One process, no group: the plain executor."""
    main, startup, loss = build(fluid)
    with fluid.program_guard(main, startup):
        fluid.optimizer.SGD(0.1).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        return [float(np.asarray(exe.run(main, feed=feed(),
                                         fetch_list=[loss])[0]))
                for _ in range(steps)]


def fleet_losses(steps=4):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel.fleet import PaddleCloudRoleMaker, fleet

    fleet.init(PaddleCloudRoleMaker(device="cpu"))
    main, startup, loss = build(fluid)
    with fluid.program_guard(main, startup):
        fleet.distributed_optimizer(fluid.optimizer.SGD(0.1)).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    out = [float(np.asarray(exe.run(fleet.main_program, feed=feed(),
                                    fetch_list=[loss])[0]))
           for _ in range(steps)]
    fleet.barrier_worker()
    return fleet.worker_index(), fleet.worker_num(), out


def shuffled_ids():
    from paddle_tpu_torch.dataset import factory
    from paddle_tpu_torch.parallel import env

    env.init_parallel_env(device="cpu")
    rank = env.get_rank()
    ds = factory.InMemoryDataset()
    ds._memory = [(f"rec-{i}", i) for i in range(rank * 40, rank * 40 + 40)]
    ds.global_shuffle()
    return rank, sorted(i for _, i in ds._memory)


def main():
    import torch

    torch.set_num_threads(1)
    if "--local" in sys.argv:
        import paddle_tpu_torch as fluid

        print(json.dumps({"rank": -1, "losses": local_losses(fluid)}),
              flush=True)
        return
    if "--shuffle" in sys.argv:
        rank, ids = shuffled_ids()
        print(json.dumps({"rank": rank, "ids": ids}), flush=True)
        return
    rank, world, losses = fleet_losses()
    assert world == 2, world
    print(json.dumps({"rank": rank, "losses": losses}), flush=True)


if __name__ == "__main__":
    main()
