"""Preemptible trainer subprocess of the port for tests/test_torch_elastic.py
(the counterpart of tests/elastic_runner.py).

Trains a deterministic model via ``distributed.run_elastic`` on the CPU;
prints one line per completed step: ``step <i> <loss>`` (full float repr,
flushed, so the parent can SIGTERM mid-run), then ``done <next_step>`` on
exit. Re-launching with the same --ckpt resumes.

Modes:
- default: one fixed feed dict, plain Executor — the minimal loop;
- ``--reader``: a STATEFUL epoch-aware reader (each epoch's batches are a
  function of the epoch index and batch position) pulled through a
  DeviceLoader that run_elastic checkpoints/restores — resume must
  skip-ahead to the exact next undelivered batch or losses diverge;
- ``--tp N``: the weight carries a tensor-parallel shard_spec over a
  1×N dp×tp mesh: the process is one rank of an N-rank gloo group
  started by ``paddle_tpu_torch.distributed.launch``, and every checkpoint
  writes per-rank shard files (the ``ckpt.shard_write`` chaos target);
  rank 0 prints.

Fault injection: the parent sets ``PDTPU_FAULT_SPEC`` in the environment;
an injected ``crash`` exits with ``faults.CRASH_EXIT_CODE``. The model
builder and the reader take the package, so the test builds the same
program with the JAX package. Imports torch and the port only.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

BATCHES_PER_EPOCH = 4


def build(fluid, tp=0):
    """tests/elastic_runner.py's model: fc 16→4 from a fixed weight (a
    (None, "tp") shard_spec under --tp), softmax cross entropy, Adam.
    Returns (main, startup, loss)."""
    main_p, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_p, startup):
        x = fluid.layers.data("x", [16])
        y = fluid.layers.data("y", [1], dtype="int64")
        w = np.random.RandomState(5).rand(16, 4).astype("float32") * 0.1
        logits = fluid.layers.fc(
            x, 4, bias_attr=False,
            param_attr=fluid.ParamAttr(
                name="w",
                initializer=fluid.initializer.NumpyArrayInitializer(w),
                shard_spec=((None, "tp") if tp else None)))
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.Adam(0.05).minimize(loss)
    return main_p, startup, loss


def fixed_feed():
    rng = np.random.RandomState(0)
    return {"x": rng.rand(32, 16).astype("float32"),
            "y": rng.randint(0, 4, (32, 1)).astype("int64")}


def reader(epoch):
    """Epoch-aware and position-dependent: batch b of epoch e is always
    the same data, so a correct mid-epoch resume is bitwise-exact and a
    wrong cursor is immediately visible in the losses."""
    r = np.random.RandomState(1000 + epoch)
    for _ in range(BATCHES_PER_EPOCH):
        yield {"x": r.rand(32, 16).astype("float32"),
               "y": r.randint(0, 4, (32, 1)).astype("int64")}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--save-interval", type=int, default=2)
    ap.add_argument("--step-delay", type=float, default=0.0)
    ap.add_argument("--reader", action="store_true",
                    help="stateful epoch-aware reader via DeviceLoader")
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel degree (shard files on save)")
    args = ap.parse_args()

    import torch

    torch.set_num_threads(1)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.distributed import run_elastic

    rank = 0
    if args.tp:
        from paddle_tpu_torch.parallel import env

        env.init_parallel_env(device="cpu")
        rank = env.get_rank()
    main_p, startup, loss = build(fluid, args.tp)
    place = fluid.CPUPlace()
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(place)
        exe.run(startup)
        prog = main_p
        if args.tp:
            from paddle_tpu_torch.parallel import make_mesh
            prog = fluid.CompiledProgram(main_p).with_mesh(
                make_mesh({"dp": 1, "tp": args.tp}))

        loader = None
        if args.reader:
            loader = fluid.DeviceLoader(reader, capacity=2, program=main_p,
                                        place=place)
            it = None

            def get_feed():
                nonlocal it
                if it is None:
                    it = iter(loader)
                try:
                    return next(it)
                except StopIteration:
                    it = iter(loader)
                    return next(it)
        else:
            feed = fixed_feed()

            def get_feed():
                return feed

        def step_fn(i):
            (lv,) = exe.run(prog, feed=get_feed(), fetch_list=[loss])
            if rank == 0:
                print(f"step {i} {float(np.asarray(lv))!r}", flush=True)
            if args.step_delay:
                time.sleep(args.step_delay)

        nxt = run_elastic(step_fn, args.ckpt, args.steps,
                          save_interval=args.save_interval,
                          program=main_p, loader=loader, place=place,
                          heartbeat=(os.path.join(args.ckpt, "heartbeat")
                                     if rank == 0 else None))
        if loader is not None:
            loader.close()
    if rank == 0:
        print(f"done {nxt}", flush=True)


if __name__ == "__main__":
    main()
