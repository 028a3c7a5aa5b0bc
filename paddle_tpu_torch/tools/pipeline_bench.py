#!/usr/bin/env python
"""Input-pipeline micro-bench: sync feed/fetch vs prefetch + fetch handles
(counterpart of ``paddle_tpu.tools.pipeline_bench``).

Drives a deliberately slow reader (sleep-augmented, host cost ≈ 50% of
the synchronous step) through the two execution paths:

- **sync**: per step, numpy feed → ``Executor.run(return_numpy=True)`` —
  feed conversion, H2D, dispatch, and the device→host fetch copy all
  serialize on the training loop, exactly the pre-dataio behavior;
- **pipelined**: a ``dataio.DeviceLoader`` worker converts the next batch
  and copies it to the device on its side stream while the device runs,
  and the loop keeps
  ``max_inflight`` un-synced ``FetchHandle`` dispatches outstanding.

Both arms consume IDENTICAL batch data from identically-initialized
scopes, so the per-step losses double as the bitwise-equivalence check
of the handle path against ``return_numpy=True``.

Run: ``python -m paddle_tpu_torch.tools.pipeline_bench [--steps N]
[--device cpu]`` — prints one JSON object. It trains on CUDA device 0
unless ``--device cpu`` (``device=``) is given; without a card and
without it the Executor raises.
"""
from __future__ import annotations

import argparse
import collections
import json
import time

import numpy as np

__all__ = ["run_pipeline_bench"]


def _build(batch: int, dim: int, depth: int, seed: int = 7):
    import paddle_tpu_torch as fluid

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [dim])
        label = fluid.layers.data("label", [1], dtype="int32")
        h = x
        for _ in range(depth):
            h = fluid.layers.fc(h, dim, act="relu")
        logits = fluid.layers.fc(h, 10)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def run_pipeline_bench(steps: int = 30, batch: int = 256, dim: int = 512,
                       depth: int = 4, reader_cost_frac: float = 1.0,
                       max_inflight: int = 2, device: str = "cuda",
                       init_state=None) -> dict:
    """Returns {sync_steps_per_s, pipelined_steps_per_s, speedup,
    reader_sleep_ms, bare_step_ms, outputs_identical, sync_losses, ...}.

    reader_cost_frac scales the reader's per-batch sleep relative to the
    measured bare step time; 1.0 means host cost equals device step time
    — i.e. ~50% of the SYNCHRONOUS step. `init_state` ({name: array}, e.g.
    another package's initialized parameters) replaces the startup
    program's draw in both arms.

    Model sizing note: the step must be COMPUTE-dominated for the overlap
    to be observable on the CPU: torch's kernels release the GIL, so the
    reader thread's work runs concurrently; a host-dispatch-dominated toy
    step would serialize on the GIL and understate the win (on the card
    the device computes while the host dispatches)."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.dataio import DeviceLoader

    main, startup, loss = _build(batch, dim, depth)
    place = fluid.CPUPlace() if device == "cpu" else fluid.CUDAPlace(0)
    exe = fluid.Executor(place)
    sync = (torch.cuda.synchronize if device != "cpu" else (lambda: None))

    def start(scope):
        exe.run(startup)
        if init_state is not None:
            fluid.io.load_params_from_numpy(init_state, scope=scope)

    rng = np.random.RandomState(0)
    data = [{"x": rng.randn(batch, dim).astype("float32"),
             "label": rng.randint(0, 10, (batch, 1)).astype("int32")}
            for _ in range(steps)]

    # bare device step time (feed resident, async dispatch, one sync)
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        dev_feed = {k: torch.as_tensor(v, device=place.torch_device())
                    for k, v in data[0].items()}
        exe.run(main, feed=dev_feed, fetch_list=[loss])  # plan
        sync()
        t0 = time.perf_counter()
        for _ in range(10):
            exe.run(main, feed=dev_feed, fetch_list=[loss],
                    return_handle=True)
        sync()
        bare_step_s = (time.perf_counter() - t0) / 10

    sleep_s = bare_step_s * reader_cost_frac

    def slow_reader():
        for b in data:
            time.sleep(sleep_s)
            yield b

    # -- sync arm ----------------------------------------------------------
    sync_losses = []
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        exe.run(main, feed=data[0], fetch_list=[loss])  # warm (discarded)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        start(scope)
        t0 = time.perf_counter()
        for feed in slow_reader():
            sync_losses.append(exe.run(main, feed=feed,
                                       fetch_list=[loss])[0])
        sync_s = time.perf_counter() - t0

    # -- pipelined arm -----------------------------------------------------
    pipe_losses = []
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        start(scope)
        loader = DeviceLoader(slow_reader, capacity=max(2, max_inflight),
                              program=main, name="pipeline_bench",
                              place=place)
        inflight: "collections.deque" = collections.deque()
        t0 = time.perf_counter()
        try:
            for feed in loader:
                inflight.append(exe.run(main, feed=feed, fetch_list=[loss],
                                        return_handle=True))
                while len(inflight) > max_inflight:
                    pipe_losses.append(inflight.popleft().numpy()[0])
            while inflight:
                pipe_losses.append(inflight.popleft().numpy()[0])
            pipe_s = time.perf_counter() - t0
        finally:
            loader.close()

    identical = (len(sync_losses) == len(pipe_losses) == steps and all(
        np.array_equal(a, b) for a, b in zip(sync_losses, pipe_losses)))
    return {
        "steps": steps,
        "bare_step_ms": round(bare_step_s * 1e3, 3),
        "reader_sleep_ms": round(sleep_s * 1e3, 3),
        "sync_steps_per_s": round(steps / sync_s, 2),
        "pipelined_steps_per_s": round(steps / pipe_s, 2),
        "speedup": round(sync_s / pipe_s, 3),
        "max_inflight": max_inflight,
        "outputs_identical": bool(identical),
        "sync_losses": [float(np.asarray(v).reshape(-1)[0])
                        for v in sync_losses],
    }


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--dim", type=int, default=512)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--reader-cost-frac", type=float, default=1.0)
    p.add_argument("--max-inflight", type=int, default=2)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args()
    print(json.dumps(run_pipeline_bench(
        steps=args.steps, batch=args.batch, dim=args.dim, depth=args.depth,
        reader_cost_frac=args.reader_cost_frac,
        max_inflight=args.max_inflight, device=args.device)))


if __name__ == "__main__":
    main()
