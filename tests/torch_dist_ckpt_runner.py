"""The port's shard-parallel checkpoint runner (the twin of
dist_ckpt_runner.py).

Modes::

    python tests/torch_dist_ckpt_runner.py --save DIR | --restore DIR
    python -m paddle_tpu_torch.distributed.launch --nproc 2 \\
        --started_port PORT tests/torch_dist_ckpt_runner.py --save DIR

--save trains 2 SGD steps of a model whose weight w_tp carries the spec
(None, "tp"), saves a checkpoint at step 7 (under a group, each rank
writes its slice of w_tp to its shard file and index) and prints the
whole weight's sum; --restore restores into a fresh scope, prints that
sum and runs one step under this topology. Under the launcher the two
ranks form a {"dp": 1, "tp": 2} gloo mesh; one process runs the plain
executor. Every rank prints one JSON line. Imports torch and the port
only.
"""
import json
import os
import sys

import numpy as np
import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

import torch_dist_runner as R  # noqa: E402


def main():
    torch.set_num_threads(1)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.mesh_step import is_dtensor
    from paddle_tpu_torch.parallel import (Checkpointer, get_rank,
                                           get_world_size, init_parallel_env,
                                           make_mesh)
    from paddle_tpu_torch.parallel.collective import gathered

    mode, ckdir = sys.argv[1], sys.argv[2]
    multi = init_parallel_env(device="cpu", timeout=120)
    rank, world = get_rank(), get_world_size()
    main_prog, startup, loss = R.build_w_tp(fluid)
    prog = main_prog
    if multi:
        prog = fluid.CompiledProgram(main_prog).with_mesh(
            make_mesh({"dp": 1, "tp": world}), data_axis="dp")
    feed = R.w_tp_feed()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        ck = Checkpointer(ckdir, keep=0)

        def wsum():
            w = scope.find_var("w_tp")
            if is_dtensor(w):
                step = next(iter(prog._mesh_steps.values()))
                w = gathered(w.to_local(), 1, step.tp_group)
            return float(w.double().sum())

        if mode == "--save":
            for _ in range(2):
                exe.run(prog, feed=feed, fetch_list=[loss])
            total = wsum()
            ck.save(7, program=main_prog, scope=scope, blocking=True)
            out = {"rank": rank, "mode": "save", "wsum": total}
        else:
            step = ck.restore(program=main_prog, scope=scope,
                              place=fluid.CPUPlace())
            total = float(np.asarray(scope.find_var("w_tp").double())
                          .sum())
            lv = exe.run(prog, feed=feed, fetch_list=[loss])[0]
            out = {"rank": rank, "mode": "restore", "step": step,
                   "wsum": total,
                   "loss": float(np.asarray(lv).reshape(-1)[0])}
    if multi:
        import torch.distributed as dist

        dist.destroy_process_group()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
