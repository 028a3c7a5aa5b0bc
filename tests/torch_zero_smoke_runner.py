"""One rank of the port's ZeRO smoke (the twin of zero_smoke_runner.py),
started by the port's launcher::

    python -m paddle_tpu_torch.distributed.launch --nproc 4 \
        --started_port PORT tests/torch_zero_smoke_runner.py [--stage3]

Each rank joins the gloo group from the PADDLE_* environment, trains the
ZeRO MLP of tests/test_zero_sharding.py on its rows at stage off and at
stage 1 (or 3), and rank 0 prints one JSON line: the world size, both
runs' losses (hex bytes), the largest shard fraction of the sharded leaves
and the state bytes each rank held. Imports torch and the port only.
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
    stage3 = "--stage3" in sys.argv
    from paddle_tpu_torch.parallel import get_rank, get_world_size
    from paddle_tpu_torch.parallel import init_parallel_env

    assert init_parallel_env(device="cpu", timeout=120)
    rank, world = get_rank(), get_world_size()
    feed = R.rows(R.zero_mlp_feed(), rank, world)
    stage = 3 if stage3 else 1
    off = R.case_train("zero_mlp", feed, stage=0, fetch_state=False)
    on = R.case_train("zero_mlp", feed, stage=stage, fetch_state=False)
    key = "max_param_shard_frac" if stage3 else "max_shard_frac"
    fracs = [int(np.prod(loc)) / int(np.prod(glob))
             for loc, glob, axis in on["info"].values() if axis is not None]
    report = {"device_count": world,
              "losses_off": [b.hex() for b in off["losses"]],
              f"losses_stage{stage}": [b.hex() for b in on["losses"]],
              key: max(fracs),
              "state_bytes_off": off["state_bytes"],
              f"state_bytes_stage{stage}": on["state_bytes"]}
    import torch.distributed as dist

    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
