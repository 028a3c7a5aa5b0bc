"""Multi-process launcher (the port's counterpart of
``paddle_tpu.distributed.launch``; reference
``python/paddle/distributed/launch.py`` :132 start_procs).

One process a GPU (the JAX package starts one a host), each with the
reference's environment: ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS`` (the first endpoint is the rendezvous that
``parallel.init_parallel_env`` connects to), ``PADDLE_CURRENT_ENDPOINT`` and
``FLAGS_selected_gpus`` (the rank's card)::

    python -m paddle_tpu_torch.distributed.launch --nproc 8 train.py --args...

If a rank exits with an error the launcher stops the others (they would
wait on it until their group's timeout) and exits with that code.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time


def trainer_env(rank: int, nproc: int, started_port: int = 6170) -> dict:
    """The variables the launcher gives trainer `rank` of `nproc` (the
    reference names; ``parallel.init_parallel_env`` and the role makers
    read them)."""
    endpoints = ",".join(f"127.0.0.1:{started_port + i}" for i in range(nproc))
    return {"PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(nproc),
            "PADDLE_TRAINER_ENDPOINTS": endpoints,
            "PADDLE_CURRENT_ENDPOINT": endpoints.split(",")[rank],
            "FLAGS_selected_gpus": str(rank)}


def start_procs(nproc: int, training_script: str, script_args,
                started_port: int = 6170, log_dir: str | None = None):
    procs = []
    log_fds = []
    for rank in range(nproc):
        env = dict(os.environ)
        env.update(trainer_env(rank, nproc, started_port))
        cmd = [sys.executable, "-u", training_script] + list(script_args)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            fd = open(os.path.join(log_dir, f"workerlog.{rank}"), "w")
            log_fds.append(fd)
            procs.append(subprocess.Popen(cmd, env=env, stdout=fd, stderr=fd))
        else:
            procs.append(subprocess.Popen(cmd, env=env))
    return procs, log_fds


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.time() + 5.0
    for p in procs:
        try:
            p.wait(max(0.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def wait_procs(procs, log_fds):
    """Wait for every rank; the first non-zero exit stops the rest and is
    returned."""
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                _stop(procs)
                return bad[0]
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.05)
    except KeyboardInterrupt:
        _stop(procs)
        return 1
    finally:
        for fd in log_fds:
            fd.close()


def main():
    parser = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    parser.add_argument("--nproc", type=int,
                        default=int(os.environ.get("PADDLE_TRAINERS_NUM", 1)))
    parser.add_argument("--started_port", type=int, default=6170)
    parser.add_argument("--log_dir", type=str, default=None)
    parser.add_argument("training_script")
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args()
    procs, fds = start_procs(args.nproc, args.training_script,
                             args.script_args, args.started_port, args.log_dir)
    sys.exit(wait_procs(procs, fds))


if __name__ == "__main__":
    main()
