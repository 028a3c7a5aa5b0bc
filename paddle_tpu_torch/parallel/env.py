"""The process group (the port's counterpart of ``paddle_tpu.parallel.env``;
reference gen_nccl_id_op.cc, distribute_transpiler.py:259 nccl2 mode and
distributed/launch.py).

The JAX package calls ``jax.distributed.initialize`` once a host; the port
runs one process a GPU and starts a ``torch.distributed`` group over them:
NCCL when the process's device is a GPU, gloo on the CPU. The environment
keeps the reference names, so the JAX package's launcher contract holds:
``PADDLE_TRAINER_ENDPOINTS`` (its first endpoint is the rendezvous),
``PADDLE_TRAINER_ID`` and ``PADDLE_TRAINERS_NUM``; ``FLAGS_selected_gpus``
(set by ``paddle_tpu_torch.distributed.launch``) picks the process's card.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["init_parallel_env", "get_rank", "get_world_size"]


def _init_method(address: str) -> str:
    """A rendezvous URL: ``host:port`` becomes ``tcp://host:port``; a URL
    (``tcp://``, ``file://``) is taken as it is."""
    return address if "://" in address else f"tcp://{address}"


def init_parallel_env(coordinator_address: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None,
                      device: Optional[str] = None,
                      timeout: Optional[float] = None) -> bool:
    """Start the process group from the arguments or the PADDLE_* variables.
    Returns True when a group is running, False for one process with no
    rendezvous (as the JAX package returns False).

    `device` is "cuda" or "cpu" (default: "cuda" when torch sees a GPU): on
    "cuda" the process takes the card ``FLAGS_selected_gpus`` names (else
    its rank modulo the cards present) with ``torch.cuda.set_device``
    before the group starts, and the group is NCCL; on "cpu" it is gloo.
    `timeout` (seconds) bounds every collective of the group."""
    if dist.is_available() and dist.is_initialized():
        return True
    endpoints = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
    if coordinator_address is None and endpoints:
        eps = endpoints.split(",")
        coordinator_address = eps[0]
        num_processes = num_processes or int(
            os.environ.get("PADDLE_TRAINERS_NUM", len(eps)))
        if process_id is None:
            process_id = int(os.environ.get("PADDLE_TRAINER_ID", "0") or 0)
    if coordinator_address is None:
        return False  # single process
    num_processes = int(num_processes or 1)
    process_id = int(process_id or 0)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    kwargs = {}
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_parallel_env(device='cuda'): torch sees "
                               "no GPU; pass device='cpu' for a gloo group")
        sel = os.environ.get("FLAGS_selected_gpus", "")
        local = (int(sel.split(",")[0]) if sel
                 else process_id % torch.cuda.device_count())
        torch.cuda.set_device(local)
        backend = "nccl"
        kwargs["device_id"] = torch.device("cuda", local)
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_parallel_env: device must be 'cuda' or "
                         f"'cpu', got {device!r}")
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend,
                            init_method=_init_method(coordinator_address),
                            world_size=num_processes, rank=process_id,
                            **kwargs)
    return True


def get_world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def get_rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0
