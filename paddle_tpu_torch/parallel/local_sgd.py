"""LocalSGD — periodically-averaged independent replicas (the port's
counterpart of ``paddle_tpu.parallel.local_sgd``).

Reference analog: ``python/paddle/fluid/transpiler/collective.py:269``
(LocalSGD transpiler: snapshot params, train without gradient sync,
all-reduce-average the params every k steps).

The JAX package stacks the replicas as ``[dp, ...]`` under one controller
and maps the step over the dp axis. The port runs one process a GPU, so
each rank holds its own replica (plain tensors, any pytree of them):

- ``replicate_params`` broadcasts rank 0's parameters (the reference's
  init broadcast), so every replica starts identical;
- ``average_params`` is an all-reduce mean over the axis's group;
- ``local_sgd_step(...)(params, batch, i)`` takes this rank's shard of the
  batch and decides on the host whether step `i` syncs, as the JAX package
  decides at trace time: a step without a sync sends no collective but the
  loss mean, the point of LocalSGD (wire traffic every k-th step only).

`mesh` is a ``DeviceMesh`` (``parallel.make_mesh``) whose `axis` dim holds
the replicas, or None for the whole process group.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

__all__ = ["replicate_params", "average_params", "local_sgd_step"]


def _group(mesh, axis: str):
    return mesh.get_group(axis) if mesh is not None else None


def replicate_params(params, n_replicas: int = None, mesh=None,
                     axis: str = "dp"):
    """This rank's replica: a copy of rank 0's parameters (every replica
    starts identical). `n_replicas`, where given, must be the group's
    size: one replica a rank."""
    group = _group(mesh, axis)
    world = dist.get_world_size(group)
    if n_replicas is not None and int(n_replicas) != world:
        raise ValueError(f"replicate_params: {n_replicas} replicas over a "
                         f"group of {world} ranks; the port holds one "
                         f"replica a rank")
    root = dist.get_global_rank(group, 0) if group is not None else 0

    def one(p):
        p = p.detach().clone().contiguous()
        dist.broadcast(p, root, group=group)
        return p

    return tree_map(one, params)


def average_params(params, mesh=None, axis: str = "dp"):
    """The k-step synchronization: every replica becomes the mean of all
    of them (an all-reduce sum over the group, divided by its size)."""
    group = _group(mesh, axis)
    n = dist.get_world_size(group)

    def one(p):
        p = p.detach().clone().contiguous()
        dist.all_reduce(p, group=group)
        return p / n

    return tree_map(one, params)


def local_sgd_step(grad_fn: Callable, mesh=None, axis: str = "dp",
                   k_steps: int = 4, lr: float = 0.1):
    """Build a LocalSGD step.

    grad_fn(params, batch) -> (loss, grads) for this rank's replica and its
    shard of the batch. Returns step(params, batch, i) -> (new params, the
    group's mean loss); `i` is a python int, and step i averages the
    replicas when (i + 1) % k_steps == 0."""
    group = _group(mesh, axis)
    n = dist.get_world_size(group)

    def step(params, batch, i):
        loss, grads = grad_fn(params, batch)
        new = tree_map(lambda p, g: (p - lr * g).detach(), params, grads)
        if (int(i) + 1) % k_steps == 0:
            new = average_params(new, mesh, axis)
        loss = torch.as_tensor(loss).detach().clone().reshape(())
        dist.all_reduce(loss, group=group)
        return new, loss / n

    return step
