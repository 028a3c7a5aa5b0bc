"""Mesh construction and the fleet strategy knobs (the port's counterpart
of ``paddle_tpu.parallel.mesh``; reference nccl_helper.h ring
construction and fleet DistributedStrategy).

The JAX package lays a ``jax.sharding.Mesh`` with named axes over the
devices of one controller. The port lays a ``DeviceMesh`` with named dims
over the ranks of the process group (``init_device_mesh``), one rank a
device. A mesh whose size differs from the group's world size raises: a
mesh never runs on fewer devices than it names without saying so.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch.distributed as dist

__all__ = ["make_mesh", "auto_mesh", "mesh_shape", "DistributedStrategy"]


def _device_type() -> str:
    """The mesh's device: the card under NCCL, and under gloo too once this
    process works on the card (a gloo group of ranks sharing one card
    moves CUDA tensors; a ``DTensor`` takes its mesh's device), else the
    CPU."""
    import torch

    if dist.get_backend() == "nccl" or (torch.cuda.is_available()
                                        and torch.cuda.is_initialized()):
        return "cuda"
    return "cpu"


def make_mesh(axis_sizes: Dict[str, int], devices=None):
    """``make_mesh({'dp': 2, 'tp': 4})`` over the group's ranks, in rank
    order. Needs a running group whose world size is the product of the
    sizes (``init_parallel_env``, or ``distributed.launch``). `devices`
    takes the JAX signature's place and must be None: a rank owns one
    device."""
    from torch.distributed.device_mesh import init_device_mesh

    if devices is not None:
        raise ValueError("make_mesh: the port lays a mesh over the process "
                         "group's ranks, one device a rank; devices= is "
                         "not taken")
    names = tuple(axis_sizes)
    sizes = tuple(int(axis_sizes[n]) for n in names)
    n = math.prod(sizes)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"make_mesh({axis_sizes}) needs a torch.distributed group of {n} "
            f"processes: start them with `python -m "
            f"paddle_tpu_torch.distributed.launch --nproc {n} script.py` and "
            f"call parallel.init_parallel_env()")
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"make_mesh({axis_sizes}) names {n} devices; the "
                         f"process group has {world}")
    return init_device_mesh(_device_type(), sizes, mesh_dim_names=names)


def auto_mesh(dp: Optional[int] = None, tp: int = 1, pp: int = 1,
              sp: int = 1, devices=None):
    """Fill the dp axis with whatever ranks remain after tp/pp/sp."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp is None:
        dp = world // (tp * pp * sp)
    axes = {}
    for name, size in (("dp", dp), ("pp", pp), ("tp", tp), ("sp", sp)):
        if size > 1 or name == "dp":
            axes[name] = size
    return make_mesh(axes, devices)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{dim_name: size}``, the JAX ``Mesh.shape`` mapping."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


class DistributedStrategy:
    """fleet DistributedStrategy parity: the knobs map to mesh and sharding
    choices rather than NCCL ring counts (same fields and defaults as the
    JAX package's)."""

    def __init__(self):
        self.tensor_parallel_degree = 1
        self.pipeline_parallel_degree = 1
        self.sequence_parallel_degree = 1
        self.sharding_degree = 1          # ZeRO-style optimizer sharding
        # ShardingStrategy stage once sharding is on: 1 = state sharding,
        # 2 = state + gradient reduce-scatter, 3 = the parameters too
        self.sharding_stage = 1
        self.amp = False
        self.recompute = False            # legacy remat switch
        # remat policy surface (compiler.resolve_remat): None defers to the
        # legacy `recompute` bool
        self.remat_policy = None
        self.gradient_merge_steps = 1     # microbatch accumulation
        self.embedding_shards = 0
        self.pull_ahead = 1
        self.push_depth = 0
        self.hot_rows = 0
        # reference-compat knobs, inert
        self.nccl_comm_num = 1
        self.use_hierarchical_allreduce = False
        self.fuse_all_reduce_ops = True

    def build_mesh(self, devices=None):
        return auto_mesh(tp=self.tensor_parallel_degree,
                         pp=self.pipeline_parallel_degree,
                         sp=self.sequence_parallel_degree,
                         devices=devices)
