"""The port's parallelism library (counterpart of ``paddle_tpu.parallel``):
the process group (``env``), meshes (``mesh``), collectives
(``collective``), ring and Ulysses attention over a sequence axis
(``ring_attention``) and checkpoints (``checkpoint``).

Tensor parallelism, pipelines and MoE (``tensor_parallel``, ``pipeline``,
``moe``) are ROADMAP A9b; the fleet API, local SGD and DGC (``fleet``,
``local_sgd``, ``dgc``) are A9c. Their names raise ``NotImplementedError``
naming the item.
"""
from .checkpoint import (  # noqa: F401
    Checkpointer, load_checkpoint, save_checkpoint)
from .collective import (  # noqa: F401
    all_gather,
    all_reduce,
    all_to_all,
    barrier,
    broadcast,
    reduce_scatter,
)
from .env import get_rank, get_world_size, init_parallel_env  # noqa: F401
from .mesh import (DistributedStrategy, auto_mesh, make_mesh,  # noqa: F401
                   mesh_shape)
from .ring_attention import (ring_attention,  # noqa: F401
                             ring_self_attention, ulysses_attention)

_DEFERRED = {
    "A9b": ("MEGATRON_RULES", "annotate_tp", "annotate_tp_auto",
            "derive_tp_specs", "GPipe", "pipeline_step", "init_moe_params",
            "moe_ffn", "moe_ffn_expert_parallel", "top_k_gating"),
    "A9c": ("dgc_allreduce", "sparse_allgather_exchange", "top_k_sparsify",
            "average_params", "local_sgd_step", "replicate_params"),
}


def __getattr__(name):
    for item, names in _DEFERRED.items():
        if name in names:
            raise NotImplementedError(
                f"paddle_tpu_torch.parallel.{name} is not ported yet "
                f"(ROADMAP {item})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Checkpointer", "load_checkpoint", "save_checkpoint",
           "all_gather", "all_reduce", "all_to_all", "barrier", "broadcast",
           "reduce_scatter", "get_rank", "get_world_size",
           "init_parallel_env", "DistributedStrategy", "auto_mesh",
           "make_mesh", "mesh_shape", "ring_attention",
           "ring_self_attention", "ulysses_attention"]
