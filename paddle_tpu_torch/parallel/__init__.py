"""The port's parallelism library (counterpart of ``paddle_tpu.parallel``):
the process group (``env``), meshes (``mesh``), collectives
(``collective``), ring and Ulysses attention over a sequence axis
(``ring_attention``), Megatron tensor-parallel rules
(``tensor_parallel``), Mixture-of-Experts with expert parallelism
(``moe``), pipelines (``pipeline``: GPipe, 1F1B and heterogeneous
stages over a ``pp`` axis), checkpoints (``checkpoint``), local SGD with
one replica a rank (``local_sgd``), Deep Gradient Compression's
exchanges (``dgc``) and the fleet API with its role makers (``fleet``).
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
from .dgc import (dgc_allreduce, sparse_allgather_exchange,  # noqa: F401
                  top_k_sparsify)
from .env import get_rank, get_world_size, init_parallel_env  # noqa: F401
from .local_sgd import (average_params, local_sgd_step,  # noqa: F401
                        replicate_params)
from .moe import (init_moe_params, moe_ffn,  # noqa: F401
                  moe_ffn_expert_parallel, top_k_gating)
from .mesh import (DistributedStrategy, auto_mesh, make_mesh,  # noqa: F401
                   mesh_shape)
from .pipeline import (GPipe, pipeline_1f1b,  # noqa: F401
                       pipeline_hetero, pipeline_step)
from .ring_attention import (ring_attention,  # noqa: F401
                             ring_self_attention, ulysses_attention)
from .tensor_parallel import (DEEPFM_RULES, MEGATRON_RULES,  # noqa: F401
                              NMT_RULES, annotate_tp, annotate_tp_auto,
                              derive_tp_specs, embedding_shard_spec)

__all__ = ["Checkpointer", "load_checkpoint", "save_checkpoint",
           "all_gather", "all_reduce", "all_to_all", "barrier", "broadcast",
           "reduce_scatter", "get_rank", "get_world_size",
           "init_parallel_env", "DistributedStrategy", "auto_mesh",
           "make_mesh", "mesh_shape", "ring_attention",
           "ring_self_attention", "ulysses_attention", "MEGATRON_RULES",
           "NMT_RULES", "DEEPFM_RULES", "annotate_tp", "annotate_tp_auto",
           "derive_tp_specs", "embedding_shard_spec", "init_moe_params",
           "moe_ffn", "moe_ffn_expert_parallel", "top_k_gating", "GPipe",
           "pipeline_step", "pipeline_1f1b", "pipeline_hetero",
           "dgc_allreduce", "sparse_allgather_exchange", "top_k_sparsify",
           "average_params", "local_sgd_step", "replicate_params"]
