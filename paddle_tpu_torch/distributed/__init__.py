"""paddle_tpu_torch.distributed: the launcher and the process-group helpers
(reference python/paddle/distributed/). ``elastic`` is ROADMAP A9c."""
from ..parallel.env import get_rank, get_world_size, init_parallel_env  # noqa: F401
