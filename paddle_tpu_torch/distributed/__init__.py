"""paddle_tpu_torch.distributed: the launcher, the process-group helpers
and the elastic driver (reference python/paddle/distributed/)."""
from ..parallel.env import get_rank, get_world_size, init_parallel_env  # noqa: F401
from .elastic import PreemptionGuard, run_elastic, touch_heartbeat  # noqa: F401
