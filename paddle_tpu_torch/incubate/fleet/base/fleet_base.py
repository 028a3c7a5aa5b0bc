"""incubate/fleet/base/fleet_base.py parity — the Fleet abstraction lives
in paddle_tpu_torch.parallel.fleet; re-exported here at the reference
path."""
from ....parallel.fleet import DistributedOptimizer, Fleet, fleet  # noqa: F401
