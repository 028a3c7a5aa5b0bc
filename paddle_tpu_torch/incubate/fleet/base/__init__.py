from . import role_maker  # noqa: F401
from .fleet_base import DistributedOptimizer, Fleet  # noqa: F401
