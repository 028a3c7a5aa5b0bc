"""incubate.fleet package (reference incubate/fleet/: base + collective +
parameter_server role/optimizer surface over this build's fleet)."""
from . import base  # noqa: F401
from . import collective  # noqa: F401
from ...parallel.fleet import DistributedOptimizer, Fleet, fleet  # noqa: F401
