"""incubate/fleet/collective parity (collective/__init__.py:41): the
collective-mode fleet singleton + optimizer wrapper. The mesh step sums
the gradients over the data axis, so CollectiveOptimizer is
DistributedOptimizer."""
from ....parallel.fleet import (  # noqa: F401
    DistributedOptimizer, Fleet, fleet)
from ....parallel.mesh import DistributedStrategy  # noqa: F401

CollectiveOptimizer = DistributedOptimizer
