"""incubate/fleet/parameter_server parity: the pserver fleet mode is a
declared non-goal of the JAX package (SURVEY §2.2), kept as it is —
importing works, using it points at the collective path."""


def _unsupported(*a, **kw):
    raise NotImplementedError(
        "parameter-server fleet mode is a non-goal of this build; use "
        "incubate.fleet.collective (data parallel over the process group) "
        "and shard large embeddings over the tp axis "
        "(parallel/tensor_parallel.py)")


class DistributedTranspiler:
    def __new__(cls, *a, **kw):
        _unsupported()


class _UnsupportedFleet:
    """Every attribute access delivers the migration pointer instead of a
    bare AttributeError."""

    def __getattr__(self, name):
        _unsupported()


fleet = _UnsupportedFleet()
