"""Checkpoints of the port (``parallel/checkpoint.py``): ``Checkpointer``,
``save_checkpoint`` and ``load_checkpoint``, in the JAX package's formats.

The rest of the JAX package's ``parallel`` library (meshes, collectives,
tensor, pipeline and sequence parallelism, fleet) is not ported yet
(ROADMAP A9).
"""
from .checkpoint import (  # noqa: F401
    Checkpointer, load_checkpoint, save_checkpoint)

__all__ = ["Checkpointer", "load_checkpoint", "save_checkpoint"]
