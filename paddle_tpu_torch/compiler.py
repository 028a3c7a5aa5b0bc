"""fluid.compiler (reference compiler.py — CompiledProgram surface)."""
from .core.compiler import (  # noqa: F401
    BuildStrategy, CompiledProgram, ExecutionStrategy)

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy"]
