"""Core framework: IR, registry, scope, executor, autodiff."""
from .backward import append_backward, calc_gradient, gradients  # noqa: F401
from .compiler import (  # noqa: F401
    BuildStrategy,
    CompiledProgram,
    ExecutionStrategy,
    ShardingStrategy,
)
from .executor import CPUPlace, CUDAPlace, Executor, Place  # noqa: F401
from .program import (  # noqa: F401
    Block,
    Operator,
    Parameter,
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    grad_var_name,
    program_guard,
    remat_unit,
)
from .registry import get_op, has_op, register_op, registered_ops  # noqa: F401
from .scope import Scope, global_scope, scope_guard  # noqa: F401
