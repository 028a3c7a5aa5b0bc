"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The same Fluid-style define-then-run API as ``paddle_tpu``: the ``layers``
DSL builds a ``Program``; ``Optimizer.minimize`` appends the autodiff op and
the updates; ``Executor.run`` and the inference ``Predictor`` run it op by
op on torch tensors (training through torch.autograd), on the GPU unless
the caller asks for the CPU. Where the JAX package ran a Pallas kernel, the port runs a kernel
written by hand for Hopper (``csrc/``), built at first use. This package
imports torch and numpy, never JAX and never ``paddle_tpu``.

The operator CLIs ``python -m paddle_tpu_torch.tools.ps_admin``,
``.metrics_lint``, ``.postmortem`` and ``.ops_console`` run on hosts
without torch (a bastion, a pserver host): started that way, this
``__init__`` skips the framework surface, and the tool imports only the
stdlib and numpy modules it needs.

    import paddle_tpu_torch as fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [784])
        y = fluid.layers.fc(x, 10)
        loss = fluid.layers.mean(y)
        fluid.optimizer.Adam(1e-3).minimize(loss)
    exe = fluid.Executor(fluid.CUDAPlace(0))   # or fluid.CPUPlace()
    exe.run(startup)
    exe.run(main, feed={...}, fetch_list=[loss])
"""

import sys as _sys

# ``python -m`` entry points that must not load torch
_TORCH_FREE_ENTRIES = ("paddle_tpu_torch.tools.ps_admin",
                       "paddle_tpu_torch.tools.metrics_lint",
                       "paddle_tpu_torch.tools.postmortem",
                       "paddle_tpu_torch.tools.ops_console")


def _torch_free_entry() -> bool:
    """True when the interpreter was started as ``python -m`` with one of
    `_TORCH_FREE_ENTRIES` (read from its own argv, before any script or
    ``-c`` argument)."""
    argv = list(getattr(_sys, "orig_argv", ()))[1:]
    for i, a in enumerate(argv):
        if a == "-m":
            return i + 1 < len(argv) and argv[i + 1] in _TORCH_FREE_ENTRIES
        if a == "-c" or not a.startswith("-"):
            return False
    return False


if not _torch_free_entry():
    from . import initializer  # noqa: F401
    from . import ops  # registers all ops  # noqa: F401
    from . import layers  # noqa: F401
    from . import clip  # noqa: F401
    from . import optimizer  # noqa: F401
    from . import regularizer  # noqa: F401
    from . import contrib  # noqa: F401
    from . import io  # noqa: F401
    from . import ir  # noqa: F401
    from . import inference  # noqa: F401
    from . import reader  # noqa: F401
    from . import ps  # noqa: F401
    from . import dataio  # noqa: F401
    from . import metrics  # noqa: F401
    from . import evaluator  # noqa: F401
    from . import average  # noqa: F401
    from . import compat  # noqa: F401
    from . import data_feed_desc  # noqa: F401
    from . import distribute_lookup_table  # noqa: F401
    from . import dataset  # noqa: F401
    from . import native  # noqa: F401
    from . import parallel  # noqa: F401
    from . import distributed  # noqa: F401
    from . import dygraph  # noqa: F401
    from . import dygraph_grad_clip  # noqa: F401
    from .parallel_executor import ParallelExecutor  # noqa: F401
    from .data_feed_desc import DataFeedDesc  # noqa: F401
    from .data_feeder import DataFeeder  # noqa: F401
    from .reader import PyReader  # noqa: F401
    from .flags import get_flags, set_flags  # noqa: F401
    from .core import (  # noqa: F401
        Block,
        BuildStrategy,
        CompiledProgram,
        CPUPlace,
        CUDAPlace,
        ExecutionStrategy,
        Executor,
        Operator,
        Parameter,
        Place,
        Program,
        Scope,
        Variable,
        append_backward,
        calc_gradient,
        default_main_program,
        default_startup_program,
        global_scope,
        gradients,
        in_dygraph_mode,
        program_guard,
        remat_unit,
        scope_guard,
        ShardingStrategy,
    )
    from .core import unique_name  # noqa: F401
    from .core.lod import (  # noqa: F401
        LoDTensor,
        LoDTensorArray,
        create_lod_tensor,
        create_random_int_lodtensor,
    )
    from .param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401
    from . import faults  # noqa: F401
    from . import observability  # noqa: F401
    from . import planner  # noqa: F401
    from . import profiler  # noqa: F401
    from . import debugger  # noqa: F401
    from . import net_drawer  # noqa: F401
    from . import serving  # noqa: F401
    from . import incubate  # noqa: F401
    from . import compiler  # noqa: F401
    from . import data_generator  # noqa: F401
    from . import reader as py_reader_module  # noqa: F401
    from .dataio import DeviceLoader, FetchHandle  # noqa: F401
    from .dataset import DatasetFactory  # noqa: F401
    from .evaluator import Evaluator  # noqa: F401
    from .average import WeightedAverage  # noqa: F401
    from .layers import learning_rate_scheduler  # noqa: F401
    from .layers.math_op_patch import monkey_patch_variable  # noqa: F401
    from .core import executor  # noqa: F401
    from .core import program as framework  # noqa: F401
    from .parallel.fleet import fleet  # noqa: F401

    # the reference's common import forms (``from paddle_tpu_torch.framework
    # import ...``) resolve as the JAX package's do, not just attributes
    _sys.modules[__name__ + ".framework"] = framework
    _sys.modules[__name__ + ".executor"] = executor

    def CUDAPinnedPlace():
        """place.h CUDAPinnedPlace parity: the host side of a transfer.
        The loaders pin their own staging buffers (``dataio.DeviceLoader``),
        so the place is the CPU's, as in the JAX package."""
        return CPUPlace()

    class backward:  # namespace parity: fluid.backward.append_backward
        from .core.backward import append_backward, calc_gradient, gradients

        append_backward = staticmethod(append_backward)
        calc_gradient = staticmethod(calc_gradient)
        gradients = staticmethod(gradients)

__version__ = "0.1.0"
