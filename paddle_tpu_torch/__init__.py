"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The same Fluid-style define-then-run API as ``paddle_tpu``: the ``layers``
DSL builds a ``Program``; ``Optimizer.minimize`` appends the autodiff op and
the updates; ``Executor.run`` and the inference ``Predictor`` run it op by
op on torch tensors (training through torch.autograd), on the GPU unless
the caller asks for the CPU. Where the JAX package ran a Pallas kernel, the port runs a kernel
written by hand for Hopper (``csrc/``), built at first use. This package
imports torch and numpy, never JAX and never ``paddle_tpu``.

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
from . import dataset  # noqa: F401
from . import native  # noqa: F401
from . import parallel  # noqa: F401
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
from .param_attr import ParamAttr  # noqa: F401

__version__ = "0.1.0"
