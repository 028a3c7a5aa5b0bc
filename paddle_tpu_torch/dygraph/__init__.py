"""Dygraph — eager imperative mode (the port's counterpart of
``paddle_tpu.dygraph``).

Reference analog: ``paddle/fluid/imperative/`` (Tracer tracer.cc:35, VarBase
layer.h:55, BasicEngine engine.cc:42) + ``python/paddle/fluid/dygraph/``.

Ops run eagerly on torch tensors through the same registered op functions
as the static graph (one kernel library, two frontends — the reference's
PreparedOp shares the static kernel registry), so a BatchNorm under
``PDTPU_BN_MODE=pallas`` launches the same hand-written kernels as the
static executor. Autograd is torch autograd (``tracer.py``):
`loss.backward()` fills each live VarBase's gradient. ``dygraph.jit`` runs
a Layer's forward as a function of its parameter values.

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph
    with dygraph.guard(fluid.CPUPlace()):     # no place: CUDAPlace(0)
        model = dygraph.Linear(4, 2)
        loss = ...; loss.backward()
        fluid.optimizer.SGD(0.1).minimize(loss,
                                          parameter_list=model.parameters())
"""
from .base import enabled, guard, no_grad, to_variable  # noqa: F401
from .checkpoint import load_dygraph, save_dygraph  # noqa: F401
from .jit import jit  # noqa: F401
from .layers import Layer  # noqa: F401
from .nn import (  # noqa: F401
    BatchNorm,
    BilinearTensorProduct,
    Conv2D,
    Conv2DTranspose,
    Conv3D,
    Conv3DTranspose,
    Embedding,
    FC,
    GroupNorm,
    GRUUnit,
    LayerNorm,
    Linear,
    NCE,
    Pool2D,
    PRelu,
    RowConv,
    SequenceConv,
    SpectralNorm,
    TreeConv,
)
from .checkpoint import (  # noqa: F401
    load_dygraph as load_persistables,
    save_dygraph as save_persistables,
)
from .learning_rate_scheduler import (  # noqa: F401
    CosineDecay,
    ExponentialDecay,
    InverseTimeDecay,
    NaturalExpDecay,
    NoamDecay,
    PiecewiseDecay,
    PolynomialDecay,
)
from .parallel import DataParallel, prepare_context  # noqa: F401


class BackwardStrategy:
    """Reference backward_strategy.py shim: sort_sum_gradient toggles an
    accumulation order that torch autograd decides."""

    def __init__(self):
        self.sort_sum_gradient = False


def start_gperf_profiler():
    """imperative/profiler.cc gperftools hook — no gperftools here; use
    paddle_tpu_torch.profiler instead. No-op shim."""


def stop_gperf_profiler():
    """See start_gperf_profiler."""
from .tracer import Tracer  # noqa: F401
from .varbase import VarBase  # noqa: F401
