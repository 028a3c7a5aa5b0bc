"""Op implementations; importing this package registers them all."""
from . import activation_ops  # noqa: F401
from . import beam_ops  # noqa: F401
from . import compare_ops  # noqa: F401
from . import control_flow_ops  # noqa: F401
from . import deferred_rows  # noqa: F401
from . import fused_ops  # noqa: F401
from . import math_ops  # noqa: F401
from . import metric_ops  # noqa: F401
from . import misc_ops  # noqa: F401
from . import moe_ops  # noqa: F401
from . import nn_ops  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import pipeline_ops  # noqa: F401
from . import quant_ops  # noqa: F401
from . import reduce_ops  # noqa: F401
from . import sequence_ops  # noqa: F401
from . import tensor_ops  # noqa: F401
