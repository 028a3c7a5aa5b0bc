"""Layers DSL (reference python/paddle/fluid/layers/): the subset the BERT,
ResNet, Transformer NMT, DeepFM and LeNet slices use, the learning-rate
schedules, ConditionalBlock, the Variable operators, the sequence layers,
the beam-search layers and pad / pad2d / space_to_depth."""
from . import math_op_patch  # noqa: F401  (attaches Variable operators)
from . import control_flow  # noqa: F401
from .control_flow import ConditionalBlock  # noqa: F401
from . import learning_rate_scheduler  # noqa: F401
from .learning_rate_scheduler import (  # noqa: F401
    cosine_decay,
    exponential_decay,
    inverse_time_decay,
    linear_lr_warmup,
    natural_exp_decay,
    noam_decay,
    piecewise_decay,
    polynomial_decay,
)
from .metric_op import accuracy, auc  # noqa: F401
from .nn import (  # noqa: F401
    batch_norm,
    conv2d,
    data,
    dropout,
    embedding,
    fc,
    flash_attention,
    flash_attention_sparse,
    fused_conv_bn,
    layer_norm,
    matmul,
    mean,
    moe_ffn,
    pool2d,
    relu,
    sigmoid_cross_entropy_with_logits,
    softmax,
    softmax_with_cross_entropy,
    square_error_cost,
    topk,
)
from .ops import (  # noqa: F401
    elementwise_add,
    elementwise_div,
    elementwise_floordiv,
    elementwise_max,
    elementwise_min,
    elementwise_mod,
    elementwise_mul,
    elementwise_pow,
    elementwise_sub,
    equal,
    gelu,
    greater_equal,
    greater_than,
    less_equal,
    less_than,
    not_equal,
    scale,
    sigmoid,
    sign,
    sqrt,
    square,
    tanh,
)
from .reduce import reduce_mean, reduce_sum  # noqa: F401
from .tensor import (  # noqa: F401
    assign,
    cast,
    concat,
    fill_constant,
    gather,
    reshape,
    slice,
    split,
    transpose,
    unsqueeze,
)
from .coverage import (  # noqa: F401
    create_py_reader_by_data,
    double_buffer,
    pad,
    pad2d,
    py_reader,
    space_to_depth,
)
from .rnn import beam_search, beam_search_decode  # noqa: F401
from .sequence import (  # noqa: F401
    sequence_concat,
    sequence_conv,
    sequence_enumerate,
    sequence_erase,
    sequence_expand_as,
    sequence_mask,
    sequence_pad,
    sequence_pool,
    sequence_reshape,
    sequence_reverse,
    sequence_scatter,
    sequence_slice,
    sequence_softmax,
    sequence_topk_avg_pooling,
    sequence_unpad,
)
