"""Layers DSL (reference python/paddle/fluid/layers/): the subset the BERT
serving and training slices use."""
from .nn import (  # noqa: F401
    data,
    dropout,
    embedding,
    fc,
    flash_attention,
    layer_norm,
    matmul,
    mean,
    softmax,
    softmax_with_cross_entropy,
)
from .ops import (  # noqa: F401
    elementwise_add,
    elementwise_div,
    elementwise_max,
    elementwise_min,
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
    cast,
    fill_constant,
    reshape,
    split,
    transpose,
    unsqueeze,
)
