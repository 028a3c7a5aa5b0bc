"""Every op the port registers, against the JAX package's registered op on
the same numpy inputs (rtol 1e-5, atol 1e-6; f32).

The random initializer ops draw from a torch.Generator, whose numbers differ
from the JAX package's PRNG keys by design, so they are checked by their
distribution instead."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core import registry as jreg
from paddle_tpu.core.executor import ExecContext as JaxCtx
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.dtypes import to_numpy
from paddle_tpu_torch.core.executor import ExecContext as TorchCtx

# One intra-op thread: tier-1 runs several xdist workers, and a second
# torch worker thread, started beside JAX's runtime in the same process, was
# seen to compute some batches of a CPU matmul ~1e-4 off.
torch.set_num_threads(1)

RANDOM_OPS = ("uniform_random", "gaussian_random",
              "truncated_gaussian_random", "rowpack_init")
# ops whose gradient input is a SelectedRows: test_packed_row_op_matches_jax
SELECTED_ROWS_OPS = ("sgd_row_packed", "adagrad_row_packed",
                     "adam_row_packed")


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """Fresh default programs, scope and unique names of the port."""
    from paddle_tpu_torch.core import program as prog_mod
    from paddle_tpu_torch.core import scope as scope_mod
    from paddle_tpu_torch.core import unique_name

    old = (prog_mod._main_program, prog_mod._startup_program,
           scope_mod._global_scope, scope_mod._current_scope)
    prog_mod._main_program = prog_mod.Program()
    prog_mod._startup_program = prog_mod.Program()
    scope_mod._global_scope = scope_mod._current_scope = scope_mod.Scope()
    with unique_name.guard():
        yield
    (prog_mod._main_program, prog_mod._startup_program,
     scope_mod._global_scope, scope_mod._current_scope) = old


def _r(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _pos(*shape, seed=0):
    return (np.random.RandomState(seed).rand(*shape) + 0.5).astype(np.float32)


def _ids(*shape, hi=10, seed=0):
    return np.random.RandomState(seed).randint(0, hi, shape).astype(np.int64)


X34 = _r(3, 4)
# three tied ones among 1000 columns, the rest tied at 0
_TIES_1000 = np.zeros((1, 1000), np.float32)
_TIES_1000[0, [5, 17, 900]] = 1.0
_ACT_ATTRS = {"relu6": {"threshold": 1.0}, "leaky_relu": {"alpha": 0.1},
              "elu": {"alpha": 0.5}, "swish": {"beta": 1.5}}

# (case id, op type, inputs {slot: [array]}, attrs)
CASES = []
for _op in ("elementwise_add", "elementwise_sub", "elementwise_mul",
            "elementwise_min", "elementwise_max"):
    CASES.append((_op, _op, {"X": [_r(2, 3, 4)], "Y": [_r(4, seed=1)]},
                  {"axis": -1}))
CASES += [
    ("elementwise_add_axis1", "elementwise_add",
     {"X": [_r(2, 3, 4)], "Y": [_r(3, seed=1)]}, {"axis": 1}),
    ("elementwise_div", "elementwise_div",
     {"X": [_r(2, 3)], "Y": [_pos(2, 3, seed=1)]}, {}),
    ("elementwise_pow", "elementwise_pow",
     {"X": [_pos(2, 3)], "Y": [_r(2, 3, seed=1)]}, {}),
    ("elementwise_mod", "elementwise_mod",
     {"X": [_r(2, 3, scale=5)], "Y": [_pos(2, 3, seed=1)]}, {}),
    ("elementwise_floordiv", "elementwise_floordiv",
     {"X": [_r(2, 3, scale=5)], "Y": [_pos(2, 3, seed=1)]}, {}),
    ("scale", "scale", {"X": [X34]}, {"scale": 3.0, "bias": 0.5}),
    ("scale_bias_first", "scale", {"X": [X34]},
     {"scale": 3.0, "bias": 0.5, "bias_after_scale": False}),
    ("matmul", "matmul", {"X": [_r(2, 3, 4)], "Y": [_r(2, 4, 5, seed=1)]}, {}),
    ("matmul_tt_alpha", "matmul",
     {"X": [_r(2, 4, 3)], "Y": [_r(2, 5, 4, seed=1)]},
     {"transpose_X": True, "transpose_Y": True, "alpha": 0.5}),
    ("mul", "mul", {"X": [_r(2, 3, 4)], "Y": [_r(4, 6, seed=1)]},
     {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    ("gelu", "gelu", {"X": [X34]}, {}),
    ("gelu_approximate", "gelu", {"X": [X34]}, {"approximate": True}),
    ("softmax", "softmax", {"X": [_r(2, 3, 5)]}, {"axis": -1}),
    ("softmax_axis1", "softmax", {"X": [_r(2, 3, 5)]}, {"axis": 1}),
    ("reshape", "reshape", {"X": [_r(2, 3, 4)]}, {"shape": [0, -1, 2]}),
    ("transpose", "transpose", {"X": [_r(2, 3, 4)]}, {"axis": [0, 2, 1]}),
    ("split_num", "split", {"X": [_r(2, 6)]}, {"num": 3, "axis": 1}),
    ("split_sections", "split", {"X": [_r(2, 6)]},
     {"sections": [1, 2, 3], "axis": -1}),
    ("unsqueeze", "unsqueeze", {"X": [_r(2, 3)]}, {"axes": [1, 0]}),
    ("cast", "cast", {"X": [_r(2, 3, scale=3)]},
     {"out_dtype": "int32", "in_dtype": "float32"}),
    ("assign", "assign", {"X": [X34]}, {}),
    ("fill_constant", "fill_constant", {},
     {"shape": [2, 3], "dtype": "float32", "value": -1.5}),
    ("fill_constant_int64", "fill_constant", {},
     {"shape": [4], "dtype": "int64", "value": 7.0}),
    ("assign_value", "assign_value", {},
     {"values": [1.0, 2.5, -3.0, 4.0], "shape": [2, 2], "dtype": "float32"}),
    ("layer_norm", "layer_norm",
     {"X": [_r(2, 3, 8)], "Scale": [_r(8, seed=1)], "Bias": [_r(8, seed=2)]},
     {"begin_norm_axis": 2, "epsilon": 1e-5}),
    ("layer_norm_noaffine", "layer_norm", {"X": [_r(2, 12)]},
     {"begin_norm_axis": 1}),
    ("dropout_is_test_downgrade", "dropout", {"X": [X34]},
     {"dropout_prob": 0.3, "is_test": True}),
    ("dropout_is_test_upscale", "dropout", {"X": [X34]},
     {"dropout_prob": 0.3, "is_test": True,
      "dropout_implementation": "upscale_in_train"}),
    ("lookup_table", "lookup_table",
     {"W": [_r(10, 4)], "Ids": [_ids(2, 3, 1)]}, {"padding_idx": -1}),
    ("lookup_table_padding", "lookup_table",
     {"W": [_r(10, 4)], "Ids": [_ids(2, 5)]}, {"padding_idx": 3}),
    ("lookup_table_v2", "lookup_table_v2",
     {"W": [_r(10, 4)], "Ids": [_ids(2, 5)]}, {"padding_idx": 2}),
    ("fused_fc_gelu", "fused_fc",
     {"Input": [_r(2, 3, 8)], "W": [_r(8, 5, seed=1)], "Bias": [_r(5, seed=2)]},
     {"in_num_col_dims": 2, "activation_type": "gelu"}),
    ("fused_fc_nobias", "fused_fc",
     {"Input": [_r(4, 8)], "W": [_r(8, 5, seed=1)]},
     {"in_num_col_dims": 1, "activation_type": ""}),
    ("flash_attention_packed_mask", "flash_attention",
     {"Q": [_r(2, 16, 32)], "K": [_r(2, 16, 32, seed=1)],
      "V": [_r(2, 16, 32, seed=2)],
      "BiasQK": [np.where(_r(2, 1, 16, seed=3) > 0, 0, -1e4).astype(
          np.float32)]},
     {"num_heads": 2, "is_test": True, "dropout_prob": 0.1}),
    ("flash_attention_4d_causal", "flash_attention",
     {"Q": [_r(2, 2, 16, 8)], "K": [_r(2, 2, 16, 8, seed=1)],
      "V": [_r(2, 2, 16, 8, seed=2)]},
     {"causal": True, "is_test": True}),
]
for _act in ("relu", "sigmoid", "tanh", "softplus", "softsign", "relu6",
             "leaky_relu", "elu", "swish", "logsigmoid", "silu"):
    CASES.append((_act, _act, {"X": [_r(3, 4, scale=3)]},
                  _ACT_ATTRS.get(_act, {})))
for _act in ("relu", "tanh", "sigmoid", "gelu"):
    CASES.append((f"fused_elemwise_add_{_act}", "fused_elemwise_activation",
                   {"X": [_r(2, 3, 4)], "Y": [_r(4, seed=1)]},
                   {"functor_list": ["elementwise_add", _act], "axis": -1}))

# the training slice: losses, reductions, comparisons, the ops regularizers
# and clipping emit, and the optimizer updates
_LABELS = _ids(4, 6, 1, hi=7, seed=4)
_LABELS[1, 2, 0] = -100   # ignored positions
_LABELS[3, :, 0] = -100
CASES += [
    ("softmax_with_cross_entropy_ignore", "softmax_with_cross_entropy",
     {"Logits": [_r(4, 6, 7, scale=2)], "Label": [_LABELS]},
     {"ignore_index": -100, "axis": -1}),
    ("softmax_with_cross_entropy_soft", "softmax_with_cross_entropy",
     {"Logits": [_r(3, 5)], "Label": [_pos(3, 5, seed=1) / 5]},
     {"soft_label": True}),
    ("reduce_sum_all", "reduce_sum", {"X": [_r(2, 3, 4)]},
     {"reduce_all": True}),
    ("reduce_sum_dims_keep", "reduce_sum", {"X": [_r(2, 3, 4)]},
     {"dim": [0, 2], "keep_dim": True}),
    ("reduce_mean_dim", "reduce_mean", {"X": [_r(2, 3, 4)]}, {"dim": [1]}),
    ("mean", "mean", {"X": [_r(2, 3, 4)]}, {}),
    ("sum", "sum", {"X": [X34, _r(3, 4, seed=1), _r(3, 4, seed=2)]}, {}),
    ("clip", "clip", {"X": [X34]}, {"min": -0.5, "max": 0.7}),
    ("clip_by_norm", "clip_by_norm", {"X": [X34]}, {"max_norm": 1.0}),
    ("squared_l2_norm", "squared_l2_norm", {"X": [X34]}, {}),
    ("sqrt", "sqrt", {"X": [_pos(3, 4)]}, {}),
    ("square", "square", {"X": [X34]}, {}),
    ("sign", "sign", {"X": [X34]}, {}),
    ("logical_not", "logical_not", {"X": [_r(3, 4) > 0]}, {}),
    ("update_loss_scaling_finite", "update_loss_scaling",
     {"Grads": [X34, _r(5, seed=1)], "LossScaling": [np.float32([1024.0])],
      "GoodSteps": [np.int32([2])], "BadSteps": [np.int32([1])]},
     {"incr_every_n_steps": 3, "decr_every_n_nan_or_inf": 2,
      "incr_ratio": 2.0, "decr_ratio": 0.5}),
    ("update_loss_scaling_inf", "update_loss_scaling",
     {"Grads": [np.where(X34 > 1.0, np.inf, X34).astype(np.float32)],
      "LossScaling": [np.float32([1024.0])],
      "GoodSteps": [np.int32([2])], "BadSteps": [np.int32([1])]},
     {"decr_every_n_nan_or_inf": 2, "decr_ratio": 0.5}),
]
for _op in ("equal", "not_equal", "less_than", "less_equal", "greater_than",
            "greater_equal"):
    CASES.append((_op, _op, {"X": [_ids(3, 4, hi=3)], "Y": [_ids(4, hi=3,
                                                                 seed=1)]}, {}))
for _op in ("logical_and", "logical_or", "logical_xor"):
    CASES.append((_op, _op, {"X": [_r(3, 4) > 0], "Y": [_r(3, 4, seed=1) > 0]},
                  {}))
_LR = np.float32([0.01])
_ADAM_IN = {"Param": [_r(3, 4)], "Grad": [_r(3, 4, seed=1)],
            "Moment1": [_r(3, 4, seed=2, scale=0.1)],
            "Moment2": [_pos(3, 4, seed=3) * 0.01],
            "Beta1Pow": [np.float32([0.9 ** 3])],
            "Beta2Pow": [np.float32([0.999 ** 3])], "LearningRate": [_LR]}
CASES += [
    ("sgd", "sgd", {"Param": [X34], "Grad": [_r(3, 4, seed=1)],
                    "LearningRate": [_LR]}, {}),
    ("adam", "adam", _ADAM_IN, {"beta1": 0.9, "beta2": 0.999,
                                "epsilon": 1e-8}),
    ("adamw", "adamw", _ADAM_IN, {"beta1": 0.9, "beta2": 0.999,
                                  "epsilon": 1e-8, "coeff": 0.05}),
    ("lamb", "lamb", _ADAM_IN, {"beta1": 0.9, "beta2": 0.999,
                                "epsilon": 1e-6, "weight_decay": 0.01}),
]

# the ResNet slice: convolution, pooling, normalization (the frozen-stats
# paths here; the training paths are in test_torch_fused_bn.py), Momentum,
# top_k and accuracy
_IMG = _r(2, 4, 8, 8)
_CONV_W = _r(6, 4, 3, 3, seed=1, scale=0.3)
_BN_IN = {"Scale": [_pos(6, seed=2)], "Bias": [_r(6, seed=3)],
          "Mean": [_r(6, seed=4, scale=0.1)], "Variance": [_pos(6, seed=5)]}
def _dgc_in(step):
    """dgc_momentum's inputs at float step `step` (a [1] accumulator)."""
    return {"Param": [X34], "Grad": [_r(3, 4, seed=1)],
            "Velocity": [_r(3, 4, seed=2, scale=0.1)],
            "Residual": [_r(3, 4, seed=3, scale=0.1)],
            "Step": [np.float32([step])], "LearningRate": [_LR]}


_VEL_IN = {"Param": [X34], "Grad": [_r(3, 4, seed=1)],
           "Velocity": [_r(3, 4, seed=2, scale=0.1)], "LearningRate": [_LR]}
CASES += [
    ("conv2d_pad_stride2", "conv2d", {"Input": [_IMG], "Filter": [_CONV_W]},
     {"strides": [2, 2], "paddings": [1, 1]}),
    ("conv2d_same_stride2", "conv2d", {"Input": [_r(2, 4, 7, 7)],
                                       "Filter": [_CONV_W]},
     {"strides": [2, 2], "padding_algorithm": "SAME"}),
    ("conv2d_valid", "conv2d", {"Input": [_IMG], "Filter": [_CONV_W]},
     {"padding_algorithm": "VALID"}),
    ("conv2d_asym_pad", "conv2d", {"Input": [_IMG], "Filter": [_CONV_W]},
     {"paddings": [0, 1, 2, 1]}),
    ("conv2d_groups_dilation", "conv2d",
     {"Input": [_IMG], "Filter": [_r(6, 2, 3, 3, seed=1)]},
     {"groups": 2, "dilations": [2, 2], "paddings": [2, 2]}),
    ("pool2d_max_pad", "pool2d", {"X": [_IMG]},
     {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [1, 1]}),
    ("pool2d_avg_exclusive_pad", "pool2d", {"X": [_IMG]},
     {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [1, 1], "exclusive": True}),
    ("pool2d_avg_inclusive_pad", "pool2d", {"X": [_IMG]},
     {"pooling_type": "avg", "ksize": [3, 3], "strides": [1, 1],
      "paddings": [1, 1], "exclusive": False}),
    ("pool2d_global_avg", "pool2d", {"X": [_IMG]},
     {"pooling_type": "avg", "global_pooling": True}),
    ("pool2d_global_max", "pool2d", {"X": [_IMG]},
     {"pooling_type": "max", "global_pooling": True}),
    ("batch_norm_is_test_relu", "batch_norm",
     dict(_BN_IN, X=[_r(2, 6, 5, 5)]),
     {"is_test": True, "act": "relu", "epsilon": 1e-5}),
    ("batch_norm_is_test_nhwc", "batch_norm",
     dict(_BN_IN, X=[_r(2, 5, 5, 6)]),
     {"is_test": True, "data_layout": "NHWC"}),
    ("fused_conv_bn_is_test", "fused_conv_bn",
     dict(_BN_IN, Input=[_IMG], Filter=[_r(6, 4, 1, 1, seed=6)],
          Residual=[_r(2, 6, 4, 4, seed=7)]),
     {"stride": 2, "act": "relu", "is_test": True}),
    ("momentum", "momentum", _VEL_IN, {"mu": 0.9}),
    ("momentum_nesterov", "momentum", _VEL_IN,
     {"mu": 0.9, "use_nesterov": True}),
    # dgc_momentum: the dense phase (step 0 < 2), the sparse phase with the
    # local clip and Nesterov, and a rampup of two stages (loose k, then
    # the final k after the rampup)
    ("dgc_momentum_dense", "dgc_momentum", _dgc_in(0.0),
     {"mu": 0.9, "rampup_begin_step": 2, "sparsity": [0.75]}),
    ("dgc_momentum_sparse_nesterov", "dgc_momentum", _dgc_in(3.0),
     {"mu": 0.9, "rampup_begin_step": 2, "sparsity": [0.75],
      "use_nesterov": True, "clip_norm": 0.5}),
    ("dgc_momentum_rampup", "dgc_momentum", _dgc_in(2.0),
     {"mu": 0.9, "rampup_begin_step": 2, "rampup_step": 4,
      "sparsity": [0.5, 0.9], "clip_norm": 0.0}),
    ("dgc_momentum_after_rampup", "dgc_momentum", _dgc_in(9.0),
     {"mu": 0.9, "rampup_begin_step": 2, "rampup_step": 4,
      "sparsity": [0.5, 0.9], "clip_norm": 0.0}),
    ("top_k", "top_k", {"X": [_r(4, 7)]}, {"k": 3}),
    # ties: the lower index first, as lax.top_k orders them
    ("top_k_ties", "top_k",
     {"X": [np.array([[1, 3, 3, 2, 3]], np.float32)]}, {"k": 2}),
    ("top_k_ties_wide", "top_k", {"X": [_TIES_1000]}, {"k": 5}),
    ("accuracy", "accuracy",
     {"Indices": [_ids(5, 3, hi=6)], "Label": [_ids(5, 1, hi=6, seed=1)]},
     {}),
]

# the NMT slice: the position-table gather and block-sparse attention on
# packed rows (segment ids 1-based and contiguous, 0 = pad; row 0 all pad)
_SEG = np.array([[0] * 16, [1] * 5 + [2] * 7 + [0] * 4], np.int32)
_KSEG = np.array([[0] * 24, [1] * 9 + [2] * 11 + [0] * 4], np.int32)
CASES += [
    ("gather_rows", "gather", {"X": [_r(10, 4)], "Index": [_ids(6, hi=10)]},
     {}),
    ("gather_index_n1", "gather",
     {"X": [_r(10, 4)], "Index": [_ids(6, 1, hi=10, seed=1)]}, {}),
    ("flash_attention_sparse_causal", "flash_attention_sparse",
     {"Q": [_r(2, 16, 32)], "K": [_r(2, 16, 32, seed=1)],
      "V": [_r(2, 16, 32, seed=2)], "QSeg": [_SEG], "KSeg": [_SEG]},
     {"num_heads": 2, "causal": True, "is_test": True, "dropout_prob": 0.1}),
    ("flash_attention_sparse_cross", "flash_attention_sparse",
     {"Q": [_r(2, 16, 32)], "K": [_r(2, 24, 32, seed=1)],
      "V": [_r(2, 24, 32, seed=2)], "QSeg": [_SEG], "KSeg": [_KSEG]},
     {"num_heads": 2}),
    # the MoE block's dense path (no mesh): top-2 routing, capacity 2
    ("moe_ffn_dense", "moe_ffn",
     {"X": [_r(2, 4, 6)], "GateW": [_r(6, 4, seed=1)],
      "W1": [_r(4, 6, 10, seed=2, scale=0.3)], "B1": [_r(4, 10, seed=3)],
      "W2": [_r(4, 10, 6, seed=4, scale=0.3)], "B2": [_r(4, 6, seed=5)]},
     {"k": 2, "capacity_factor": 2.0, "act": "gelu"}),
]


# the DeepFM slice: concat/slice, the CTR loss, dense Adagrad, the packed
# row-major table's lookup and state-column init
_PACKED = np.random.RandomState(9).randint(0, 2 ** 16, (10, 128)).astype(
    np.uint16)
_PACKED[:, :12] = _r(10, 6).view(np.uint16)   # 6 finite f32 values a row
_SIG_LABEL = (_pos(4, 3, seed=1) > 1.0).astype(np.float32)
_SIG_LABEL[1, 2] = -100.0
CASES += [
    ("concat", "concat", {"X": [_r(2, 3), _r(2, 5, seed=1)]}, {"axis": 1}),
    ("slice_neg", "slice", {"Input": [_r(2, 3, 8)]},
     {"axes": [2, 1], "starts": [-6, 0], "ends": [7, -1]}),
    ("sigmoid_ce", "sigmoid_cross_entropy_with_logits",
     {"X": [_r(4, 3, scale=3)], "Label": [_SIG_LABEL]}, {}),
    ("sigmoid_ce_normalize", "sigmoid_cross_entropy_with_logits",
     {"X": [_r(4, 3, scale=3)], "Label": [_SIG_LABEL]},
     {"normalize": True, "ignore_index": -100}),
    ("square_error_cost", "square_error_cost",
     {"X": [X34], "Label": [_r(3, 4, seed=1)]}, {}),
    ("adagrad", "adagrad", {"Param": [X34], "Grad": [_r(3, 4, seed=1)],
                            "Moment": [_pos(3, 4, seed=2)],
                            "LearningRate": [_LR]}, {"epsilon": 1e-6}),
    ("lookup_table_row_pack", "lookup_table",
     {"W": [_PACKED], "Ids": [_ids(2, 3, 1)]},
     {"row_pack_dt": 6, "padding_idx": 4}),
    ("rowpack_init_state_cols", "rowpack_init_state_cols",
     {"Param": [_PACKED]}, {"vis": 3, "dt": 6, "value": 0.1}),
]


# the training-surface slice: the lr schedules, the remaining update ops
# (one step each; decayed_adagrad, adadelta, rmsprop and ftrl through
# sqrt_rn) and the streaming auc
_STEP = np.array([5], np.int64)
_B = _r(3, 4, seed=3)
_AUC_P = np.random.RandomState(4).rand(64, 2).astype(np.float32)
_AUC_L = np.random.RandomState(5).randint(0, 2, (64, 1)).astype(np.int64)
_AUC_STAT = np.random.RandomState(6).randint(0, 9, 64).astype(np.float32)


def _sched(kind, **attrs):
    return (f"lr_schedule_{kind}", "lr_schedule", {"Step": [_STEP]},
            dict(attrs, kind=kind))


CASES += [
    _sched("noam", d_model=64, warmup_steps=4, learning_rate=2.0),
    _sched("exponential", learning_rate=0.1, decay_steps=3, decay_rate=0.5,
           staircase=True),
    _sched("natural_exp", learning_rate=0.1, decay_steps=3, decay_rate=0.5),
    _sched("inverse_time", learning_rate=0.1, decay_steps=3, decay_rate=0.5),
    _sched("polynomial", learning_rate=0.1, decay_steps=3,
           end_learning_rate=1e-3, power=2.0, cycle=True),
    _sched("piecewise", boundaries=[3, 7], values=[0.1, 0.01, 0.001],
           learning_rate=0.1),
    _sched("cosine", learning_rate=0.1, step_each_epoch=2, epochs=5),
    ("lr_schedule_warmup_base", "lr_schedule",
     {"Step": [_STEP], "Base": [np.array([0.03], np.float32)]},
     {"kind": "warmup", "warmup_steps": 8, "start_lr": 0.0, "end_lr": 0.1}),
    ("lars_momentum", "lars_momentum",
     {"Param": [X34], "Grad": [_B], "Velocity": [_r(3, 4, seed=4)],
      "LearningRate": [_LR]}, {"mu": 0.9}),
    ("adamax", "adamax",
     {"Param": [X34], "Grad": [_B], "Moment": [_r(3, 4, seed=4)],
      "InfNorm": [_pos(3, 4, seed=5)], "Beta1Pow": [np.array([0.81],
                                                             np.float32)],
      "LearningRate": [_LR]}, {}),
    ("decayed_adagrad", "decayed_adagrad",
     {"Param": [X34], "Grad": [_B], "Moment": [_pos(3, 4, seed=4)],
      "LearningRate": [_LR]}, {"decay": 0.9}),
    ("adadelta", "adadelta",
     {"Param": [X34], "Grad": [_B], "AvgSquaredGrad": [_pos(3, 4, seed=4)],
      "AvgSquaredUpdate": [_pos(3, 4, seed=5)], "LearningRate": [_LR]},
     {"rho": 0.9}),
    ("rmsprop_centered", "rmsprop",
     {"Param": [X34], "Grad": [_B], "MeanSquare": [_pos(3, 4, seed=4)],
      "MeanGrad": [_r(3, 4, seed=5, scale=0.1)],
      "Moment": [_r(3, 4, seed=6)], "LearningRate": [_LR]},
     {"centered": True, "momentum": 0.5}),
    ("ftrl_power", "ftrl",
     {"Param": [X34], "Grad": [_B], "SquaredAccumulator": [_pos(3, 4, seed=4)],
      "LinearAccumulator": [_r(3, 4, seed=5)], "LearningRate": [_LR]},
     {"l1": 0.1, "l2": 0.01, "lr_power": -0.3}),
    ("auc", "auc", {"Predict": [_AUC_P], "Label": [_AUC_L],
                    "StatPos": [_AUC_STAT], "StatNeg": [_AUC_STAT[::-1].copy()]},
     {"num_thresholds": 63}),
]

_LEN = np.array([2, 5, 1], np.int32)
_SEQ = _r(3, 5, 4, seed=7)
_TOKS = np.array([[2, 1, 2, 3, 0], [5, 2, 2, 2, 1]], np.int32)
_LOG_IDS = np.array([3, 1, 3, 2**31 - 1, 3, 5, 2**31 - 1, 2**31 - 1],
                    np.int32)
CASES += [
    ("pad", "pad", {"X": [_r(2, 3, 4)]},
     {"paddings": [0, 1, 2, 0, 1, 3], "pad_value": -0.5}),
    ("pad2d_constant", "pad2d", {"X": [_r(2, 3, 4, 5)]},
     {"paddings": [1, 0, 2, 3], "mode": "constant", "pad_value": 1.5}),
    ("pad2d_reflect", "pad2d", {"X": [_r(2, 3, 4, 5)]},
     {"paddings": [1, 2, 2, 3], "mode": "reflect"}),
    ("pad2d_edge", "pad2d", {"X": [_r(2, 3, 4, 5)]},
     {"paddings": [2, 1, 0, 3], "mode": "edge"}),
    ("space_to_depth", "space_to_depth", {"X": [_r(2, 3, 6, 4)]},
     {"blocksize": 2}),
    ("sequence_mask", "sequence_mask", {"X": [_LEN]},
     {"maxlen": 6, "out_dtype": "int32"}),
    ("sequence_pool_sum", "sequence_pool", {"X": [_SEQ], "Length": [_LEN]},
     {"pooltype": "SUM"}),
    ("sequence_pool_average", "sequence_pool",
     {"X": [_SEQ], "Length": [_LEN]}, {"pooltype": "AVERAGE"}),
    ("sequence_pool_sqrt", "sequence_pool", {"X": [_SEQ], "Length": [_LEN]},
     {"pooltype": "SQRT"}),
    ("sequence_pool_max", "sequence_pool", {"X": [_SEQ], "Length": [_LEN]},
     {"pooltype": "MAX"}),
    ("sequence_pool_last", "sequence_pool", {"X": [_SEQ], "Length": [_LEN]},
     {"pooltype": "LAST"}),
    ("sequence_pool_first", "sequence_pool",
     {"X": [_SEQ], "Length": [_LEN]}, {"pooltype": "FIRST"}),
    ("sequence_softmax", "sequence_softmax",
     {"X": [_r(3, 5)], "Length": [_LEN]}, {}),
    ("sequence_expand", "sequence_expand",
     {"X": [_r(3, 4)], "Y": [_r(3, 2, 4, seed=1)]}, {}),
    ("sequence_reverse", "sequence_reverse", {"X": [_SEQ], "Length": [_LEN]},
     {}),
    ("sequence_concat", "sequence_concat",
     {"X": [_r(2, 3, 4), _r(2, 5, 4, seed=1)]}, {}),
    ("im2sequence", "im2sequence", {"X": [_r(2, 3, 7, 5)]},
     {"kernels": [3, 2], "strides": [2, 1], "paddings": [1, 0, 1, 0]}),
    ("sequence_pad", "sequence_pad",
     {"X": [_SEQ], "PadValue": [np.array(-1.0, np.float32)], "Length": [_LEN]},
     {"padded_length": 7}),
    ("sequence_pad_truncate", "sequence_pad",
     {"X": [_SEQ], "PadValue": [np.array(0.5, np.float32)], "Length": [_LEN]},
     {"padded_length": 3}),
    ("sequence_unpad", "sequence_unpad", {"X": [_SEQ], "Length": [_LEN]},
     {}),
    ("sequence_conv", "sequence_conv",
     {"X": [_SEQ], "Filter": [_r(12, 3, seed=2)], "Length": [_LEN]},
     {"contextLength": 3, "contextStart": -1}),
    ("sequence_slice", "sequence_slice",
     {"X": [_SEQ], "Offset": [np.array([1, 0, 3], np.int32)],
      "Length": [_LEN]}, {}),
    ("sequence_erase", "sequence_erase",
     {"X": [_TOKS], "Length": [np.array([4, 5], np.int32)]}, {"tokens": [2]}),
    ("sequence_expand_as", "sequence_expand_as",
     {"X": [_r(3, 4)], "Y": [_SEQ], "Length": [_LEN]}, {}),
    ("sequence_enumerate", "sequence_enumerate",
     {"X": [_TOKS], "Length": [np.array([3, 5], np.int32)]},
     {"win_size": 3, "pad_value": 9}),
    ("sequence_reshape", "sequence_reshape",
     {"X": [_SEQ], "Length": [_LEN]}, {"new_dim": 2}),
    ("sequence_scatter", "sequence_scatter",
     {"X": [_r(2, 6)], "Ids": [np.array([[0, 2, 2], [5, 1, 0]], np.int32)],
      "Updates": [_r(2, 3, seed=1)], "Length": [np.array([3, 2], np.int32)]},
     {}),
    ("sequence_topk_avg_pooling", "sequence_topk_avg_pooling",
     {"X": [_r(3, 2, 5)], "Length": [_LEN]}, {"topks": [1, 3]}),
    ("beam_search", "beam_search",
     {"Scores": [_r(2, 3, 7)], "PreScores": [_r(2, 3, seed=1)],
      "PreFinished": [np.array([[0, 1, 0], [0, 0, 1]], np.int32)]},
     {"beam_size": 3, "end_id": 0}),
    ("beam_search_decode", "beam_search_decode",
     {"Ids": [_ids(4, 2, 3, hi=7)], "ParentIdx": [_ids(4, 2, 3, hi=3, seed=1)],
      "Scores": [_r(2, 3)]}, {}),
    ("deferred_fold", "deferred_fold",
     {"Param": [_r(6, 4, seed=3)], "LogIds": [_LOG_IDS],
      "LogRaw": [_r(8, 128, seed=4)], "LogCum": [_r(8, 128, seed=5)],
      "PendingPos": [np.arange(6, dtype=np.int32)],
      "Count": [np.array([6], np.int32)]}, {}),
    ("deferred_init_state_cols", "deferred_init_state_cols",
     {"Param": [_r(5, 6)]}, {"vis": 2, "value": 0.1}),
]

# ops whose attrs hold a sub-block: the program-level twins in
# tests/test_torch_optimizers_more.py (conditional_block) and
# tests/test_torch_pipeline.py (the pipelines) run them
BLOCK_OPS = ("conditional_block", "pipeline", "pipeline_hetero")
# the deferred-row update ops (a SelectedRows gradient):
# test_deferred_row_op_matches_jax
DEFERRED_ROW_OPS = ("sgd_row_deferred", "adagrad_row_deferred",
                    "adam_row_deferred")
# the quantization ops: tests/test_torch_quant_ops.py
QUANT_OPS = ("fake_quantize_abs_max", "fake_channel_wise_quantize_abs_max",
             "fake_quantize_moving_average_abs_max",
             "fake_quantize_range_abs_max", "moving_average_abs_max_scale",
             "fake_dequantize_max_abs",
             "fake_channel_wise_dequantize_max_abs", "quantized_fc",
             "quantized_lookup_table")


# the ops the dygraph layer zoo traces: tests/test_torch_dygraph_ops.py
# holds each forward and input gradient to jax.vjp
DYGRAPH_OPS = ("conv2d_transpose", "conv3d", "group_norm",
               "conv3d_transpose", "prelu", "bilinear_tensor_product",
               "row_conv", "spectral_norm", "nce", "tree_conv")


# the control-flow slice's 25 ops: tests/test_torch_control_flow_ops.py
# holds each forward and input gradient to jax.vjp
CONTROL_FLOW_SLICE_OPS = (
    "increment", "fill_constant_batch_size_like", "stack", "reduce_max",
    "reduce_min", "reduce_prod", "reduce_any", "reduce_all",
    "max_sequence_len", "while", "static_rnn", "cond", "switch", "select",
    "array_write", "array_read", "array_length", "lstm", "gru", "gru_unit",
    "lstm_unit", "cudnn_lstm", "linear_chain_crf", "crf_decoding",
    "chunk_eval")


def test_cases_cover_every_ported_op():
    covered = ({op for _, op, _, _ in CASES} | set(RANDOM_OPS)
               | set(SELECTED_ROWS_OPS) | set(BLOCK_OPS)
               | set(DEFERRED_ROW_OPS) | set(QUANT_OPS) | set(DYGRAPH_OPS)
               | set(CONTROL_FLOW_SLICE_OPS))
    assert covered == set(treg.registered_ops())
    # the port registers nothing the JAX package does not have
    assert set(treg.registered_ops()) <= set(jreg.registered_ops())


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    _, op_type, inputs, attrs = case
    want = jreg.get_op(op_type).fn(
        JaxCtx(None, is_test=True),
        {s: [jnp.asarray(a) for a in v] for s, v in inputs.items()}, attrs)
    got = treg.get_op(op_type).fn(
        TorchCtx("cpu", is_test=True),
        {s: [torch.from_numpy(a.copy()) for a in v] for s, v in inputs.items()},
        attrs)
    assert sorted(got) == sorted(want)
    for slot in want:
        assert len(got[slot]) == len(want[slot])
        for g, w in zip(got[slot], want[slot]):
            g, w = to_numpy(g), np.asarray(w)
            assert g.shape == w.shape, (slot, g.shape, w.shape)
            # ints: the JAX package narrows int64 to int32, the port keeps it
            assert g.dtype.kind == w.dtype.kind, (slot, g.dtype, w.dtype)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_fill_constant_keeps_int64():
    out = treg.get_op("fill_constant").fn(
        TorchCtx("cpu"), {}, {"shape": [2], "dtype": "int64", "value": 3})
    assert out["Out"][0].dtype == torch.int64


@pytest.mark.parametrize("op_type,attrs,check", [
    ("gaussian_random", {"mean": 1.0, "std": 2.0},
     lambda a: abs(a.mean() - 1.0) < 0.1 and abs(a.std() - 2.0) < 0.1),
    ("uniform_random", {"min": -0.5, "max": 1.5},
     lambda a: a.min() >= -0.5 and a.max() < 1.5 and abs(a.mean() - 0.5) < 0.05),
    ("truncated_gaussian_random", {"mean": 0.0, "std": 0.5},
     lambda a: np.abs(a).max() <= 1.0 and abs(a.std() - 0.5 * 0.8796) < 0.03),
])
def test_random_ops_distribution_and_seed(op_type, attrs, check):
    """Draw from the context's seeded generator: the right distribution,
    the same numbers for the same seed, new numbers on the next draw."""
    attrs = dict(attrs, shape=[4000], dtype="float32")
    fn = treg.get_op(op_type).fn

    def draw(gen):
        return fn(TorchCtx("cpu", gen), {}, attrs)["Out"][0].numpy()

    g1 = torch.Generator().manual_seed(3)
    a, a2 = draw(g1), draw(g1)
    b = draw(torch.Generator().manual_seed(3))
    assert a.dtype == np.float32 and a.shape == (4000,)
    assert check(a)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, a2)


@pytest.mark.parametrize("op_type", SELECTED_ROWS_OPS)
def test_packed_row_op_matches_jax(op_type):
    """The packed-table update ops on a SelectedRows gradient with
    duplicates, against the JAX ops (the unfused branch: no Pallas)."""
    from paddle_tpu.core.selected_rows import SelectedRows as JRows
    from paddle_tpu_torch.core.selected_rows import SelectedRows as TRows

    mult = {"sgd_row_packed": 1, "adagrad_row_packed": 2,
            "adam_row_packed": 3}[op_type]
    vis, q = 3, 8
    rows = _r(10, vis * mult, seed=5)
    rows[:, vis:] = np.abs(rows[:, vis:])
    table = np.zeros((10, 128), np.uint16)
    table[:, :2 * vis * mult] = rows.view(np.uint16)
    ids = np.array([4, 1, 4, 9, 0, 1, 1, 7])
    fwd = rows[ids]
    grows = _r(q, vis * mult, seed=6)
    inputs = {"Param": [table], "FwdRows": [fwd], "LearningRate": [_LR],
              "Beta1Pow": [np.float32([0.9 ** 2])],
              "Beta2Pow": [np.float32([0.999 ** 2])]}
    attrs = {"vis": vis, "rows_per_step": 12, "fused": False,
             "epsilon": 1e-6}
    want = jreg.get_op(op_type).fn(
        JaxCtx(None), dict({s: [jnp.asarray(a) for a in v]
                            for s, v in inputs.items()},
                           Grad=[JRows(jnp.asarray(ids, jnp.int32),
                                       jnp.asarray(grows), 10)]), attrs)
    got = treg.get_op(op_type).fn(
        TorchCtx("cpu"), dict({s: [torch.from_numpy(a.copy()) for a in v]
                               for s, v in inputs.items()},
                              Grad=[TRows(torch.from_numpy(ids),
                                          torch.from_numpy(grows), 10)]),
        attrs)
    assert sorted(got) == sorted(want)
    w = np.asarray(want["ParamOut"][0])
    g = to_numpy(got["ParamOut"][0])
    assert g.dtype == np.uint16
    np.testing.assert_array_equal(g[:, 2 * vis * mult:],
                                  w[:, 2 * vis * mult:])
    np.testing.assert_allclose(g[:, :2 * vis * mult].copy().view(np.float32),
                               w[:, :2 * vis * mult].copy().view(np.float32),
                               rtol=1e-5, atol=1e-6)
    for slot in set(want) - {"ParamOut"}:
        np.testing.assert_allclose(to_numpy(got[slot][0]),
                                   np.asarray(want[slot][0]), rtol=1e-6)


@pytest.mark.parametrize("op_type", DEFERRED_ROW_OPS)
def test_deferred_row_op_matches_jax(op_type):
    """The deferred-row update ops on a SelectedRows gradient with
    duplicates, the log half full and ids already pending, against the JAX
    ops: every output within rtol 1e-5 (the int32 state equal)."""
    from paddle_tpu.core.selected_rows import SelectedRows as JRows
    from paddle_tpu_torch.core.selected_rows import SelectedRows as TRows

    mult = {"sgd_row_deferred": 1, "adagrad_row_deferred": 2,
            "adam_row_deferred": 3}[op_type]
    vis, q, cap = 3, 8, 24
    ids = np.array([4, 1, 4, 9, 0, 1, 1, 7])
    fwd = _r(q, vis * mult, seed=5)
    fwd[:, vis:] = np.abs(fwd[:, vis:])
    postab = np.full(10, -1, np.int32)
    postab[[1, 9]] = [2, 5]
    log_ids = np.full(cap, 2**31 - 1, np.int32)
    log_ids[:q] = [3, 8, 1, 2, 6, 9, 5, 0]
    inputs = {"FwdRows": [fwd], "FwdCum": [_r(q, vis * mult, seed=7)],
              "PendingPos": [postab], "LogIds": [log_ids],
              "LogRaw": [_r(cap, 128, seed=8)],
              "LogCum": [_r(cap, 128, seed=9)],
              "Count": [np.array([q], np.int32)], "LearningRate": [_LR],
              "Beta1Pow": [np.float32([0.9 ** 2])],
              "Beta2Pow": [np.float32([0.999 ** 2])]}
    grows = _r(q, vis, seed=6)
    attrs = {"vis": vis, "rows_per_step": q + 4, "epsilon": 1e-6}
    want = jreg.get_op(op_type).fn(
        JaxCtx(None), dict({s: [jnp.asarray(a) for a in v]
                            for s, v in inputs.items()},
                           Grad=[JRows(jnp.asarray(ids, jnp.int32),
                                       jnp.asarray(grows), 10)]), attrs)
    got = treg.get_op(op_type).fn(
        TorchCtx("cpu"), dict({s: [torch.from_numpy(a.copy()) for a in v]
                               for s, v in inputs.items()},
                              Grad=[TRows(torch.from_numpy(ids),
                                          torch.from_numpy(grows), 10)]),
        attrs)
    assert sorted(got) == sorted(want)
    for slot in want:
        g, w = to_numpy(got[slot][0]), np.asarray(want[slot][0])
        assert g.shape == w.shape and g.dtype == w.dtype, slot
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                   err_msg=slot)


def test_rowpack_init_distribution_and_seed():
    """Visible columns uniform in [low, high), state columns at their value,
    spare lanes zero; the same numbers for the same seed."""
    attrs = {"height": 3000, "vis": 5, "dt": 10, "low": -0.5, "high": 0.5,
             "state_value": 0.25}
    fn = treg.get_op("rowpack_init").fn

    def draw(seed):
        ctx = TorchCtx("cpu", torch.Generator().manual_seed(seed))
        return to_numpy(fn(ctx, {}, attrs)["Out"][0])

    a = draw(3)
    assert a.dtype == np.uint16 and a.shape == (3000, 128)
    vals = a[:, :20].copy().view(np.float32)
    assert vals[:, :5].min() >= -0.5 and vals[:, :5].max() < 0.5
    assert abs(vals[:, :5].mean()) < 0.02
    assert (vals[:, 5:] == 0.25).all() and not a[:, 20:].any()
    np.testing.assert_array_equal(a, draw(3))
    assert not np.array_equal(a, draw(4))
