"""The port's static graph against the JAX package's on the CPU: every
ported op lowering, one op program at a time, through both Executors on
the same numpy feeds (float32 at rtol 1e-5 / atol 1e-6, integers and
bools exact); the IR passes' output programs (compared as wire bytes);
static LeNet with Adam over 3 steps on the JAX package's weights (the
carrier `convert.from_jax_scope`); autodiff, sparse rows, run_n, random
ops, control flow read from the wire; and the Executor's device rule and
raises."""
import numpy as np
import pytest
import torch

from _torch_parity import keep_global_rng  # noqa: F401
from _torch_static import (assert_close, carry, fluids, jax_program_bytes,
                           lenet, no_cuda, op_program, port_program_bytes,
                           rel_l2, run_pair, static_ernie)

pytestmark = pytest.mark.usefixtures("keep_global_rng")

_RS = np.random.RandomState(2025)


def f32(*shape, lo=-1.0, hi=1.0):
    return _RS.uniform(lo, hi, shape).astype(np.float32)


def pos(*shape):
    return f32(*shape, lo=0.5, hi=2.0)


def i64(hi, *shape, lo=0):
    return _RS.randint(lo, hi, shape).astype(np.int64)


def boolean(*shape):
    return _RS.rand(*shape) > 0.5


X34 = f32(3, 4)
SPECIAL = np.array([[0.5, np.nan, np.inf], [-np.inf, -1.0, 0.0]],
                   np.float32)

UNARY = {
    "relu": X34, "relu6": f32(3, 4, lo=-8, hi=8), "sigmoid": X34,
    "tanh": X34, "sqrt": pos(3, 4), "rsqrt": pos(3, 4), "exp": X34,
    "log": pos(3, 4), "square": X34, "abs": X34, "floor": f32(3, 4) * 3,
    "ceil": f32(3, 4) * 3, "round": f32(3, 4) * 3, "sin": X34, "cos": X34,
    "sign": X34, "reciprocal": pos(3, 4), "softsign": X34, "softplus": X34,
    "mish": X34, "silu": X34, "swish": X34, "hard_swish": f32(3, 4) * 4,
    "tanh_shrink": X34, "erf": X34, "logsigmoid": X34, "tan": X34,
    "asin": f32(3, 4) * 0.9, "acos": f32(3, 4) * 0.9, "atan": X34,
    "sinh": X34, "cosh": X34, "asinh": X34, "acosh": pos(3, 4) + 1.0,
    "atanh": f32(3, 4) * 0.9, "log2": pos(3, 4), "log10": pos(3, 4),
    "log1p": pos(3, 4), "expm1": X34, "selu": X34, "isnan_v2": SPECIAL,
    "isinf_v2": SPECIAL, "isfinite_v2": SPECIAL, "fill_zeros_like": X34,
}

EW = ["elementwise_add", "elementwise_sub", "elementwise_mul",
      "elementwise_div", "elementwise_max", "elementwise_min",
      "elementwise_pow", "elementwise_mod", "elementwise_floordiv"]


def _opt_inputs(extra):
    p = f32(4, 3)
    base = {"Param": [p], "Grad": [f32(4, 3)],
            "LearningRate": [np.float32([0.05])]}
    base.update(extra)
    return base


def _specs():
    """(id, op type, inputs, attrs, outputs) of the one-op programs."""
    s = []
    for name, x in UNARY.items():
        s.append((name, name, {"X": [x]}, {}, {"Out": 1}))
    for name in EW:
        lo, hi = (0.5, 3.0) if name in ("elementwise_pow", "elementwise_mod",
                                        "elementwise_floordiv") else (-1, 1)
        s.append((name, name, {"X": [f32(2, 3, 4, lo=lo, hi=hi)],
                               "Y": [f32(3, 4, lo=lo, hi=hi)]},
                  {"axis": -1}, {"Out": 1}))
    s += [
        ("elementwise_add_axis1", "elementwise_add",
         {"X": [f32(2, 3, 4)], "Y": [f32(3)]}, {"axis": 1}, {"Out": 1}),
        ("leaky_relu", "leaky_relu", {"X": [X34]}, {"alpha": 0.1},
         {"Out": 1}),
        ("elu", "elu", {"X": [X34]}, {"alpha": 0.7}, {"Out": 1}),
        ("gelu", "gelu", {"X": [X34]}, {}, {"Out": 1}),
        ("gelu_tanh", "gelu", {"X": [X34]}, {"approximate": True},
         {"Out": 1}),
        ("hard_sigmoid", "hard_sigmoid", {"X": [f32(3, 4) * 4]},
         {"slope": 0.25, "offset": 0.4}, {"Out": 1}),
        ("softmax", "softmax", {"X": [f32(2, 3, 5)]}, {"axis": 1},
         {"Out": 1}),
        ("log_softmax", "log_softmax", {"X": [f32(2, 5)]}, {},
         {"Out": 1}),
        ("scale", "scale", {"X": [X34]}, {"scale": 3.0, "bias": 0.5},
         {"Out": 1}),
        ("scale_bias_first", "scale", {"X": [X34]},
         {"scale": 3.0, "bias": 0.5, "bias_after_scale": False},
         {"Out": 1}),
        ("clip", "clip", {"X": [X34]}, {"min": -0.3, "max": 0.4},
         {"Out": 1}),
        ("pow", "pow", {"X": [pos(3, 4)]}, {"factor": 2.5}, {"Out": 1}),
        ("cast_int32", "cast", {"X": [f32(3, 4) * 5]},
         {"out_dtype": "int32"}, {"Out": 1}),
        ("cast_float64", "cast", {"X": [X34]}, {"out_dtype": "float64"},
         {"Out": 1}),
        ("matmul", "matmul", {"X": [f32(2, 4, 3)], "Y": [f32(2, 5, 4)]},
         {"transpose_X": True, "transpose_Y": True, "alpha": 0.5},
         {"Out": 1}),
        ("matmul_v2", "matmul_v2", {"X": [f32(3, 4)], "Y": [f32(4, 2)]},
         {"trans_x": False, "trans_y": False}, {"Out": 1}),
        ("mul", "mul", {"X": [f32(2, 3, 4)], "Y": [f32(4, 5)]},
         {"x_num_col_dims": 2, "y_num_col_dims": 1}, {"Out": 1}),
        ("fc", "fc", {"Input": [f32(2, 3, 4)], "W": [f32(4, 5)],
                      "Bias": [f32(5)]}, {"in_num_col_dims": 2},
         {"Out": 1}),
        ("conv2d", "conv2d", {"Input": [f32(2, 3, 7, 7)],
                              "Filter": [f32(4, 3, 3, 3)]},
         {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
          "groups": 1}, {"Output": 1}),
        ("depthwise_conv2d", "depthwise_conv2d",
         {"Input": [f32(2, 4, 6, 6)], "Filter": [f32(4, 1, 3, 3)]},
         {"strides": [1, 1], "paddings": [0, 0], "dilations": [2, 2],
          "groups": 4}, {"Output": 1}),
        ("conv2d_transpose", "conv2d_transpose",
         {"Input": [f32(2, 3, 4, 4)], "Filter": [f32(3, 2, 3, 3)]},
         {"strides": [2, 2], "paddings": [1, 1], "output_padding": [1, 1]},
         {"Output": 1}),
        ("conv_transpose", "conv_transpose",
         {"Input": [f32(1, 2, 3, 3)], "Filter": [f32(2, 3, 2, 2)]},
         {"strides": [1, 1], "paddings": [0, 0]}, {"Output": 1}),
        ("pool2d_max", "pool2d", {"X": [f32(2, 3, 6, 6)]},
         {"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2]},
         {"Out": 1}),
        ("pool2d_avg", "pool2d", {"X": [f32(2, 3, 6, 6)]},
         {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
          "paddings": [1, 1], "exclusive": True}, {"Out": 1}),
        ("pool2d_global", "pool2d", {"X": [f32(2, 3, 5, 5)]},
         {"pooling_type": "avg", "ksize": [1, 1], "global_pooling": True},
         {"Out": 1}),
        ("pool2d_adaptive", "pool2d", {"X": [f32(2, 3, 6, 6)]},
         {"pooling_type": "max", "ksize": [3, 2], "adaptive": True},
         {"Out": 1}),
        ("batch_norm_train", "batch_norm",
         {"X": [f32(4, 3, 5, 5)], "Scale": [pos(3)], "Bias": [f32(3)],
          "Mean": [f32(3)], "Variance": [pos(3)]},
         {"epsilon": 1e-5, "momentum": 0.9},
         {"Y": 1, "MeanOut": 1, "VarianceOut": 1, "SavedMean": 1,
          "SavedVariance": 1}),
        ("batch_norm_test", "batch_norm",
         {"X": [f32(4, 3, 5, 5)], "Scale": [pos(3)], "Bias": [f32(3)],
          "Mean": [f32(3)], "Variance": [pos(3)]},
         {"is_test": True}, {"Y": 1}),
        ("layer_norm", "layer_norm", {"X": [f32(2, 3, 4)], "Scale": [pos(12)],
                                      "Bias": [f32(12)]},
         {"begin_norm_axis": 1, "epsilon": 1e-5}, {"Y": 1}),
        ("dropout_test_downgrade", "dropout", {"X": [X34]},
         {"dropout_prob": 0.3, "is_test": True}, {"Out": 1}),
        ("dropout_test_upscale", "dropout", {"X": [X34]},
         {"dropout_prob": 0.3, "is_test": True,
          "dropout_implementation": "upscale_in_train"}, {"Out": 1}),
        ("fill_constant", "fill_constant", {},
         {"shape": [2, 3], "dtype": "int64", "value": 7.0}, {"Out": 1}),
        ("fill_constant_batch_size_like", "fill_constant_batch_size_like",
         {"Input": [f32(5, 2)]}, {"shape": [-1, 3], "value": 1.5},
         {"Out": 1}),
        ("assign", "assign", {"X": [X34]}, {}, {"Out": 1}),
        ("assign_value", "assign_value", {},
         {"shape": [2, 2], "dtype": "float32",
          "values": [0.5, -1.0, 2.0, 3.0]}, {"Out": 1}),
        ("shape", "shape", {"Input": [f32(2, 3, 4)]}, {}, {"Out": 1}),
        ("reshape2", "reshape2", {"X": [f32(2, 3, 4)]},
         {"shape": [0, -1, 2]}, {"Out": 1}),
        ("transpose2", "transpose2", {"X": [f32(2, 3, 4)]},
         {"axis": [2, 0, 1]}, {"Out": 1}),
        ("concat", "concat", {"X": [f32(2, 3), f32(2, 2)]}, {"axis": 1},
         {"Out": 1}),
        ("split_num", "split", {"X": [f32(4, 6)]}, {"num": 3, "axis": 1},
         {"Out": 3}),
        ("split_sections", "split", {"X": [f32(4, 6)]},
         {"sections": [1, 3], "axis": 0}, {"Out": 2}),
        ("split_byref", "split_byref", {"X": [f32(4, 6)]},
         {"num": 2, "axis": 0}, {"Out": 2}),
        ("stack", "stack", {"X": [X34, f32(3, 4)]}, {"axis": 1}, {"Y": 1}),
        ("squeeze2", "squeeze2", {"X": [f32(2, 1, 3, 1)]}, {"axes": [1]},
         {"Out": 1}),
        ("unsqueeze2", "unsqueeze2", {"X": [f32(2, 3)]}, {"axes": [0, 2]},
         {"Out": 1}),
        ("flatten2", "flatten2", {"X": [f32(2, 3, 4)]}, {"axis": 2},
         {"Out": 1}),
        ("flatten_contiguous_range", "flatten_contiguous_range",
         {"X": [f32(2, 3, 4, 5)]}, {"start_axis": 1, "stop_axis": 2},
         {"Out": 1}),
        ("expand", "expand", {"X": [f32(2, 3)]}, {"expand_times": [2, 1]},
         {"Out": 1}),
        ("expand_v2", "expand_v2", {"X": [f32(3, 1)]}, {"shape": [2, 3, 4]},
         {"Out": 1}),
        ("slice", "slice", {"Input": [f32(4, 5, 6)]},
         {"axes": [0, 2], "starts": [1, -4], "ends": [3, 10000]},
         {"Out": 1}),
        ("gather", "gather", {"X": [f32(5, 3)], "Index": [i64(5, 4)]}, {},
         {"Out": 1}),
        ("pad", "pad", {"X": [f32(2, 3)]},
         {"paddings": [1, 0, 0, 2], "pad_value": 0.5}, {"Out": 1}),
        ("pad2d", "pad2d", {"X": [f32(1, 2, 3, 3)]},
         {"paddings": [0, 0, 0, 0, 1, 1, 2, 0], "mode": "constant"},
         {"Out": 1}),
        ("mean", "mean", {"X": [X34]}, {}, {"Out": 1}),
        ("sum", "sum", {"X": [X34, f32(3, 4), f32(3, 4)]}, {}, {"Out": 1}),
        ("softmax_with_cross_entropy", "softmax_with_cross_entropy",
         {"Logits": [f32(4, 5)], "Label": [i64(5, 4, 1)]}, {},
         {"Loss": 1, "Softmax": 1}),
        ("softmax_with_cross_entropy_soft", "softmax_with_cross_entropy",
         {"Logits": [f32(4, 5)], "Label": [pos(4, 5) / 5]},
         {"soft_label": True}, {"Loss": 1, "Softmax": 1}),
        ("cross_entropy", "cross_entropy",
         {"X": [pos(4, 5) / 5], "Label": [i64(5, 4, 1)]}, {}, {"Y": 1}),
        ("cross_entropy2_soft", "cross_entropy2",
         {"X": [pos(4, 5) / 5], "Label": [pos(4, 5) / 5]},
         {"soft_label": True}, {"Y": 1}),
        ("square_error_cost", "square_error_cost",
         {"X": [X34], "Y": [f32(3, 4)]}, {}, {"Out": 1}),
        ("accuracy", "accuracy", {"Out": [f32(6, 4)], "Label": [i64(4, 6, 1)]},
         {}, {"Accuracy": 1, "Correct": 1, "Total": 1}),
        ("top_k", "top_k", {"X": [f32(3, 6)]}, {"k": 2},
         {"Out": 1, "Indices": 1}),
        ("top_k_v2_smallest", "top_k_v2", {"X": [f32(3, 6)]},
         {"k": 3, "axis": 0, "largest": False}, {"Out": 1, "Indices": 1}),
        ("arg_max", "arg_max", {"X": [f32(3, 6)]}, {"axis": 1}, {"Out": 1}),
        ("arg_min", "arg_min", {"X": [f32(3, 6)]},
         {"axis": 0, "keepdims": True}, {"Out": 1}),
        ("lookup_table", "lookup_table",
         {"Ids": [i64(7, 4, 1)], "W": [f32(7, 3)]}, {"padding_idx": 2},
         {"Out": 1}),
        ("lookup_table_v2", "lookup_table_v2",
         {"Ids": [i64(7, 2, 5)], "W": [f32(7, 3)]}, {}, {"Out": 1}),
        ("one_hot", "one_hot", {"X": [i64(5, 4, 1)]}, {"depth": 5},
         {"Out": 1}),
        ("one_hot_v2", "one_hot_v2", {"X": [i64(6, 3)]}, {"depth": 6},
         {"Out": 1}),
        ("clip_by_norm", "clip_by_norm", {"X": [f32(3, 4) * 5]},
         {"max_norm": 1.0}, {"Out": 1}),
        ("squared_l2_norm", "squared_l2_norm", {"X": [X34]}, {},
         {"Out": 1}),
        ("scatter_overwrite", "scatter",
         {"X": [f32(5, 3)], "Ids": [np.int64([3, 0])],
          "Updates": [f32(2, 3)]}, {}, {"Out": 1}),
        ("scatter_add", "scatter",
         {"X": [f32(5, 3)], "Ids": [np.int64([1, 1, 4])],
          "Updates": [f32(3, 3)]}, {"overwrite": False}, {"Out": 1}),
        ("scatter_nd_add", "scatter_nd_add",
         {"X": [f32(4, 5)], "Index": [np.int64([[1, 2], [1, 2], [3, 0]])],
          "Updates": [f32(3)]}, {}, {"Out": 1}),
        ("gather_nd", "gather_nd",
         {"X": [f32(4, 5, 2)], "Index": [np.int64([[0, 1], [3, 4]])]}, {},
         {"Out": 1}),
        ("increment", "increment", {"X": [np.float32([2.0])]},
         {"step": 3.0}, {"Out": 1}),
        ("quantized_mul", "quantized_mul",
         {"X": [f32(2, 3, 4)], "Y": [i64(100, 4, 5, lo=-100).astype(
             np.int8)]},
         {"in_scale": 0.02, "weight_scales": [0.01, 0.02, 0.03, 0.04,
                                              0.05],
          "x_num_col_dims": 2}, {"Out": 1}),
        ("quantized_matmul_v2", "quantized_matmul_v2",
         {"X": [f32(3, 4)], "Y": [i64(100, 5, 4, lo=-100).astype(np.int8)]},
         {"in_scale": 0.01, "weight_scales": [0.02], "trans_y": True,
          "alpha": 2.0}, {"Out": 1}),
        ("quantized_conv2d", "quantized_conv2d",
         {"Input": [f32(1, 2, 5, 5)],
          "Filter": [i64(100, 3, 2, 3, 3, lo=-100).astype(np.int8)]},
         {"in_scale": 0.01, "weight_scales": [0.01, 0.02, 0.03],
          "paddings": [1, 1]}, {"Output": 1}),
        ("sigmoid_cross_entropy_with_logits",
         "sigmoid_cross_entropy_with_logits",
         {"X": [f32(3, 4) * 3], "Label": [np.where(boolean(3, 4), 1.0, -100.0)
                                          .astype(np.float32)]},
         {"normalize": True}, {"Out": 1}),
        ("smooth_l1_loss", "smooth_l1_loss",
         {"X": [f32(3, 4) * 2], "Y": [f32(3, 4)], "InsideWeight": [pos(3, 4)],
          "OutsideWeight": [pos(3, 4)]}, {"sigma": 2.0},
         {"Diff": 1, "Out": 1}),
        ("label_smooth", "label_smooth", {"X": [pos(3, 4) / 4]},
         {"epsilon": 0.2}, {"Out": 1}),
        ("cumsum_exclusive_reverse", "cumsum", {"X": [f32(3, 5)]},
         {"axis": 1, "exclusive": True, "reverse": True}, {"Out": 1}),
        ("reverse", "reverse", {"X": [f32(3, 4, 2)]}, {"axis": [0, 2]},
         {"Out": 1}),
        ("prelu_channel", "prelu", {"X": [f32(2, 3, 4)], "Alpha": [f32(3)]},
         {"mode": "channel"}, {"Out": 1}),
        ("group_norm", "group_norm",
         {"X": [f32(2, 4, 3, 3)], "Scale": [pos(4)], "Bias": [f32(4)]},
         {"groups": 2}, {"Y": 1}),
        ("instance_norm", "instance_norm",
         {"X": [f32(2, 3, 4, 4)], "Scale": [pos(3)], "Bias": [f32(3)]}, {},
         {"Y": 1}),
        ("rms_norm", "rms_norm", {"X": [f32(2, 6)], "Scale": [pos(6)]}, {},
         {"Y": 1}),
        ("norm", "norm", {"X": [f32(3, 4)]}, {"axis": 1},
         {"Out": 1, "Norm": 1}),
        ("p_norm", "p_norm", {"X": [f32(3, 4)]},
         {"porder": 3.0, "axis": 1, "keepdim": True}, {"Out": 1}),
        ("frobenius_norm", "frobenius_norm", {"X": [f32(2, 3, 4)]},
         {"dim": [1, 2]}, {"Out": 1}),
        ("roll", "roll", {"X": [f32(3, 4)]}, {"shifts": [1], "axis": [1]},
         {"Out": 1}),
        ("flip", "flip", {"X": [f32(3, 4)]}, {"axis": [0]}, {"Out": 1}),
        ("cumprod", "cumprod", {"X": [pos(3, 4)]}, {"dim": 1}, {"Out": 1}),
        ("diag_v2", "diag_v2", {"X": [f32(3)]},
         {"offset": 1, "padding_value": 0.5}, {"Out": 1}),
        ("meshgrid", "meshgrid", {"X": [f32(3), f32(2)]}, {}, {"Out": 2}),
        ("argsort", "argsort", {"X": [f32(3, 5)]},
         {"axis": 1, "descending": True}, {"Indices": 1, "Out": 1}),
        ("tril_triu", "tril_triu", {"X": [f32(4, 4)]},
         {"lower": False, "diagonal": 1}, {"Out": 1}),
        ("multiplex", "multiplex",
         {"X": [f32(3, 2), f32(3, 2)], "Ids": [np.int32([[1], [0], [1]])]},
         {}, {"Out": 1}),
        ("strided_slice", "strided_slice", {"Input": [f32(6, 5)]},
         {"axes": [0, 1], "starts": [0, 4], "ends": [6, 0],
          "strides": [2, -1]}, {"Out": 1}),
        ("expand_as_v2", "expand_as_v2", {"X": [f32(1, 3)]},
         {"target_shape": [4, 3]}, {"Out": 1}),
        ("index_select", "index_select",
         {"X": [f32(4, 5)], "Index": [i64(5, 3)]}, {"dim": 1}, {"Out": 1}),
        ("index_sample", "index_sample",
         {"X": [f32(3, 5)], "Index": [i64(5, 3, 2)]}, {}, {"Out": 1}),
        ("where", "where", {"Condition": [boolean(3, 4)], "X": [X34],
                            "Y": [f32(3, 4)]}, {}, {"Out": 1}),
        ("reduce_sum", "reduce_sum", {"X": [f32(2, 3, 4)]},
         {"dim": [1], "keep_dim": True}, {"Out": 1}),
        ("reduce_mean_all", "reduce_mean", {"X": [f32(2, 3, 4)]},
         {"reduce_all": True}, {"Out": 1}),
        ("reduce_max", "reduce_max", {"X": [f32(2, 3, 4)]}, {"dim": [0, 2]},
         {"Out": 1}),
        ("reduce_min", "reduce_min", {"X": [f32(2, 3, 4)]}, {"dim": [2]},
         {"Out": 1}),
        ("reduce_prod", "reduce_prod", {"X": [pos(2, 3)]}, {"dim": [1]},
         {"Out": 1}),
        ("reduce_all", "reduce_all", {"X": [boolean(3, 4)]}, {"dim": [1]},
         {"Out": 1}),
        ("reduce_any_all", "reduce_any", {"X": [boolean(3, 4)]},
         {"reduce_all": True, "keep_dim": True}, {"Out": 1}),
        ("logsumexp", "logsumexp", {"X": [f32(3, 4)]},
         {"axis": [1], "keepdim": True}, {"Out": 1}),
        ("size", "size", {"Input": [f32(3, 4)]}, {}, {"Out": 1}),
        ("fill_any_like", "fill_any_like", {"X": [X34]},
         {"value": 2.5, "dtype": "float64"}, {"Out": 1}),
        ("eye", "eye", {}, {"num_rows": 3, "num_columns": 4,
                            "dtype": "float32"}, {"Out": 1}),
        ("cos_sim", "cos_sim", {"X": [f32(3, 4)], "Y": [f32(3, 4)]}, {},
         {"Out": 1, "XNorm": 1, "YNorm": 1}),
        ("huber_loss", "huber_loss", {"X": [f32(3, 4) * 2], "Y": [f32(3, 4)]},
         {"delta": 0.5}, {"Out": 1, "Residual": 1}),
        ("log_loss", "log_loss", {"Predicted": [pos(3, 1) / 2.5],
                                  "Labels": [boolean(3, 1).astype(
                                      np.float32)]}, {}, {"Loss": 1}),
        ("affine_channel", "affine_channel",
         {"X": [f32(2, 3, 4, 4)], "Scale": [f32(3)], "Bias": [f32(3)]}, {},
         {"Out": 1}),
        ("pixel_shuffle", "pixel_shuffle", {"X": [f32(1, 8, 2, 3)]},
         {"upscale_factor": 2}, {"Out": 1}),
        ("nearest_interp", "nearest_interp", {"X": [f32(1, 2, 3, 4)]},
         {"out_h": 5, "out_w": 7}, {"Out": 1}),
        ("nearest_interp_v2_scale", "nearest_interp_v2",
         {"X": [f32(1, 2, 3, 4)]}, {"scale": [2.0, 1.5]}, {"Out": 1}),
        ("bilinear_interp", "bilinear_interp", {"X": [f32(1, 2, 4, 4)]},
         {"out_h": 6, "out_w": 5, "align_corners": True}, {"Out": 1}),
        ("bilinear_interp_v2", "bilinear_interp_v2",
         {"X": [f32(1, 2, 4, 4)]},
         {"out_h": 7, "out_w": 3, "align_corners": False, "align_mode": 0},
         {"Out": 1}),
        ("grid_sampler", "grid_sampler",
         {"X": [f32(2, 3, 4, 5)], "Grid": [f32(2, 3, 3, 2) * 1.2]},
         {"align_corners": False}, {"Output": 1}),
        ("grid_sampler_nearest_border", "grid_sampler",
         {"X": [f32(1, 2, 4, 4)], "Grid": [f32(1, 2, 2, 2) * 1.2]},
         {"mode": "nearest", "padding_mode": "border"}, {"Output": 1}),
        ("warpctc", "warpctc",
         {"Logits": [f32(2, 6, 4)], "Label": [np.int32([[1, 2], [3, 3]])],
          "LogitsLength": [np.int64([6, 5])],
          "LabelLength": [np.int64([2, 1])]},
         {"blank": 0, "norm_by_times": True}, {"Loss": 1}),
        ("linear_chain_crf", "linear_chain_crf",
         {"Emission": [f32(2, 5, 3)], "Transition": [f32(5, 3)],
          "Label": [i64(3, 2, 5)], "Length": [np.int64([5, 3])]}, {},
         {"LogLikelihood": 1}),
        ("crf_decoding", "crf_decoding",
         {"Emission": [f32(2, 5, 3)], "Transition": [f32(5, 3)],
          "Length": [np.int64([5, 2])]}, {}, {"ViterbiPath": 1}),
        ("im2sequence", "im2sequence", {"X": [f32(2, 2, 5, 5)]},
         {"kernels": [2, 3], "strides": [1, 2], "paddings": [1, 0, 0, 1]},
         {"Out": 1}),
        ("gru_unit", "gru_unit",
         {"Input": [f32(3, 12)], "HiddenPrev": [f32(3, 4)],
          "Weight": [f32(4, 12)], "Bias": [f32(1, 12)]}, {},
         {"Hidden": 1}),
        ("lstm_unit", "lstm_unit", {"X": [f32(3, 16)], "C_prev": [f32(3, 4)]},
         {"forget_bias": 0.5}, {"C": 1, "H": 1}),
        ("margin_rank_loss", "margin_rank_loss",
         {"Label": [np.float32([[1.0], [-1.0], [1.0]])], "X1": [f32(3, 1)],
          "X2": [f32(3, 1)]}, {"margin": 0.1}, {"Out": 1, "Activated": 1}),
        ("rank_loss", "rank_loss",
         {"Label": [boolean(3, 1).astype(np.float32)], "Left": [f32(3, 1)],
          "Right": [f32(3, 1)]}, {}, {"Out": 1}),
        ("hinge_loss", "hinge_loss",
         {"Logits": [f32(4, 1)], "Labels": [boolean(4, 1).astype(
             np.float32)]}, {}, {"Loss": 1}),
        ("skip_layernorm", "skip_layernorm",
         {"X": [f32(2, 3, 8)], "Y": [f32(2, 3, 8)], "Scale": [pos(8)],
          "Bias": [f32(8)]}, {"epsilon": 1e-5, "begin_norm_axis": 2},
         {"Out": 1}),
        ("fused_fc_elementwise_layernorm", "fused_fc_elementwise_layernorm",
         {"X": [f32(2, 3, 4)], "W": [f32(4, 8)], "Y": [f32(2, 3, 8)],
          "Bias0": [f32(8)], "Scale": [pos(8)], "Bias1": [f32(8)]},
         {"in_num_col_dims": 2, "begin_norm_axis": 2}, {"Out": 1}),
        ("fused_embedding_eltwise_layernorm",
         "fused_embedding_eltwise_layernorm",
         {"Ids": [i64(9, 2, 4), i64(5, 2, 4)],
          "Embs": [f32(9, 8), f32(5, 8)], "Scale": [pos(8)],
          "Bias": [f32(8)]}, {"epsilon": 1e-5}, {"Out": 1}),
        ("fused_sdpa_mask", "fused_sdpa",
         {"Q": [f32(2, 2, 5, 4)], "K": [f32(2, 2, 5, 4)],
          "V": [f32(2, 2, 5, 4)],
          "Mask": [np.where(np.arange(5)[None, None, None, :] <
                            np.array([5, 3])[:, None, None, None], 0.0,
                            -10000.0).astype(np.float32)]},
         {"scale": 0.5}, {"Out": 1}),
        ("fused_sdpa_3d", "fused_sdpa",
         {"Q": [f32(4, 5, 4)], "K": [f32(4, 6, 4)], "V": [f32(4, 6, 4)]},
         {"scale": 0.4}, {"Out": 1}),
        ("multihead_matmul_w", "multihead_matmul",
         {"Input": [f32(2, 5, 8)], "W": [f32(8, 3, 2, 4)],
          "Bias": [f32(3, 2, 4)],
          "BiasQK": [np.zeros((2, 1, 1, 5), np.float32)]},
         {"head_number": 2}, {"Out": 1}),
        ("multihead_matmul_qkv", "multihead_matmul",
         {"Input": [f32(2, 5, 24)]}, {"head_number": 4, "alpha": 0.3},
         {"Out": 1}),
        # the optimizer rules
        ("sgd", "sgd", _opt_inputs({}), {}, {"ParamOut": 1}),
        ("momentum_nesterov", "momentum",
         _opt_inputs({"Velocity": [f32(4, 3)]}),
         {"mu": 0.8, "use_nesterov": True},
         {"ParamOut": 1, "VelocityOut": 1}),
        ("adam", "adam", _opt_inputs({
            "Moment1": [f32(4, 3)], "Moment2": [pos(4, 3)],
            "Beta1Pow": [np.float32([0.81])],
            "Beta2Pow": [np.float32([0.998])]}),
         {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
         {"ParamOut": 1, "Moment1Out": 1, "Moment2Out": 1,
          "Beta1PowOut": 1, "Beta2PowOut": 1}),
        ("lamb", "lamb", _opt_inputs({
            "Moment1": [f32(4, 3)], "Moment2": [pos(4, 3)],
            "Beta1Pow": [np.float32([0.9])],
            "Beta2Pow": [np.float32([0.999])]}),
         {"weight_decay": 0.02},
         {"ParamOut": 1, "Moment1Out": 1, "Moment2Out": 1,
          "Beta1PowOut": 1, "Beta2PowOut": 1}),
        ("adagrad", "adagrad", _opt_inputs({"Moment": [pos(4, 3)]}), {},
         {"ParamOut": 1, "MomentOut": 1}),
        ("rmsprop", "rmsprop", _opt_inputs({"MeanSquare": [pos(4, 3)],
                                            "Moment": [f32(4, 3)]}),
         {"decay": 0.9, "momentum": 0.5},
         {"ParamOut": 1, "MeanSquareOut": 1, "MomentOut": 1}),
        ("adadelta", "adadelta",
         _opt_inputs({"AvgSquaredGrad": [pos(4, 3)],
                      "AvgSquaredUpdate": [pos(4, 3)]}), {},
         {"ParamOut": 1, "AvgSquaredGradOut": 1,
          "AvgSquaredUpdateOut": 1}),
        ("adamax", "adamax", _opt_inputs({
            "Moment": [f32(4, 3)], "InfNorm": [pos(4, 3)],
            "Beta1Pow": [np.float32([0.81])]}), {},
         {"ParamOut": 1, "MomentOut": 1, "InfNormOut": 1,
          "Beta1PowOut": 1}),
        ("ftrl", "ftrl", _opt_inputs({"SquaredAccumulator": [pos(4, 3)],
                                      "LinearAccumulator": [f32(4, 3)]}),
         {"l1": 0.1, "l2": 0.2},
         {"ParamOut": 1, "SquaredAccumOut": 1, "LinearAccumOut": 1}),
    ]
    for name in ("less_than", "less_equal", "greater_than", "greater_equal",
                 "equal", "not_equal"):
        a = i64(3, 3, 4).astype(np.float32)
        s.append((name, name, {"X": [a], "Y": [i64(3, 3, 4).astype(
            np.float32)]}, {}, {"Out": 1}))
    for name in ("logical_and", "logical_or", "logical_xor"):
        s.append((name, name, {"X": [boolean(3, 4)], "Y": [boolean(3, 4)]},
                  {}, {"Out": 1}))
    s.append(("logical_not", "logical_not", {"X": [boolean(3, 4)]}, {},
              {"Out": 1}))
    return s


SPECS = _specs()
X64_INTERP = {"bilinear_interp", "bilinear_interp_v2"}


@pytest.mark.parametrize("spec", SPECS, ids=[s[0] for s in SPECS])
def test_lowering_matches_the_jax_executor(spec):
    _, op_type, inputs, attrs, outputs = spec
    jf, tf = fluids()
    jprog, feed, fetch = op_program(jf, op_type, inputs, attrs, outputs)
    tprog, _, _ = op_program(tf, op_type, inputs, attrs, outputs)
    assert port_program_bytes(tprog) == jax_program_bytes(jprog)
    (want, got), = run_pair(jprog, tprog, feed, fetch, jf.Scope(),
                            tf.Scope())
    for name, g, w in zip(fetch, got, want):
        if op_type in X64_INTERP:
            # the JAX interpolate returns float64 for a float32 input
            # under x64; the port keeps the input's type
            assert np.asarray(g).dtype == np.float32
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype, name
        assert_close(g, w, what=name)


def test_every_lowering_of_the_jax_lowering_module_is_ported():
    """Each op type the JAX `fluid/lowering.py` registers has a lowering
    here (LoD-only and jit-artifact ones raise with their sub-item), and
    the fused inference targets the passes form are lowered too."""
    import paddle_tpu.fluid.lowering as JL
    import paddle_tpu_torch.fluid.lowering as TL

    base = {k for k, fn in JL._REGISTRY.items()
            if fn.__module__ == "paddle_tpu.fluid.lowering"}
    assert len(base) >= 215
    missing = sorted(k for k in base if not TL.has_lowering(k))
    assert not missing, missing
    for k in ("fused_sdpa", "multihead_matmul", "skip_layernorm",
              "fused_fc_elementwise_layernorm",
              "fused_embedding_eltwise_layernorm"):
        assert TL.has_lowering(k)
    tested = {s[1] for s in SPECS}
    elsewhere = {"jax_autodiff", "while", "conditional_block", "recurrent",
                 "write_to_array", "read_from_array", "lod_array_length",
                 "tensor_array_to_tensor", "dropout", "uniform_random",
                 "gaussian_random", "truncated_gaussian_random",
                 "jax_exported", "lod_reset", "seq_pool_placeholder",
                 "quantized_matmul", "quantized_depthwise_conv2d", "reshape",
                 "transpose", "squeeze", "unsqueeze", "flatten",
                 "cross_entropy2", "elementwise_add", "range", "linspace"}
    untested = sorted(base - tested - elsewhere)
    assert not untested, untested


def test_range_and_linspace_take_host_bounds():
    """The JAX lowerings read their bounds on the host, which its jit
    cannot do for feeds (they fail there); the port's Executor runs op by
    op, so the bounds are concrete: numpy's values, in float32."""
    jf, tf = fluids()
    exe = tf.Executor(tf.CPUPlace())
    prog, feed, fetch = op_program(
        tf, "range", {"Start": [np.float32([1.0])], "End": [np.float32([4.0])],
                      "Step": [np.float32([0.5])]}, {}, {"Out": 1})
    got, = exe.run(prog, feed, fetch)
    np.testing.assert_array_equal(got, np.arange(1.0, 4.0, 0.5, np.float32))
    prog, feed, fetch = op_program(
        tf, "linspace", {"Start": [np.float32([0.0])],
                         "Stop": [np.float32([1.0])],
                         "Num": [np.int32([5])]}, {}, {"Out": 1})
    got, = exe.run(prog, feed, fetch)
    np.testing.assert_array_equal(got, np.linspace(0, 1, 5, dtype=np.float32))


def _lenet_pair(optimizer="adam"):
    jf, tf = fluids()
    jm, js, jl = lenet(jf, optimizer)
    tm, ts, tl = lenet(tf, optimizer)
    jscope = jf.Scope()
    jf.Executor().run(js, scope=jscope)
    tscope = carry(jscope, tf.Scope())
    return (jm, jl, jscope), (tm, tl, tscope)


def _mnist_batch(seed, b=16):
    rs = np.random.RandomState(seed)
    return {"img": rs.randn(b, 1, 28, 28).astype(np.float32),
            "lbl": rs.randint(0, 10, (b, 1)).astype(np.int64)}


@pytest.mark.parametrize("optimizer", ["adam", "momentum"])
def test_static_lenet_three_steps_match_the_jax_executor(optimizer):
    """bench.py's static LeNet: same weights (carried), same batches, 3
    steps: losses and every parameter and slot within 1e-5 relative
    L2."""
    (jm, jl, jscope), (tm, tl, tscope) = _lenet_pair(optimizer)
    feed = _mnist_batch(0)
    for step, (a, b) in enumerate(run_pair(jm, tm, feed, [jl.name],
                                           jscope, tscope, steps=3)):
        assert rel_l2(b[0], a[0]) <= 1e-5, (step, a, b)
    for n, v in jscope._values.items():
        assert rel_l2(tscope._values[n].numpy(), np.asarray(v)) <= 1e-5, n


def test_run_n_equals_n_runs_and_the_plan_skips_the_recomputed_forward():
    jf, tf = fluids()
    tm, ts, tl = lenet(tf)
    feed = _mnist_batch(1, 8)
    scopes = []
    for _ in range(2):
        scope = tf.Scope()
        exe = tf.Executor(tf.CPUPlace())
        exe.run(ts, scope=scope)
        scopes.append((exe, scope))
    for n in list(scopes[1][1]._values):
        scopes[1][1]._values[n] = scopes[0][1]._values[n].clone()
    (e0, s0), (e1, s1) = scopes
    want = [e0.run(tm, feed, [tl], scope=s0)[0] for _ in range(3)][-1]
    got = e1.run_n(tm, feed, [tl], n=3, scope=s1)[0]
    assert np.array_equal(got, want)
    for n in s0._values:
        assert torch.equal(s0._values[n], s1._values[n]), n
    # the jax_autodiff op re-runs the forward: the first pass runs only
    # the autodiff op and the updates
    types = [op.type for op in tm.global_block().ops]
    assert e0.last_ops_run == len(types) - types.index("jax_autodiff")


def test_persistables_update_in_place_in_the_scope():
    jf, tf = fluids()
    tm, ts, tl = lenet(tf, "sgd")
    scope = tf.Scope()
    exe = tf.Executor(tf.CPUPlace())
    exe.run(ts, scope=scope)
    held = {n: t for n, t in scope._values.items()}
    before = {n: t.clone() for n, t in held.items()}
    exe.run(tm, _mnist_batch(2, 4), [tl], scope=scope)
    for n, t in held.items():
        assert scope._values[n] is t, n
    assert not torch.equal(held["fc_2.w_0"], before["fc_2.w_0"])


def _dropout_program(fluid, p=0.4, impl="upscale_in_train"):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [6], dtype="float32")
        w = fluid.layers.create_parameter(
            [6], "float32", name="w",
            default_initializer=fluid.initializer.Constant(1.5))
        h = fluid.layers.dropout(fluid.layers.elementwise_mul(x, w), p,
                                 dropout_implementation=impl)
        loss = fluid.layers.reduce_sum(h)
        grads = fluid.backward.append_backward(loss)
    return main, startup, h, loss, grads


def test_autodiff_rerun_draws_the_forward_pass_dropout_mask():
    """loss = sum(dropout(x * w)): d loss / d w = sum over rows of
    keep * x / (1 - p), with the SAME keep mask the fetched forward
    shows — the re-run draws by (run seed, op uid), not by a running
    generator state. Two runs draw different masks."""
    jf, tf = fluids()
    main, startup, h, loss, grads = _dropout_program(tf)
    scope = tf.Scope()
    exe = tf.Executor(tf.CPUPlace())
    exe.run(startup, scope=scope)
    x = np.random.RandomState(3).uniform(0.5, 1.5, (64, 6)).astype(
        np.float32)
    masks = []
    for _ in range(2):
        hv, g = exe.run(main, {"x": x}, [h, grads[0][1]], scope=scope)
        keep = hv != 0
        np.testing.assert_allclose(hv[keep], (x * 1.5 / 0.6)[keep],
                                   rtol=1e-6)
        np.testing.assert_allclose(g, (keep * x / 0.6).sum(0), rtol=1e-5)
        masks.append(keep)
        assert 0.4 < keep.mean() < 0.8
    assert (masks[0] != masks[1]).any()


def test_random_ops_draw_per_program_seed_and_respect_ranges():
    jf, tf = fluids()
    main = tf.Program()
    blk = main.global_block()
    outs = []
    for t, attrs in (("uniform_random", {"min": -2.0, "max": 3.0}),
                     ("gaussian_random", {"mean": 1.0, "std": 2.0}),
                     ("truncated_gaussian_random", {"mean": 0.0,
                                                    "std": 1.0})):
        o = blk.create_var(name=t + "_out")
        blk.append_op(type=t, outputs={"Out": [o]},
                      attrs={"shape": [4000], "dtype": "float32", **attrs})
        outs.append(o.name)
    main.random_seed = 7
    exe = tf.Executor(tf.CPUPlace())
    u, g, tg = exe.run(main, fetch_list=outs)
    assert u.dtype == np.float32 and u.min() >= -2.0 and u.max() < 3.0
    assert abs(u.mean() - 0.5) < 0.1
    assert abs(g.mean() - 1.0) < 0.15 and abs(g.std() - 2.0) < 0.15
    assert tg.min() >= -2.0 and tg.max() <= 2.0
    u2 = exe.run(main, fetch_list=outs)[0]
    assert not np.array_equal(u, u2)           # the counter moved
    again = main.clone()
    again._seed_counter = 0
    again.random_seed = 7
    assert np.array_equal(exe.run(again, fetch_list=outs)[0], u)


def _sparse_program(fluid, opt):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data("ids", [3], dtype="int64")
        y = fluid.layers.data("y", [1], dtype="float32")
        emb = fluid.layers.embedding(ids, [20, 4], is_sparse=True,
                                     param_attr="table")
        pred = fluid.layers.fc(fluid.layers.reduce_sum(emb, dim=[1]), 1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        opt(fluid).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("opt", [
    lambda f: f.optimizer.SGD(0.5),
    lambda f: f.optimizer.Momentum(0.3, 0.9, use_nesterov=True),
    lambda f: f.optimizer.Adam(0.05)], ids=["sgd", "momentum", "adam"])
def test_sparse_lookup_rows_gradient_matches_the_jax_rows_form(opt):
    jf, tf = fluids()
    jm, js, jl = _sparse_program(jf, opt)
    tm, ts, tl = _sparse_program(tf, opt)
    assert port_program_bytes(tm) == jax_program_bytes(jm)
    jscope = jf.Scope()
    jf.Executor().run(js, scope=jscope)
    tscope = carry(jscope, tf.Scope())
    init_table = np.asarray(jscope._values["table"]).copy()
    rs = np.random.RandomState(5)
    feed = {"ids": rs.randint(0, 8, (6, 3)).astype(np.int64),
            "y": rs.randn(6, 1).astype(np.float32)}
    for a, b in run_pair(jm, tm, feed, [jl.name], jscope, tscope, steps=3):
        assert rel_l2(b[0], a[0]) <= 1e-5
    for n, v in jscope._values.items():
        assert rel_l2(tscope._values[n].numpy(), np.asarray(v)) <= 1e-5, n
    # rows no id touched never moved
    assert np.array_equal(tscope._values["table"].numpy()[8:],
                          init_table[8:])


def test_calc_gradient_with_seeded_cotangent_matches_jax():
    jf, tf = fluids()

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [3], dtype="float32",
                                  stop_gradient=False)
            h = fluid.layers.fc(x, 4, act="tanh")
            seed = fluid.layers.data("seed", [4], dtype="float32")
            gx, = fluid.backward.gradients([h], [x], [seed])
        return main, startup, gx

    jm, js, jg = build(jf)
    tm, ts, tg = build(tf)
    jscope = jf.Scope()
    jf.Executor().run(js, scope=jscope)
    tscope = carry(jscope, tf.Scope())
    rs = np.random.RandomState(6)
    feed = {"x": rs.randn(5, 3).astype(np.float32),
            "seed": rs.randn(5, 4).astype(np.float32)}
    (a, b), = run_pair(jm, tm, feed, [jg.name], jscope, tscope)
    assert_close(b[0], a[0])


def _flow_programs(fluid):
    """While, cond and StaticRNN programs, built with the JAX layers."""
    L = fluid.layers
    progs = []
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data("x", [3], dtype="float32")
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 3)
        acc = L.assign(x)
        cond = L.less_than(i, n)
        loop = L.While(cond)
        with loop.block():
            L.assign(L.scale(acc, 2.0, 0.5), acc)
            L.increment(i, 1.0, in_place=True)
            L.less_than(i, n, cond=cond)
        progs.append((main, [acc.name, i.name]))
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = L.data("x", [3], dtype="float32")
        s = L.reduce_sum(x)
        zero = L.fill_constant([1], "float32", 0.0)
        out = L.cond(L.greater_than(s, zero), lambda: L.scale(x, 3.0),
                     lambda: L.scale(x, -1.0))
        progs.append((main, [out.name]))
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        xs = L.data("xs", [4, 2, 3], dtype="float32",
                    append_batch_size=False)
        rnn = L.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(xs)
            h = rnn.memory(shape=[-1, 3], batch_ref=xt, init_value=0.0,
                           ref_batch_dim_idx=0)
            nh = L.tanh(L.elementwise_add(L.scale(h, 0.5), xt))
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        progs.append((main, [rnn().name]))
    return progs


@pytest.mark.parametrize("which", [0, 1, 2], ids=["while", "cond",
                                                  "static_rnn"])
def test_control_flow_lowerings_run_jax_built_programs(which):
    """The control-flow builders wait for item 8b; their lowerings run
    the programs the JAX layers build, read from the wire."""
    from paddle_tpu_torch.core import program_pb as TP

    jf, tf = fluids()
    jprog, fetch = _flow_programs(jf)[which]
    tprog = TP.proto_to_program(TP.ProgramDesc.FromString(
        jax_program_bytes(jprog)))
    rs = np.random.RandomState(which)
    feeds = ({"x": rs.randn(2, 3).astype(np.float32)},
             {"x": rs.randn(2, 3).astype(np.float32)},
             {"xs": rs.randn(4, 2, 3).astype(np.float32)})[which]
    for sign in (1.0, -1.0):
        feed = {k: v * sign for k, v in feeds.items()}
        (want, got), = run_pair(jprog, tprog, feed, fetch, jf.Scope(),
                                tf.Scope())
        for g, w in zip(got, want):
            assert_close(g, w)


def test_ernie_passes_rewrite_as_the_jax_passes_do():
    """Each inference pass over static ERNIE (tiny) leaves the same
    program in both packages (wire bytes equal)."""
    from paddle_tpu.fluid.ir import apply_pass as japply
    from paddle_tpu_torch.fluid.ir import apply_pass as tapply
    from paddle_tpu_torch.inference import INFERENCE_PASSES

    jf, tf = fluids()
    cfg = dict(vocab=64, hidden=16, layers=2, heads=2, ffn=32, max_pos=16,
               type_vocab=2, seq=8)
    jm, _, _, jouts = static_ernie(jf, **cfg)
    tm, _, _, touts = static_ernie(tf, **cfg)
    jp, tp = (m._prune(o).clone(for_test=True)
              for m, o in ((jm, jouts), (tm, touts)))
    for name in INFERENCE_PASSES:
        japply(jp, name)
        tapply(tp, name)
        assert port_program_bytes(tp) == jax_program_bytes(jp), name
    types = [op.type for op in tp.global_block().ops]
    assert types.count("fused_sdpa") == 2 and "softmax" not in types
    assert "fused_embedding_eltwise_layernorm" in types


def test_conv_bn_fold_passes_mutate_the_scope_like_jax():
    from paddle_tpu.fluid.ir import apply_pass as japply
    from paddle_tpu_torch.fluid.ir import apply_pass as tapply

    jf, tf = fluids()

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [3, 6, 6], dtype="float32")
            c = fluid.layers.conv2d(x, 4, 3, padding=1, bias_attr=False)
            y = fluid.layers.batch_norm(c, is_test=True)
        return main, startup, y

    jm, js, jy = build(jf)
    tm, ts, ty = build(tf)
    jscope = jf.Scope()
    jf.Executor().run(js, scope=jscope)
    rs = np.random.RandomState(4)
    for n in list(jscope._values):
        if "batch_norm" in n:
            jscope._values[n] = np.abs(rs.randn(
                *np.asarray(jscope._values[n]).shape)).astype(np.float32)
    import jax.numpy as jnp

    jscope._values = {n: jnp.asarray(v) for n, v in jscope._values.items()}
    tscope = carry(jscope, tf.Scope())
    feed = {"x": rs.randn(2, 3, 6, 6).astype(np.float32)}
    (want0, got0), = run_pair(jm, tm, feed, [jy.name], jscope, tscope)
    japply(jm, "conv_bn_fuse_pass", scope=jscope)
    tapply(tm, "conv_bn_fuse_pass", scope=tscope)
    assert port_program_bytes(tm) == jax_program_bytes(jm)
    (want, got), = run_pair(jm, tm, feed, [jy.name], jscope, tscope)
    assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    assert_close(got[0], got0[0], rtol=1e-4, atol=1e-4)


def test_executor_runs_on_the_card_unless_given_the_cpu():
    jf, tf = fluids()
    assert tf.Executor(tf.CPUPlace()).device.type == "cpu"
    if no_cuda():
        for make in (lambda: tf.Executor(), lambda: tf.Executor(
                tf.CUDAPlace(0)), lambda: tf.Executor(tf.TPUPlace(0))):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
    else:
        assert tf.Executor().device.type == "cuda"


def test_unported_ops_and_lod_feeds_raise_naming_their_item():
    from paddle_tpu_torch.core.lod import LoDTensor

    jf, tf = fluids()
    prog, feed, fetch = op_program(tf, "sequence_pool",
                                   {"X": [f32(4, 3)]}, {}, {"Out": 1})
    exe = tf.Executor(tf.CPUPlace())
    with pytest.raises(NotImplementedError,
                       match="'sequence_pool'.*ROADMAP item 8b"):
        exe.run(prog, feed, fetch)
    for t, item in (("jax_exported", "8d"), ("lod_reset", "8b")):
        prog, feed, fetch = op_program(tf, t, {"X": [f32(2, 2)]}, {},
                                       {"Out": 1})
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            exe.run(prog, feed, fetch)
    prog, feed, fetch = op_program(tf, "relu", {"X": [f32(4, 3)]}, {},
                                   {"Out": 1})
    lod = LoDTensor(f32(4, 3), lod=[[0, 1, 4]])
    with pytest.raises(NotImplementedError, match="item 8b"):
        exe.run(prog, {"in_X_0": lod}, fetch)
    L = tf.layers
    for build in (lambda: L.While(None), lambda: L.sequence_pool(None, "sum"),
                  lambda: L.detection.multiclass_nms(None, None),
                  lambda: L.StaticRNN(), lambda: tf.nets.attention_lstm(
                      None, 4),
                  lambda: tf.optimizer.PipelineOptimizer(None),
                  lambda: tf.io.DataLoader.from_generator(),
                  lambda: tf.DistributeTranspiler()):
        with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
            build()


def test_enable_static_switches_the_mode_as_jax():
    import paddle_tpu as jp
    import paddle_tpu_torch as tp

    try:
        for m in (jp, tp):
            m.enable_static()
            assert not m.in_dynamic_mode()
        for m in (jp, tp):
            m.disable_static()
            assert m.in_dynamic_mode()
        assert tp.in_dygraph_mode()
    finally:
        jp.disable_static()
        tp.disable_static()


def test_compiled_program_runs_and_refuses_more_than_one_rank():
    jf, tf = fluids()
    tm, ts, tl = lenet(tf, "sgd")
    scope = tf.Scope()
    exe = tf.Executor(tf.CPUPlace())
    exe.run(ts, scope=scope)
    cp = tf.CompiledProgram(tm).with_data_parallel(loss_name=tl.name)
    loss = exe.run(cp, _mnist_batch(3, 4), [tl], scope=scope)[0]
    assert np.isfinite(loss)
    with pytest.raises(NotImplementedError, match="item 8c"):
        tf.CompiledProgram(tm).with_data_parallel(places=[0, 1])
