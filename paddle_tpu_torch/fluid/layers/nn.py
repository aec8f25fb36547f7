"""Static NN layers: fc, conv2d, pool2d, batch_norm, embedding...

Reference parity: python/paddle/fluid/layers/nn.py (15.2k LoC of op sugar).
Each function appends ops to the current main program and init ops to the
startup program via LayerHelper, with build-time shape propagation.
"""
from __future__ import annotations

import numpy as np

from ..dtypes import convert_dtype, dtype_name
from .. import initializer as init
from ..framework import Variable
from ..layer_helper import LayerHelper, ParamAttr


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def _conv_out(hw, k, s, p, d=1):
    if hw in (-1, None):
        return -1
    return (hw + 2 * p - (d * (k - 1) + 1)) // s + 1


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    helper = LayerHelper("fc", name=name)
    in_shape = input.shape
    in_features = int(np.prod(in_shape[num_flatten_dims:]))
    w = helper.create_parameter(param_attr, [in_features, size], input.dtype)
    out_shape = list(in_shape[:num_flatten_dims]) + [size]
    out = helper.create_variable_for_type_inference(input.dtype, out_shape)
    helper.append_op(type="mul", inputs={"X": [input], "Y": [w]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": num_flatten_dims,
                            "y_num_col_dims": 1})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [size], input.dtype,
                                    is_bias=True)
        out = helper.append_bias_op(out, b, num_flatten_dims)
    return helper.append_activation(out, act)


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    xs = list(x.shape)
    ys = list(y.shape)
    if transpose_x and len(xs) >= 2:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if transpose_y and len(ys) >= 2:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    out_shape = xs[:-1] + ys[-1:]
    out = helper.create_variable_for_type_inference(x.dtype, out_shape)
    helper.append_op(type="matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y, "alpha": alpha})
    return out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    helper = LayerHelper("conv2d", name=name)
    k = _pair(filter_size)
    s = _pair(stride)
    p = _pair(padding)
    d = _pair(dilation)
    c_in = input.shape[1]
    filter_shape = [num_filters, c_in // groups, k[0], k[1]]
    fan_in = (c_in // groups) * k[0] * k[1]
    std = (2.0 / fan_in) ** 0.5
    w = helper.create_parameter(param_attr, filter_shape, input.dtype,
                                default_initializer=init.Normal(0.0, std))
    n, _, h, wd = input.shape
    out_shape = [n, num_filters, _conv_out(h, k[0], s[0], p[0], d[0]),
                 _conv_out(wd, k[1], s[1], p[1], d[1])]
    out = helper.create_variable_for_type_inference(input.dtype, out_shape)
    helper.append_op(type="conv2d",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": s, "paddings": p, "dilations": d,
                            "groups": groups})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                    is_bias=True)
        out = helper.append_bias_op(out, b, 1)
    return helper.append_activation(out, act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None, data_format="NCHW"):
    helper = LayerHelper("pool2d", name=name)
    k = _pair(pool_size)
    s = _pair(pool_stride)
    p = _pair(pool_padding)
    n, c, h, w = input.shape
    if global_pooling:
        out_shape = [n, c, 1, 1]
    else:
        out_shape = [n, c, _conv_out(h, k[0], s[0], p[0]),
                     _conv_out(w, k[1], s[1], p[1])]
    out = helper.create_variable_for_type_inference(input.dtype, out_shape)
    helper.append_op(type="pool2d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type, "ksize": k,
                            "strides": s, "paddings": p,
                            "global_pooling": global_pooling,
                            "ceil_mode": ceil_mode, "exclusive": exclusive})
    return out


def adaptive_pool2d(input, pool_size, pool_type="max", name=None):
    helper = LayerHelper("pool2d", name=name)
    k = _pair(pool_size)
    n, c = input.shape[0], input.shape[1]
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    [n, c, k[0], k[1]])
    helper.append_op(type="pool2d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type, "ksize": k,
                            "adaptive": True})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None, do_model_average_for_mean_and_var=
               True, use_global_stats=False):
    helper = LayerHelper("batch_norm", name=name)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(param_attr, [c], input.dtype,
                                    default_initializer=init.Constant(1.0))
    bias = helper.create_parameter(bias_attr, [c], input.dtype, is_bias=True)
    # moving stats: persistable, init in startup
    sblock = helper.startup_program.global_block()
    mean = helper.create_global_variable([c], input.dtype,
                                         name=moving_mean_name)
    var = helper.create_global_variable([c], input.dtype,
                                        name=moving_variance_name)
    for v, value in ((mean, 0.0), (var, 1.0)):
        sv = sblock.create_var(name=v.name, shape=[c], dtype=input.dtype,
                               persistable=True)
        init.Constant(value)(sv, sblock)
    saved_mean = helper.create_variable_for_type_inference(input.dtype, [c])
    saved_var = helper.create_variable_for_type_inference(input.dtype, [c])
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [var]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [var],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "data_layout": data_layout, "is_test": is_test,
               "use_global_stats": use_global_stats})
    return helper.append_activation(out, act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", name=name)
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(param_attr, norm_shape, input.dtype,
                                    default_initializer=init.Constant(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(bias_attr, norm_shape, input.dtype,
                                    is_bias=True)
        inputs["Bias"] = [b]
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op(type="layer_norm", inputs=inputs,
                     outputs={"Y": [out]},
                     attrs={"begin_norm_axis": begin_norm_axis,
                            "epsilon": epsilon})
    return helper.append_activation(out, act)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout")
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="dropout", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "dropout_implementation":
                            dropout_implementation})
    return out


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    helper = LayerHelper("embedding")
    w = helper.create_parameter(param_attr, size, dtype,
                                default_initializer=init.Xavier())
    out_shape = list(input.shape)
    if out_shape and out_shape[-1] == 1:
        out_shape = out_shape[:-1]
    out_shape = out_shape + [size[1]]
    out = helper.create_variable_for_type_inference(convert_dtype(dtype),
                                                    out_shape)
    helper.append_op(type="lookup_table",
                     inputs={"Ids": [input], "W": [w]},
                     outputs={"Out": [out]},
                     attrs={"is_sparse": is_sparse,
                            "padding_idx": padding_idx if padding_idx
                            is not None else -1})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy")
    loss_shape = list(logits.shape)
    loss_shape[axis] = 1
    loss = helper.create_variable_for_type_inference(logits.dtype,
                                                     loss_shape)
    softmax_out = helper.create_variable_for_type_inference(logits.dtype,
                                                            logits.shape)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Loss": [loss], "Softmax": [softmax_out]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index, "axis": axis})
    if return_softmax:
        return loss, softmax_out
    return loss


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    shape = list(input.shape[:-1]) + [1]
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    helper.append_op(type="cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op(type="square_error_cost",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out]}, attrs={})
    return out


def accuracy(input, label, k=1, correct=None, total=None):
    helper = LayerHelper("accuracy")
    acc = helper.create_variable_for_type_inference(np.float32, [1])
    correct = helper.create_variable_for_type_inference(np.int32, [1])
    total = helper.create_variable_for_type_inference(np.int32, [1])
    helper.append_op(type="accuracy",
                     inputs={"Out": [input], "Label": [label]},
                     outputs={"Accuracy": [acc], "Correct": [correct],
                              "Total": [total]},
                     attrs={"k": k})
    return acc


def topk(input, k=1, name=None):
    helper = LayerHelper("top_k")
    shape = list(input.shape[:-1]) + [k]
    values = helper.create_variable_for_type_inference(input.dtype, shape)
    indices = helper.create_variable_for_type_inference(np.int64, shape)
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    return values, indices


def conv2d_transpose(input, num_filters, filter_size=None, output_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    helper = LayerHelper("conv2d_transpose", name=name)
    k = _pair(filter_size if filter_size is not None else 4)
    s = _pair(stride)
    p = _pair(padding)
    d = _pair(dilation)
    c_in = input.shape[1]
    w = helper.create_parameter(
        param_attr, [c_in, num_filters // groups, k[0], k[1]], input.dtype)
    n, _, h, wd = input.shape

    def _base(sz, i):
        return (sz - 1) * s[i] - 2 * p[i] + d[i] * (k[i] - 1) + 1

    opad = [0, 0]
    if output_size is not None:
        osz = _pair(output_size)
        for i, sz in enumerate((h, wd)):
            if sz in (-1, None):
                continue
            opad[i] = int(osz[i]) - _base(sz, i)
            if not 0 <= opad[i] < s[i]:
                raise ValueError(
                    f"output_size[{i}]={osz[i]} unreachable from input "
                    f"{sz} with stride {s[i]} (valid range "
                    f"[{_base(sz, i)}, {_base(sz, i) + s[i] - 1}])")
    oh = _base(h, 0) + opad[0] if h not in (-1, None) else -1
    ow = _base(wd, 1) + opad[1] if wd not in (-1, None) else -1
    out = helper.create_variable_for_type_inference(
        input.dtype, [n, num_filters, oh, ow])
    helper.append_op(type="conv2d_transpose",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": s, "paddings": p,
                            "output_padding": opad,
                            "dilations": d,
                            "groups": groups})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                    is_bias=True)
        out = helper.append_bias_op(out, b, 1)
    return helper.append_activation(out, act)


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    shape = [(-1 if d in (-1, None) else d * t)
             for d, t in zip(x.shape, expand_times)]
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op(type="expand", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"expand_times": list(expand_times)})
    return out


def slice(input, axes, starts, ends, name=None):  # noqa: A001
    helper = LayerHelper("slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, None)
    helper.append_op(type="slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


def gather(input, index, overwrite=True, name=None):
    helper = LayerHelper("gather", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, None)
    helper.append_op(type="gather",
                     inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]}, attrs={})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, None)
    helper.append_op(type="pad", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"paddings": list(paddings),
                            "pad_value": float(pad_value)})
    return out


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      name=None, normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x], "Label": [label]},
                     outputs={"Out": [out]},
                     attrs={"ignore_index": ignore_index,
                            "normalize": normalize})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=1.0):
    helper = LayerHelper("smooth_l1_loss")
    diff = helper.create_variable_for_type_inference(x.dtype, x.shape)
    out = helper.create_variable_for_type_inference(
        x.dtype, [x.shape[0], 1])
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    helper.append_op(type="smooth_l1_loss", inputs=inputs,
                     outputs={"Out": [out], "Diff": [diff]},
                     attrs={"sigma": sigma})
    return out


def l2_normalize(x, axis=-1, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    n = helper.create_variable_for_type_inference(x.dtype, None)
    helper.append_op(type="norm", inputs={"X": [x]},
                     outputs={"Out": [out], "Norm": [n]},
                     attrs={"axis": axis, "epsilon": float(epsilon)})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(label.dtype,
                                                    label.shape)
    helper.append_op(type="label_smooth", inputs={"X": [label]},
                     outputs={"Out": [out]},
                     attrs={"epsilon": float(epsilon)})
    return out


def cumsum(x, axis=None, exclusive=False, reverse=False, name=None):
    helper = LayerHelper("cumsum", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="cumsum", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"axis": -1 if axis is None else axis,
                            "exclusive": exclusive, "reverse": reverse})
    return out


def reverse(x, axis, name=None):
    helper = LayerHelper("reverse", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="reverse", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"axis": axis if isinstance(axis, (list, tuple))
                            else [axis]})
    return out


def sign(x, name=None):
    helper = LayerHelper("sign", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="sign", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={})
    return out


def argmin(x, axis=0, name=None):
    helper = LayerHelper("arg_min", name=name)
    out = helper.create_variable_for_type_inference(np.int64, None)
    helper.append_op(type="arg_min", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"axis": axis, "keepdims": False})
    return out


def unstack(x, axis=0, num=None, name=None):
    """Composed: split along axis then squeeze it."""
    from .tensor import cast  # noqa: F401 (import keeps style parity)

    helper = LayerHelper("unstack", name=name)
    n = num if num is not None else x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype, None)
            for _ in range(n)]
    helper.append_op(type="split", inputs={"X": [x]},
                     outputs={"Out": outs},
                     attrs={"num": n, "axis": axis, "sections": None})
    squeezed = []
    for o in outs:
        so = helper.create_variable_for_type_inference(x.dtype, None)
        helper.append_op(type="squeeze", inputs={"X": [o]},
                        outputs={"Out": [so]}, attrs={"axes": [axis]})
        squeezed.append(so)
    return squeezed


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="clip_by_norm", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"max_norm": float(max_norm)})
    return out


def lod_reset(x, y=None, target_lod=None):
    """sequence lod override (lod_reset_op.h): re-attaches the lengths
    companion from y (another sequence var) or a literal lod."""
    helper = LayerHelper("lod_reset")
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    out.lod_level = 1
    inputs = {"X": [x]}
    if y is not None:
        inputs["Y"] = [y]
    helper.append_op(type="lod_reset", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"target_lod": list(target_lod or [])})
    return out


def warpctc(input, label, blank=0, norm_by_times=False,
            input_length=None, label_length=None):
    helper = LayerHelper("warpctc")
    loss = helper.create_variable_for_type_inference(
        np.float32, [input.shape[0] or -1, 1])
    inputs = {"Logits": [input], "Label": [label]}
    if input_length is not None:
        inputs["LogitsLength"] = [input_length]
    if label_length is not None:
        inputs["LabelLength"] = [label_length]
    helper.append_op(type="warpctc", inputs=inputs,
                     outputs={"Loss": [loss]},
                     attrs={"blank": blank,
                            "norm_by_times": norm_by_times})
    return loss


def linear_chain_crf(input, label, param_attr=None, length=None):
    """linear_chain_crf layer: creates the [num_tags+2, num_tags]
    transition parameter (fluid layout) and returns per-example
    log-likelihood (negated by callers as the loss)."""
    helper = LayerHelper("linear_chain_crf")
    num_tags = input.shape[-1]
    transition = helper.create_parameter(
        param_attr, [num_tags + 2, num_tags], input.dtype,
        default_initializer=init.Normal(0.0, 0.1))
    ll = helper.create_variable_for_type_inference(
        input.dtype, [input.shape[0] or -1, 1])
    inputs = {"Emission": [input], "Transition": [transition],
              "Label": [label]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(type="linear_chain_crf", inputs=inputs,
                     outputs={"LogLikelihood": [ll]}, attrs={})
    return ll


def crf_decoding(input, param_attr=None, label=None, length=None,
                 transition=None):
    helper = LayerHelper("crf_decoding")
    if transition is None:
        attr = ParamAttr._to_attr(param_attr)
        transition = helper.main_program.global_block().var(attr.name)
    path = helper.create_variable_for_type_inference(
        np.int64, list(input.shape[:-1]))
    path.lod_level = getattr(input, "lod_level", 0)
    inputs = {"Emission": [input], "Transition": [transition]}
    if label is not None:
        # fluid contract: with Label, the output is a 0/1 correctness
        # mask per position, not the path
        inputs["Label"] = [label]
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(type="crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [path]}, attrs={})
    return path


def im2sequence(input, filter_size=1, stride=1, padding=0,
                input_image_size=None, out_stride=1, name=None):
    if input_image_size is not None:
        raise NotImplementedError(
            "im2sequence with per-image input_image_size produces "
            "data-dependent sequence lengths (LoD, ROADMAP item 8b); pad "
            "images uniformly or mask downstream")
    helper = LayerHelper("im2sequence", name=name)
    k = _pair(filter_size)
    s = _pair(stride)
    p = padding if isinstance(padding, (list, tuple)) else [padding] * 4
    out = helper.create_variable_for_type_inference(input.dtype, None)
    helper.append_op(type="im2sequence", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"kernels": list(k), "strides": list(s),
                            "paddings": list(p)})
    return out


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", name=name)
    out = helper.create_variable_for_type_inference(left.dtype,
                                                    left.shape)
    act = helper.create_variable_for_type_inference(left.dtype,
                                                    left.shape)
    helper.append_op(type="margin_rank_loss",
                     inputs={"Label": [label], "X1": [left],
                             "X2": [right]},
                     outputs={"Out": [out], "Activated": [act]},
                     attrs={"margin": margin})
    return out


def rank_loss(label, left, right, name=None):
    helper = LayerHelper("rank_loss", name=name)
    out = helper.create_variable_for_type_inference(left.dtype,
                                                    left.shape)
    helper.append_op(type="rank_loss",
                     inputs={"Label": [label], "Left": [left],
                             "Right": [right]},
                     outputs={"Out": [out]}, attrs={})
    return out


def hinge_loss(input, label, name=None):
    helper = LayerHelper("hinge_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    input.shape)
    helper.append_op(type="hinge_loss",
                     inputs={"Logits": [input], "Labels": [label]},
                     outputs={"Loss": [out]}, attrs={})
    return out
