"""fluid.nets — composite-layer sugar (python/paddle/fluid/nets.py:1).

The four wrappers the reference book examples lean on: conv+pool image
stem, sequence conv+pool text stem, gated linear unit, and scaled
dot-product attention — all composed from the existing fluid layers so
every path lowers through the same registry.
"""
from __future__ import annotations

from . import layers

__all__ = ["simple_img_conv_pool", "sequence_conv_pool", "glu",
           "scaled_dot_product_attention", "img_conv_group",
           "attention_lstm"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1,
                         conv_padding=0, conv_dilation=1, conv_groups=1,
                         param_attr=None, bias_attr=None, act=None,
                         use_cudnn=True):
    """conv2d + pool2d (nets.py simple_img_conv_pool)."""
    conv_out = layers.conv2d(
        input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr,
        act=act)
    return layers.pool2d(
        conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size,
                   conv_padding=1, conv_filter_size=3, conv_act=None,
                   param_attr=None, conv_with_batchnorm=False,
                   conv_batchnorm_drop_rate=0.0, pool_stride=1,
                   pool_type="max", use_cudnn=True):
    """VGG-style conv block group + trailing pool
    (nets.py img_conv_group)."""
    tmp = input
    n = len(conv_num_filter) if isinstance(conv_num_filter,
                                           (list, tuple)) else 1
    filters = conv_num_filter if isinstance(conv_num_filter,
                                            (list, tuple)) \
        else [conv_num_filter]

    def _ith(v, i):
        return v[i] if isinstance(v, (list, tuple)) else v

    for i in range(n):
        with_bn = bool(_ith(conv_with_batchnorm, i))
        tmp = layers.conv2d(
            tmp, num_filters=filters[i],
            filter_size=_ith(conv_filter_size, i),
            padding=_ith(conv_padding, i),
            param_attr=_ith(param_attr, i),
            act=None if with_bn else _ith(conv_act, i))
        if with_bn:
            tmp = layers.batch_norm(tmp, act=_ith(conv_act, i))
            rate = _ith(conv_batchnorm_drop_rate, i)
            if rate:
                tmp = layers.dropout(tmp, dropout_prob=rate)
    return layers.pool2d(tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", bias_attr=None):
    """sequence_conv + sequence_pool (nets.py sequence_conv_pool) —
    the classic text-CNN stem."""
    conv_out = layers.sequence_conv(
        input, num_filters=num_filters, filter_size=filter_size,
        param_attr=param_attr, bias_attr=bias_attr, act=act)
    return layers.sequence_pool(conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    """Gated linear unit: split along `dim`, a * sigmoid(b)
    (nets.py glu)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention over [B, T, D] tensors
    (nets.py scaled_dot_product_attention). Composed from matmul/
    softmax so the multihead fuse pass can rewrite it to fused_sdpa."""
    if queries.shape[-1] != keys.shape[-1]:
        raise ValueError(
            f"queries hidden size {queries.shape[-1]} must equal keys "
            f"hidden size {keys.shape[-1]}")
    for name, t in (("queries", queries), ("keys", keys),
                    ("values", values)):
        if t.shape[-1] % num_heads != 0:
            raise ValueError(
                f"{name} hidden size {t.shape[-1]} is not divisible by "
                f"num_heads {num_heads}")
    d_key = queries.shape[-1] // num_heads
    d_val = values.shape[-1] // num_heads   # values may be wider

    def _split_heads(x):
        if num_heads == 1:
            return x
        # [B, T, D] -> [B, H, T, D/H], split by the tensor's OWN width
        r = layers.reshape(x, shape=[0, 0, num_heads,
                                     x.shape[-1] // num_heads])
        return layers.transpose(r, perm=[0, 2, 1, 3])

    q = _split_heads(queries)
    k = _split_heads(keys)
    v = _split_heads(values)
    scores = layers.matmul(q, k, transpose_y=True,
                           alpha=float(d_key) ** -0.5)
    weights = layers.softmax(scores)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    ctx = layers.matmul(weights, v)
    if num_heads == 1:
        return ctx
    ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
    return layers.reshape(ctx, shape=[0, 0, num_heads * d_val])


def attention_lstm(x, size, name="attn_lstm"):
    """Per-step attention LSTM in its UNFUSED DynamicRNN form — the
    program shape users of the reference wrote before
    attention_lstm_fuse_pass.cc rewrote it into the fused
    `attention_lstm` op (attention_lstm_op.cc semantics: at every step,
    scores over ALL tokens from token-fc + prev-cell-fc -> relu ->
    softmax; the attended sum feeds one LSTM step; gate order
    [forget, input, output, candidate]).

    x: dense [B, T, M] (full-length rows; ragged masking arrives with
    the fused op's LoD lens after `attention_lstm_fuse_pass` runs).
    Returns (hidden [B, T, size], cell [B, T, size]). Its DynamicRNN
    comes with ROADMAP item 8b, and it raises until then.
    """
    raise NotImplementedError(
        "fluid.nets.attention_lstm: its DynamicRNN comes with ROADMAP "
        "item 8b")
    from .framework import unique_name
    from .layer_helper import LayerHelper

    helper = LayerHelper(name)
    B_, T, M = x.shape[0], int(x.shape[1]), int(x.shape[2])
    D = int(size)

    def param(suffix, shape):
        return layers.create_parameter(
            shape, "float32",
            name=unique_name.generate(f"{name}_{suffix}"))

    aw_m = param("attn_w", [M, 1])
    ab = param("attn_b", [1])
    aw_d = param("cell_w", [D, 1])
    w_x = param("lstm_wx", [M, 4 * D])
    w_h = param("lstm_wh", [D, 4 * D])
    b = param("lstm_b", [4 * D])

    def app(t, ins, _outs=None, attrs=None, out_shape=None):
        # helper.block at CALL time: ops inside the DynamicRNN `with`
        # must land in the rnn sub-block, not the parent
        blk = helper.block
        ov = blk.create_var(
            name=unique_name.generate(f"{name}_t"), shape=out_shape,
            dtype="float32")
        blk.append_op(type=t, inputs=ins, outputs={"Out": [ov]},
                      attrs=attrs or {})
        return ov

    # precomputed token scores: atted[B, T] = x @ aw_m + ab (the fused
    # lowering hoists exactly this out of its scan too)
    mm = app("mul", {"X": [x], "Y": [aw_m]}, None,
             {"x_num_col_dims": 2}, out_shape=[B_, T, 1])
    mb = app("elementwise_add", {"X": [mm], "Y": [ab]}, None,
             {"axis": -1}, out_shape=[B_, T, 1])
    atted = app("reshape2", {"X": [mb]}, None, {"shape": [0, T]},
                out_shape=[B_, T])

    rnn = layers.DynamicRNN()
    with rnn.block():
        step = rnn.step_input(x)               # drives T; value unused
        xs = rnn.static_input(x)               # whole sequence per step
        h_pre = rnn.memory(shape=[D], value=0.0)
        c_pre = rnn.memory(shape=[D], value=0.0)
        cfc = app("mul", {"X": [c_pre], "Y": [aw_d]}, None,
                  {"x_num_col_dims": 1}, out_shape=[-1, 1])
        e_pre = app("elementwise_add", {"X": [atted], "Y": [cfc]}, None,
                    {"axis": -1}, out_shape=[-1, T])
        e = app("relu", {"X": [e_pre]}, None, out_shape=[-1, T])
        a = app("softmax", {"X": [e]}, None, {"axis": -1},
                out_shape=[-1, T])
        a_r = app("reshape2", {"X": [a]}, None, {"shape": [0, T, 1]},
                  out_shape=[-1, T, 1])
        ax = app("elementwise_mul", {"X": [xs], "Y": [a_r]}, None,
                 {"axis": -1}, out_shape=[-1, T, M])
        lstm_x = app("reduce_sum", {"X": [ax]}, None,
                     {"dim": [1], "keep_dim": False},
                     out_shape=[-1, M])
        g1 = app("mul", {"X": [lstm_x], "Y": [w_x]}, None,
                 {"x_num_col_dims": 1}, out_shape=[-1, 4 * D])
        g2 = app("mul", {"X": [h_pre], "Y": [w_h]}, None,
                 {"x_num_col_dims": 1}, out_shape=[-1, 4 * D])
        g12 = app("elementwise_add", {"X": [g1], "Y": [g2]}, None,
                  {"axis": -1}, out_shape=[-1, 4 * D])
        gates = app("elementwise_add", {"X": [g12], "Y": [b]}, None,
                    {"axis": -1}, out_shape=[-1, 4 * D])
        gs = []
        for gi in range(4):                     # [f, i, o, candidate]
            gs.append(app("slice", {"Input": [gates]}, None,
                          {"axes": [1], "starts": [gi * D],
                           "ends": [(gi + 1) * D]}, out_shape=[-1, D]))
        f = app("sigmoid", {"X": [gs[0]]}, None, out_shape=[-1, D])
        i = app("sigmoid", {"X": [gs[1]]}, None, out_shape=[-1, D])
        o = app("sigmoid", {"X": [gs[2]]}, None, out_shape=[-1, D])
        cand = app("tanh", {"X": [gs[3]]}, None, out_shape=[-1, D])
        fc_ = app("elementwise_mul", {"X": [f], "Y": [c_pre]}, None,
                  {"axis": -1}, out_shape=[-1, D])
        ic = app("elementwise_mul", {"X": [i], "Y": [cand]}, None,
                 {"axis": -1}, out_shape=[-1, D])
        c2 = app("elementwise_add", {"X": [fc_], "Y": [ic]}, None,
                 {"axis": -1}, out_shape=[-1, D])
        ct = app("tanh", {"X": [c2]}, None, out_shape=[-1, D])
        h2 = app("elementwise_mul", {"X": [ct], "Y": [o]}, None,
                 {"axis": -1}, out_shape=[-1, D])
        rnn.update_memory(h_pre, h2)
        rnn.update_memory(c_pre, c2)
        rnn.output(h2, c2)
    hidden, cell = rnn()
    return hidden, cell
