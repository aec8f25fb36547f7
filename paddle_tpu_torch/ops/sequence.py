"""Sequence (LoD) ops over the padded + lengths form (the JAX package's
`ops/sequence.py`).

Every op takes a dense padded tensor x [B, T, ...] and the row lengths
[B] (a tensor or anything `torch.as_tensor` reads) and computes with
masks, on x's device. `dynamic_lstm` and `dynamic_gru` are Python loops
over T of torch ops, in the fluid gate layouts (`lstm_kernel.h`,
`gru_kernel.h`), which are not the layouts of `nn/layer/rnn.py`. Past a
row's length both freeze the state and emit zeros.
"""
from __future__ import annotations

import torch

__all__ = ["seq_mask", "sequence_pool", "sequence_softmax",
           "sequence_expand_as", "sequence_conv", "sequence_reverse",
           "sequence_slice", "sequence_concat", "sequence_reshape",
           "sequence_enumerate", "sequence_pad", "sequence_unpad",
           "sequence_scatter", "dynamic_lstm", "dynamic_gru"]


def _lens(lengths, device):
    """[B] int64 lengths on `device`."""
    return torch.as_tensor(lengths, device=device).reshape(-1).long()


def _expand_mask(mask, x):
    """[B, T] mask broadcast over x [B, T, ...]'s trailing dims."""
    return mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - 2))


def seq_mask(lengths, maxlen, dtype=None):
    """[B] lengths -> [B, maxlen] validity mask (sequence_mask_op.cc), on
    the lengths' device."""
    lens = _lens(lengths, getattr(lengths, "device", None))
    m = torch.arange(maxlen, device=lens.device)[None, :] < lens[:, None]
    return m.to(dtype) if dtype is not None else m


def sequence_pool(x, lengths, pool_type="sum", pad_value=0.0):
    """sequence_pool_op.cc: SUM / AVERAGE / SQRT / MAX / MIN / LAST / FIRST
    over each row's valid prefix; empty rows give pad_value. Integer x
    divides in float32 and truncates back."""
    lens = _lens(lengths, x.device)
    mask = seq_mask(lens, x.shape[1])
    fmask = _expand_mask(mask, x).to(x.dtype)
    pt = pool_type.lower()
    div_dtype = x.dtype if x.is_floating_point() else torch.float32
    tail = (-1,) + (1,) * (x.dim() - 2)
    div = lens.clamp(min=1).reshape(tail).to(div_dtype)
    if pt == "sum":
        out = (x * fmask).sum(1)
    elif pt == "average":
        out = ((x * fmask).sum(1).to(div_dtype) / div).to(x.dtype)
    elif pt == "sqrt":
        out = ((x * fmask).sum(1).to(div_dtype) / div.sqrt()).to(x.dtype)
    elif pt in ("max", "min"):
        info = torch.finfo(x.dtype) if x.is_floating_point() else \
            torch.iinfo(x.dtype)
        fill = info.min if pt == "max" else info.max
        masked = torch.where(_expand_mask(mask, x), x,
                             torch.tensor(fill, dtype=x.dtype,
                                          device=x.device))
        out = masked.amax(1) if pt == "max" else masked.amin(1)
    elif pt == "last":
        idx = (lens - 1).clamp(min=0).reshape(
            (-1, 1) + (1,) * (x.dim() - 2))
        out = torch.gather(x, 1, idx.expand((-1, 1) + x.shape[2:]))[:, 0]
    elif pt == "first":
        out = x[:, 0]
    else:
        raise ValueError(f"unknown pool_type {pool_type!r}")
    empty = (lens == 0).reshape((-1,) + (1,) * (out.dim() - 1))
    return torch.where(empty, torch.tensor(pad_value, dtype=out.dtype,
                                           device=out.device), out)


def sequence_softmax(x, lengths):
    """Softmax within each row's valid prefix; padding -> 0
    (sequence_softmax_op.cc)."""
    mask = _expand_mask(seq_mask(_lens(lengths, x.device), x.shape[1]), x)
    neg = torch.tensor(torch.finfo(x.dtype).min, dtype=x.dtype,
                       device=x.device)
    z = torch.where(mask, x, neg)
    z = z - z.amax(1, keepdim=True)
    e = torch.exp(z) * mask.to(x.dtype)
    return e / e.sum(1, keepdim=True).clamp(min=1e-12)


def sequence_expand_as(x, y, y_lengths):
    """sequence_expand(_as)_op.h, static-shape case: x [B, D] (or [B, 1,
    D]) broadcast along y's padded time axis, masked by y's lengths."""
    if x.dim() >= 3 and x.shape[1] == 1:
        x = x[:, 0]
    T = y.shape[1]
    out = x[:, None].expand((x.shape[0], T) + tuple(x.shape[1:]))
    m = _expand_mask(seq_mask(_lens(y_lengths, x.device), T), out)
    return out * m.to(out.dtype)


def sequence_conv(x, lengths, filt, context_length, context_start=None,
                  bias=None):
    """sequence_conv_op: each step's context window [t + start, t + start
    + context_length), zeros outside the row's valid range, times filt
    [context_length * D, M] (im2col + gemm, math/context_project.h)."""
    if context_start is None:
        context_start = -(context_length - 1) // 2 if context_length % 2 \
            else -(context_length // 2)
    B, T, D = x.shape
    lens = _lens(lengths, x.device)
    t = torch.arange(T, device=x.device)
    cols = []
    for k in range(context_length):
        off = context_start + k
        pos = t + off
        valid = (pos >= 0)[None, :] & (pos[None, :] < lens[:, None])
        cols.append(torch.roll(x, -off, 1) * valid[:, :, None].to(x.dtype))
    out = torch.cat(cols, -1) @ filt
    if bias is not None:
        out = out + bias
    return out * (t[None, :] < lens[:, None])[:, :, None].to(out.dtype)


def sequence_reverse(x, lengths):
    """Reverse each row's valid prefix in place; padding stays put
    (sequence_reverse_op.h)."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    lens = _lens(lengths, x.device)[:, None]
    idx = torch.where(t < lens, lens - 1 - t, t)
    idx = idx.reshape(tuple(idx.shape) + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand((-1, -1) + tuple(x.shape[2:])))


def sequence_slice(x, lengths, offset, length):
    """sequence_slice_op.h: each row's [offset, offset + length), clamped
    to the row's valid range. Returns (out, new lengths int32)."""
    T = x.shape[1]
    rows = _lens(lengths, x.device)[:, None]
    off = torch.minimum(_lens(offset, x.device)[:, None].clamp(min=0), rows)
    ln = torch.minimum(_lens(length, x.device)[:, None].clamp(min=0),
                       rows - off)
    t = torch.arange(T, device=x.device)[None, :]
    src = (off + t).clamp(0, T - 1)
    src = src.reshape(tuple(src.shape) + (1,) * (x.dim() - 2))
    out = torch.gather(x, 1, src.expand((-1, -1) + tuple(x.shape[2:])))
    m = _expand_mask(t < ln, out).to(out.dtype)
    return out * m, ln[:, 0].int()


def sequence_concat(xs, lens_list):
    """sequence_concat_op.h: row b of the output is x1[b, :l1] ++ x2[b,
    :l2] ++ ...; the output's T is the sum of the inputs'. Returns (out,
    lengths int32)."""
    B, dev = xs[0].shape[0], xs[0].device
    T_out = sum(x.shape[1] for x in xs)
    out = torch.zeros((B, T_out) + tuple(xs[0].shape[2:]),
                      dtype=xs[0].dtype, device=dev)
    out_lens = torch.zeros(B, dtype=torch.long, device=dev)
    batch = torch.arange(B, device=dev)[:, None]
    for x, lens in zip(xs, lens_list):
        lens = _lens(lens, dev)
        t = torch.arange(x.shape[1], device=dev)[None, :]
        valid = t < lens[:, None]
        dst = torch.where(valid, out_lens[:, None] + t, T_out - 1)
        vals = torch.where(_expand_mask(valid, x), x, 0)
        out = out.index_put((batch.expand_as(dst), dst), vals,
                            accumulate=True)
        out_lens = out_lens + lens
    return out, out_lens.int()


def sequence_reshape(x, lengths, new_dim):
    """sequence_reshape_op.h: refold the feature dim; row lengths scale by
    D / new_dim. Returns (out, lengths int32)."""
    B, T, D = x.shape
    if (T * D) % new_dim:
        raise ValueError(f"cannot reshape T*D={T * D} to new_dim={new_dim}")
    out = x.reshape(B, T * D // new_dim, new_dim)
    return out, ((_lens(lengths, x.device) * D) // new_dim).int()


def sequence_enumerate(ids, lengths, win_size, pad_value=0):
    """sequence_enumerate_op.h: sliding windows of ids, pad_value past
    the row's end; ids [B, T] -> [B, T, win_size]."""
    B, T = ids.shape[:2]
    base = ids.reshape(B, T)
    dev = ids.device
    pos = (torch.arange(T, device=dev)[:, None]
           + torch.arange(win_size, device=dev)[None, :])
    src = pos.clamp(0, T - 1).reshape(1, -1).expand(B, -1)
    win = torch.gather(base, 1, src).reshape(B, T, win_size)
    lens = _lens(lengths, dev)[:, None, None]
    win = torch.where(pos[None] < lens, win,
                      torch.tensor(pad_value, dtype=base.dtype, device=dev))
    mask = torch.arange(T, device=dev)[None, :] < lens[:, :, 0]
    return win * mask[:, :, None].to(win.dtype)


def sequence_pad(x, lengths, pad_value=0.0, padded_length=None):
    """sequence_pad_op: the padded form is already canonical: cut or pad
    the time axis to padded_length and set the padding to pad_value."""
    T = x.shape[1]
    if padded_length is not None and padded_length != T:
        if padded_length < T:
            x = x[:, :padded_length]
        else:
            x = torch.cat([x, x.new_zeros((x.shape[0], padded_length - T)
                                          + tuple(x.shape[2:]))], 1)
        T = padded_length
    m = _expand_mask(seq_mask(_lens(lengths, x.device), T), x)
    return torch.where(m, x, torch.tensor(pad_value, dtype=x.dtype,
                                          device=x.device))


def sequence_unpad(x, lengths):
    """sequence_unpad_op: zero the padding and attach the lengths (int32)."""
    lens = _lens(lengths, x.device)
    m = _expand_mask(seq_mask(lens, x.shape[1]), x)
    return x * m.to(x.dtype), lens.int()


def sequence_scatter(x, ids, updates, upd_lengths):
    """sequence_scatter_op.h: x[b, ids[b, j]] += updates[b, j] for j <
    upd_lengths[b]."""
    B, J = x.shape[0], ids.shape[1]
    valid = seq_mask(_lens(upd_lengths, x.device), J)
    idx = torch.where(valid, ids.reshape(B, J).long(), 0)
    upd = torch.where(_expand_mask(valid, updates), updates, 0)
    batch = torch.arange(B, device=x.device)[:, None].expand(B, J)
    return x.index_put((batch, idx), upd, accumulate=True)


# ---------------------------------------------------------- recurrent ops

def _act(name):
    return {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
            "relu": torch.relu, "identity": lambda v: v}[name]


def dynamic_lstm(x, lengths, weight, bias, h0=None, c0=None,
                 use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh"):
    """dynamic_lstm over x [B, T, 4D], already projected (lstm_op.cc).

    Gates in the order c~, i, f, o (math/detail/lstm_kernel.h:25): c =
    act(c~) * i + c_prev * f, with the peepholes checkI / checkF on the
    previous cell and checkO on the new one. `bias` is [1, 4D], or [1,
    7D] with the peepholes after the gate bias. Returns (hidden [B, T,
    D], cell [B, T, D])."""
    B, T, D4 = x.shape
    D = D4 // 4
    if use_peepholes and bias is None:
        raise ValueError("use_peepholes needs the [1, 7D] bias")
    act_g, act_c = _act(gate_activation), _act(cell_activation)
    act_cand = _act(candidate_activation)
    h = h0 if h0 is not None else x.new_zeros(B, D)
    c = c0 if c0 is not None else x.new_zeros(B, D)
    b_gate = bias[:, :D4] if bias is not None else 0.0
    if use_peepholes:
        check_i = bias[:, D4:D4 + D]
        check_f = bias[:, D4 + D:D4 + 2 * D]
        check_o = bias[:, D4 + 2 * D:D4 + 3 * D]
    lens = _lens(lengths, x.device)[:, None]
    xs = sequence_reverse(x, lens[:, 0]) if is_reverse else x
    hs, cs = [], []
    for t in range(T):
        g = xs[:, t] + h @ weight + b_gate
        cand, ig, fg, og = g[:, :D], g[:, D:2 * D], g[:, 2 * D:3 * D], \
            g[:, 3 * D:]
        if use_peepholes:
            ig = ig + c * check_i
            fg = fg + c * check_f
        i, f = act_g(ig), act_g(fg)
        c_new = act_cand(cand) * i + c * f
        if use_peepholes:
            og = og + c_new * check_o
        h_new = act_g(og) * act_c(c_new)
        alive = (t < lens).to(x.dtype)
        hs.append(h_new * alive)
        cs.append(c_new * alive)
        h = h_new * alive + h * (1 - alive)
        c = c_new * alive + c * (1 - alive)
    hs, cs = torch.stack(hs, 1), torch.stack(cs, 1)
    if is_reverse:
        hs, cs = sequence_reverse(hs, lens[:, 0]), \
            sequence_reverse(cs, lens[:, 0])
    return hs, cs


def dynamic_gru(x, lengths, weight, bias=None, h0=None, is_reverse=False,
                gate_activation="sigmoid", candidate_activation="tanh",
                origin_mode=False):
    """dynamic_gru over x [B, T, 3D], already projected
    (math/detail/gru_kernel.h): the gates [u, r] from weight[:, :2D], the
    candidate from (r * h_prev) @ weight[:, 2D:]; h = (1 - u) * h_prev +
    u * cand, or u * h_prev + (1 - u) * cand with origin_mode. Returns
    hidden [B, T, D]."""
    B, T, D3 = x.shape
    D = D3 // 3
    act_g, act_c = _act(gate_activation), _act(candidate_activation)
    h = h0 if h0 is not None else x.new_zeros(B, D)
    w_gate, w_cand = weight[:, :2 * D], weight[:, 2 * D:]
    b = bias if bias is not None else x.new_zeros(1, D3)
    lens = _lens(lengths, x.device)[:, None]
    xs = sequence_reverse(x, lens[:, 0]) if is_reverse else x
    hs = []
    for t in range(T):
        xt = xs[:, t]
        gates = xt[:, :2 * D] + b[:, :2 * D] + h @ w_gate
        u, r = act_g(gates[:, :D]), act_g(gates[:, D:])
        cand = act_c(xt[:, 2 * D:] + b[:, 2 * D:] + (r * h) @ w_cand)
        if origin_mode:
            h_new = u * h + cand - u * cand
        else:
            h_new = h - u * h + u * cand
        alive = (t < lens).to(x.dtype)
        hs.append(h_new * alive)
        h = h_new * alive + h * (1 - alive)
    hs = torch.stack(hs, 1)
    return sequence_reverse(hs, lens[:, 0]) if is_reverse else hs
