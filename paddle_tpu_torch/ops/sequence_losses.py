"""Structured sequence losses: CTC and the linear-chain CRF (the JAX
package's `ops/sequence_losses.py`).

- `ctc_loss`: the log-domain alpha recursion over the blank-interleaved
  labels, a Python loop over T. An unreachable state holds the finite
  NEG = -1e30, so a row no alignment fits gives ~1e30, where
  `torch.nn.functional.ctc_loss` gives inf.
- `crf_log_likelihood` / `crf_decode`: the fluid transition layout
  [C + 2, C]: row 0 the start weights, row 1 the stop weights, rows 2..
  the pairs (from, to).

Every op takes padded batches and lengths and runs on its inputs'
device; the gradients come from autograd through the loops.
"""
from __future__ import annotations

import torch

__all__ = ["NEG", "ctc_loss", "crf_log_likelihood", "crf_decode"]

NEG = -1e30


def _lens(v, device):
    return torch.as_tensor(v, device=device).reshape(-1).long()


def _no_inf(x):
    return torch.where(torch.isinf(x), 0.0, x)


class _LogAddExp(torch.autograd.Function):
    """torch.logaddexp with jax.numpy.logaddexp's gradient, exp(x - out)
    for each input. The two differ where the sum absorbs log 2 (both
    inputs at NEG): there JAX's weights are 1 and 1, torch's 1/2 and 1/2.
    That reaches the gradient only on a row no alignment fits."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        out = _no_inf(out)
        return g * torch.exp(_no_inf(a) - out), \
            g * torch.exp(_no_inf(b) - out)


_logaddexp = _LogAddExp.apply


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0):
    """Negative log-likelihood per example: log_probs [T, B, C]
    (log-softmax outputs), labels [B, L] padded, input_lengths and
    label_lengths [B]. Returns [B] in log_probs' dtype."""
    T, B, C = log_probs.shape
    dev, dt = log_probs.device, log_probs.dtype
    labels = torch.as_tensor(labels, device=dev).long()
    S = 2 * labels.shape[1] + 1
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    lab_len = _lens(label_lengths, dev)
    inp_len = _lens(input_lengths, dev)
    ext_len = 2 * lab_len + 1
    prev2 = torch.cat([ext.new_full((B, 2), -1), ext[:, :-2]], 1)
    can_skip = (ext != blank) & (ext != prev2)

    def emit(t):
        return torch.gather(log_probs[t], 1, ext)

    def neg(n):
        return torch.full((B, n), NEG, dtype=dt, device=dev)

    e0 = emit(0)
    alpha = torch.cat([e0[:, :1], torch.where(lab_len[:, None] > 0,
                                              e0[:, 1:2], NEG),
                       neg(S - 2)], 1)
    for t in range(1, T):
        shift1 = torch.cat([neg(1), alpha[:, :-1]], 1)
        shift2 = torch.where(can_skip, torch.cat([neg(2), alpha[:, :-2]], 1),
                             NEG)
        new = _logaddexp(alpha, _logaddexp(shift1, shift2)) + emit(t)
        alpha = torch.where((t < inp_len)[:, None], new, alpha)
    a_last = torch.gather(alpha, 1, (ext_len - 1).clamp(0, S - 1)[:, None])
    a_prev = torch.gather(alpha, 1, (ext_len - 2).clamp(0, S - 1)[:, None])
    a_prev = torch.where(ext_len[:, None] >= 2, a_prev, NEG)
    return -_logaddexp(a_last, a_prev)[:, 0]


def _split_transition(transition):
    return transition[0], transition[1], transition[2:]


def crf_log_likelihood(emission, transition, label, lengths):
    """Per-example log p(label | emission) = score - logZ: emission [B, T,
    C], transition [C + 2, C], label [B, T] int, lengths [B]."""
    B, T, C = emission.shape
    dev = emission.device
    start, stop, trans = _split_transition(transition)
    lens = _lens(lengths, dev)
    label = torch.as_tensor(label, device=dev).reshape(B, T).long()
    mask = torch.arange(T, device=dev)[None, :] < lens[:, None]

    em = torch.gather(emission, 2, label[..., None])[..., 0]
    em_score = (em * mask).sum(1)
    last = torch.gather(label, 1, (lens - 1).clamp(0, T - 1)[:, None])[:, 0]
    pair = trans[label[:, :-1], label[:, 1:]]
    score = (em_score + start[label[:, 0]] + stop[last]
             + (pair * mask[:, 1:]).sum(1))

    alpha = start[None, :] + emission[:, 0]
    for t in range(1, T):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], 1) \
            + emission[:, t]
        alpha = torch.where((t < lens)[:, None], nxt, alpha)
    return score - torch.logsumexp(alpha + stop[None, :], 1)


def crf_decode(emission, transition, lengths):
    """Viterbi path under the fluid transition layout. Returns (path [B,
    T] int32, zero past each length, scores [B]); a step past a row's
    length backtracks to itself."""
    B, T, C = emission.shape
    dev = emission.device
    start, stop, trans = _split_transition(transition)
    lens = _lens(lengths, dev)
    same = torch.arange(C, device=dev).expand(B, C)
    alpha = start[None, :] + emission[:, 0]
    backs = []
    for t in range(1, T):
        cand = alpha[:, :, None] + trans[None]          # [B, from, to]
        alive = (t < lens)[:, None]
        backs.append(torch.where(alive, cand.argmax(1), same))
        alpha = torch.where(alive, cand.amax(1) + emission[:, t], alpha)
    final = alpha + stop[None, :]
    tag, scores = final.argmax(1), final.amax(1)
    path = [tag]
    for t in range(T - 2, -1, -1):
        prev = torch.gather(backs[t], 1, tag[:, None])[:, 0]
        tag = torch.where(t < lens - 1, prev, tag)
        path.append(tag)
    path = torch.stack(path[::-1], 1)
    path = torch.where(torch.arange(T, device=dev)[None, :] < lens[:, None],
                       path, 0)
    return path.int(), scores
