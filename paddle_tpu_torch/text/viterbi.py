"""Viterbi decoding over a [C, C] transition (the JAX package's
`text/viterbi.py`; reference: operators/crf_decoding_op.h)."""
from __future__ import annotations

import torch

__all__ = ["viterbi_decode"]


def viterbi_decode(potentials, transition, lengths=None,
                   include_bos_eos_tag=True):
    """Best tag path of each row of potentials [B, T, C] under transition
    [C, C] (from, to), with no start or stop row. Returns (scores [B],
    paths [B, T]), in that order.

    Every row is decoded over all T steps. `lengths` raises: the JAX
    function takes it and applies nothing. `include_bos_eos_tag` is
    taken and, as there, applies nothing."""
    if lengths is not None:
        raise NotImplementedError(
            "viterbi_decode(lengths=) is not supported: the JAX package "
            "takes it and decodes every row over all T steps")
    score = potentials[:, 0]
    idxs = []
    for t in range(1, potentials.shape[1]):
        cand = score[:, :, None] + transition[None]     # [B, from, to]
        idxs.append(cand.argmax(1))
        score = cand.amax(1) + potentials[:, t]
    tag = score.argmax(1)
    path = [tag]
    for idx in reversed(idxs):
        tag = torch.gather(idx, 1, tag[:, None])[:, 0]
        path.append(tag)
    return score.amax(1), torch.stack(path[::-1], 1)
