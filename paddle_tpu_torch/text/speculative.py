"""Speculative decoding: the n-gram self-draft, the draft model and the
cache-mirror arithmetic the serving steppers and `DecodeEngine` share
(the JAX package's `text/speculative.py`).

Draft-verify generation: a cheap DRAFT source proposes k - 1
continuation tokens, ONE k-token VERIFY step runs them through the
target model against the live KV cache (the pending token plus the
drafts, written at each row's own offset: `ops.attention.
verify_attention`), and the longest draft prefix whose tokens match the
verify argmaxes is accepted together with one correction token
(`text.decode.greedy_accept`). Greedy acceptance keeps the output
identical to plain greedy decoding for any draft source.

Cache rollback needs no copy: the verify step writes all k fed tokens
and acceptance sets the per-row write index back to (pre-verify + 1 +
n_match); rejected positions hold garbage that the next round's fixed-k
write covers before any query can see it (key positions at or past the
write index are masked everywhere).
"""
from __future__ import annotations

import torch

__all__ = ["ngram_propose", "write_hist", "rollback_index", "DraftModel"]


def ngram_propose(hist, pending, lengths, Pb, n_new, gen_len, ngram=2):
    """Suffix n-gram self-speculation: propose `n_new` tokens per row by
    finding the most recent position in the row's own history whose
    trailing `ngram`-gram matches the current context, and reading the
    tokens that followed it.

    hist [B, L]: token mirror of the KV cache (prompt at [0, Pb) with its
    pad hole, generated tokens from Pb on). pending [B]: the last emitted
    token (not yet written). lengths [B]: true prompt lengths (the hole
    [lengths, Pb) is skipped by matching in LOGICAL coordinates). Pb: an
    int or [B]. gen_len [B]: valid generated tokens in hist. Rows with no
    match repeat the pending token. Returns int32 [B, n_new]."""
    B, L = hist.shape
    dev = hist.device
    lens = torch.as_tensor(lengths, device=dev).long().reshape(-1, 1)
    Pbv = torch.as_tensor(Pb, device=dev).long().reshape(-1, 1)
    pending = pending.long()
    pos = torch.arange(L, device=dev)[None, :]
    # logical view: real prompt tokens then generated tokens, the pad
    # hole [len, Pb) spliced out
    phys = torch.where(pos < lens, pos, pos + (Pbv - lens))
    hl = hist.long().gather(1, torch.clamp(phys, 0, L - 1).expand(B, L))
    ell = lens[:, 0] + torch.as_tensor(gen_len, device=dev).long()   # [B]
    # match at q: hl[q] == pending and hl[q - j] == (the j-th token back
    # from the current end) for j = 1 .. ngram - 1
    ok = hl == pending[:, None]
    for j in range(1, int(ngram)):
        cj = hl.gather(1, torch.clamp(ell - j, 0, L - 1)[:, None])
        hl_back = hl.gather(1, torch.clamp(pos - j, 0, L - 1).expand(B, L))
        ok = ok & (hl_back == cj) & (pos >= j)
    ok = ok & (pos < ell[:, None])
    q = torch.where(ok, pos, -1).amax(dim=1)                      # [B]
    # the match distance is the detected period: the j-th proposal reads
    # q + 1 + (j mod p), so periodic continuations of any period are
    # proposed in full
    p = torch.clamp(ell - q, min=1)[:, None]
    jj = torch.arange(int(n_new), device=dev)[None, :]
    off = q[:, None] + 1 + jj % p
    gath = hl.gather(1, torch.clamp(off, 0, L - 1))
    oob = (q[:, None] < 0) | (off >= ell[:, None])
    return torch.where(oob, pending[:, None], gath).to(torch.int32)


def write_hist(hist, fed, index):
    """Mirror a verify round's fed block [B, k] into the history buffer
    [B, L] at each row's cache write offset, in place (a block that
    would run past L starts at L - k, as the JAX dynamic_update_slice
    clamps). Returns `hist`."""
    k = fed.shape[1]
    start = torch.clamp(torch.as_tensor(index, device=hist.device).long(),
                        0, hist.shape[1] - k)
    pos = start[:, None] + torch.arange(k, device=hist.device)[None]
    hist.scatter_(1, pos, fed.to(hist.dtype))
    return hist


def rollback_index(index, k, n_match, active):
    """The acceptance-time write-index arithmetic shared by every cache:
    verify advanced `index` by k; keep the pending token plus the
    accepted drafts on active rows, pin inactive rows."""
    keep = torch.where(active, 1 + n_match.to(torch.int32), 0)
    return (index.to(torch.int32) - int(k) + keep).to(torch.int32)


class DraftModel:
    """A small draft model with its OWN StaticKVCache: a (decoder, embed,
    project) triple that shares the target's vocabulary and
    cross-attention memory. `DecodeEngine.generate(spec_k=k,
    draft_model=...)` prefills it beside the target, steps it k times a
    round (the pending token, then each draft; the last step only writes,
    so the draft cache covers the same k positions the verify writes) and
    rolls its write indices back with the target's acceptance arithmetic
    (`rollback_index`). Its weights live where the target's do."""

    def __init__(self, decoder, embed, project):
        from .generation import _StepNet

        self.decoder = decoder
        self._net = _StepNet(decoder, embed, project).eval()
