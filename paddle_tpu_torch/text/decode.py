"""Sequence decoding: greedy, speculative greedy and beam search (the JAX
package's `text/decode.py`).

Where the reference runs each search as one `lax.scan` / `while_loop`,
the port runs a plain loop of torch ops over a caller's step function:

    step_fn(tokens [N] int64, state) -> (logits [N, V], new_state)

one model step for N rows (N = batch * beam inside `beam_search`). The
state holds preallocated caches (`MultiHeadAttention.StaticKVCache`);
no cache grows by concatenation. A loop stops early once every row has
finished; what the reference's remaining steps would produce is then
filled in without the model (eos tokens, unchanged lengths, and for
beams the score reorder that only finished beams take part in), so the
returned arrays equal the reference's in full.

Ties follow JAX: argmax takes the first maximal index, top-k and the
final best-first sort keep the lower flat index first among equal
scores (a stable descending sort).
"""
from __future__ import annotations

import torch

__all__ = ["NEG", "greedy_search", "greedy_accept", "spec_greedy_search",
           "beam_search", "map_state"]

NEG = -1e9


def map_state(fn, state):
    """Apply `fn` to every tensor leaf of a nested state (lists, tuples,
    namedtuples, dicts); other leaves pass through."""
    if isinstance(state, torch.Tensor):
        return fn(state)
    if isinstance(state, dict):
        return {k: map_state(fn, v) for k, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(map_state(fn, v) for v in state))
    if isinstance(state, (list, tuple)):
        return type(state)(map_state(fn, v) for v in state)
    return state


def greedy_search(step_fn, init_state, batch_size, bos_id, eos_id, max_len,
                  init_logits=None, device=None):
    """Argmax decoding. Returns (tokens [B, max_len], lengths [B]), int32.

    init_logits ([B, V], optional): next-token logits already computed for
    the prefix (the decode engine's prefill). When given, the first token
    is their argmax and the loop runs max_len - 1 steps, each fed a token
    the cache has not seen."""
    if init_logits is None:
        dev = device
        tok = torch.full((batch_size,), bos_id, dtype=torch.long, device=dev)
        done = torch.zeros((batch_size,), dtype=torch.bool, device=dev)
        lengths = torch.zeros((batch_size,), dtype=torch.int32, device=dev)
        toks, steps = [], max_len
    else:
        dev = init_logits.device
        tok = init_logits.argmax(-1)
        done = tok == eos_id
        lengths = torch.ones((batch_size,), dtype=torch.int32, device=dev)
        toks, steps = [tok], max_len - 1
    state = init_state
    for _ in range(steps):
        if bool(done.all()):
            # every row emits eos from here on and no length moves
            toks.append(torch.full_like(tok, eos_id))
            continue
        logits, state = step_fn(tok, state)
        nxt = logits.argmax(-1)
        nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
        lengths = lengths + (~done).to(torch.int32)
        done = done | (nxt == eos_id)
        tok = nxt
        toks.append(tok)
    return torch.stack(toks, 1).to(torch.int32), lengths


def greedy_accept(drafts, preds):
    """Greedy draft-verify acceptance. drafts [B, K-1] are the proposed
    continuation tokens; preds [B, K] the argmax of the verify logits
    for the fed block [pending, d_1, ..., d_{K-1}], so preds[:, i] is the
    oracle token FOLLOWING fed position i. Draft i is accepted only while
    every earlier draft matched its oracle, which keeps the output
    identical to plain greedy decoding for any draft source.

    Returns (n_match [B] in [0, K-1], emit [B, K]), both int32: emit[:, i]
    is the i-th newly emitted token (the accepted drafts, then the
    correction token preds[:, n_match]; positions past n_match repeat
    the correction token, and callers emit only n_match + 1)."""
    K = preds.shape[1]
    match = (drafts == preds[:, :-1]).to(torch.int32)
    n_match = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
    corr = preds.gather(1, n_match[:, None].long())
    ii = torch.arange(K, device=preds.device)[None, :]
    dpad = torch.cat([drafts.to(preds.dtype), corr], dim=1)
    emit = torch.where(ii < n_match[:, None], dpad, corr)
    return n_match, emit.to(torch.int32)


def spec_greedy_search(verify_fn, draft_fn, rollback_fn, init_state,
                       batch_size, eos_id, max_len, k, init_logits,
                       return_stats=False):
    """Speculative greedy decoding: each round proposes k - 1 drafts, runs
    ONE k-token verify step (the pending token plus the drafts, written
    at each row's cache offset), accepts the longest matching prefix with
    `greedy_accept` and rolls the caches back to it. The output equals
    plain greedy decoding for any draft source.

    verify_fn(tokens [B, k], state) -> (logits [B, k, V], state)
    draft_fn(pending [B], emitted [B], state) -> (drafts [B, k-1], state)
    rollback_fn(state, n_match [B], active [B]) -> state: every write index
        back to (pre-verify index + 1 + n_match) on active rows; inactive
        rows' indices pinned (verify advanced them all by k).

    init_logits [B, V]: the prefill logits; the first token is their
    argmax. Returns (tokens [B, max_len], lengths [B]) int32, and with
    return_stats a {"rounds", "proposed", "accepted"} dict of ints
    (accepted counts drafts that were emitted)."""
    B, K = batch_size, int(k)
    dev = init_logits.device
    tok0 = init_logits.argmax(-1)
    done = tok0 == eos_id
    # k wider than max_len so a round's fixed-k block write never clips;
    # eos-filled so capped tails read as plain greedy's (eos after eos)
    buf = torch.full((B, max_len + K), eos_id, dtype=torch.long, device=dev)
    buf[:, 0] = tok0
    cnt = torch.ones((B,), dtype=torch.long, device=dev)
    pending, state = tok0, init_state
    rounds = prop = acc = 0
    ii = torch.arange(K, device=dev)[None, :]
    while not bool(done.all()):
        active = ~done
        drafts, state = draft_fn(pending, cnt, state)
        fed = torch.cat([pending[:, None], drafts.long()], dim=1)
        logits, state = verify_fn(fed, state)
        preds = logits.argmax(-1)
        n_match, emit = greedy_accept(drafts.long(), preds)
        n_match = n_match.long()
        # emission caps: stop at the first emitted eos (inclusive) and
        # never past max_len; done rows emit nothing
        eos_pos = torch.where(emit == eos_id, ii, K).amin(dim=1)
        n_emit = torch.minimum(n_match + 1, eos_pos + 1)
        n_emit = torch.minimum(n_emit, max_len - cnt)
        n_emit = torch.where(active, n_emit, 0)
        blk = torch.where(ii < n_emit[:, None], emit.long(), eos_id)
        buf.scatter_(1, cnt[:, None] + ii, blk)
        state = rollback_fn(state, n_match, active)
        cnt = cnt + n_emit
        done = done | (eos_pos < n_emit) | (cnt >= max_len)
        corr = preds.gather(1, n_match[:, None])[:, 0]
        pending = torch.where(active, corr, pending)
        n_act = int(active.sum())
        rounds += min(n_act, 1)
        prop += n_act * (K - 1)
        acc += int(torch.where(active, torch.minimum(n_match, n_emit),
                               0).sum())
    toks = buf[:, :max_len].to(torch.int32)
    lengths = cnt.to(torch.int32)
    if return_stats:
        return toks, lengths, {"rounds": rounds, "proposed": prop,
                               "accepted": acc}
    return toks, lengths


def _top_k(x, k):
    """Top-k along the last axis with JAX's tie order (the lower index
    first among equal values): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_search(step_fn, init_state, batch_size, bos_id, eos_id, beam_size,
                max_len, length_penalty=0.0, init_logits=None, device=None):
    """Beam search. Returns (tokens [B, K, max_len] best-first int32,
    scores [B, K] float32, lengths [B, K] int32).

    States have leading dim batch_size; they are tiled to batch * beam
    rows (beam-major: row b * K + j) and regathered by the beam parents
    every step. init_logits ([B, V], optional): the prefill's logits; the
    first expansion is top-k over them and the loop runs max_len - 1
    cache-backed steps. Finished beams continue with eos only, at no
    cost; the final scores divide by max(length, 1) ** length_penalty."""
    B, K = batch_size, int(beam_size)
    state = map_state(lambda t: t.repeat_interleave(K, dim=0), init_state)
    if init_logits is None:
        dev = device
        # beam 0 live, the others dead, so the first expansion is unique
        logp = torch.tensor([0.0] + [NEG] * (K - 1), dtype=torch.float32,
                            device=dev).repeat(B, 1)
        tok = torch.full((B, K), bos_id, dtype=torch.long, device=dev)
        fin = torch.zeros((B, K), dtype=torch.bool, device=dev)
        lens = torch.zeros((B, K), dtype=torch.int32, device=dev)
        steps = max_len
    else:
        dev = init_logits.device
        lp0 = torch.log_softmax(init_logits.float(), -1)
        logp, tok = _top_k(lp0, K)
        fin = tok == eos_id
        lens = torch.ones((B, K), dtype=torch.int32, device=dev)
        steps = max_len - 1
    tok0 = tok
    base = (torch.arange(B, device=dev) * K)[:, None]
    toks, srcs = [], []
    fin_mask = None
    for _ in range(steps):
        if bool(fin.all()) and fin_mask is not None:
            # every beam has finished: the logits no longer matter (each
            # beam continues with eos alone), so the step needs no model
            lp = fin_mask.expand(B, K, -1)
        else:
            logits, state = step_fn(tok.reshape(B * K), state)
            V = logits.shape[-1]
            if fin_mask is None:
                fin_mask = torch.full((V,), NEG, dtype=torch.float32,
                                      device=dev)
                fin_mask[eos_id] = 0.0
            lp = torch.log_softmax(logits.float(), -1).reshape(B, K, V)
            lp = torch.where(fin[:, :, None], fin_mask, lp)
        V = lp.shape[-1]
        total = logp[:, :, None] + lp
        logp, top_ix = _top_k(total.reshape(B, K * V), K)
        src = top_ix // V
        tok = top_ix % V
        if not bool(fin.all()):
            flat = (base + src).reshape(-1)
            state = map_state(lambda t: t.index_select(0, flat), state)
        fin = fin.gather(1, src)
        lens = lens.gather(1, src) + (~fin).to(torch.int32)
        fin = fin | (tok == eos_id)
        toks.append(tok)
        srcs.append(src)
    # backtrack the ancestry so each final beam reads its own history
    ix = torch.arange(K, device=dev).repeat(B, 1)
    rev = []
    for t in range(steps - 1, -1, -1):
        rev.append(toks[t].gather(1, ix))
        ix = srcs[t].gather(1, ix)
    seqs = torch.stack(rev[::-1], 2) if rev else \
        torch.zeros((B, K, 0), dtype=torch.long, device=dev)
    if init_logits is not None:
        # the ancestry bottoms out in the first expansion: prepend each
        # final beam's own first token
        seqs = torch.cat([tok0.gather(1, ix)[:, :, None], seqs], 2)
    denom = lens.clamp(min=1).float() ** float(length_penalty)
    scores = logp / denom
    order = torch.argsort(-scores, dim=1, stable=True)
    seqs = seqs.gather(1, order[:, :, None].expand(-1, -1, seqs.shape[2]))
    return (seqs.to(torch.int32), scores.gather(1, order),
            lens.gather(1, order))
