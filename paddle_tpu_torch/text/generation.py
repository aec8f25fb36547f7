"""The decoder step net shared by the serving engine's join and step, and
the eager greedy oracle.

Position and masking conventions are the JAX package's
(`text/generation.py`): a prompt pads with eos to its power-of-two
bucket Pb, the pad hole [len, Pb) keeps a -1e30 key bias for the whole
generation, and generated tokens occupy absolute cache positions Pb,
Pb + 1, ... That is what makes every serving slot comparable token for
token with a solo `generate_eager` run.
"""
from __future__ import annotations

import inspect

import numpy as np
import torch
from torch import nn

from ..core.bucketing import bucket_size
from ..nn.layer.transformer import MultiHeadAttention

__all__ = ["NEG", "generate_eager", "pad_bias_row"]

NEG = -1e30


def _takes_positions(fn):
    """Does the embed callable accept (tokens, positions)?"""
    try:
        target = fn.forward if isinstance(fn, nn.Module) else fn
        params = [p for p in inspect.signature(target).parameters.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
        return len(params) >= 2
    except (TypeError, ValueError):
        return False


def pad_bias_row(lengths, Pb, L, device):
    """[B, L] float32 key bias: -1e30 over each row's pad hole
    [lengths[b], Pb), 0 elsewhere."""
    lengths = torch.as_tensor(lengths, device=device).reshape(-1, 1)
    kpos = torch.arange(L, device=device)[None, :]
    hole = (kpos >= lengths) & (kpos < Pb)
    return torch.where(hole, NEG, 0.0).float()


class _StepNet(nn.Module):
    """decoder + embed + project as one unit: the prefill of a prompt
    (which also computes the cross-attention K/V of the memory) and the
    decode step over the caches."""

    def __init__(self, decoder, embed, project):
        super().__init__()
        self.decoder = decoder
        self.embed = embed
        self.project = project
        self._embed_pos = _takes_positions(embed)

    def _embed(self, tokens, positions):
        if self._embed_pos:
            return self.embed(tokens, positions)
        return self.embed(tokens)

    def cross_kv(self, memory):
        """Per-layer cross-attention (K, V) of `memory` [B, M, D]: the
        only model compute of a prefix-hit attach."""
        return [tuple(layer.cross_attn.gen_cache(
            memory, type=MultiHeadAttention.StaticCache))
            for layer in self.decoder.layers]

    def forward(self, tokens, positions, memory, tgt_mask=None,
                memory_mask=None, inc=None, static_kv=None, prefill=False):
        """One pass over `tokens` with the self-attention caches `inc`
        (StaticKVCache or PagedKVCache per layer) and the cross-attention
        K/V `static_kv`. prefill=True computes the cross K/V from
        `memory` first and returns them too."""
        if prefill:
            static_kv = self.cross_kv(memory)
        x = self._embed(tokens, positions)
        cache = [(inc[i], MultiHeadAttention.StaticCache(sk, sv))
                 for i, (sk, sv) in enumerate(static_kv)]
        out, new_caches = self.decoder(x, memory, tgt_mask, memory_mask,
                                       cache)
        logits = self.project(out)
        new_inc = [c[0] for c in new_caches]
        if prefill:
            return logits, new_inc, static_kv
        return logits, new_inc

    def prefill(self, prompt, length, memory, inc, L):
        """Prefill one bucketed prompt row [1, Pb] of true length
        `length` (an int) into the empty batch-1 caches `inc`. Returns
        (logits [1, Pb, V], new caches, cross K/V, key-bias row [1, L])."""
        Pb = prompt.shape[1]
        bias_row = pad_bias_row([length], Pb, L, prompt.device)
        positions = torch.arange(Pb, device=prompt.device)[None]
        logits, inc, static_kv = self(
            prompt, positions, memory, tgt_mask=bias_row[:, :Pb],
            inc=inc, prefill=True)
        return logits, inc, static_kv, bias_row


@torch.inference_mode()
def generate_eager(decoder, embed, project, memory, prompt=None,
                   prompt_lengths=None, *, bos_id=0, eos_id=1,
                   max_new_tokens=32, pad_prompt_to=None,
                   return_logits=False):
    """Greedy token-by-token generation on the concat-grown Cache path:
    the solo oracle the serving engine is held to. Runs where the
    decoder's parameters live. memory [B, M, D]; prompt [B, P] (a bos
    column by default), right-padded, with true lengths
    `prompt_lengths`. Returns (tokens [B, max_new_tokens], lengths [B])
    as numpy arrays, plus the per-step logits [B, max_new_tokens, V]
    (float32, CPU) when `return_logits`."""
    dev = next(decoder.parameters()).device
    takes_pos = _takes_positions(embed)

    def run_embed(tokens, positions):
        if takes_pos:
            return embed(tokens, positions)
        return embed(tokens)

    was_training = decoder.training
    decoder.eval()
    try:
        memory = torch.as_tensor(memory, device=dev)
        B = memory.shape[0]
        if prompt is None:
            prompt = torch.full((B, 1), bos_id, dtype=torch.long)
        prompt = torch.as_tensor(np.asarray(prompt), device=dev).long()
        P0 = prompt.shape[1]
        Pb = pad_prompt_to or bucket_size(P0)
        lengths = (torch.full((B,), P0, dtype=torch.long, device=dev)
                   if prompt_lengths is None else
                   torch.as_tensor(np.asarray(prompt_lengths),
                                   device=dev).long())
        prompt = torch.cat([prompt, torch.full((B, Pb - P0), eos_id,
                                               dtype=torch.long,
                                               device=dev)], 1)
        L = Pb + max_new_tokens
        pad_bias = pad_bias_row(lengths, Pb, L, dev)
        caches = decoder.gen_cache(memory)
        positions = torch.arange(Pb, device=dev)[None].expand(B, Pb)
        out, caches = decoder(run_embed(prompt, positions), memory,
                              pad_bias[:, None, None, :Pb], None, caches,
                              tgt_is_causal=True)
        lg = project(out)
        last = lg[torch.arange(B, device=dev), lengths - 1]
        tok = last.argmax(-1)
        done = tok == eos_id
        lens = torch.ones((B,), dtype=torch.long, device=dev)
        toks, step_logits = [tok], [last]
        for t in range(1, max_new_tokens):
            pos = torch.full((B, 1), Pb + t - 1, dtype=torch.long,
                             device=dev)
            out, caches = decoder(run_embed(tok[:, None], pos), memory,
                                  pad_bias[:, None, None, :Pb + t], None,
                                  caches)
            lg2 = project(out)[:, 0]
            nxt = lg2.argmax(-1)
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            lens = lens + (~done).long()
            done = done | (nxt == eos_id)
            tok = nxt
            toks.append(tok)
            step_logits.append(lg2)
        toks = torch.stack(toks, 1).cpu().numpy()
        lens = lens.cpu().numpy()
        if return_logits:
            return toks, lens, torch.stack(step_logits, 1).float().cpu()
        return toks, lens
    finally:
        decoder.train(was_training)
