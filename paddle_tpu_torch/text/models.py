"""ERNIE / BERT-family encoders (the JAX package's `text/models.py`).

The module tree and parameter names match the JAX package's
(`ernie.embeddings.word_embeddings.weight`,
`ernie.encoder.layers.0.self_attn.q_proj.weight`, ...), so
`convert.from_jax_state` loads a JAX `state_dict()` as it stands.
Attention runs through the flash kernels with in-kernel attention
dropout in training. The packed-varlen inputs (segment ids, per-sequence
CLS indices), `ErnieForPretraining` and the MoE feed-forward belong to
later slices.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.device import resolve_device
from ..nn.layer.common import Dropout, Embedding, LayerNorm, Linear, Tanh
from ..nn.layer.transformer import TransformerEncoder, TransformerEncoderLayer

__all__ = ["ErnieConfig", "ErnieEmbeddings", "ErnieModel",
           "ErnieForSequenceClassification"]


class ErnieConfig:
    def __init__(self, vocab_size=18000, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072, max_position=513,
                 type_vocab_size=2, hidden_dropout=0.1, attn_dropout=0.1,
                 num_classes=2):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position = max_position
        self.type_vocab_size = type_vocab_size
        self.hidden_dropout = hidden_dropout
        self.attn_dropout = attn_dropout
        self.num_classes = num_classes

    @classmethod
    def base(cls, **kw):
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
                 intermediate_size=128, max_position=128)
        d.update(kw)
        return cls(**d)


class ErnieEmbeddings(nn.Module):
    def __init__(self, cfg: ErnieConfig, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **kw)
        self.position_embeddings = Embedding(cfg.max_position,
                                             cfg.hidden_size, **kw)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size, **kw)
        self.layer_norm = LayerNorm(cfg.hidden_size, device=device)
        self.dropout = Dropout(cfg.hidden_dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        seq_len = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(seq_len, device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class ErnieModel(nn.Module):
    """BERT/ERNIE encoder. attention_mask: (B, S) 1/0 valid-token mask,
    applied as a (1 - mask) * -1e4 key bias (the flash kernels' key-bias
    path). Returns (sequence output, pooled CLS output)."""

    def __init__(self, cfg: ErnieConfig, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.cfg = cfg
        self.embeddings = ErnieEmbeddings(cfg, **kw)
        enc_layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout, activation="gelu",
            attn_dropout=cfg.attn_dropout, **kw)
        self.encoder = TransformerEncoder(enc_layer, cfg.num_layers)
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        self.pooler_act = Tanh()

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        mask = None
        if attention_mask is not None:
            # (B, S) -> additive (B, 1, 1, S) over heads and queries
            mask = (1.0 - attention_mask.float())[:, None, None, :] * -1e4
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        seq_out = self.encoder(x, mask)
        pooled = self.pooler_act(self.pooler(seq_out[:, 0]))
        return seq_out, pooled


class ErnieForSequenceClassification(nn.Module):
    def __init__(self, cfg: ErnieConfig, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.ernie = ErnieModel(cfg, device=device, generator=generator)
        self.dropout = Dropout(cfg.hidden_dropout)
        self.classifier = Linear(cfg.hidden_size, cfg.num_classes,
                                 device=device, generator=generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None):
        _, pooled = self.ernie(input_ids, token_type_ids,
                               position_ids=position_ids,
                               attention_mask=attention_mask)
        return self.classifier(self.dropout(pooled))
