"""ERNIE / BERT-family encoders (the JAX package's `text/models.py`).

The module tree and parameter names match the JAX package's
(`ernie.embeddings.word_embeddings.weight`,
`ernie.encoder.layers.0.self_attn.q_proj.weight`, ...), so
`convert.from_jax_state` loads a JAX `state_dict()` as it stands.
Attention runs through the flash kernels with in-kernel attention
dropout in training, over padded rows (a key bias) or packed rows
(segment ids, per-sequence CLS indices). `ErnieForPretraining` adds the
masked-LM head (Linear -> gelu -> LayerNorm, decoded against the word
embeddings: ``h @ W_emb.T``, no bias) and the next-sentence head.

`ErnieConfig(moe_experts=E, moe_capacity_factor=c)` with E > 0 puts a
top-1 `MoELayer` (`nn/layer/moe.py`) in place of the feed-forward of
every encoder layer, as the JAX package does (Switch Transformers puts
one in every other layer; the port keeps the JAX model). Each MoE layer
sets its load-balance `aux_loss` every forward; `SpmdTrainer(...,
moe_aux_weight=0.01)` adds `moe_aux_weight` times their sum to each
micro-batch's loss. This covers `ErnieForSequenceClassification` and
`ErnieForPretraining`.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.device import resolve_device
from ..nn import functional as F
from ..nn.layer.common import Dropout, Embedding, LayerNorm, Linear, Tanh
from ..nn.layer.transformer import TransformerEncoder, TransformerEncoderLayer

__all__ = ["ErnieConfig", "ErnieEmbeddings", "ErnieModel",
           "ErnieForSequenceClassification", "ErnieForPretraining",
           "ernie_base", "ernie_tiny"]


class ErnieConfig:
    def __init__(self, vocab_size=18000, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072, max_position=513,
                 type_vocab_size=2, hidden_dropout=0.1, attn_dropout=0.1,
                 num_classes=2, moe_experts=0, moe_capacity_factor=1.25):
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
        # moe_experts > 0: every encoder feed-forward is a top-1 MoELayer
        self.moe_experts = moe_experts
        self.moe_capacity_factor = moe_capacity_factor

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
    path). Returns (sequence output, pooled CLS output).

    Packed varlen feeds (LoD-native fine-tuning): pass the fields of
    `core.lod.pack_padded` instead of a padded batch: `input_ids` =
    packed.data, `position_ids` = packed.positions, `attn_segment_ids`
    = packed.segment_ids and `cls_flat_index` = packed.cls_flat_index(),
    which pools each SEQUENCE's first token from the flattened
    [rows * row_len, H] view (several sequences share a row). No
    attention_mask is needed: pads form their own segment, and the
    segment ids ride the flash kernels' segment branch."""

    def __init__(self, cfg: ErnieConfig, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.cfg = cfg
        self.embeddings = ErnieEmbeddings(cfg, **kw)
        enc_layer = TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout, activation="gelu",
            attn_dropout=cfg.attn_dropout, moe_experts=cfg.moe_experts,
            moe_capacity_factor=cfg.moe_capacity_factor, **kw)
        self.encoder = TransformerEncoder(enc_layer, cfg.num_layers)
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        self.pooler_act = Tanh()

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, attn_segment_ids=None,
                cls_flat_index=None):
        mask = None
        if attention_mask is not None:
            # (B, S) -> additive (B, 1, 1, S) over heads and queries
            mask = (1.0 - attention_mask.float())[:, None, None, :] * -1e4
        if attn_segment_ids is not None:
            # int32 on the device once, not in every layer
            attn_segment_ids = torch.as_tensor(
                attn_segment_ids, device=input_ids.device).to(torch.int32)
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        seq_out = self.encoder(x, mask, segment_ids=attn_segment_ids)
        if cls_flat_index is not None:
            b, s, hdim = seq_out.shape
            index = torch.as_tensor(cls_flat_index, device=seq_out.device)
            cls_tok = seq_out.reshape(b * s, hdim).index_select(
                0, index.long())
        else:
            cls_tok = seq_out[:, 0]
        pooled = self.pooler_act(self.pooler(cls_tok))
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
                position_ids=None, attn_segment_ids=None,
                cls_flat_index=None):
        _, pooled = self.ernie(input_ids, token_type_ids,
                               position_ids=position_ids,
                               attention_mask=attention_mask,
                               attn_segment_ids=attn_segment_ids,
                               cls_flat_index=cls_flat_index)
        return self.classifier(self.dropout(pooled))


class ErnieForPretraining(nn.Module):
    """ERNIE with its pretraining heads: returns (mlm_logits [B, S,
    vocab], nsp_logits [B, 2]). The masked-LM decoder is tied to the
    word embeddings (it brings no weight of its own). On a tp mesh, where
    the table is split over vocabulary rows, each rank computes the logits
    of its rows and they are gathered into the whole vocabulary, so the
    loss is the one-rank loss."""

    def __init__(self, cfg: ErnieConfig, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.ernie = ErnieModel(cfg, **kw)
        self.mlm_transform = Linear(cfg.hidden_size, cfg.hidden_size, **kw)
        self.mlm_norm = LayerNorm(cfg.hidden_size, device=device)
        self.nsp = Linear(cfg.hidden_size, 2, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq_out, pooled = self.ernie(input_ids, token_type_ids,
                                     attention_mask=attention_mask)
        h = self.mlm_norm(F.gelu(self.mlm_transform(seq_out)))
        table = self.ernie.embeddings.word_embeddings
        group = getattr(table, "_group", None)
        if group is None:
            mlm_logits = h @ table.weight.T
        else:
            # a table split over vocabulary rows (tp): this rank's logit
            # columns, gathered into the whole vocabulary; h's gradient
            # sums the ranks' columns' parts, and the tied table's rows
            # get the gradient of their own columns
            from ..parallel.collectives import copy_to, gather_from

            mlm_logits = gather_from(copy_to(h, group) @ table.weight.T,
                                     group, -1, table._ranks)
        return mlm_logits, self.nsp(pooled)


def ernie_base(*, device=None, generator=None, **kw):
    """ErnieModel at base width (`ErnieConfig.base(**kw)`) on `device`
    (None: the card)."""
    return ErnieModel(ErnieConfig.base(**kw), device=device,
                      generator=generator)


def ernie_tiny(*, device=None, generator=None, **kw):
    """ErnieModel at the tiny test width (`ErnieConfig.tiny(**kw)`)."""
    return ErnieModel(ErnieConfig.tiny(**kw), device=device,
                      generator=generator)
