"""Layers of the port (PyTorch modules with the reference's layouts)."""
from . import functional
from .layer.common import Dropout, Embedding, LayerNorm, Linear, Tanh
from .layer.transformer import (MultiHeadAttention, Transformer,
                                TransformerDecoder, TransformerDecoderLayer,
                                TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "Dropout", "Embedding", "LayerNorm", "Linear",
           "MultiHeadAttention", "Tanh", "Transformer", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer"]
