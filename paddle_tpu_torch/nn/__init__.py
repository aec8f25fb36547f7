"""Layers of the port (PyTorch modules with the reference's layouts)."""
from . import functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer.common import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Dropout,
                           Embedding, LayerNorm, Linear, MaxPool2D, ReLU,
                           Sequential, Tanh)
from .layer.transformer import (MultiHeadAttention, Transformer,
                                TransformerDecoder, TransformerDecoderLayer,
                                TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "AdaptiveAvgPool2D", "BatchNorm2D",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Conv2D", "Dropout", "Embedding", "LayerNorm", "Linear",
           "MaxPool2D", "MultiHeadAttention", "ReLU", "Sequential", "Tanh", "Transformer",
           "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer"]
