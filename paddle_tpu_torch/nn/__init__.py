"""Layers of the port (PyTorch modules with the reference's layouts)."""
from . import functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer.common import (AdaptiveAvgPool2D, AdaptiveMaxPool2D, AvgPool1D,
                           AvgPool2D, BatchNorm, BatchNorm1D, BatchNorm2D,
                           BatchNorm3D, Conv2D, Conv2DTranspose,
                           CrossEntropyLoss, Dropout, Embedding, Flatten,
                           Identity, LayerNorm, Linear, MaxPool1D, MaxPool2D,
                           MSELoss, ReLU, ReLU6, Sequential, Tanh)
from .layer.transformer import (MultiHeadAttention, Transformer,
                                TransformerDecoder, TransformerDecoderLayer,
                                TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "AdaptiveAvgPool2D", "AdaptiveMaxPool2D",
           "AvgPool1D", "AvgPool2D", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "Conv2D", "Conv2DTranspose",
           "CrossEntropyLoss", "Dropout", "Embedding", "Flatten", "Identity",
           "LayerNorm", "Linear", "MaxPool1D", "MaxPool2D", "MSELoss",
           "MultiHeadAttention", "ReLU", "ReLU6", "Sequential", "Tanh",
           "Transformer", "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer"]
