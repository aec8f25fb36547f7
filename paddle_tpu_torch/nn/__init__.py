"""Layers of the port (Paddle's `nn`, the JAX package's `nn/__init__.py`):
`Layer` and `ParamAttr`, `initializer`, `functional`, the layers, the
RNNs, `MoELayer`, `SyncBatchNorm` and the gradient clips."""
from torch.nn import Parameter

from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer.common import (AdaptiveAvgPool2D, AdaptiveMaxPool2D, AlphaDropout,
                           AvgPool1D, AvgPool2D, BatchNorm, BatchNorm1D,
                           BatchNorm2D, BatchNorm3D, BCELoss,
                           BCEWithLogitsLoss, Bilinear, Conv1D, Conv2D,
                           Conv2DTranspose, CosineSimilarity,
                           CrossEntropyLoss, Dropout, Dropout2D, ELU,
                           Embedding, Flatten, GELU, GroupNorm, Hardshrink,
                           Hardsigmoid, Hardswish, Hardtanh, Identity,
                           InstanceNorm2D, KLDivLoss, L1Loss, LayerDict,
                           LayerList, LayerNorm, LeakyReLU, Linear,
                           LocalResponseNorm, LogSigmoid, LogSoftmax,
                           MarginRankingLoss, Maxout, MaxPool1D, MaxPool2D,
                           Mish, MSELoss, NLLLoss, Pad2D, ParameterList,
                           PixelShuffle, PReLU, ReLU, ReLU6, RMSNorm, SELU,
                           Sequential, Sigmoid, Silu, SmoothL1Loss, Softmax,
                           Softplus, Softshrink, Softsign, SpectralNorm,
                           Swish, SyncBatchNorm, Tanh, Tanhshrink, Unfold,
                           Upsample, UpsamplingBilinear2D,
                           UpsamplingNearest2D)
from .layer.layers import HookRemoveHelper, Layer, ParamAttr
from .layer.moe import MoELayer
from .layer.rnn import (GRU, GRUCell, LSTM, LSTMCell, RNN, RNNCellBase,
                        SimpleRNN, SimpleRNNCell)
from .layer.transformer import (MultiHeadAttention, Transformer,
                                TransformerDecoder, TransformerDecoderLayer,
                                TransformerEncoder, TransformerEncoderLayer)

__all__ = [
    "functional", "initializer", "Parameter", "Layer", "ParamAttr",
    "HookRemoveHelper", "ClipGradByGlobalNorm", "ClipGradByNorm",
    "ClipGradByValue", "AdaptiveAvgPool2D", "AdaptiveMaxPool2D",
    "AlphaDropout", "AvgPool1D", "AvgPool2D", "BatchNorm", "BatchNorm1D",
    "BatchNorm2D", "BatchNorm3D", "BCELoss", "BCEWithLogitsLoss",
    "Bilinear", "Conv1D", "Conv2D", "Conv2DTranspose", "CosineSimilarity",
    "CrossEntropyLoss", "Dropout", "Dropout2D", "ELU", "Embedding",
    "Flatten", "GELU", "GroupNorm", "Hardshrink", "Hardsigmoid",
    "Hardswish", "Hardtanh", "Identity", "InstanceNorm2D", "KLDivLoss",
    "L1Loss", "LayerDict", "LayerList", "LayerNorm", "LeakyReLU", "Linear",
    "LocalResponseNorm", "LogSigmoid", "LogSoftmax", "MarginRankingLoss",
    "Maxout", "MaxPool1D", "MaxPool2D", "Mish", "MSELoss", "NLLLoss",
    "Pad2D", "ParameterList", "PixelShuffle", "PReLU", "ReLU", "ReLU6",
    "RMSNorm", "SELU", "Sequential", "Sigmoid", "Silu", "SmoothL1Loss",
    "Softmax", "Softplus", "Softshrink", "Softsign", "SpectralNorm",
    "Swish", "SyncBatchNorm", "Tanh", "Tanhshrink", "Unfold", "Upsample",
    "UpsamplingBilinear2D", "UpsamplingNearest2D", "MoELayer", "GRU",
    "GRUCell", "LSTM", "LSTMCell", "RNN", "RNNCellBase", "SimpleRNN",
    "SimpleRNNCell", "MultiHeadAttention", "Transformer",
    "TransformerDecoder", "TransformerDecoderLayer", "TransformerEncoder",
    "TransformerEncoderLayer", "utils_spectral_norm"]


def utils_spectral_norm(*a, **k):
    """Raises, as the JAX package's does (`nn.SpectralNorm` is the layer
    form)."""
    raise NotImplementedError(
        "utils_spectral_norm is not implemented (the JAX package's raises "
        "too); use nn.SpectralNorm")
