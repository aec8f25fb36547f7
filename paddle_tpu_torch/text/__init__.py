"""Text models and generation: the ERNIE encoders, the decoder step net,
the eager greedy oracle and Viterbi decoding."""
from . import viterbi
from .generation import generate_eager
from .models import (ErnieConfig, ErnieEmbeddings, ErnieForPretraining,
                     ErnieForSequenceClassification, ErnieModel)
from .viterbi import viterbi_decode

__all__ = ["generate_eager", "ErnieConfig", "ErnieEmbeddings",
           "ErnieForPretraining", "ErnieForSequenceClassification",
           "ErnieModel", "viterbi", "viterbi_decode"]
