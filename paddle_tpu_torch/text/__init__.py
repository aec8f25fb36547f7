"""Text models and generation: the ERNIE encoders, the decoder step net
and the eager greedy oracle."""
from .generation import generate_eager
from .models import (ErnieConfig, ErnieEmbeddings,
                     ErnieForSequenceClassification, ErnieModel)

__all__ = ["generate_eager", "ErnieConfig", "ErnieEmbeddings",
           "ErnieForSequenceClassification", "ErnieModel"]
