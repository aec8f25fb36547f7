"""Generation: the decoder step net and the eager greedy oracle."""
from .generation import generate_eager

__all__ = ["generate_eager"]
