"""The sequence (LoD) builders (the JAX package's `fluid/layers/sequence_lod.py`).

They come with their lowerings in ROADMAP item 8b and raise until
then.
"""
from __future__ import annotations

from .control_flow import _waits

__all__ = [
    "sequence_pool", "sequence_first_step", "sequence_last_step",
    "sequence_softmax", "sequence_expand", "sequence_expand_as",
    "sequence_conv", "sequence_reverse", "sequence_slice",
    "sequence_concat", "sequence_reshape", "sequence_enumerate",
    "sequence_pad", "sequence_unpad", "sequence_scatter",
    "sequence_mask", "dynamic_lstm", "dynamic_gru",
]

sequence_pool = _waits("sequence_pool")
sequence_first_step = _waits("sequence_first_step")
sequence_last_step = _waits("sequence_last_step")
sequence_softmax = _waits("sequence_softmax")
sequence_expand = _waits("sequence_expand")
sequence_expand_as = _waits("sequence_expand_as")
sequence_conv = _waits("sequence_conv")
sequence_reverse = _waits("sequence_reverse")
sequence_slice = _waits("sequence_slice")
sequence_concat = _waits("sequence_concat")
sequence_reshape = _waits("sequence_reshape")
sequence_enumerate = _waits("sequence_enumerate")
sequence_pad = _waits("sequence_pad")
sequence_unpad = _waits("sequence_unpad")
sequence_scatter = _waits("sequence_scatter")
sequence_mask = _waits("sequence_mask")
dynamic_lstm = _waits("dynamic_lstm")
dynamic_gru = _waits("dynamic_gru")
