"""Attention, int8 and LoRA ops and the hand-written CUDA kernels' build;
the sequence, structured-loss and detection op libraries."""
from . import detection, detection_train, sequence, sequence_losses  # noqa
