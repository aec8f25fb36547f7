"""Attention, int8 and LoRA ops and the hand-written CUDA kernels' build."""
