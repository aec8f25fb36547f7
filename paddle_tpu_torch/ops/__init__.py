"""Attention ops and the hand-written CUDA kernels' build."""
