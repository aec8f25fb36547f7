"""Core helpers of the PyTorch port: shape buckets and device choice."""
from .bucketing import bucket_size, pad_prompt_row
from .device import resolve_device

__all__ = ["bucket_size", "pad_prompt_row", "resolve_device"]
