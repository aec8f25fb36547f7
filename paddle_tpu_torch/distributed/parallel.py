"""Dygraph `DataParallel` (the JAX package's `distributed/parallel.py`;
reference: fluid/dygraph/parallel.py, `scale_loss` and the coalesced
bucket all-reduce of `apply_collective_grads`).

`scale_loss` divides the loss by the world's size; after the backward,
`apply_collective_grads` sums each gradient over the world in buckets
of `comm_buffer_size_mb`, each bucket flattened in float32 and split
back into the gradients' own types: the mean gradient of the replicas.
A one-process world leaves both alone.
"""
from __future__ import annotations

import torch
from torch import nn

from . import all_reduce, get_world_size

__all__ = ["DataParallel"]


class DataParallel(nn.Module):
    def __init__(self, layers, strategy=None, comm_buffer_size_mb=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self._comm_buffer_bytes = int(comm_buffer_size_mb * 1024 * 1024)
        self._group = group

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def scale_loss(self, loss):
        world = get_world_size(self._group)
        return loss if world == 1 else loss / world

    def buckets(self):
        """The parameters with a gradient, grouped into buckets of at
        most `comm_buffer_size_mb` (a larger gradient alone)."""
        out, bucket, size = [], [], 0
        for p in self._layers.parameters():
            if p.grad is None:
                continue
            nbytes = p.grad.numel() * p.grad.element_size()
            if bucket and size + nbytes > self._comm_buffer_bytes:
                out.append(bucket)
                bucket, size = [], 0
            bucket.append(p)
            size += nbytes
        if bucket:
            out.append(bucket)
        return out

    def apply_collective_grads(self):
        """One all-reduce (sum) a bucket: the float32 concatenation of its
        gradients, split back in place."""
        if get_world_size(self._group) == 1:
            return
        for bucket in self.buckets():
            flat = torch.cat([p.grad.reshape(-1).float() for p in bucket])
            all_reduce(flat, group=self._group)
            ofs = 0
            for p in bucket:
                n = p.grad.numel()
                p.grad.copy_(flat[ofs:ofs + n].view_as(p.grad))
                ofs += n

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.load_state_dict(*a, **k)

    def parameters(self, recurse=True):
        return self._layers.parameters(recurse)
