"""Layer -> pure-function bridge (the JAX package's
`parallel/functional.py`), over `torch.func.functional_call`.

`fm = functionalize(layer)`; `out, new_buffers = fm.apply(params,
buffers, rng, *inputs)` runs the layer's forward on the given parameter
and buffer tensors instead of its own, and leaves the layer's state as it
was. Buffers that the forward updates in place (BatchNorm's running
stats) are updated on copies, returned as `new_buffers`. `rng` (a
torch.Generator or an int seed, or None) feeds every dropout of the call:
the layer's `Dropout`s draw their masks from it and its
`MultiHeadAttention`s their attention-dropout seeds, for that call only.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

__all__ = ["FunctionalModule", "functionalize"]


class FunctionalModule:
    def __init__(self, layer):
        self.layer = layer
        self.param_names = [n for n, _ in layer.named_parameters()]
        self.buffer_names = [n for n, b in layer.named_buffers()
                             if b is not None]

    def params(self) -> Dict[str, Any]:
        return dict(self.layer.named_parameters())

    def buffers(self) -> Dict[str, Any]:
        return {n: b for n, b in self.layer.named_buffers() if b is not None}

    def load(self, params=None, buffers=None):
        """Copy the given tensors into the layer's own state."""
        own = {**dict(self.layer.named_parameters()),
               **dict(self.layer.named_buffers())}
        with torch.no_grad():
            for tree in (params, buffers):
                for n, v in (tree or {}).items():
                    own[n].copy_(v)

    def _bind_rng(self, rng):
        """Point the dropouts at `rng`; returns the undo list."""
        from ..nn.layer.common import Dropout
        from ..nn.layer.transformer import MultiHeadAttention

        if rng is None:
            return []
        if not isinstance(rng, torch.Generator):
            seed = int(rng)
            rng = torch.Generator().manual_seed(seed)
        dev = next((p.device for p in self.layer.parameters()),
                   torch.device("cpu"))
        mask_gen = rng
        if dev.type != "cpu" or rng.device.type != "cpu":
            mask_gen = torch.Generator(device=dev).manual_seed(
                int(torch.randint(0, 2 ** 62, (), generator=rng)))
        undo = []
        for m in self.layer.modules():
            if isinstance(m, MultiHeadAttention):
                undo.append((m, "seed_generator", m.seed_generator))
                m.seed_generator = rng
            elif isinstance(m, Dropout):
                undo.append((m, "generator", m.generator))
                m.generator = mask_gen
        return undo

    def apply(self, params, buffers, rng, *inputs, training=True,
              unwrap=True, **kwargs):
        """Pure forward: (outputs, new buffers). `unwrap` is kept for the
        JAX signature (the port's outputs are tensors already)."""
        layer = self.layer
        was_training = layer.training
        layer.train(training)
        new_buffers = {n: b.clone() for n, b in (buffers or {}).items()}
        undo = self._bind_rng(rng)
        try:
            out = torch.func.functional_call(
                layer, ({**params}, new_buffers), tuple(inputs), kwargs,
                strict=False)
        finally:
            for m, attr, v in undo:
                setattr(m, attr, v)
            layer.train(was_training)
        return out, new_buffers

    def __call__(self, params, buffers, rng, *inputs, **kw):
        return self.apply(params, buffers, rng, *inputs, **kw)


def functionalize(layer) -> FunctionalModule:
    """fm = functionalize(net); out, new_bufs = fm.apply(fm.params(),
    fm.buffers(), rng, x)."""
    return FunctionalModule(layer)
