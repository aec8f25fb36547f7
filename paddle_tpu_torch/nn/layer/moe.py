"""Mixture-of-experts feed-forward with top-1 (switch) routing and
capacity-bounded dispatch (the JAX package's `nn/layer/moe.py`).

`MoELayer` computes the JAX layer's function on one device:

  * the router: probs = softmax(x @ router) over E experts, each token
    to its argmax (ties to the lower index, as jnp.argmax), gate =
    probs[t, e(t)];
  * capacity C = max(1, int(capacity_factor * tokens / E)) per forward
    call, tokens being every position of the batch (pads included);
  * each token's slot in its expert's queue in token order; a token past
    its expert's capacity is dropped: its output is 0 and its gate gets
    no gradient (the residual around the layer carries it);
  * y[t] = gate[t] * W_out[e] @ act(W_in[e] @ x[t]) (act gelu, or relu);
  * the Switch load-balance loss E * sum_e f_e * P_e (f_e the share of
    tokens whose argmax is e, which carries no gradient; P_e the mean
    router probability of e), exposed as `aux_loss` after each forward.

The JAX layer dispatches with dense one-hot einsums over a static
[tokens, E, C] tensor, the TPU's idiom. The port gathers and scatters by
index instead: each token's slot index is computed once (a scan along
each expert's row of an [E, tokens] one-hot), the [E, C, D] expert
inputs are one `index_select` of the token rows (empty slots read a zero
row), the expert products are two batched matmuls, and the combine is
one `index_select` of the slot rows times the gate. No [tokens, E, C] tensor is
built, no host sync is needed, and since each slot holds one token both
forms give the same numbers, forward and backward. Under a bf16 compute
type the JAX layer's float32 one-hot masks promote its dispatch and
expert products to float32; the port keeps them in the compute type.

The parameters keep the JAX paths: `router` [D, E], and the stacked
`experts.weight_in` [E, D, F] and `experts.weight_out` [E, F, D], all
Xavier-uniform with the JAX package's fans (a stacked weight is read as
OIHW, `nn.initializer`).

After each forward the layer also keeps its routing for inspection
(detached): `last_route` (each token's expert), `last_probs` (the router
probabilities), `last_load` (tokens routed to each expert) and
`last_dropped` (tokens past capacity).
"""
from __future__ import annotations

import torch

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["MoELayer"]


class _Experts(Layer):
    """The stacked expert weights; its path gives the
    `experts.weight_in` / `experts.weight_out` names."""

    def __init__(self, num_experts, d_model, d_ff, *, device=None,
                 generator=None):
        super().__init__(device=device, generator=generator)
        self.weight_in = self.create_parameter(
            [num_experts, d_model, d_ff],
            default_initializer=I.XavierUniform())
        self.weight_out = self.create_parameter(
            [num_experts, d_ff, d_model],
            default_initializer=I.XavierUniform())


class MoELayer(Layer):
    def __init__(self, d_model, d_ff, num_experts=2, capacity_factor=1.25,
                 activation="gelu", name=None, *, device=None,
                 generator=None):
        super().__init__(device=device, generator=generator)
        self.num_experts = int(num_experts)
        self.capacity_factor = float(capacity_factor)
        self.act = activation
        self.router = self.create_parameter(
            [d_model, self.num_experts],
            default_initializer=I.XavierUniform())
        self.experts = _Experts(self.num_experts, d_model, d_ff,
                                device=device, generator=generator)
        self.aux_loss = None
        self.last_route = self.last_probs = None
        self.last_load = self.last_dropped = None

    def __getstate__(self):
        # the last forward's aux loss and routing are no state (and the
        # aux loss, a graph node, cannot be copied)
        state = self.__dict__.copy()
        for k in ("aux_loss", "last_route", "last_probs", "last_load",
                  "last_dropped"):
            state[k] = None
        return state

    def capacity(self, tokens):
        return max(1, int(self.capacity_factor * tokens / self.num_experts))

    def forward(self, x):
        """x [B, S, D] -> [B, S, D]; sets `aux_loss`."""
        b, s, d = x.shape
        e = self.num_experts
        tokens = b * s
        cap = self.capacity(tokens)
        xf = x.reshape(tokens, d)

        probs = torch.softmax(xf @ self.router, -1)             # [T, E]
        route = torch.argmax(probs, -1)                         # [T]
        gate = probs.gather(1, route[:, None])[:, 0]            # [T]
        # expert-major one-hot [E, T]: the queue positions are a scan
        # along each expert's row (a scan down the token axis of [T, E]
        # runs 8 columns wide and took 0.7 ms a layer on the card)
        onehot = route[None] == torch.arange(e, device=x.device)[:, None]
        pos = torch.cumsum(onehot.long(), 1).gather(0, route[None])[0] - 1
        keep = pos < cap
        # slot e * C + pos for a kept token, the overflow slot E * C for
        # a dropped one; each real slot holds at most one token
        slot = torch.where(keep, route * cap + pos, e * cap)
        token_of_slot = torch.full((e * cap + 1,), tokens, dtype=torch.long,
                                   device=x.device).scatter(
            0, slot, torch.arange(tokens, device=x.device))[:e * cap]
        # index_select, whose backward adds each row once: the backward of
        # a tensor-indexed gather sorts its indices (1.6 ms a call there)
        zero = xf.new_zeros(1, d)
        expert_in = torch.cat([xf, zero]).index_select(
            0, token_of_slot).reshape(e, cap, d)
        h = torch.bmm(expert_in, self.experts.weight_in)       # [E, C, F]
        h = F.gelu(h) if self.act == "gelu" else F.relu(h)
        expert_out = torch.bmm(h, self.experts.weight_out)     # [E, C, D]
        rows = torch.cat([expert_out.reshape(e * cap, d), zero]).index_select(
            0, slot)
        out = rows * (gate * keep.to(gate.dtype))[:, None]

        # Switch load-balance loss: f_e from the argmax (no gradient)
        f_e = onehot.float().mean(1)
        p_e = probs.mean(0).float()
        self.aux_loss = (f_e * p_e).sum() * float(e)
        self.last_route, self.last_probs = route.detach(), probs.detach()
        self.last_load = onehot.sum(1).detach()
        self.last_dropped = (~keep).sum().detach()
        return out.reshape(b, s, d)
