"""Continuous-batching generation engine over a fixed slot pool.

Iteration-level batching as in the JAX package (`serving/engine.py`):
the pool owns S cache slots (per-layer [S, H, max_len, D] K/V buffers
with per-row write indices, pooled cross-attention K/V and pad-bias
rows); one batched decode step runs over all slots with an active mask;
a free slot is refilled by prefilling the new prompt (bucketed to a
power of two) straight into the slot's pool rows.

Numerics contract: every slot reproduces `generate_eager` for its own
prompt token for token. All per-slot operations are row-wise, so
co-resident requests cannot perturb each other's output.

This slice serves the dense pool on one card. The paged pool, the
speculative stepper, LoRA adapters, int8 weights and chunked prefill
are later slices and are refused at construction.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.bucketing import bucket_size, pad_prompt_row
from ..core.device import resolve_device
from .layers import DenseLayout, PlainStepper, SinglePlacement
from .metrics import ServingMetrics

__all__ = ["ServingEngine"]

#: engine options of the JAX package that later slices of the port bring
_LATER = {"paged": "the paged-pool slice (kernels #6-7)",
          "spec_k": "the speculative-decoding slice (kernel #5)",
          "adapters": "the int8/LoRA slice (kernels #8-9)",
          "quantize": "the int8/LoRA slice (kernels #8-9)",
          "prefill_chunk": "the traffic-shaping slice"}


class _EngineBase:
    """Slot lifecycle and the per-iteration orchestration. One
    `run_iteration(scheduler)` is the continuous-batching unit: (1)
    cancelled / past-deadline requests leave their slots with partial
    output; (2) up to `max_joins_per_iter` queued requests prefill into
    free slots; (3) one batched decode step over the active mask. Not
    thread-safe: drive it from one thread (the `ServingServer` loop or a
    synchronous drain)."""

    def __init__(self, num_slots, *, max_joins_per_iter=2, metrics=None,
                 clock=time.monotonic):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self.num_slots = int(num_slots)
        self.max_joins_per_iter = int(max_joins_per_iter)
        self.clock = clock
        self.metrics = metrics if metrics is not None else \
            ServingMetrics(clock=clock)
        self.slots = [None] * self.num_slots   # Request | None

    def admit_check(self, request):
        """Raise ValueError for requests this pool can never serve."""

    def _join(self, slot, request):
        raise NotImplementedError

    def _decode_step(self, active):
        raise NotImplementedError

    def _reset_pool(self):
        """Rebuild device pool state after a decode-step failure."""

    def occupancy(self):
        return sum(r is not None for r in self.slots)

    def _finish_slot(self, s, reason, now):
        r = self.slots[s]
        self.slots[s] = None
        self.metrics.record_finish(reason)
        r.finish(reason, now)

    def _fail_active(self, exc):
        """A decode step failed: the batched step is all-or-nothing, so
        every in-flight request ends with its partial tokens and the
        cause, the pool is rebuilt, and serving continues."""
        now = self.clock()
        for s, r in enumerate(self.slots):
            if r is None:
                continue
            self.slots[s] = None
            self.metrics.record_finish("error")
            r.finish("error", now, error=exc)
        self._reset_pool()

    def _deliver(self, r, tok, now):
        if r.state == "DONE":
            return
        r.tokens.append(tok)
        self.metrics.record_token()
        if r.first_token_at is None:
            r.first_token_at = now
            if r.submitted_at is not None:
                self.metrics.record_first_token(now - r.submitted_at)
        if r.stream_cb is not None:
            try:
                r.stream_cb(r, tok)
            except Exception as e:
                # a broken streaming callback must not stall the pool;
                # the failure is recorded, never swallowed
                self.metrics.record_error("stream_cb", e)
        if r.eos_id is not None and tok == r.eos_id:
            self._finish_slot(r.slot, "eos", now)
        elif len(r.tokens) >= r.max_new_tokens:
            self._finish_slot(r.slot, "length", now)

    def run_iteration(self, scheduler):
        """One iteration: harvest, admit, decode. Returns True when any
        work was done (False = idle)."""
        now = self.clock()
        progress = False
        for s, r in enumerate(self.slots):
            if r is None:
                continue
            if r.cancelled:
                self._finish_slot(s, "cancelled", now)
                progress = True
            elif r.expired(now):
                self._finish_slot(s, "timeout", now)
                progress = True

        def _queue_death(req):   # cancelled / expired while queued
            self.metrics.record_finish(req.finish_reason)

        joins = 0
        tok0s = []   # (request, device token 0), synced after the loop
        while joins < self.max_joins_per_iter:
            free = [i for i, r in enumerate(self.slots) if r is None]
            if not free:
                break
            r = scheduler.pop_ready(now, on_dead=_queue_death)
            if r is None:
                break
            try:
                self.admit_check(r)
            except ValueError as e:
                self.metrics.record_error("admit", e)
                r.fail(e, now)
                self.metrics.record_finish("error")
                continue
            s = free[0]
            r.state, r.slot = "RUNNING", s
            self.slots[s] = r
            try:
                tok = self._join(s, r)
            except Exception as e:
                # per-request isolation: the failed join fails THIS
                # request and frees its slot; the join's writes were
                # slot-local, so the pool keeps serving
                self.slots[s] = None
                r.slot = None
                self.metrics.record_error("slot_join", e)
                r.fail(e, self.clock())
                self.metrics.record_finish("error")
                progress = True
                continue
            joins += 1
            progress = True
            self.metrics.record_join()
            tok0s.append((r, tok))
        if tok0s:
            # one host sync for the whole admission round's first tokens
            firsts = torch.stack([t for _, t in tok0s]).cpu().tolist()
            for (r, _), tok in zip(tok0s, firsts):
                self._deliver(r, int(tok), self.clock())
        active = np.asarray([r is not None for r in self.slots], bool)
        if active.any():
            t0 = self.clock()
            try:
                toks = self._decode_step(active)
            except Exception as e:
                self.metrics.record_error("decode_step", e)
                self._fail_active(e)
                progress = True
            else:
                now2 = self.clock()
                n = 0
                for s, r in enumerate(list(self.slots)):
                    if r is not None and active[s]:
                        self._deliver(r, int(toks[s]), now2)
                        n += 1
                self.metrics.record_decode(n, now2 - t0)
                progress = True
        self.metrics.record_iteration(scheduler.depth(),
                                      self.occupancy() / self.num_slots)
        return progress

    def serve_until_idle(self, scheduler, max_iterations=None):
        """Synchronous drive: iterate until queue and pool are empty."""
        it = 0
        while scheduler.depth() > 0 or self.occupancy() > 0:
            self.run_iteration(scheduler)
            it += 1
            if max_iterations is not None and it >= max_iterations:
                raise RuntimeError(f"serve_until_idle: no convergence "
                                   f"after {it} iterations")

    def abort_active(self, reason, now=None):
        """Finalize every in-flight request (non-drain shutdown); partial
        tokens are delivered."""
        if now is None:
            now = self.clock()
        for s, r in enumerate(self.slots):
            if r is not None:
                self._finish_slot(s, "cancelled" if r.cancelled else reason,
                                  now)


class ServingEngine(_EngineBase):
    """The model-backed engine: a (decoder, embed, project) triple over a
    pooled StaticKVCache of `num_slots` rows x `max_len` positions on
    `device` (None means the CUDA card; the model must already live
    there). On CUDA every attention runs through the flash-forward and
    flash-decode kernels, and float32 matmuls are kept at full precision
    (`torch.backends.cuda.matmul.allow_tf32 = False`).

    Admission contract: a request needs `bucket(prompt_len) +
    max_new_tokens <= max_len` cache positions and a cross-attention
    memory of the pool's [M, D] shape (fixed by the first join). Prompt
    at positions [0, Pb), its pad hole key-masked forever, generated
    tokens at Pb, Pb + 1, ..."""

    def __init__(self, decoder, embed, project, *, num_slots=8,
                 max_len=128, max_joins_per_iter=2, metrics=None,
                 clock=time.monotonic, device=None, paged=False,
                 spec_k=None, adapters=None, quantize=None,
                 prefill_chunk=None):
        later = {"paged": paged, "spec_k": spec_k, "adapters": adapters,
                 "quantize": quantize, "prefill_chunk": prefill_chunk}
        for name, value in later.items():
            if value:
                raise NotImplementedError(
                    f"ServingEngine({name}=...) is not ported yet: it comes "
                    f"with {_LATER[name]}")
        super().__init__(num_slots, max_joins_per_iter=max_joins_per_iter,
                         metrics=metrics, clock=clock)
        from ..text.generation import _StepNet

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        self._net = _StepNet(decoder, embed, project).eval()
        for name, p in self._net.named_parameters():
            if p.device != self.device:
                raise ValueError(f"parameter {name} lives on {p.device}, "
                                 f"the engine serves on {self.device}")
        self.max_len = int(max_len)
        self._pool_len = self.max_len
        self.layout = DenseLayout(self)
        self.placement = SinglePlacement(self)
        self.stepper = PlainStepper(self)
        self._state = None          # built on the first join
        self._mem_shape = None

    def admit_check(self, r):
        P = max(1, int(r.prompt.shape[0]))
        Pb = bucket_size(P)
        if Pb + r.max_new_tokens > self.max_len:
            raise ValueError(f"request needs bucket({P})={Pb} prompt slots "
                             f"+ {r.max_new_tokens} decode slots > pool "
                             f"max_len {self.max_len}")
        if r.memory is None or r.memory.dim() != 2:
            raise ValueError("ServingEngine requests need a 2-D "
                             "cross-attention memory [M, D]")
        if self._mem_shape is not None and \
                tuple(r.memory.shape) != self._mem_shape:
            raise ValueError(f"memory shape {tuple(r.memory.shape)} != "
                             f"pool's {self._mem_shape} (fixed by the first "
                             f"join)")

    def _ensure_state(self, memory):
        if self._state is None:
            self._state = self.placement.run(self.layout.build_state,
                                             memory)
            self._mem_shape = tuple(memory.shape)

    def _join(self, s, r):
        pad_id = int(r.eos_id) if r.eos_id is not None else 0
        prompt_b, P0, _ = pad_prompt_row(r.prompt, pad_id)
        memory = r.memory.to(self.device)
        self._ensure_state(memory)
        prompt = torch.as_tensor(prompt_b, device=self.device)
        return self.placement.run(self.layout.join, s, prompt, P0,
                                  memory[None])

    def _decode_step(self, active):
        return self.stepper.decode(active)

    def _reset_pool(self):
        # every slot is empty by now: the next join rebuilds a zeroed pool
        self._state = None
