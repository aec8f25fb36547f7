"""Static-graph Executor: a block interpreted op by op on torch tensors
(the JAX package's `fluid/executor.py`).

Reference parity: fluid/executor.py:474 (Executor, run :915) and the C++
interpreter executor.cc:180/428. The JAX Executor traces the whole block
into one `jax.jit` with donated buffers; this one runs each op's lowering
(fluid/lowering.py) in program order, as executor.cc does:

  * each op's lowering is resolved once per (program uid, version, feed
    signature) into a plan, the counterpart of the JAX compile cache; an
    op with no lowering raises when the plan is made, before any op runs;
  * a `jax_autodiff` op re-runs its forward slice under autograd, so the
    plan leaves out of the first pass the forward ops that only that
    slice reads (their values are the re-run's), and no forward op runs
    twice in a training step;
  * persistables (parameters, optimizer state) live in the Scope as
    tensors on the Executor's device; after a run the updated values are
    copied into the Scope's tensors in place, after the fetches are read;
  * each run draws from seeds derived from (program.random_seed,
    program._seed_counter, the program's content tag), per op uid.

`Executor()` and `Executor(CUDAPlace(i))` run on the card
(`core.device.resolve_device`); only `Executor(CPUPlace())` (or
`paddle.set_device("cpu")`) runs on the CPU. With no card, the default
raises: it never falls back to the CPU.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.lod import LoDTensor
from ..core.place import CPUPlace, CUDAPinnedPlace, Place
from . import lowering
from .dtypes import dtype_name, to_torch
from .framework import default_main_program


class _ScopeVar:
    def __init__(self, scope, name):
        self._scope = scope
        self._name = name

    def get_tensor(self):
        return self

    # tensor-protocol shims (pybind tensor parity)
    def set(self, value, place=None):
        self._scope.set_value(self._name, np.asarray(value))

    def __array__(self, dtype=None, copy=None):
        arr = _to_numpy(self._scope._values[self._name])
        return arr.astype(dtype) if dtype else arr

    def shape(self):
        return list(self._scope._values[self._name].shape)


def _to_numpy(v):
    if torch.is_tensor(v):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


class Scope:
    """framework/scope.h:46 parity: name -> tensor map (flat)."""

    def __init__(self):
        self._values = {}

    def var(self, name):
        self._values.setdefault(name, None)
        return _ScopeVar(self, name)

    def find_var(self, name):
        if name in self._values:
            return _ScopeVar(self, name)
        return None

    def set_value(self, name, value):
        """Store a tensor (or a numpy array / number, placed on the device
        of the value it replaces, else the CPU)."""
        if not torch.is_tensor(value):
            old = self._values.get(name)
            arr = np.asarray(value)
            value = torch.from_numpy(np.ascontiguousarray(arr))
            if torch.is_tensor(old):
                value = value.to(old.device)
        self._values[name] = value

    def get_value(self, name):
        return self._values.get(name)

    def drop_kids(self):
        pass


_global_scope = Scope()


def global_scope():
    return _global_scope


def scope_guard(scope):
    @contextlib.contextmanager
    def guard():
        global _global_scope
        old = _global_scope
        _global_scope = scope
        try:
            yield
        finally:
            _global_scope = old

    return guard()


def place_device(place=None):
    """The torch device of an Executor's place: None (the card unless
    `paddle.set_device` named another), a Place, or a device string."""
    if place is None:
        return resolve_device(None)
    if isinstance(place, (CPUPlace, CUDAPinnedPlace)):
        return torch.device("cpu")
    if isinstance(place, Place):
        return resolve_device(f"cuda:{place.get_device_id()}")
    return resolve_device(place)


class _Plan:
    """One program signature's resolved run: (op, lowering) pairs of the
    first pass and the persistable names."""

    def __init__(self, program):
        blk = program.global_block()
        ops = [op for op in blk.ops if op.type not in ("feed", "fetch")]
        skip = _recomputed_ops(blk.ops)
        self.steps = [(op, lowering.get_lowering(op.type)) for op in ops
                      if id(op) not in skip]
        self.persist_names = [v.name for v in blk.vars.values()
                              if v.persistable]


def _autodiff_slice(fwd_ops, op):
    """Indices of the forward ops a jax_autodiff op re-runs (its backward
    slice from the targets, stopping at the params)."""
    pset = set(op.attrs["param_names"])
    loss_names = op.attrs.get("loss_names") or [op.attrs["loss_name"]]
    tgs = op.attrs.get("target_grad_names") or ()
    need = set(loss_names) | {g for g in tgs if g}
    keep = set()
    for i in range(len(fwd_ops) - 1, -1, -1):
        fop = fwd_ops[i]
        if fop.type in ("feed", "fetch"):
            continue
        if need & set(fop.output_arg_names):
            keep.add(i)
            need |= set(fop.input_arg_names) - pset
    return keep


def _recomputed_ops(ops):
    """ids of the forward ops whose values a later jax_autodiff op
    recomputes and adopts and that nothing before it reads: the first
    pass leaves them out (the JAX package's XLA dedupes the same
    overlap). An autodiff op with sparse params keeps its slice (it reads
    the ids from the first pass), and so does a program with several
    autodiff ops (one may read what another re-runs)."""
    skip = set()
    autodiffs = [a for a, op in enumerate(ops) if op.type == "jax_autodiff"]
    if len(autodiffs) != 1:
        return skip
    for a in autodiffs:
        op = ops[a]
        if op.attrs.get("sparse_param_names"):
            continue
        n_fwd = op.attrs["fwd_op_count"]
        traced = _autodiff_slice(ops[:n_fwd], op)
        for t in range(min(n_fwd, a) - 1, -1, -1):
            if t not in traced:
                continue
            outs = set(ops[t].output_arg_names)
            readers = [r for r in range(t + 1, a)
                       if outs & set(ops[r].input_arg_names)]
            if all(id(ops[r]) in skip for r in readers):
                skip.add(id(ops[t]))
    return skip


class Executor:
    def __init__(self, place=None):
        self.place = place
        self.device = place_device(place)
        self._cache = {}

    # ------------------------------------------------------------------
    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            feed_var_name="feed", fetch_var_name="fetch",
            return_numpy=True, use_program_cache=True):
        program = _unwrap(program or default_main_program())
        self._check_runnable(program)
        feed = feed or {}
        fetch_names = [f.name if hasattr(f, "name") else f
                       for f in (fetch_list or [])]
        scope = scope or _global_scope
        program._seed_counter += 1
        seed = lowering.mix_seed(program.random_seed or 0,
                                 program._seed_counter, program._rng_tag())
        return self._run_steps(program, feed, fetch_names, scope,
                               return_numpy, [seed], use_program_cache)

    def run_n(self, program=None, feed=None, fetch_list=None, n=1,
              scope=None, return_numpy=True):
        """Run the program n times with the same feed; the fetches come
        from the LAST step (the JAX `run_n`, whose steps are one jitted
        scan: here they are n runs of the plan, with one seed counter
        bump and a seed per step, and the fetches read once)."""
        program = _unwrap(program or default_main_program())
        self._check_runnable(program)
        feed = feed or {}
        fetch_names = [f.name if hasattr(f, "name") else f
                       for f in (fetch_list or [])]
        scope = scope or _global_scope
        program._seed_counter += 1
        base = lowering.mix_seed(program.random_seed or 0,
                                 program._seed_counter, program._rng_tag())
        seeds = [lowering.mix_seed(base, i) for i in range(max(int(n), 1))]
        return self._run_steps(program, feed, fetch_names, scope,
                               return_numpy, seeds, True)

    def _check_runnable(self, program):
        if getattr(program, "_run_hooks", ()):
            raise NotImplementedError(
                "Executor: a program with run hooks (the transpiler's PS "
                "push / pull) comes with ROADMAP item 8c")

    # ------------------------------------------------------------------
    def _run_steps(self, program, feed, fetch_names, scope, return_numpy,
                   seeds, use_cache):
        blk = program.global_block()
        feed_vals = self._materialize_feeds(blk, feed)
        sig = (program._uid, program._version,
               tuple(sorted((k, tuple(v.shape), str(v.dtype))
                            for k, v in feed_vals.items())))
        plan = self._cache.get(sig) if use_cache else None
        if plan is None:
            plan = _Plan(program)
            if use_cache:
                self._cache[sig] = plan
        persist = self._persistables(plan, scope)
        env = None
        with torch.no_grad():
            for seed in seeds:
                env = dict(persist)
                env.update(feed_vals)
                ctx = lowering.LowerCtx(env, seed, training=True,
                                        program=program,
                                        base_env={**persist, **feed_vals},
                                        device=self.device)
                for op, fn in plan.steps:
                    lowering.lower_op(ctx, op, fn)
                persist = {n: env[n] for n in plan.persist_names
                           if n in env}
            missing = [n for n in fetch_names if n not in env]
            if missing:
                raise KeyError(f"fetch vars {missing} were not computed by "
                               f"the program")
            if return_numpy:
                out = [_to_numpy(env[n]) for n in fetch_names]
            else:
                out = [env[n].clone() if torch.is_tensor(env[n]) else env[n]
                       for n in fetch_names]
            self._store(scope, persist)
        self.last_ops_run = len(plan.steps) * len(seeds)
        return out

    def _persistables(self, plan, scope):
        vals = {}
        for n in plan.persist_names:
            v = scope._values.get(n)
            if v is None:
                continue
            if not torch.is_tensor(v):
                v = torch.as_tensor(np.asarray(v))
            if v.device != self.device:
                v = v.to(self.device)
                scope._values[n] = v
            vals[n] = v
        return vals

    @staticmethod
    def _store(scope, new):
        """Write the run's persistables into the Scope: in place where the
        Scope's tensor has the same shape, dtype and device."""
        dst, src = [], []
        for n, v in new.items():
            old = scope._values.get(n)
            if v is old or not torch.is_tensor(v):
                continue
            if torch.is_tensor(old) and old.shape == v.shape and \
                    old.dtype == v.dtype and old.device == v.device:
                dst.append(old)
                src.append(v)
            else:
                scope._values[n] = v
        if dst:
            torch._foreach_copy_(dst, src)

    def _materialize_feeds(self, blk, feed):
        vals = {}
        for k, v in feed.items():
            want = blk.vars.get(k)
            if isinstance(v, LoDTensor) and v.lod_level > 0 or (
                    isinstance(v, tuple) and getattr(want, "lod_level", 0)):
                raise NotImplementedError(
                    f"feed {k!r} is a sequence (LoD) tensor: LoD feeds "
                    f"come with ROADMAP item 8b")
            dt = to_torch(want.dtype) if want is not None and \
                want.dtype is not None else None
            if torch.is_tensor(v):
                t = v
            else:
                arr = np.asarray(v)
                if dt is not None and dt != torch.bfloat16:
                    arr = arr.astype(dtype_name(want.dtype))
                t = torch.from_numpy(np.ascontiguousarray(arr))
            vals[k] = t.to(device=self.device, dtype=dt or t.dtype)
        return vals

    # legacy parity helpers ------------------------------------------------
    def close(self):
        pass

    def train_from_dataset(self, *args, **kwargs):
        raise NotImplementedError(
            "Executor.train_from_dataset: the dataset runner comes with "
            "ROADMAP item 8c")

    infer_from_dataset = train_from_dataset


def _unwrap(program):
    """A CompiledProgram's program (the Executor runs it transparently)."""
    inner = getattr(program, "_program", None)
    return inner if inner is not None else program
