"""Static-graph Program IR (the JAX package's `fluid/framework.py`).

Reference parity: python/paddle/fluid/framework.py (Variable :889, Operator
:1881, Block :2472, Program :3934, Parameter :5053) over framework.proto
(OpDesc :42, VarType :104, BlockDesc :174). The IR is host Python and the
same as the JAX package's, so a program built here carries the same names,
attrs and wire bytes; the port's Executor (fluid/executor.py) interprets a
block op by op on torch tensors.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import itertools
import pickle

import numpy as np

from .dtypes import convert_dtype, dtype_name


class _UniqueNames:
    def __init__(self):
        self.ids = collections.defaultdict(int)

    def generate(self, prefix):
        self.ids[prefix] += 1
        return f"{prefix}_{self.ids[prefix] - 1}"


_unique = _UniqueNames()


class unique_name:
    @staticmethod
    def generate(prefix):
        return _unique.generate(prefix)

    @staticmethod
    @contextlib.contextmanager
    def guard(new_generator=None):
        global _unique
        old = _unique
        _unique = _UniqueNames()
        try:
            yield
        finally:
            _unique = old


class Variable:
    def __init__(self, block, name=None, shape=None, dtype=None,
                 persistable=False, stop_gradient=True, is_data=False,
                 lod_level=0, trainable=False, **kw):
        self.block = block
        self.name = name or unique_name.generate("var")
        self.shape = list(shape) if shape is not None else []
        self.dtype = convert_dtype(dtype) if dtype is not None else None
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.lod_level = lod_level
        self.trainable = trainable
        self.op = None  # producing operator

    @property
    def ndim(self):
        return len(self.shape)

    def __repr__(self):
        return (f"Var({self.name}, shape={self.shape}, "
                f"dtype={dtype_name(self.dtype)}, "
                f"persistable={self.persistable})")

    # sugar so static vars compose like tensors in layer code
    def _binop(self, other, op_type, reverse=False):
        from .layers.math_ops import _elementwise

        return _elementwise(op_type, self, other, reverse)

    def __add__(self, o):
        return self._binop(o, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "elementwise_sub")

    def __rsub__(self, o):
        return self._binop(o, "elementwise_sub", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "elementwise_div")

    def __mod__(self, o):
        return self._binop(o, "elementwise_mod")

    def __floordiv__(self, o):
        return self._binop(o, "elementwise_floordiv")

    def __neg__(self):
        return self._binop(-1.0, "elementwise_mul")

    def __lt__(self, o):
        from .layers.control_flow import less_than

        return less_than(self, o)

    def __le__(self, o):
        from .layers.control_flow import less_equal

        return less_equal(self, o)

    def __gt__(self, o):
        from .layers.control_flow import greater_than

        return greater_than(self, o)

    def __ge__(self, o):
        from .layers.control_flow import greater_equal

        return greater_equal(self, o)

    def __matmul__(self, o):
        from .layers.nn import matmul

        return matmul(self, o)

    def astype(self, dtype):
        from .layers.tensor import cast

        return cast(self, dtype)


class Parameter(Variable):
    def __init__(self, block, shape, dtype, **kw):
        kw.setdefault("persistable", True)
        kw.setdefault("stop_gradient", False)
        kw.setdefault("trainable", True)
        super().__init__(block, shape=shape, dtype=dtype, **kw)
        self.optimize_attr = kw.get("optimize_attr",
                                    {"learning_rate": 1.0})
        self.regularizer = kw.get("regularizer")
        self.initializer = kw.get("initializer")


_PKG_DIR = None


def _user_callstack(limit=6):
    """Trimmed creation traceback for an op, excluding frames inside the
    framework itself — the user-code attribution the reference records per
    OpDesc (framework/op_call_stack.cc). Returns FrameSummary objects;
    formatting (source-line loading) is deferred to the error path."""
    global _PKG_DIR
    if _PKG_DIR is None:
        import os

        _PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    import sys
    import traceback

    f = sys._getframe(2)
    frames = traceback.StackSummary.extract(
        traceback.walk_stack(f), limit=32, lookup_lines=False)
    frames.reverse()  # walk_stack yields innermost-first
    user = [fr for fr in frames if not fr.filename.startswith(_PKG_DIR)]
    return list(user[-limit:])


class Operator:
    _uid_counter = itertools.count(1)

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        # stable identity for the random draws: a lowering seeds its
        # generator from this (not a run-order counter), so the pruned
        # re-run of jax_autodiff reproduces the forward pass's masks.
        # PROGRAM-local (not process-global): a program's random draws —
        # weight init above all — must not depend on how many ops other
        # programs created earlier in the process (reference random_seed
        # reproducibility; a process-global counter made convergence
        # tests order-sensitive).
        prog = getattr(block, "program", None)
        if prog is not None and hasattr(prog, "_next_op_uid"):
            self._uid = prog._next_op_uid
            prog._next_op_uid += 1
        else:
            self._uid = next(Operator._uid_counter)
        # canonical form: {slot: [var names]}
        self.inputs = {}
        for k, v in (inputs or {}).items():
            vs = v if isinstance(v, (list, tuple)) else [v]
            self.inputs[k] = [x.name if isinstance(x, Variable) else x
                              for x in vs]
        self.outputs = {}
        for k, v in (outputs or {}).items():
            vs = v if isinstance(v, (list, tuple)) else [v]
            self.outputs[k] = [x.name if isinstance(x, Variable) else x
                               for x in vs]
        self.attrs = dict(attrs or {})
        if "op_callstack" not in self.attrs:
            stack = _user_callstack()
            if stack:
                self.attrs["op_callstack"] = stack
        # device_guard annotation (framework.py:5516 op_device attr) — the
        # hook PipelineOptimizer's program splitter cuts stages on
        if "op_device" not in self.attrs:
            dev = current_device_annotation()
            if dev is not None:
                self.attrs["op_device"] = dev

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    @property
    def output_arg_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def attr(self, name):
        return self.attrs.get(name)

    def _set_attr(self, name, val):
        self.attrs[name] = val
        self.block.program._bump()

    def __repr__(self):
        return f"Op({self.type}, in={self.inputs}, out={self.outputs})"


class Block:
    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = collections.OrderedDict()
        self.ops = []

    def create_var(self, name=None, **kw):
        if name and name in self.vars:
            return self.vars[name]
        v = Variable(self, name=name, **kw)
        self.vars[v.name] = v
        return v

    def create_parameter(self, name=None, shape=None, dtype=None, **kw):
        p = Parameter(self, shape=shape, dtype=dtype, **{"name": name, **kw})
        self.vars[p.name] = p
        return p

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            if self.parent_idx >= 0:
                return self.program.block(self.parent_idx).var(name)
            raise ValueError(f"var {name!r} not found in block {self.idx}")
        return v

    def has_var(self, name):
        if name in self.vars:
            return True
        if self.parent_idx >= 0:
            return self.program.block(self.parent_idx).has_var(name)
        return False

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        for vs in (outputs or {}).values():
            vs = vs if isinstance(vs, (list, tuple)) else [vs]
            for v in vs:
                if isinstance(v, Variable):
                    v.op = op
        self.program._bump()
        return op

    def _insert_op(self, index, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self.program._bump()
        return op

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def __repr__(self):
        lines = [f"Block {self.idx}:"]
        for v in self.vars.values():
            lines.append(f"  {v!r}")
        for op in self.ops:
            lines.append(f"  {op!r}")
        return "\n".join(lines)


class Program:
    _uid_counter = itertools.count()

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.random_seed = 0
        # monotonic identity for executor caches: id(program) can alias a
        # GC'd-and-reallocated Program, a uid cannot
        self._uid = next(Program._uid_counter)
        # per-program op identity stream (rng key derivation): fresh per
        # program so draws don't depend on process history (plain int:
        # deepcopy-able, unlike itertools.count)
        self._next_op_uid = 1
        self._version = 0
        self._seed_counter = 0
        # parity attrs
        self._is_distributed = False
        self._is_startup = False
        self.lr_scheduler = None

    def __deepcopy__(self, memo):
        p = self.__class__.__new__(self.__class__)
        memo[id(self)] = p
        for k, v in self.__dict__.items():
            setattr(p, k, copy.deepcopy(v, memo))
        p._uid = next(Program._uid_counter)
        return p

    def _bump(self):
        self._version += 1

    def _rng_tag(self):
        """Stable content fingerprint folded into the executor's run
        seed: per-program op uids restart at 1, so WITHOUT this two
        different programs (startup vs main) would derive identical
        per-op keys on their first runs — init draws correlating with
        dropout masks. The fingerprint depends only on the program's
        own content, never on process history."""
        cached = getattr(self, "_rng_tag_cache", None)
        if cached is not None and cached[0] == self._version:
            return cached[1]
        import zlib

        sig = "|".join(
            f"{op.type}:{','.join(sorted(op.output_arg_names))}"
            for blk in self.blocks for op in blk.ops)
        tag = zlib.crc32(sig.encode())
        self._rng_tag_cache = (self._version, tag)
        return tag

    def global_block(self):
        return self.blocks[0]

    def block(self, idx):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[self._current_block_idx] if hasattr(
            self, "_current_block_idx") else self.global_block()

    @property
    def num_blocks(self):
        return len(self.blocks)

    def _create_block(self, parent_idx=None):
        if parent_idx is None:
            parent_idx = self.current_block().idx
        b = Block(self, len(self.blocks), parent_idx)
        self.blocks.append(b)
        return b

    @contextlib.contextmanager
    def _block_guard(self):
        """Build ops into a fresh sub-block (control-flow bodies). The
        reference switches BlockDesc on a stack (framework.py:3934
        Program._create_block/_rollback); here the guard sets
        current_block so LayerHelper appends land in the sub-block."""
        prev = self.current_block().idx
        b = self._create_block(prev)
        self._current_block_idx = b.idx
        try:
            yield b
        finally:
            self._current_block_idx = prev

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def all_parameters(self):
        out = []
        for b in self.blocks:
            out.extend(b.all_parameters())
        return out

    def clone(self, for_test=False):
        p = copy.deepcopy(self)
        if for_test:
            for b in p.blocks:
                for op in b.ops:
                    if op.type in ("dropout",):
                        op.attrs["is_test"] = True
                    if op.type in ("batch_norm", "batch_norm_infer"):
                        op.attrs["is_test"] = True
        return p

    def _prune(self, targets):
        """Keep only ops needed for target vars (Program.prune parity)."""
        names = {t.name if isinstance(t, Variable) else t for t in targets}
        blk = self.global_block()
        keep = [False] * len(blk.ops)
        needed = set(names)
        for i in range(len(blk.ops) - 1, -1, -1):
            op = blk.ops[i]
            if needed & set(op.output_arg_names):
                keep[i] = True
                needed |= set(op.input_arg_names)
        p = copy.deepcopy(self)
        nb = p.global_block()
        nb.ops = [op for i, op in enumerate(nb.ops) if keep[i]]
        # jax_autodiff's forward segment is "every op before me": its
        # fwd_op_count was its own append-time index, stale after pruning
        for i, op in enumerate(nb.ops):
            if op.type == "jax_autodiff":
                op.attrs["fwd_op_count"] = min(op.attrs["fwd_op_count"], i)
        return p

    # --------- serialization (pickle-based; stable across processes) ------
    def desc_bytes(self):
        return pickle.dumps(_program_to_desc(self))

    @staticmethod
    def parse_from_string(data):
        return _desc_to_program(pickle.loads(data))

    def to_string(self, throw_on_error=True, with_details=False):
        return "\n".join(repr(b) for b in self.blocks)

    def __repr__(self):
        return self.to_string()


def _program_to_desc(p):
    return {
        "random_seed": p.random_seed,
        "blocks": [{
            "idx": b.idx,
            "parent_idx": b.parent_idx,
            "vars": [{
                "name": v.name, "shape": v.shape,
                "dtype": dtype_name(v.dtype) if v.dtype is not None else None,
                "persistable": v.persistable,
                "stop_gradient": v.stop_gradient,
                "is_data": v.is_data,
                "is_parameter": isinstance(v, Parameter),
                "trainable": v.trainable,
            } for v in b.vars.values()],
            "ops": [{
                "type": op.type, "inputs": op.inputs,
                "outputs": op.outputs,
                "attrs": {k: v for k, v in op.attrs.items()
                          if _picklable(v)},
            } for op in b.ops],
        } for b in p.blocks],
    }


def _picklable(v):
    try:
        pickle.dumps(v)
        return True
    except Exception:
        return False


def _desc_to_program(d):
    p = Program()
    p.random_seed = d.get("random_seed", 0)
    p.blocks = []
    for bd in d["blocks"]:
        b = Block(p, bd["idx"], bd["parent_idx"])
        p.blocks.append(b)
        for vd in bd["vars"]:
            cls_kwargs = dict(
                name=vd["name"], shape=vd["shape"],
                dtype=vd["dtype"], persistable=vd["persistable"],
                stop_gradient=vd["stop_gradient"], is_data=vd["is_data"])
            if vd.get("is_parameter"):
                v = Parameter(b, vd["shape"], vd["dtype"], name=vd["name"])
            else:
                v = Variable(b, **cls_kwargs)
            v.trainable = vd.get("trainable", False)
            b.vars[v.name] = v
        for od in bd["ops"]:
            op = Operator(b, od["type"], None, None, od["attrs"])
            op.inputs = od["inputs"]
            op.outputs = od["outputs"]
            b.ops.append(op)
    return p


# ---------------- default programs + guards ----------------

_main_program = [Program()]
_startup_program = [Program()]


def default_main_program():
    return _main_program[0]


def default_startup_program():
    return _startup_program[0]


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main, old_startup = _main_program[0], _startup_program[0]
    _main_program[0] = main_program
    if startup_program is not None:
        _startup_program[0] = startup_program
    try:
        yield
    finally:
        _main_program[0] = old_main
        _startup_program[0] = old_startup


def switch_main_program(program):
    old = _main_program[0]
    _main_program[0] = program
    return old


_device_guard = [None]


@contextlib.contextmanager
def device_guard(device=None):
    """fluid.device_guard parity (framework.py:5516): annotates ops with an
    op_device attr — the hook pipeline parallelism uses to split stages."""
    old = _device_guard[0]
    _device_guard[0] = device
    try:
        yield
    finally:
        _device_guard[0] = old


def current_device_annotation():
    return _device_guard[0]


@contextlib.contextmanager
def name_scope(prefix=None):
    yield


def grad_var_name(name):
    return name + "@GRAD"
