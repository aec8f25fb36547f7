"""The program IR's wire format (`csrc/proto/ptframework.proto`) in plain
Python: a proto3 codec with no protobuf library.

The JAX package reads and writes `__model__` through protoc and a dynamic
descriptor; the card machine has neither protoc nor `google.protobuf`,
so the port encodes and decodes the same messages by hand. Its bytes are
those of protobuf's `SerializeToString()` for the same message:

  * fields in field-number order;
  * proto3 scalars left out at their default (0, "", false, enum 0),
    except a set member of a oneof (`Attr.value`), which is written even
    at its default, as is a set singular message field;
  * repeated numeric fields packed (`shape`, `IntList.val`,
    `BoolList.val` as varints, `FloatList.val` as doubles), repeated
    strings and messages one record each;
  * negative int32 / int64 as ten-byte varints (two's complement on 64
    bits).

The decoder takes packed and unpacked repeated scalars alike and skips
unknown fields, as protobuf's parser does.

`program_to_proto` / `proto_to_program` carry a `fluid` Program across,
as the JAX package's functions of the same names do: an attribute that
no `Attr` member can hold (the op's recorded call stack) is dropped, an
empty list is written as an empty `bools`, and a var's dtype is
`DataType` 0 (DT_UNSPECIFIED) unless it carries a `name` (the fluid
dtypes are numpy scalar types, which carry none).
"""
from __future__ import annotations

import struct

import numpy as np

__all__ = ["Message", "ProgramDesc", "BlockDesc", "OpDesc", "VarDesc",
           "Attr", "OpSlot", "OpVersionPair", "IntList", "FloatList",
           "StrList", "BoolList", "InferenceModel", "dtype_to_pb",
           "pb_to_dtype", "program_to_proto", "proto_to_program",
           "encode_varint"]

_MASK64 = (1 << 64) - 1


def encode_varint(v):
    """Base-128 varint of v; a negative v as its 64-bit two's
    complement (ten bytes)."""
    v &= _MASK64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf, pos):
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def _signed(v, bits):
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _tag(num, wire):
    return encode_varint((num << 3) | wire)


def _scalar_bytes(kind, v):
    if kind == "double":
        return struct.pack("<d", float(v))
    if kind == "bool":
        return encode_varint(1 if v else 0)
    return encode_varint(int(v))


def _is_default(kind, v):
    if kind == "string":
        return v == ""
    if kind == "double":
        return v == 0.0 and not np.signbit(v)
    return not v


class Message:
    """A proto3 message: `FIELDS` is ((number, name, kind, repeated,
    oneof), ...), kind one of int64 / int32 / bool / enum / double /
    string or a Message subclass."""

    FIELDS = ()

    def __init__(self, **kw):
        self._set = set()   # oneof members and singular messages set
        for _num, name, kind, rep, _oneof in self.FIELDS:
            if rep:
                object.__setattr__(self, name, [])
            elif isinstance(kind, type):
                object.__setattr__(self, name, None)
            else:
                object.__setattr__(self, name, _DEFAULTS[kind])
        for k, v in kw.items():
            setattr(self, k, v)

    def __setattr__(self, name, value):
        if name != "_set":
            f = self._field(name)
            if f is not None and not f[3] and (
                    f[4] is not None or isinstance(f[2], type)):
                if f[4] is not None:   # a oneof: one member at a time
                    for g in self.FIELDS:
                        if g[4] == f[4] and g[1] != name:
                            self._set.discard(g[1])
                            object.__setattr__(
                                self, g[1], None if isinstance(g[2], type)
                                else _DEFAULTS[g[2]])
                if value is None:
                    self._set.discard(name)
                else:
                    self._set.add(name)
        object.__setattr__(self, name, value)

    @classmethod
    def _field(cls, name):
        for f in cls.FIELDS:
            if f[1] == name:
                return f
        return None

    def WhichOneof(self, group):  # noqa: N802 (protobuf's name)
        for f in self.FIELDS:
            if f[4] == group and f[1] in self._set:
                return f[1]
        return None

    def __repr__(self):
        parts = []
        for _num, name, kind, rep, oneof in self.FIELDS:
            v = getattr(self, name)
            if rep and not v:
                continue
            if not rep and (oneof is not None or isinstance(kind, type)):
                if name not in self._set:
                    continue
            elif not rep and _is_default(kind, v):
                continue
            parts.append(f"{name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"

    # ---------------------------------------------------------------- encode
    def SerializeToString(self):
        out = bytearray()
        for num, name, kind, rep, oneof in self.FIELDS:
            v = getattr(self, name)
            if isinstance(kind, type):
                if rep:
                    for m in v:
                        body = m.SerializeToString()
                        out += _tag(num, 2) + encode_varint(len(body)) + body
                elif name in self._set:
                    body = v.SerializeToString()
                    out += _tag(num, 2) + encode_varint(len(body)) + body
            elif kind == "string":
                vals = v if rep else (
                    [v] if (name in self._set if oneof is not None
                            else v != "") else [])
                for s in vals:
                    b = s.encode("utf-8")
                    out += _tag(num, 2) + encode_varint(len(b)) + b
            elif rep:
                if v:
                    body = b"".join(_scalar_bytes(kind, x) for x in v)
                    out += _tag(num, 2) + encode_varint(len(body)) + body
            else:
                present = name in self._set if oneof is not None \
                    else not _is_default(kind, v)
                if present:
                    wire = 1 if kind == "double" else 0
                    out += _tag(num, wire) + _scalar_bytes(kind, v)
        return bytes(out)

    # ---------------------------------------------------------------- decode
    def ParseFromString(self, data):
        fresh = type(self)()
        for k, v in fresh.__dict__.items():
            object.__setattr__(self, k, v)
        self._set = set()
        self._merge(memoryview(bytes(data)))
        return len(data)

    @classmethod
    def FromString(cls, data):
        m = cls()
        m.ParseFromString(data)
        return m

    def _merge(self, buf):
        by_num = {f[0]: f for f in self.FIELDS}
        pos, end = 0, len(buf)
        while pos < end:
            key, pos = _read_varint(buf, pos)
            num, wire = key >> 3, key & 7
            f = by_num.get(num)
            if wire == 0:
                raw, pos = _read_varint(buf, pos)
                payload = None
            elif wire == 1:
                raw, pos = bytes(buf[pos:pos + 8]), pos + 8
                payload = None
            elif wire == 2:
                n, pos = _read_varint(buf, pos)
                payload, pos = buf[pos:pos + n], pos + n
                if pos > end:
                    raise ValueError("truncated length-delimited field")
                raw = None
            elif wire == 5:
                raw, pos = bytes(buf[pos:pos + 4]), pos + 4
                payload = None
            else:
                raise ValueError(f"unsupported wire type {wire}")
            if f is None:
                continue                          # unknown field: skipped
            _num, name, kind, rep, _oneof = f
            if isinstance(kind, type):
                sub = kind()
                sub._merge(payload)
                if rep:
                    getattr(self, name).append(sub)
                else:
                    setattr(self, name, sub)
                continue
            if kind == "string":
                s = bytes(payload).decode("utf-8")
                if rep:
                    getattr(self, name).append(s)
                else:
                    setattr(self, name, s)
                continue
            if payload is not None:               # packed scalars
                vals = _unpack(kind, payload)
            else:
                vals = [_decode_scalar(kind, raw)]
            if rep:
                getattr(self, name).extend(vals)
            else:
                setattr(self, name, vals[-1])


_DEFAULTS = {"int64": 0, "int32": 0, "enum": 0, "bool": False,
             "double": 0.0, "string": ""}


def _decode_scalar(kind, raw):
    if kind == "double":
        return struct.unpack("<d", raw)[0]
    if kind == "bool":
        return bool(raw)
    if kind == "int32":
        return _signed(raw, 32)
    if kind == "int64":
        return _signed(raw, 64)
    return _signed(raw, 32)                       # enum


def _unpack(kind, payload):
    if kind == "double":
        return list(struct.unpack(f"<{len(payload) // 8}d", payload))
    vals, pos = [], 0
    while pos < len(payload):
        raw, pos = _read_varint(payload, pos)
        vals.append(_decode_scalar(kind, raw))
    return vals


# ---------------------------------------------------------------------------
# ptframework.proto's messages
# ---------------------------------------------------------------------------

class IntList(Message):
    FIELDS = ((1, "val", "int64", True, None),)


class FloatList(Message):
    FIELDS = ((1, "val", "double", True, None),)


class StrList(Message):
    FIELDS = ((1, "val", "string", True, None),)


class BoolList(Message):
    FIELDS = ((1, "val", "bool", True, None),)


class Attr(Message):
    FIELDS = ((1, "name", "string", False, None),
              (2, "i", "int64", False, "value"),
              (3, "f", "double", False, "value"),
              (4, "s", "string", False, "value"),
              (5, "b", "bool", False, "value"),
              (6, "ints", IntList, False, "value"),
              (7, "floats", FloatList, False, "value"),
              (8, "strs", StrList, False, "value"),
              (9, "bools", BoolList, False, "value"),
              (10, "block_idx", "int32", False, "value"))


class VarDesc(Message):
    FIELDS = ((1, "name", "string", False, None),
              (2, "dtype", "enum", False, None),
              (3, "shape", "int64", True, None),
              (4, "persistable", "bool", False, None),
              (5, "is_data", "bool", False, None),
              (6, "lod_level", "int32", False, None),
              (7, "trainable", "bool", False, None),
              (8, "stop_gradient", "bool", False, None))


class OpSlot(Message):
    FIELDS = ((1, "name", "string", False, None),
              (2, "args", "string", True, None))


class OpDesc(Message):
    FIELDS = ((1, "type", "string", False, None),
              (2, "inputs", OpSlot, True, None),
              (3, "outputs", OpSlot, True, None),
              (4, "attrs", Attr, True, None))


class BlockDesc(Message):
    FIELDS = ((1, "idx", "int32", False, None),
              (2, "parent_idx", "int32", False, None),
              (3, "vars", VarDesc, True, None),
              (4, "ops", OpDesc, True, None))


class OpVersionPair(Message):
    FIELDS = ((1, "op_name", "string", False, None),
              (2, "version", "int32", False, None))


class ProgramDesc(Message):
    FIELDS = ((1, "blocks", BlockDesc, True, None),
              (2, "version", "int64", False, None),
              (3, "op_version_map", OpVersionPair, True, None))


class InferenceModel(Message):
    FIELDS = ((1, "program", ProgramDesc, False, None),
              (2, "feed_names", "string", True, None),
              (3, "fetch_names", "string", True, None))


# ---------------------------------------------------------------------------
# Program <-> ProgramDesc (the JAX package's program_pb functions)
# ---------------------------------------------------------------------------

# dtype-name <-> proto enum (shared with csrc PTT1 codes)
_DT_TO_PB = {
    "float32": 1, "float64": 2, "int32": 3, "int64": 4, "bool": 5,
    "bfloat16": 6, "float16": 7, "uint8": 8, "int8": 9, "int16": 10,
}
_PB_TO_DT = {v: k for k, v in _DT_TO_PB.items()}


def dtype_to_pb(name):
    return _DT_TO_PB.get(str(name), 0)


def pb_to_dtype(code):
    return _PB_TO_DT.get(int(code))


def _set_attr(pb_attr, name, val):
    pb_attr.name = name
    if type(val).__name__ == "Block":  # control-flow sub-block reference
        pb_attr.block_idx = val.idx
    elif isinstance(val, bool):
        pb_attr.b = val
    elif isinstance(val, (int, np.integer)):
        pb_attr.i = int(val)
    elif isinstance(val, (float, np.floating)):
        pb_attr.f = float(val)
    elif isinstance(val, str):
        pb_attr.s = val
    elif isinstance(val, (list, tuple)):
        if all(isinstance(v, bool) for v in val):
            pb_attr.bools = BoolList(val=list(val))
        elif all(isinstance(v, (int, np.integer)) for v in val):
            pb_attr.ints = IntList(val=[int(v) for v in val])
        elif all(isinstance(v, (int, float, np.floating, np.integer))
                 for v in val):
            pb_attr.floats = FloatList(val=[float(v) for v in val])
        elif all(isinstance(v, str) for v in val):
            pb_attr.strs = StrList(val=list(val))
        else:
            raise TypeError(f"attr {name}: unsupported list {val!r}")
    else:
        raise TypeError(f"attr {name}: unsupported value {val!r}")


def _get_attr(pb_attr):
    which = pb_attr.WhichOneof("value")
    if which is None:
        return None
    v = getattr(pb_attr, which)
    if which in ("ints", "floats", "strs", "bools"):
        return list(v.val)
    if which == "block_idx":
        return ("__block__", v)
    return v


def program_to_proto(program):
    """fluid Program -> ProgramDesc message."""
    from ..fluid.op_version import program_op_versions

    pb = ProgramDesc(version=1)
    for name, ver in sorted(program_op_versions(program).items()):
        pb.op_version_map.append(OpVersionPair(op_name=name, version=ver))
    for block in program.blocks:
        bpb = BlockDesc(idx=block.idx)
        bpb.parent_idx = getattr(block, "parent_idx", -1) \
            if getattr(block, "parent_idx", None) is not None else -1
        for var in block.vars.values():
            vpb = VarDesc(name=var.name)
            vpb.dtype = dtype_to_pb(
                var.dtype.name if hasattr(var.dtype, "name") else var.dtype
            ) if var.dtype is not None else 0
            vpb.shape = [int(d) if d is not None else -1
                         for d in (var.shape or [])]
            vpb.persistable = bool(var.persistable)
            vpb.is_data = bool(getattr(var, "is_data", False))
            vpb.lod_level = int(getattr(var, "lod_level", 0) or 0)
            vpb.trainable = bool(getattr(var, "trainable", False))
            vpb.stop_gradient = bool(getattr(var, "stop_gradient", True))
            bpb.vars.append(vpb)
        for op in block.ops:
            opb = OpDesc(type=op.type)
            for slot, args in op.inputs.items():
                opb.inputs.append(OpSlot(name=slot, args=list(args)))
            for slot, args in op.outputs.items():
                opb.outputs.append(OpSlot(name=slot, args=list(args)))
            for aname, aval in op.attrs.items():
                if aval is None:
                    continue
                a = Attr()
                try:
                    _set_attr(a, aname, aval)
                except TypeError:
                    continue          # non-serializable attr: dropped
                opb.attrs.append(a)
            bpb.ops.append(opb)
        pb.blocks.append(bpb)
    return pb


def proto_to_program(pb, program_cls=None):
    """ProgramDesc message -> fluid Program."""
    from ..fluid.framework import Program
    from ..fluid.op_version import check_compatible

    program_cls = program_cls or Program
    check_compatible({p.op_name: p.version for p in pb.op_version_map})
    prog = program_cls()
    # ensure enough blocks exist, with recorded parents
    for bpb in pb.blocks:
        if bpb.idx >= len(prog.blocks):
            prog._create_block(max(bpb.parent_idx, 0))
    for bpb in pb.blocks:
        block = prog.blocks[bpb.idx]
        block.parent_idx = bpb.parent_idx
        for vpb in bpb.vars:
            block.create_var(
                name=vpb.name,
                shape=[int(d) for d in vpb.shape],
                dtype=pb_to_dtype(vpb.dtype),
                persistable=vpb.persistable,
                is_data=vpb.is_data,
                lod_level=vpb.lod_level,
                trainable=vpb.trainable,
                stop_gradient=vpb.stop_gradient,
            )
        for opb in bpb.ops:
            inputs = {s.name: list(s.args) for s in opb.inputs}
            outputs = {s.name: list(s.args) for s in opb.outputs}
            attrs = {}
            for apb in opb.attrs:
                val = _get_attr(apb)
                if isinstance(val, tuple) and val[:1] == ("__block__",):
                    val = prog.blocks[val[1]]  # resolve sub-block ref
                attrs[apb.name] = val
            block.append_op(type=opb.type, inputs=inputs, outputs=outputs,
                            attrs=attrs)
    return prog
