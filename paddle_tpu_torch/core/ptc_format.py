"""Pure-Python codec for the PTT1/PTC1 tensor file formats
(csrc/ptcore/saveload.cc; the JAX package's `core/ptc_format.py`).
Byte-compatible with the native writer/reader: the port reads and writes
`__params__` only through it and never loads the native core."""
from __future__ import annotations

import struct

import numpy as np

TENSOR_MAGIC = 0x50545431  # "PTT1"
COMBINE_MAGIC = 0x50544331  # "PTC1"

DTYPE_CODES = {
    "float32": 1, "float64": 2, "int32": 3, "int64": 4, "bool": 5,
    "uint16": 6, "float16": 7, "uint8": 8, "int8": 9, "int16": 10,
}
CODE_DTYPES = {v: np.dtype(k) for k, v in DTYPE_CODES.items()}


def _tensor_record(arr):
    arr = np.ascontiguousarray(arr)
    code = DTYPE_CODES[arr.dtype.name]
    head = struct.pack("<IBB", TENSOR_MAGIC, code, arr.ndim)
    dims = struct.pack(f"<{arr.ndim}q", *arr.shape) if arr.ndim else b""
    return head + dims + struct.pack("<Q", arr.nbytes) + arr.tobytes()


def _read_tensor_record(buf, ofs):
    magic, code, ndim = struct.unpack_from("<IBB", buf, ofs)
    if magic != TENSOR_MAGIC:
        raise IOError("bad tensor magic")
    ofs += 6
    dims = struct.unpack_from(f"<{ndim}q", buf, ofs) if ndim else ()
    ofs += 8 * ndim
    (nbytes,) = struct.unpack_from("<Q", buf, ofs)
    ofs += 8
    if ofs + nbytes > len(buf):
        raise IOError("truncated tensor record")
    arr = np.frombuffer(buf[ofs:ofs + nbytes],
                        CODE_DTYPES[code]).reshape(dims).copy()
    return arr, ofs + nbytes


def save_tensor(path, arr):
    with open(path, "wb") as f:
        f.write(_tensor_record(arr))


def load_tensor(path):
    with open(path, "rb") as f:
        arr, _ = _read_tensor_record(f.read(), 0)
    return arr


def save_combine(path, named_arrays):
    with open(path, "wb") as f:
        f.write(struct.pack("<IQ", COMBINE_MAGIC, len(named_arrays)))
        for name, arr in named_arrays.items():
            nb = name.encode()
            f.write(struct.pack("<H", len(nb)) + nb)
            f.write(_tensor_record(arr))


def load_combine(path):
    with open(path, "rb") as f:
        buf = f.read()
    magic, count = struct.unpack_from("<IQ", buf, 0)
    if magic != COMBINE_MAGIC:
        raise IOError(f"bad combine magic in {path}")
    ofs = 12
    out = {}
    try:
        for _ in range(count):
            (nl,) = struct.unpack_from("<H", buf, ofs)
            ofs += 2
            name = buf[ofs:ofs + nl].decode()
            ofs += nl
            arr, ofs = _read_tensor_record(buf, ofs)
            out[name] = arr
    except (struct.error, IOError) as e:
        raise IOError(f"load_combine: truncated/corrupt file: {path}") \
            from e
    return out
