"""LoDTensor: host-side ragged-sequence metadata over dense storage, and
the packed layout of the segment-masked flash attention.

The port's own copy of the JAX package's `core/lod.py` (numpy only; the
port imports nothing of that package). Reference parity:
paddle/fluid/framework/lod_tensor.h:104, a tensor whose rows are
partitioned into variable-length sequences by level-of-detail offset
tables. LoD lives at the edges only: device compute sees either a dense
padded [batch, max_len, ...] array plus lengths, or a `PackedBatch` of
several sequences per row with per-token segment ids, which
`ops.attention.flash_attention(segment_ids=...)` masks in-kernel.
"""
from __future__ import annotations

import numpy as np

# env-key suffix for the lengths companion of a sequence-typed var inside
# lowered programs — single source of truth for executor/lowering/layers
LOD_SUFFIX = "@@LOD"
# outer nesting levels ride as additional int32 offset-array companions
LOD_OUTER_SUFFIX = "@@LODO"


def _offsets_from_lengths(lengths):
    out = [0]
    for n in lengths:
        out.append(out[-1] + int(n))
    return out


def _lengths_from_offsets(offsets):
    return [int(offsets[i + 1] - offsets[i]) for i in range(len(offsets) - 1)]


class LoDTensor:
    """Packed rows + lod offset tables (host side only).

    `data` is [total_rows, ...]; `lod` is a list of offset tables, each a
    monotone list starting at 0 (lod_tensor.h LoD = vector<vector<size_t>>).
    Level -1 (the last) partitions rows of `data`; earlier levels partition
    the level below them.
    """

    def __init__(self, data=None, lod=None):
        self._data = np.asarray(data) if data is not None else None
        self._lod = [list(map(int, l)) for l in (lod or [])]

    # ---- tensor protocol ----
    def __array__(self, dtype=None):
        arr = self._data
        return arr.astype(dtype) if dtype is not None else arr

    def set(self, value, place=None):
        self._data = np.asarray(value)

    def shape(self):
        return list(self._data.shape)

    # ---- lod protocol (pybind tensor parity) ----
    def lod(self):
        return [list(l) for l in self._lod]

    def set_lod(self, lod):
        self._lod = [list(map(int, l)) for l in lod]

    def recursive_sequence_lengths(self):
        return [_lengths_from_offsets(l) for l in self._lod]

    def set_recursive_sequence_lengths(self, seq_lens):
        self._lod = [_offsets_from_lengths(l) for l in seq_lens]

    def has_valid_recursive_sequence_lengths(self):
        if not self._lod:
            return True
        for level, nxt in zip(self._lod, self._lod[1:]):
            if level[-1] != len(nxt) - 1:
                return False
        return self._lod[-1][-1] == len(self._data)

    @property
    def lod_level(self):
        return len(self._lod)

    def __repr__(self):
        return (f"LoDTensor(shape={list(self._data.shape)}, "
                f"lod={self._lod})")

    # ---- canonicalization: pack <-> pad ----
    def sequence_lengths(self):
        """Row lengths at the LAST lod level (the one partitioning data)."""
        if not self._lod:
            return [len(self._data)]
        return _lengths_from_offsets(self._lod[-1])

    def to_padded(self, max_len=None, pad_value=0):
        """(padded [B, T, ...], lengths [B] int32). Flattens nested lod to
        the last level — device compute sees one ragged axis; outer nesting
        is re-attached at fetch from host metadata."""
        lens = self.sequence_lengths()
        T = int(max_len or (max(lens) if lens else 0)) or 1
        B = len(lens)
        tail = self._data.shape[1:]
        out = np.full((B, T) + tail, pad_value, dtype=self._data.dtype)
        offs = self._lod[-1] if self._lod else [0, len(self._data)]
        for b, n in enumerate(lens):
            out[b, :n] = self._data[offs[b]:offs[b] + n]
        return out, np.asarray(lens, dtype=np.int32)

    @staticmethod
    def from_padded(padded, lengths, outer_lod=None):
        """Inverse of to_padded: re-pack valid prefixes into [total, ...]."""
        padded = np.asarray(padded)
        lengths = [int(x) for x in np.asarray(lengths).reshape(-1)]
        rows = [padded[b, :n] for b, n in enumerate(lengths)]
        data = (np.concatenate(rows, axis=0) if rows else
                np.zeros((0,) + padded.shape[2:], dtype=padded.dtype))
        lod = list(outer_lod or []) + [_offsets_from_lengths(lengths)]
        return LoDTensor(data, lod)

    def to_packed(self, row_len=None, pad_value=0):
        """LoD -> PackedBatch (packed tokens, segment_ids, positions):
        the feed for the segment-aware packed flash path. Flattens
        nested lod to the last level, like to_padded."""
        lens = self.sequence_lengths()
        offs = self._lod[-1] if self._lod else [0, len(self._data)]
        seqs = [self._data[offs[b]:offs[b] + n]
                for b, n in enumerate(lens)]
        return pack_sequences(seqs, row_len, pad_value)

    @staticmethod
    def from_sequences(seqs, dtype=None):
        """Build from a list of per-example arrays (level-1 lod)."""
        arrs = [np.asarray(s, dtype=dtype) for s in seqs]
        lens = [len(a) for a in arrs]
        data = (np.concatenate(arrs, axis=0) if arrs else
                np.zeros((0,), dtype=dtype or np.float32))
        return LoDTensor(data, [_offsets_from_lengths(lens)])


class PackedBatch:
    """LoD sequences packed multiple-per-row for the segment-aware flash
    path (ops/attention.py). Fields:

    data          [rows, row_len, ...] — tokens, several sequences per
                  row back-to-back, padded at the row tail
    segment_ids   [rows, row_len] int32 — one id per sequence, NON-
                  DECREASING along each row (the kernel's block-level
                  early-out depends on this); tail padding gets the
                  next id after the row's last sequence, so pads form
                  their own segment and real tokens never attend them
    positions     [rows, row_len] int32 — within-sequence positions
                  (position-embedding feed for packed transformers)
    spans         per-sequence (row, start, length), in input order
    """

    def __init__(self, data, segment_ids, positions, spans, lengths):
        self.data = data
        self.segment_ids = segment_ids
        self.positions = positions
        self.spans = spans
        self.lengths = lengths

    @property
    def num_rows(self):
        return self.data.shape[0]

    @property
    def row_len(self):
        return self.data.shape[1]

    @property
    def fill(self):
        """Fraction of packed slots holding real tokens."""
        total = self.data.shape[0] * self.data.shape[1]
        return float(sum(self.lengths)) / total if total else 0.0

    def unpack(self, outputs=None):
        """Re-slice per-sequence arrays (from `outputs` aligned with
        `data`, default the packed tokens themselves) -> LoDTensor with
        the original level-1 lod."""
        src = np.asarray(outputs) if outputs is not None else self.data
        rows = [src[r, s:s + n] for (r, s, n) in self.spans]
        data = (np.concatenate(rows, axis=0) if rows else
                np.zeros((0,) + src.shape[2:], dtype=src.dtype))
        return LoDTensor(data, [_offsets_from_lengths(self.lengths)])

    def cls_flat_index(self):
        """Flat [num_seqs] int32 index of each sequence's FIRST token in
        the row-major flattened [rows*row_len, ...] view — the packed
        stand-in for `seq_out[:, 0]` CLS pooling."""
        return np.asarray([r * self.row_len + s
                           for (r, s, _) in self.spans], dtype=np.int32)


def pack_sequences(seqs, row_len=None, pad_value=0):
    """Greedy next-fit packing of per-sequence arrays into rows of
    `row_len` tokens (reference gap: lod_tensor.h:104 rides varlen
    batches through bert_encoder_functor.cu on GPU; here the packed
    layout feeds the segment-masked flash kernels). Order is
    preserved, so segment ids are monotone within every row. Sequences
    longer than row_len are rejected — pick row_len >= max length."""
    arrs = [np.asarray(s) for s in seqs]
    lens = [int(a.shape[0]) for a in arrs]
    if row_len is None:
        row_len = max(lens) if lens else 1
    if lens and max(lens) > row_len:
        raise ValueError(
            f"sequence of length {max(lens)} does not fit row_len "
            f"{row_len}")
    tail = arrs[0].shape[1:] if arrs else ()
    dtype = arrs[0].dtype if arrs else np.float32

    rows, spans = [], []
    cur, fill = None, 0
    for i, (a, n) in enumerate(zip(arrs, lens)):
        if cur is None or fill + n > row_len:
            cur = {"segs": [], "fill": 0}
            rows.append(cur)
            fill = 0
        cur["segs"].append((i, a, n))
        fill += n
        cur["fill"] = fill

    R = max(len(rows), 1)
    data = np.full((R, row_len) + tail, pad_value, dtype=dtype)
    segment_ids = np.zeros((R, row_len), np.int32)
    positions = np.zeros((R, row_len), np.int32)
    spans = [None] * len(arrs)
    for r, row in enumerate(rows):
        off = 0
        last = -1
        for (i, a, n) in row["segs"]:
            data[r, off:off + n] = a
            segment_ids[r, off:off + n] = i
            positions[r, off:off + n] = np.arange(n, dtype=np.int32)
            spans[i] = (r, off, n)
            off += n
            last = i
        # row tail: pads become their OWN segment (id follows the
        # row's last real id, keeping the row monotone) — real tokens
        # never attend them and they only attend each other
        segment_ids[r, off:] = last + 1
    return PackedBatch(data, segment_ids, positions, spans, lens)


def pack_padded(padded, lengths, row_len=None, pad_value=0):
    """(padded [B, T, ...], lengths [B]) -> PackedBatch: the LoD-native
    feed for the packed flash path. With the default row_len (= max
    length, i.e. T of a tightly padded batch) a ~50%-fill padded batch
    packs into roughly half the rows — the padding FLOPs the dense
    layout burns simply disappear."""
    padded = np.asarray(padded)
    lengths = [int(x) for x in np.asarray(lengths).reshape(-1)]
    return pack_sequences([padded[b, :n] for b, n in enumerate(lengths)],
                          row_len or padded.shape[1], pad_value)


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """fluid.create_lod_tensor parity (fluid/lod_tensor.py): data is a numpy
    array / list-of-lists / LoDTensor, recursive_seq_lens a list of
    length-lists per level."""
    if isinstance(data, LoDTensor):
        t = LoDTensor(np.asarray(data), None)
    elif isinstance(data, list):
        flat = [np.asarray(row).reshape(-1, 1) for row in data]
        exp = [len(r) for r in flat]
        if recursive_seq_lens and exp != list(recursive_seq_lens[-1]):
            raise ValueError("data row lengths do not match seq_lens")
        t = LoDTensor(np.concatenate(flat, axis=0) if flat else
                      np.zeros((0, 1)), None)
    else:
        t = LoDTensor(np.asarray(data), None)
    t.set_recursive_sequence_lengths(recursive_seq_lens)
    if not t.has_valid_recursive_sequence_lengths():
        raise ValueError(
            f"invalid recursive_seq_lens {recursive_seq_lens} for data with "
            f"{len(np.asarray(t))} rows")
    return t


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place, low,
                                high):
    """fluid.create_random_int_lodtensor parity — used by book tests."""
    total = sum(recursive_seq_lens[-1])
    data = np.random.randint(low, high + 1,
                             size=[total] + list(base_shape)).astype("int64")
    return create_lod_tensor(data, recursive_seq_lens, place)
