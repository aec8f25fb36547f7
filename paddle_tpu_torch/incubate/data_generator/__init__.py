"""User-side PS feed-file authoring API (reference parity:
python/paddle/fluid/incubate/data_generator/__init__.py:1 —
DataGenerator / MultiSlotDataGenerator / MultiSlotStringDataGenerator).

The reference's generators print MultiSlot text lines to stdout so a
Hadoop/shell pipeline shards them into trainer feed files (the `<n>
v1..vn` text wire). `write_to_file(..., binary=True)` emits the PTMB1
binary wire (`write_multislot_binary`, the port's own copy of the JAX
package's writer: the same bytes), ~3x smaller and parse-free.
"""
from __future__ import annotations

import struct
import sys

import numpy as np


def write_multislot_binary(path, records, slot_types):
    """Write records in the binary MultiSlot wire (b"PTMB\x01", then per
    record b"\xab" and per slot a little-endian uint32 count and the
    values as float32 or int64).

    records: iterable of per-slot value lists, one entry per slot in
    feed order. slot_types: 'float32'/'int64' per slot.
    """
    with open(path, "wb") as f:
        f.write(b"PTMB\x01")
        for rec in records:
            if len(rec) != len(slot_types):
                raise ValueError(
                    f"record has {len(rec)} slots, feed declares "
                    f"{len(slot_types)}")
            f.write(b"\xab")
            for vals, st in zip(rec, slot_types):
                arr = np.asarray(
                    vals, np.float32 if "float" in st else np.int64)
                f.write(struct.pack("<I", arr.size))
                f.write(arr.tobytes())


class DataGenerator:
    """Subclass and implement `generate_sample(line)` returning a
    generator of samples, each `[(slot_name, [values...]), ...]`;
    optionally `generate_batch(samples)` for batch-level rewrites."""

    def __init__(self):
        self._proto_info = None
        self.batch_size_ = 32
        self._line_limit = None

    def _set_line_limit(self, line_limit):
        if not isinstance(line_limit, int) or line_limit < 1:
            raise ValueError("line_limit must be a positive int")
        self._line_limit = line_limit

    def set_batch(self, batch_size):
        self.batch_size_ = batch_size

    # -- drive ----------------------------------------------------------
    def run_from_memory(self, out=None):
        """Generate from generate_sample(None) and write the wire lines
        to `out` (default stdout, the reference pipeline contract)."""
        out = out or sys.stdout
        batch_samples = []
        for sample in self._iter_source(None):
            batch_samples.append(sample)
            if len(batch_samples) == self.batch_size_:
                self._flush_batch(batch_samples, out)
                batch_samples = []
        if batch_samples:
            self._flush_batch(batch_samples, out)

    def run_from_stdin(self, inp=None, out=None):
        """One input line -> generate_sample(line) samples -> wire
        lines (the hadoop-streaming mapper contract)."""
        inp = inp or sys.stdin
        out = out or sys.stdout
        batch_samples = []
        for n, line in enumerate(inp, 1):
            if self._line_limit and n > self._line_limit:
                break
            for sample in self._iter_source(line):
                batch_samples.append(sample)
                if len(batch_samples) == self.batch_size_:
                    self._flush_batch(batch_samples, out)
                    batch_samples = []
        if batch_samples:
            self._flush_batch(batch_samples, out)

    def write_to_file(self, path, lines=None, binary=False,
                      slot_types=None):
        """Materialize the generated samples as a feed FILE (text
        MultiSlot, or PTMB1 when binary=True). generate_batch applies
        per batch_size_ chunk, as in run_from_memory. Returns the
        number of records."""
        records = []
        batch = []

        def flush():
            for s in self._apply_batch(batch):
                self._gen_str(s)  # validates + learns proto_info
                records.append([vals for _, vals in s])
            batch.clear()

        src = lines if lines is not None else [None]
        for line in src:
            for sample in self._iter_source(line):
                batch.append(sample)
                if len(batch) == self.batch_size_:
                    flush()
        flush()
        if binary:
            types = slot_types or [
                t for _, t in (self._proto_info or [])]
            write_multislot_binary(path, records, types)
        else:
            with open(path, "w") as f:
                for rec in records:
                    f.write(" ".join(
                        f"{len(v)} " + " ".join(str(x) for x in v)
                        for v in rec) + "\n")
        return len(records)

    # -- internals ------------------------------------------------------
    def _iter_source(self, line):
        """Raw samples from generate_sample (batch hooks apply later,
        per batch_size_ chunk: the reference DataGenerator protocol)."""
        it = self.generate_sample(line)
        if it is None:
            raise ValueError("generate_sample returned None")
        gen = it() if callable(it) else it
        for sample in gen:
            if sample is not None:
                yield sample

    def _apply_batch(self, samples):
        post = self.generate_batch(list(samples))
        return (post() if callable(post) else post)

    def _flush_batch(self, samples, out):
        for s in self._apply_batch(samples):
            out.write(self._gen_str(s))

    def generate_sample(self, line):
        raise NotImplementedError(
            "implement generate_sample(line) -> generator of "
            "[(name, [values...]), ...]")

    def generate_batch(self, samples):
        def local_iter():
            for s in samples:
                yield s
        return local_iter

    def _gen_str(self, line):
        raise NotImplementedError(
            "use MultiSlotDataGenerator or MultiSlotStringDataGenerator")


class MultiSlotDataGenerator(DataGenerator):
    """Numeric slots: sample = [(name, [int-or-float...]), ...]; wire
    line = `<n> v1..vn` per slot, space-joined (data_feed.cc
    MultiSlotDataFeed)."""

    def _gen_str(self, line):
        if not isinstance(line, (list, tuple)):
            raise ValueError(
                "the output of generate_sample must be list/tuple of "
                "(name, [values...]); got %r" % type(line))
        if self._proto_info is None:
            self._proto_info = []
            for name, elements in line:
                if not isinstance(name, str):
                    raise ValueError("slot name must be str")
                if not isinstance(elements, list) or not elements:
                    raise ValueError(
                        f"slot {name}: elements must be a non-empty "
                        f"list (pad in generate_sample)")
                is_f = any(isinstance(e, float) for e in elements)
                self._proto_info.append(
                    (name, "float32" if is_f else "int64"))
        else:
            if len(line) != len(self._proto_info):
                raise ValueError(
                    f"every sample must emit {len(self._proto_info)} "
                    f"slots, got {len(line)}")
            for (name, elements), (want, ftype) in zip(
                    line, self._proto_info):
                if name != want:
                    raise ValueError(
                        f"slot order changed: expected {want}, "
                        f"got {name}")
                if not elements:
                    raise ValueError(f"slot {name}: empty elements")
        parts = []
        for _, elements in line:
            parts.append(str(len(elements)))
            parts.extend(str(e) for e in elements)
        return " ".join(parts) + "\n"


class MultiSlotStringDataGenerator(DataGenerator):
    """Pre-stringified slots: sample = [(name, ["1", "2"]), ...], the
    fastest path when upstream already has strings."""

    def _gen_str(self, line):
        if not isinstance(line, (list, tuple)):
            raise ValueError(
                "the output of generate_sample must be list/tuple")
        parts = []
        for _, elements in line:
            parts.append(str(len(elements)))
            parts.extend(elements)
        return " ".join(parts) + "\n"
