"""Shared shim: map-style Dataset -> legacy reader generator."""
from __future__ import annotations


def dataset_reader(make_dataset):
    """Wrap a Dataset factory into a reader() generator factory."""

    def reader():
        ds = make_dataset()
        for i in range(len(ds)):
            yield tuple(ds[i])

    return reader
