"""Sparse tensors of the port (the JAX package's `sparse/`):
`SelectedRows` gradients and COO / CSR tensors.

A SelectedRows is Paddle's row-sparse tensor: row ids (int64 [n]), their
values ([n, ...]) and the dense height V. Rows may repeat; `merge()` sums
them. It is what `nn.Embedding(sparse=True)` gives as the weight's
gradient, what the sparse optimizer rules consume and what
`Communicator.push` sends, so a 1M-row table never has a dense [V, D]
gradient.

torch's autograd carries only tensors, so the gradient itself travels as
an *uncoalesced* `torch.sparse_coo_tensor` of the weight's shape, with
indices [1, n] and values [n, D]; a second backward concatenates onto it
(`AccumulateGrad` adds two uncoalesced tensors by joining their entries).
`SelectedRows(t)` wraps such a tensor without a copy (its `_indices()[0]`
and `_values()`), and `to_sparse()` gives one back.

Merging is deterministic on every device: the rows are sorted stably
(`coalesce`, a radix sort on CUDA) and each run of equal rows is summed
in its original order, so a merge repeats bit for bit on the card, where
an `index_add_` would sum duplicates by atomics in a varying order. Rows
at or past `height` (the JAX package's shape-stable fill rows) are
dropped by `merge()` and `to_dense()`.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["SelectedRows", "SparseCooTensor", "sparse_coo_tensor",
           "sparse_csr_tensor", "matmul", "is_sparse_grad"]


def _tensor(x, dtype=None, device=None):
    """A tensor of x: a tensor stays where it is (or moves to `device`),
    an array or list lands on `device`, else on `device=None`'s device
    (the card unless `paddle.set_device("cpu")`)."""
    if isinstance(x, SelectedRows):
        raise TypeError("expected a dense tensor or array, got SelectedRows")
    if not isinstance(x, torch.Tensor):
        from ..core.device import resolve_device

        x = torch.as_tensor(np.asarray(x), device=resolve_device(device))
    if device is not None and x.device != torch.device(device):
        x = x.to(device)
    return x if dtype is None else x.to(dtype)


def is_sparse_grad(g):
    """True for a row-sparse gradient: a torch sparse COO tensor or a
    SelectedRows."""
    return isinstance(g, SelectedRows) or (
        isinstance(g, torch.Tensor) and g.layout == torch.sparse_coo)


def _coo(indices, values, shape):
    return torch.sparse_coo_tensor(indices, values, shape,
                                   check_invariants=False)


class SelectedRows:
    """{rows: int64 [n], values: [n, ...], height: V}, row-sparse.

    Built from (rows, values, height), or from a torch sparse COO tensor
    alone (`SelectedRows(t)`, no copy); rows follow the values' device,
    and arrays land on the default device (the card unless
    `paddle.set_device("cpu")`), as every tensor the port makes. `+` with another SelectedRows
    concatenates (the sparse gradient accumulator's rule); `+` with a
    dense tensor densifies."""

    def __init__(self, rows, values=None, height=None):
        if values is None and isinstance(rows, torch.Tensor) \
                and rows.layout == torch.sparse_coo:
            t = rows
            if t.sparse_dim() != 1:
                raise ValueError(f"a SelectedRows has one sparse dim, the "
                                 f"tensor has {t.sparse_dim()}")
            self.values = t._values()
            self.rows = t._indices()[0]
            self.height = int(t.shape[0])
            return
        if values is None or height is None:
            raise TypeError("SelectedRows(rows, values, height) or "
                            "SelectedRows(sparse_coo_tensor)")
        self.values = _tensor(values)
        self.rows = _tensor(rows, torch.int64,
                            self.values.device).reshape(-1)
        self.height = int(height)

    @property
    def shape(self):
        return (self.height,) + tuple(self.values.shape[1:])

    @property
    def dtype(self):
        return self.values.dtype

    def astype(self, dtype):
        from ..core.dtypes import convert_dtype

        return SelectedRows(self.rows, self.values.to(convert_dtype(dtype)),
                            self.height)

    def to_sparse(self):
        """The rows as an uncoalesced torch sparse COO tensor of `shape`
        (rows past `height` dropped)."""
        rows, values = self.rows, self.values
        if rows.numel() and int(rows.max()) >= self.height:
            keep = rows < self.height
            rows, values = rows[keep], values[keep]
        return _coo(rows[None], values, self.shape)

    def merge(self, shape_stable=False):
        """Sum duplicate rows (MergeAdd): each distinct row once, in
        ascending order, its values summed in their original order. Rows
        past `height` are dropped. `shape_stable=True` pads the result
        back to the input's row count with fill rows (`height`, zero
        values), as the JAX package's shape-stable merge does."""
        n = self.rows.numel()
        rows = self.rows.clamp(max=self.height)
        t = _coo(rows[None], self.values,
                 (self.height + 1,) + tuple(self.values.shape[1:]))
        t = t.coalesce()
        urows, uvals = t._indices()[0], t._values()
        if urows.numel() and int(urows[-1]) == self.height:
            urows, uvals = urows[:-1], uvals[:-1]
        if shape_stable and urows.numel() < n:
            pad = n - urows.numel()
            urows = torch.cat([urows, urows.new_full((pad,), self.height)])
            uvals = torch.cat([uvals, uvals.new_zeros(
                (pad,) + tuple(uvals.shape[1:]))])
        return SelectedRows(urows, uvals, self.height)

    def to_dense(self):
        """The dense [V, ...] tensor (duplicates summed as `merge` sums
        them)."""
        m = self.merge()
        dense = m.values.new_zeros(self.shape)
        dense[m.rows] = m.values
        return dense

    def __add__(self, other):
        if isinstance(other, SelectedRows):
            if other.height != self.height:
                raise ValueError("SelectedRows height mismatch")
            return SelectedRows(torch.cat([self.rows, other.rows]),
                                torch.cat([self.values, other.values]),
                                self.height)
        dense = _tensor(other, device=self.values.device)
        m = self.merge()
        out = dense.clone()
        out[m.rows] += m.values.to(dense.dtype)
        return out

    __radd__ = __add__

    def numpy(self):
        return self.to_dense().detach().cpu().numpy()

    def __repr__(self):
        return (f"SelectedRows(height={self.height}, "
                f"nnz_rows={self.rows.shape[0]}, "
                f"value_shape={tuple(self.values.shape)})")


class SparseCooTensor:
    """Paddle's COO tensor: indices [sparse_dims, nnz] int64, values
    [nnz, ...dense dims], shape."""

    def __init__(self, indices, values, shape):
        self.values = _tensor(values)
        self.indices = _tensor(indices, torch.int64, self.values.device)
        self._shape = tuple(int(s) for s in shape)

    @property
    def shape(self):
        return list(self._shape)

    @property
    def dtype(self):
        return self.values.dtype

    def nnz(self):
        return int(self.values.shape[0])

    def to_torch(self):
        """The torch sparse COO tensor (uncoalesced)."""
        sd = self.indices.shape[0]
        shape = self._shape[:sd] + tuple(self.values.shape[1:])
        return _coo(self.indices, self.values, shape)

    def to_dense(self):
        return self.to_torch().to_dense()

    def coalesce(self):
        """Sum duplicate coordinates (sorted, each run summed in its
        original order)."""
        t = self.to_torch().coalesce()
        return SparseCooTensor(t._indices(), t._values(), self._shape)

    def __repr__(self):
        return f"SparseCooTensor(shape={self._shape}, nnz={self.nnz()})"


def sparse_coo_tensor(indices, values, shape, dtype=None):
    v = _tensor(values)
    if dtype is not None:
        from ..core.dtypes import convert_dtype

        v = v.to(convert_dtype(dtype))
    return SparseCooTensor(indices, v, shape)


def sparse_csr_tensor(crows, cols, values, shape, dtype=None):
    """A 2-D CSR tensor, held as COO (the JAX package's form)."""
    host = (lambda x: x.cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))
    crows, cols = host(crows).astype(np.int64), host(cols).astype(np.int64)
    rows = np.repeat(np.arange(len(crows) - 1), np.diff(crows))
    return sparse_coo_tensor(np.stack([rows, cols]), values, shape, dtype)


def matmul(sp, dense):
    """COO (2-D) @ dense: each nonzero's product with its column's row,
    summed into its row (in coordinate order, as a segment sum)."""
    if not isinstance(sp, SparseCooTensor):
        raise TypeError(f"matmul expects SparseCooTensor, got {type(sp)}")
    d = _tensor(dense, device=sp.values.device)
    rows, cols = sp.indices[0], sp.indices[1]
    contrib = sp.values[:, None] * d[cols]
    return SelectedRows(rows, contrib, sp._shape[0]).to_dense()
