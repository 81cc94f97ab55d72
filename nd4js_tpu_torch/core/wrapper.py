"""Optional NDArray wrapper — the reference's object surface, the
counterpart of ``nd4js_tpu/core/wrapper.py``.

The idiomatic API is functional over plain ``torch.Tensor``; this
wrapper exists so that reference users can port code line by line. It
is a thin immutable view: every "mutating" method (``set``, ``modify``)
returns a new wrapper over a new tensor. Torch functions unwrap it
(``__torch_function__``: ``torch.sum(a)`` sums ``a.data``), and
``numpy.asarray(a)`` copies its data to the host.
"""
from __future__ import annotations

import numpy as np

from . import ndarray as _nd

__all__ = ["NDArray", "wrap"]


def _unwrap(x):
    if isinstance(x, NDArray):
        return x.data
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(v) for v in x)
    if isinstance(x, dict):
        return {k: _unwrap(v) for k, v in x.items()}
    return x


class NDArray:
    """An immutable wrapper over a tensor with the reference's methods;
    ``NDArray(data, dtype=None, device=None)`` takes what
    :func:`core.asarray` takes."""
    __slots__ = ("data",)
    __array_priority__ = 100

    def __init__(self, data, dtype=None, device=None):
        self.data = _nd.asarray(data, dtype=dtype, device=device)

    # ---- interop -----------------------------------------------------
    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return func(*_unwrap(args), **_unwrap(kwargs or {}))

    def __array__(self, dtype=None, copy=None):
        a = self.data.detach().cpu().numpy()
        return a if dtype is None else a.astype(dtype)

    # ---- reference surface -------------------------------------------
    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def dtype(self):
        return self.data.dtype

    def __call__(self, *indices):
        """Element access a(i, j, ...)."""
        return self.data[tuple(indices)]

    def __getitem__(self, idx):
        return NDArray(self.data[idx])

    def set(self, indices, value):
        """Out-of-place element set: a copy with ``value`` at ``indices``
        (the reference mutates in place)."""
        out = self.data.clone()
        out[tuple(indices)] = _unwrap(value)
        return NDArray(out)

    def modify(self, indices, fn):
        """Out-of-place element modify: a copy with ``fn`` of the entries
        at ``indices`` there."""
        idx = tuple(indices)
        out = self.data.clone()
        out[idx] = _unwrap(fn(self.data[idx]))
        return NDArray(out)

    @property
    def T(self):
        """Transpose of the trailing two axes."""
        return NDArray(self.data.transpose(-1, -2)) if self.ndim >= 2 \
            else self

    @property
    def H(self):
        """Conjugate transpose of the trailing two axes."""
        out = self.data.conj().resolve_conj()
        if self.ndim >= 2:
            out = out.transpose(-1, -2)
        return NDArray(out)

    def transpose(self, *axes):
        """Out-of-place axis permutation (all axes reversed by default)."""
        return NDArray(self.data.permute(
            *(axes or reversed(range(self.ndim)))))

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return NDArray(self.data.reshape(shape))

    def map_elems(self, mapper, dtype=None):
        """Elementwise map; the mapper works on whole tensors."""
        return NDArray(_nd.map_elems(self.data, mapper, dtype=dtype))

    mapElems = map_elems

    def reduce_elems(self, axes=None, reducer=None, dtype=None,
                     initial=None):
        out = _nd.reduce_elems(self.data, axes, reducer, dtype=dtype,
                               initial=initial)
        return NDArray(out) if getattr(out, "ndim", 0) else out

    reduceElems = reduce_elems

    def slice_elems(self, *slices):
        return NDArray(_nd.slice_elems(self.data, *slices))

    sliceElems = slice_elems

    # ---- iteration ---------------------------------------------------
    def __iter__(self):
        for i in range(self.shape[0]):
            sub = self.data[i]
            yield NDArray(sub) if sub.ndim else sub

    def elems(self):
        """Yield (index-tuple, value) pairs, the data read to the host
        once."""
        a = np.asarray(self)
        for idx in np.ndindex(*a.shape):
            yield idx, a[idx]

    def __len__(self):
        return self.shape[0]

    # ---- arithmetic passthrough ---------------------------------------
    def __add__(self, o):
        return NDArray(self.data + _unwrap(o))

    def __radd__(self, o):
        return NDArray(_unwrap(o) + self.data)

    def __sub__(self, o):
        return NDArray(self.data - _unwrap(o))

    def __rsub__(self, o):
        return NDArray(_unwrap(o) - self.data)

    def __mul__(self, o):
        return NDArray(self.data * _unwrap(o))

    def __rmul__(self, o):
        return NDArray(_unwrap(o) * self.data)

    def __truediv__(self, o):
        return NDArray(self.data / _unwrap(o))

    def __rtruediv__(self, o):
        return NDArray(_unwrap(o) / self.data)

    def __matmul__(self, o):
        from ..la.matmul import matmul2
        return NDArray(matmul2(self.data, _unwrap(o)))

    def __neg__(self):
        return NDArray(-self.data)

    def __repr__(self):
        return f"NDArray({self.data!r})"

    def __str__(self):
        return str(self.data)


def wrap(x) -> NDArray:
    return x if isinstance(x, NDArray) else NDArray(x)
