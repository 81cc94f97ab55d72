"""Plain-array helpers, the counterpart of ``nd4js_tpu/utils/arrays.py``:
``binary_search``/``binary_rangesearch``, the incremental
``heap_sort_gen``, ``shuffle``, ``is_array``, ``Comparator``, and
``checked_array``, a view whose integer indices outside [−len, len)
raise IndexError, checked on the host before the tensor is indexed,
while ``config.debug_checks`` is on."""
from __future__ import annotations

import functools
import heapq
import random
from typing import Callable, Iterable

import numpy as np
import torch

from .. import config
from ..convert import as_tensor

__all__ = ["binary_search", "binary_rangesearch", "heap_sort_gen",
           "shuffle", "is_array", "Comparator", "checked_array"]


class _CheckedArray:
    """Bounds-checking view: integer indices outside [−n, n) raise
    IndexError; negative ones in range wrap, as the reference allows."""

    __slots__ = ("_a",)

    def __init__(self, a):
        self._a = a

    def _check(self, idx):
        pairs = enumerate(idx) if isinstance(idx, tuple) else [(0, idx)]
        for ax, i in pairs:
            if isinstance(i, (int, np.integer)):
                n = self._a.shape[ax]
                if not -n <= i < n:
                    raise IndexError(
                        f"checked_array: index {i} out of bounds "
                        f"for axis {ax} of size {n}")

    def __getitem__(self, idx):
        self._check(idx)
        return self._a[idx]

    def __len__(self):
        return len(self._a)

    def __getattr__(self, name):
        return getattr(self._a, name)

    def __repr__(self):
        return f"checked_array({self._a!r})"


def checked_array(a, device=None):
    """``a`` as a tensor in a bounds-checking view when
    ``config.debug_checks`` is on; ``a`` unchanged otherwise. An
    array-like goes to ``device`` (default ``config.default_device``)."""
    if not config.debug_checks:
        return a
    return _CheckedArray(as_tensor(a, device))


def _cmp(x, y):
    """−1, 0 or 1; numpy and tensor elements too."""
    return int(x > y) - int(x < y)


def binary_search(arr, value, compare: Callable | None = None) -> int:
    """Index of ``value`` in sorted ``arr``; ~(insertion point) when
    absent (the reference's bit-complement convention)."""
    a = arr if isinstance(arr, list) else _host(arr)
    lo, hi = 0, len(a)
    cmp = compare or _cmp
    while lo < hi:
        mid = (lo + hi) // 2
        c = cmp(a[mid], value)
        if c == 0:
            return mid
        if c < 0:
            lo = mid + 1
        else:
            hi = mid
    return ~lo


def binary_rangesearch(arr, value, compare: Callable | None = None):
    """(lo, hi), the half-open range of the entries equal to value."""
    a = arr if isinstance(arr, list) else list(_host(arr))
    cmp = compare or _cmp

    def bound(upper: bool):
        lo, hi = 0, len(a)
        while lo < hi:
            mid = (lo + hi) // 2
            c = cmp(a[mid], value)
            if c < 0 or (upper and c == 0):
                lo = mid + 1
            else:
                hi = mid
        return lo

    return bound(False), bound(True)


def _host(a):
    """A numpy copy of an array-like or tensor, for host-side search."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def heap_sort_gen(items: Iterable, compare: Callable | None = None):
    """Yield items in sorted order incrementally: pay only for what is
    consumed."""
    if compare is None:
        h = list(items)
        heapq.heapify(h)
        while h:
            yield heapq.heappop(h)
    else:
        key = functools.cmp_to_key(compare)
        h = [(key(x), x) for x in items]
        heapq.heapify(h)
        while h:
            yield heapq.heappop(h)[1]


def shuffle(arr, rng=None):
    """Fisher-Yates shuffle; returns a new sequence. With an
    ``nd4js_tpu_torch.rand.RNG``, a tensor permuted by its stream
    (``RNG.shuffle``); without one, a list by Python's ``random``."""
    if rng is not None:
        return rng.shuffle(arr)
    a = list(arr) if isinstance(arr, list) else list(_host(arr))
    random.shuffle(a)
    return a


def is_array(x) -> bool:
    return isinstance(x, (list, tuple, np.ndarray, torch.Tensor))


class Comparator:
    """Chainable comparator builder."""

    def __init__(self, cmp: Callable | None = None):
        self._cmp = cmp or _cmp

    def __call__(self, x, y):
        return self._cmp(x, y)

    def reversed(self) -> "Comparator":
        return Comparator(lambda x, y: self._cmp(y, x))

    def then(self, other: "Comparator") -> "Comparator":
        def cmp(x, y):
            c = self._cmp(x, y)
            return c if c != 0 else other(x, y)
        return Comparator(cmp)

    def by_key(self, key: Callable) -> "Comparator":
        return Comparator(lambda x, y: self._cmp(key(x), key(y)))
