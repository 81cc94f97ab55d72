"""Empty inputs of the port's general-eigen entry points held against the
JAX package on the CPU: ``schur_decomp``, ``eigenvals`` and ``eigen`` on
an empty batch of 5×5 matrices, ``hessenberg_decomp`` and
``eigen_balance_pre`` on 0×0 matrices, batched or not, all float64. Each
output has the reference's shape and dtype (and, being empty, nothing
else to compare).
"""
import numpy as np
import pytest
import torch

from nd4js_tpu import la as jla

from nd4js_tpu_torch import la

CPU = "cpu"


def _layout(out):
    """(shape, dtype name) of an output or of each in a tuple of them."""
    if isinstance(out, (tuple, list)):
        return [_layout(x) for x in out]
    if isinstance(out, torch.Tensor):
        return tuple(out.shape), str(out.dtype).removeprefix("torch.")
    return tuple(out.shape), str(out.dtype)


@pytest.mark.parametrize("shape", [(0, 5, 5), (2, 0, 5, 5)])
@pytest.mark.parametrize("fn", ["schur_decomp", "eigenvals", "eigen"])
def test_empty_batch_of_small_matrices(fn, shape):
    a = np.zeros(shape)
    want = _layout(getattr(jla, fn)(a))
    got = _layout(getattr(la, fn)(a, device=CPU))
    assert got == want


@pytest.mark.parametrize("shape", [(0, 0), (1, 0, 0), (2, 0, 0)])
@pytest.mark.parametrize("fn", ["hessenberg_decomp", "eigen_balance_pre"])
def test_zero_by_zero_matrices(fn, shape):
    a = np.zeros(shape)
    want = _layout(getattr(jla, fn)(a))
    got = _layout(getattr(la, fn)(a, device=CPU))
    assert got == want
