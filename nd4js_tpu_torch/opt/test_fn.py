"""Analytic optimisation test functions, the counterpart of
``nd4js_tpu/opt/test_fn.py``: rosenbrock, rastrigin, beale,
brown_badscale, freudenstein_roth, helical_valley, jennrich_sampson and
powell_badscale, each a torch function of one point with ``.grad``
(``torch.func.grad``), ``.hess`` (``torch.func.hessian``), ``.minima``
and ``.ndim``.
"""
from __future__ import annotations

import math

import torch

from ..convert import as_tensor

__all__ = ["rosenbrock", "rastrigin", "beale", "brown_badscale",
           "freudenstein_roth", "helical_valley", "jennrich_sampson",
           "powell_badscale", "TEST_FNS"]


class TestFn:
    __test__ = False  # not a pytest class

    def __init__(self, fn, minima=None, ndim=None, name=""):
        self._fn = fn
        self.minima = minima or []
        self.ndim = ndim
        self.name = name
        grad, hess = torch.func.grad(fn), torch.func.hessian(fn)
        # array-likes go to config.default_device, as for f itself
        self.grad = lambda x: grad(as_tensor(x))
        self.hess = lambda x: hess(as_tensor(x))

    def __call__(self, x):
        return self._fn(as_tensor(x))


def _rosenbrock(x):
    return torch.sum(100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def _rastrigin(x):
    return 10 * x.numel() + torch.sum(x * x - 10 * torch.cos(2 * math.pi * x))


def _beale(x):
    a, b = x[0], x[1]
    return ((1.5 - a + a * b) ** 2 + (2.25 - a + a * b ** 2) ** 2
            + (2.625 - a + a * b ** 3) ** 2)


def _brown_badscale(x):
    return ((x[0] - 1e6) ** 2 + (x[1] - 2e-6) ** 2
            + (x[0] * x[1] - 2) ** 2)


def _freudenstein_roth(x):
    return ((-13 + x[0] + ((5 - x[1]) * x[1] - 2) * x[1]) ** 2
            + (-29 + x[0] + ((x[1] + 1) * x[1] - 14) * x[1]) ** 2)


def _helical_valley(x):
    theta = torch.atan2(x[1], x[0]) / (2 * math.pi)
    r = torch.sqrt(x[0] ** 2 + x[1] ** 2)
    return (100 * ((x[2] - 10 * theta) ** 2 + (r - 1) ** 2)
            + x[2] ** 2)


def _jennrich_sampson(x):
    i = torch.arange(1, 11, dtype=x.dtype, device=x.device)
    return torch.sum((2 + 2 * i - (torch.exp(i * x[0])
                                   + torch.exp(i * x[1]))) ** 2)


def _powell_badscale(x):
    return ((1e4 * x[0] * x[1] - 1) ** 2
            + (torch.exp(-x[0]) + torch.exp(-x[1]) - 1.0001) ** 2)


rosenbrock = TestFn(_rosenbrock, minima=[[1.0, 1.0]], name="rosenbrock")
rastrigin = TestFn(_rastrigin, minima=[[0.0, 0.0]], name="rastrigin")
beale = TestFn(_beale, minima=[[3.0, 0.5]], ndim=2, name="beale")
brown_badscale = TestFn(_brown_badscale, minima=[[1e6, 2e-6]], ndim=2,
                        name="brown_badscale")
freudenstein_roth = TestFn(_freudenstein_roth, minima=[[5.0, 4.0]],
                           ndim=2, name="freudenstein_roth")
helical_valley = TestFn(_helical_valley, minima=[[1.0, 0.0, 0.0]],
                        ndim=3, name="helical_valley")
jennrich_sampson = TestFn(_jennrich_sampson,
                          minima=[[0.25782521, 0.25782521]], ndim=2,
                          name="jennrich_sampson")
powell_badscale = TestFn(_powell_badscale,
                         minima=[[1.09817703e-5, 9.106]], ndim=2,
                         name="powell_badscale")

TEST_FNS = [rosenbrock, rastrigin, beale, brown_badscale,
            freudenstein_roth, helical_valley, jennrich_sampson,
            powell_badscale]
