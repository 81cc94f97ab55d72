"""ODE integration by the classic fixed-step RK4, the counterpart of
``nd4js_tpu/utils/integrate.py``. The JAX package's ``lax.scan`` over the
time pairs is a Python loop here; f is a torch function of (t, y), so the
trajectory is differentiable through ``torch.func`` or autograd."""
from __future__ import annotations

import torch

from ..config import default_float_for
from ..convert import as_tensor

__all__ = ["rk4_step", "odeint_rk4"]


def rk4_step(f, t, y, dt):
    """One classic Runge-Kutta-4 step."""
    k1 = f(t, y)
    k2 = f(t + dt / 2, y + dt / 2 * k1)
    k3 = f(t + dt / 2, y + dt / 2 * k2)
    k4 = f(t + dt, y + dt * k3)
    return y + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def odeint_rk4(f, y0, ts, device=None):
    """Integrate dy/dt = f(t, y) over the time points ``ts``. Returns the
    trajectory (len(ts), *y0.shape), y0 included. An array-like y0 goes to
    ``device`` (default ``config.default_device``); ``ts`` follows its device
and dtype."""
    y = as_tensor(y0, device)
    y = y.to(default_float_for(y.dtype))
    ts = as_tensor(ts, y.device).to(y.dtype)
    ys = [y]
    for t0, t1 in zip(ts[:-1], ts[1:]):
        y = rk4_step(f, t0, y, t1 - t0)
        ys.append(y)
    return torch.stack(ys)
