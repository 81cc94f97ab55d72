"""Counted reads of device values on the host.

The JAX package runs its iterative solvers as one ``lax.while_loop`` with
``lax.cond`` inside; the port runs them as Python loops. Every value the
host needs from the device to decide (a loop's condition, a branch that
skips work) goes through :func:`read`, which counts the reads as the
kernel wrappers of ``ops/`` count their launches. On a CUDA tensor each
read waits for the device.
"""
from __future__ import annotations

import torch

__all__ = ["read"]

# Host reads since the last reset; only read() adds to it.
reads = 0


def read(flag: torch.Tensor):
    """The Python value (bool, int or float) of a 0-d tensor."""
    global reads
    reads += 1
    return flag.item()
