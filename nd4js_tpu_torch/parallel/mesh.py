"""Data parallelism over the batch axis, the counterpart of
``nd4js_tpu/parallel/mesh.py``, on ``torch.distributed``.

Every routine of the library is a function whose batch is its leading
axis, so scaling over cards is data parallel: shard the batch over a
mesh axis, run each rank's shard, and the per-matrix kernels need no
collective. ``batch_sharded(f, mesh)`` returns ``f`` run that way, its
outputs ``DTensor``s sharded on dim 0 whose full tensor is ``f`` of the
whole input.

A mesh needs a process group. :func:`init_group` starts one from a store
and so needs no address: a ``HashStore`` for one process, a
``FileStore`` (one file that every rank names) for several; NCCL for
the card, gloo for the CPU, and no other pairing. :func:`make_mesh`
starts a one-process group itself where none exists. All ranks run on
one host: unless the caller set them, NCCL's and gloo's own sockets are
pinned to the loopback interface (``NCCL_SOCKET_IFNAME``,
``GLOO_SOCKET_IFNAME``).
"""
from __future__ import annotations

import datetime
import functools
import math
import os

import torch

from .. import config
from ..convert import as_tensor

__all__ = ["init_group", "make_mesh", "shard_batch", "batch_sharded"]

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _device_type(device) -> str:
    kind = torch.device(config.default_device if device is None
                        else device).type
    if kind not in _BACKEND:
        raise ValueError(f"no process-group backend for device {kind!r}")
    return kind


def init_group(device=None, world_size: int = 1, rank: int = 0,
               store_path=None, timeout_s: float = 300.0) -> None:
    """Start torch.distributed's default process group for this process,
    rank ``rank`` of ``world_size``: NCCL on the card ``rank`` when
    ``device`` (default ``config.default_device``) is CUDA, gloo when it
    is the CPU. One process needs no store; several name one
    ``store_path`` (a file, created by the first rank). Raises where the
    host has fewer cards than ranks."""
    import torch.distributed as dist
    kind = _device_type(device)
    if kind == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if world_size > cards:
            raise RuntimeError(f"{world_size} NCCL ranks need as many CUDA "
                               f"cards; this host has {cards}")
        torch.cuda.set_device(rank)
    if store_path is None:
        if world_size != 1:
            raise ValueError("several processes need a store_path")
        store = dist.HashStore()
    else:
        store = dist.FileStore(str(store_path), world_size)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(_BACKEND[kind], store=store, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(axes=None, device=None):
    """A ``DeviceMesh`` over the first ranks of the process group.
    Default: a 1-D 'batch' mesh over all of them; ``axes`` maps names to
    sizes, e.g. ``{"batch": 2, "model": 2}``. Starts a one-process group
    on ``device`` (default ``config.default_device``) when there is none;
    raises when the group's backend does not serve ``device`` or has
    fewer ranks than the mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    kind = _device_type(device)
    if not dist.is_initialized():
        init_group(kind)
    if dist.get_backend() != _BACKEND[kind]:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, "
                           f"not {_BACKEND[kind]} for {kind}")
    world = dist.get_world_size()
    if axes is None:
        axes = {"batch": world}
    names = tuple(axes)
    shape = tuple(int(s) for s in axes.values())
    if math.prod(shape) > world:
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} "
                         f"ranks; the process group has {world}")
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(kind, ranks, mesh_dim_names=names)


def _placements(mesh, axis_name):
    from torch.distributed.tensor import Replicate, Shard
    if axis_name not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no axis {axis_name!r}: "
                         f"{mesh.mesh_dim_names}")
    return [Shard(0) if n == axis_name else Replicate()
            for n in mesh.mesh_dim_names]


def _rank_device(mesh):
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_batch(x, mesh, axis_name: str = "batch"):
    """``x`` as a ``DTensor`` with its leading axis sharded over the mesh
    axis ``axis_name`` (replicated over the others). Every rank passes
    the same ``x``."""
    from torch.distributed.tensor import distribute_tensor
    x = as_tensor(x, _rank_device(mesh))
    return distribute_tensor(x, mesh, _placements(mesh, axis_name))


def batch_sharded(f, mesh, axis_name: str = "batch"):
    """``f`` with every array argument's leading axis sharded over the
    mesh axis ``axis_name``: each rank runs ``f`` on its local shards, and
    every tensor output, whose leading axis must be the batch, comes back
    as a ``DTensor`` sharded on dim 0 (its ``full_tensor()`` is ``f`` of
    the whole input)."""

    @functools.wraps(f)
    def wrapper(*args):
        from torch.distributed.tensor import DTensor
        shards = [shard_batch(a, mesh, axis_name) for a in args]
        batch = shards[0].shape[0]
        placements = _placements(mesh, axis_name)

        def lift(o):
            if not isinstance(o, torch.Tensor):
                return o
            shape = torch.Size((batch,) + tuple(o.shape[1:]))
            stride = torch.empty(shape, device="meta").stride()
            return DTensor.from_local(o, mesh, placements, run_check=False,
                                      shape=shape, stride=stride)

        out = f(*[s.to_local() for s in shards])
        if not isinstance(out, tuple):
            return lift(out)
        lifted = [lift(o) for o in out]
        return type(out)(*lifted) if hasattr(out, "_fields") \
            else tuple(lifted)

    return wrapper
