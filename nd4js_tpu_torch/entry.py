"""The port's counterparts of ``__graft_entry__.py``: ``entry()``, one
forward step of the flagship workload, batched least squares by QR, and
``dryrun_multichip(n)``, one step of the whole sharded pipeline on a mesh
of n ranks."""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import config, la
from .core.mm import einsum

__all__ = ["entry", "forward", "dryrun_multichip"]

# the dry run's tolerance, sharded against replicated, as
# __graft_entry__._dryrun_impl states it: float32 reduction order
DRYRUN_TOL = 1e-4
# seconds a spawned rank may take, and its process group's timeout
DRYRUN_TIMEOUT_S = 120.0


def forward(a: torch.Tensor, y: torch.Tensor):
    """x = argmin‖A·x − y‖ by ``qr_decomp`` then ``qr_lstsq``, and the
    Frobenius norm of each residual A·x − y."""
    q, r = la.qr_decomp(a)
    x = la.qr_lstsq(q, r, y)
    resid = la.norm_fro(la.matmul2(a, x) - y, axis=(-2, -1))
    return x, resid


def entry(device=None, seed: int = 0):
    """(forward, (a, y)) at the shapes of ``__graft_entry__.entry()``:
    a (4, 128, 128), y (4, 128, 1), float32, standard normal from a
    ``torch.Generator`` seeded with ``seed``, on ``device`` (default
    ``config.default_device``)."""
    b, n = 4, 128
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn((b, n, n), generator=gen, dtype=torch.float32)
    y = torch.randn((b, n, 1), generator=gen, dtype=torch.float32)
    device = config.default_device if device is None else device
    return forward, (a.to(device), y.to(device))


def _dryrun_step(a, y, w):
    """QR + LU + SVD least squares on the batch, then a GEMM with w (its
    rows the 'model' shard) and the local share of the loss."""
    q, r = la.qr_decomp(a)
    x = la.qr_lstsq(q, r, y)
    lu, p = la.lu_decomp(a)
    x2 = la.lu_solve(lu, p, y)
    u, sv, v = la.svd_decomp(a)
    x3 = la.svd_lstsq(u, sv, v, y)
    z = einsum("kn,bnj->bkj", w, x + x2 + x3)
    return torch.sum(z * z), x


def _dryrun_mesh_run(n_devices: int, kind: str) -> None:
    """The dry run on this rank of an initialised group of n_devices."""
    import torch.distributed as dist
    from .parallel import make_mesh, shard_batch
    # a 2-D (batch, model) mesh where n is even, as _dryrun_impl lays it
    shape = (n_devices // 2, 2) if n_devices % 2 == 0 and n_devices > 1 \
        else (n_devices, 1)
    mesh = make_mesh({"batch": shape[0], "model": shape[1]}, kind)
    b, n, k = shape[0] * 2, 32, 64 * shape[1]
    rng = np.random.default_rng(1)
    a = rng.standard_normal((b, n, n)).astype(np.float32)
    y = rng.standard_normal((b, n, 1)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    a_l = shard_batch(a, mesh, "batch").to_local()
    y_l = shard_batch(y, mesh, "batch").to_local()
    w_l = shard_batch(w, mesh, "model").to_local()
    loss, x = _dryrun_step(a_l, y_l, w_l)
    # each rank holds one (batch shard, model shard) pair: the loss is
    # the sum over all ranks, the collective of the step
    dist.all_reduce(loss)
    dev = a_l.device
    loss_r, x_r = _dryrun_step(*(torch.from_numpy(t).to(dev)
                                 for t in (a, y, w)))
    x_r = torch.chunk(x_r, shape[0])[mesh.get_local_rank("batch")]
    if not torch.isfinite(loss):
        raise AssertionError("multichip dry run produced a non-finite loss")
    scale = max(1.0, float(x_r.abs().max()))
    dx = float((x - x_r).abs().max())
    dl = abs(float(loss) - float(loss_r)) / max(1.0, abs(float(loss_r)))
    if not (dx <= DRYRUN_TOL * scale and dl <= DRYRUN_TOL):
        raise AssertionError(
            f"sharded vs replicated disagree: |dx|={dx:.3e} (scale "
            f"{scale:.3e}), dloss_rel={dl:.3e}")


def _dryrun_rank(rank: int, n_devices: int, kind: str, store_path) -> None:
    """One spawned rank: one torch thread, its own group, the dry run."""
    import torch.distributed as dist
    from .parallel import init_group
    torch.set_num_threads(1)
    init_group(kind, n_devices, rank, store_path,
               timeout_s=DRYRUN_TIMEOUT_S)
    try:
        _dryrun_mesh_run(n_devices, kind)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One step of the sharded pipeline on a mesh of ``n_devices`` ranks,
    checked against the same step replicated (``__graft_entry__``'s dry
    run): QR, LU and SVD least squares on the 'batch' shards, a GEMM with
    the weights sharded over 'model', and the loss by an all-reduce.

    On the card (``device`` CUDA, the default ``config.default_device``)
    each rank is an NCCL rank on its own card: one rank runs in this
    process, in its process group if it has one; more ranks than cards
    raise. With ``device="cpu"`` it spawns ``n_devices`` gloo processes.
    A rank whose check fails raises, and so does this call.
    """
    import torch.distributed as dist
    from .parallel import init_group
    from .parallel.mesh import _device_type
    kind = _device_type(device)
    if kind == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(f"{n_devices} NCCL ranks need as many CUDA cards; "
                           f"this host has {torch.cuda.device_count()}")
    if kind == "cuda" and n_devices == 1:
        own = not dist.is_initialized()
        if own:
            init_group(kind)
        try:
            _dryrun_mesh_run(1, kind)
        finally:
            if own:
                dist.destroy_process_group()
        return
    _spawn_ranks(n_devices, kind)


def _spawn_ranks(n_devices: int, kind: str):
    """Run :func:`_dryrun_rank` in n_devices fresh interpreters, one torch
    thread each, sharing a FileStore in a temporary directory; raise with
    the failed ranks' error output if any fails. Every process is ended
    before this returns."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    tmp = tempfile.mkdtemp(prefix="nd4js_dryrun_")
    store = os.path.join(tmp, "store")
    procs = []
    try:
        for rank in range(n_devices):
            code = ("from nd4js_tpu_torch.entry import _dryrun_rank; "
                    f"_dryrun_rank({rank}, {n_devices}, {kind!r}, {store!r})")
            # output to files: a rank blocked on a full pipe would stall
            # the collectives of the others
            with open(os.path.join(tmp, f"rank{rank}.log"), "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code], cwd=root, env=env,
                    stdout=log, stderr=subprocess.STDOUT))
        # until all ranks end, one fails (its peers would wait for it) or
        # the time is up
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        while any(p.poll() is None for p in procs) and not any(
                p.poll() for p in procs) and time.monotonic() < deadline:
            time.sleep(0.05)
        failed = []
        for rank, proc in enumerate(procs):
            if proc.poll() != 0:
                with open(os.path.join(tmp, f"rank{rank}.log")) as log:
                    failed.append(f"rank {rank} exited {proc.poll()}:\n"
                                  f"{log.read()[-3000:]}")
        if failed:
            raise RuntimeError("multichip dry run failed:\n"
                               + "\n".join(failed))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
