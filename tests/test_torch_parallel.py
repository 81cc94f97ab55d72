"""The port's ``parallel`` on the CPU: ``batch_sharded(f)`` in a
one-process gloo group held against the JAX package's ``batch_sharded(f)``
on its 8 virtual CPU devices (tests/conftest.py), for an ``f`` that
reaches no Pallas kernel (``la.matmul2``, then ``la.norm_fro``), within
1e-12 relative in float64; ``batch_sharded(la.qr_decomp)`` in a
two-process gloo run against the port's own unsharded call (within
1e-12·max|A|: each rank factors its own matrices, in another batch);
the mesh's shapes and refusals; and ``entry.dryrun_multichip(4,
device="cpu")``, a 2×2 mesh of four gloo processes, once.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from nd4js_tpu import la as jla
from nd4js_tpu import parallel as jpar

from nd4js_tpu_torch import entry, la
from nd4js_tpu_torch.parallel import (batch_sharded, init_group, make_mesh,
                                      shard_batch)

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"


@pytest.fixture(scope="module")
def mesh():
    """A one-process gloo group for this module, and its 1-D mesh."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    assert not dist.is_initialized()
    m = make_mesh(device=CPU)
    yield m
    dist.destroy_process_group()
    torch.set_num_threads(before)


def _gemm_norm(a, b):
    c = la.matmul2(a, b)
    return c, la.norm_fro(c, axis=(-2, -1))


def _jgemm_norm(a, b):
    c = jla.matmul2(a, b)
    return c, jla.norm_fro(c, axis=(-2, -1))


def test_batch_sharded_matches_the_jax_package(mesh):
    rng = np.random.default_rng(11)
    a = rng.standard_normal((8, 6, 5))
    b = rng.standard_normal((8, 5, 3))
    got = batch_sharded(_gemm_norm, mesh)(torch.from_numpy(a),
                                          torch.from_numpy(b))
    want = jpar.batch_sharded(_jgemm_norm, jpar.make_mesh())(a, b)
    for g, w in zip(got, want):
        full = g.full_tensor()
        assert tuple(full.shape) == w.shape and full.dtype == torch.float64
        np.testing.assert_allclose(full.numpy(), np.asarray(w), rtol=1e-12)
    single = batch_sharded(lambda x: x * 2, mesh)(torch.from_numpy(a))
    np.testing.assert_array_equal(single.full_tensor().numpy(), 2 * a)


def test_make_mesh_shapes_and_refusals(mesh):
    assert mesh.mesh_dim_names == ("batch",) and mesh.size() == 1
    two = make_mesh({"batch": 1, "model": 1}, device=CPU)
    assert two.mesh_dim_names == ("batch", "model")
    with pytest.raises(ValueError):
        make_mesh({"batch": 2}, device=CPU)
    # no fallback: a card mesh on a gloo group raises
    with pytest.raises(RuntimeError):
        make_mesh(device="cuda")
    x = shard_batch(np.arange(12.0).reshape(4, 3), two, "model")
    assert x.placements[1].is_shard(0) and x.placements[0].is_replicate()
    with pytest.raises(ValueError):
        shard_batch(np.zeros(2), two, "nope")


def test_init_group_refuses_more_card_ranks_than_cards():
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError):
        init_group("cuda", cards + 1)
    with pytest.raises(RuntimeError):
        entry.dryrun_multichip(cards + 1)


_QR_RANK = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from nd4js_tpu_torch import la
from nd4js_tpu_torch.parallel import batch_sharded, init_group, make_mesh
torch.set_num_threads(1)
rank, store = int(sys.argv[1]), sys.argv[2]
init_group("cpu", 2, rank, store, timeout_s=120.0)
a = torch.from_numpy(np.random.default_rng(12).standard_normal((6, 16, 12)))
q, r = batch_sharded(la.qr_decomp, make_mesh(device="cpu"))(a)
q_ref, r_ref = la.qr_decomp(a)
tol = 1e-12 * float(a.abs().max())
for got, want in ((q, q_ref), (r, r_ref)):
    local = got.to_local()
    assert local.shape[0] == 3, local.shape
    assert float((got.full_tensor() - want).abs().max()) <= tol
    assert float((local - want[3 * rank:3 * rank + 3]).abs().max()) <= tol
dist.destroy_process_group()
print("ok")
"""


def test_batch_sharded_qr_in_two_gloo_processes(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", _QR_RANK, str(r),
                               str(tmp_path / "store")], cwd=ROOT, env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(2)]
    try:
        codes = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for log in logs:
            log.close()
    out = [(tmp_path / f"rank{r}.log").read_text() for r in range(2)]
    assert codes == [0, 0], out
    assert all(o.strip().endswith("ok") for o in out), out


def test_dryrun_multichip_on_a_2x2_mesh_of_gloo_processes():
    entry.dryrun_multichip(4, device=CPU)
