"""The port's core helpers and triangular kernels held against the JAX
package on the CPU: config dtype rules and precision pins, leading-dim
broadcasting, debug checks, norm_fro, matmul2, _tril_inv_core,
_triu_solve_blocked and triu_solve, convert's dtype rules, and numpy
input to tril, triu, the triangular solves, matmul2 and norm_fro.

Inputs come from numpy with a fixed seed and go to both packages."""
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nd4js_tpu import config as jconfig
from nd4js_tpu.core import batch as jbatch
from nd4js_tpu.la.matmul import matmul2 as j_matmul2
from nd4js_tpu.la.norm import norm_fro as j_norm_fro
from nd4js_tpu.la import tri as jtri

from nd4js_tpu_torch import config, convert
from nd4js_tpu_torch.core import batch, debug
from nd4js_tpu_torch.la import tri

# the modules, which la's functions of the same names shadow as attributes
matmul = importlib.import_module("nd4js_tpu_torch.la.matmul")
norm = importlib.import_module("nd4js_tpu_torch.la.norm")

CPU = "cpu"


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _well_conditioned_r(rng, lead, n, dtype):
    """Upper-triangular R of a tall (2n, n) Gaussian: the kind of R the
    QR solves feed the triangular routines, with κ(R) of order 10."""
    g = rng.standard_normal(lead + (2 * n, n))
    return np.linalg.qr(g)[1].astype(dtype)


@pytest.mark.parametrize("np_dtype", [np.int32, np.int64, np.bool_,
                                      np.float32, np.float64])
def test_default_float_for_matches_jax(np_dtype):
    want = np.dtype(jconfig.default_float_for(np_dtype)).name
    assert str(config.default_float_for(np_dtype)) == f"torch.{want}"
    t = torch.from_numpy(np.zeros(2, np_dtype))
    assert config.default_float_for(t.dtype) == config.default_float_for(
        np_dtype)


def test_config_defaults_and_precision_pins():
    assert config.default_float == torch.float32
    assert config.default_device == "cuda"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("shapes,core", [
    (((2, 1, 4, 3), (5, 3, 2)), (2, 2)),
    (((4, 3), (7, 3, 2)), (2, 2)),
    (((3, 1, 5), (4, 5), (1, 4, 5)), (1, 1, 1)),
])
def test_broadcast_leading_matches_jax(shapes, core):
    rng = np.random.default_rng(1)
    arrs = [rng.standard_normal(s) for s in shapes]
    want, wshape = jbatch.broadcast_leading(arrs, core)
    got, gshape = batch.broadcast_leading([_t(a) for a in arrs], core)
    assert gshape == tuple(wshape)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_broadcast_leading_rejects_missing_core_dims():
    with pytest.raises(ValueError, match="core dims"):
        batch.broadcast_leading([torch.zeros(3)], (2,))


def test_batched_matches_jax_with_broadcasting():
    """A core function with two outputs, lifted by both packages' batched
    over leading dims (2, 1) x (3,); exact float64 arithmetic up to one
    GEMM's rounding (tolerance 1e-13)."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((2, 1, 4, 3))
    b = rng.standard_normal((3, 3, 5))

    def core_j(x, y, scale):
        p = jnp.matmul(x, y, precision="highest")
        return p * scale, jnp.sum(p, axis=-1)

    def core_t(x, y, scale):
        p = torch.matmul(x, y)
        return p * scale, p.sum(-1)

    wp, ws = jbatch.batched((2, 2))(core_j)(a, b, 2.0)
    gp, gs = batch.batched((2, 2))(core_t)(_t(a), _t(b), 2.0)
    assert gp.shape == wp.shape == (2, 3, 4, 5) and gs.shape == ws.shape
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), atol=1e-13)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-13)
    # no leading dims: the core function sees the bare matrices
    gp0, _ = batch.batched((2, 2))(core_t)(_t(a[0, 0]), _t(b[0]), 1.0)
    assert gp0.shape == (4, 5)


def test_debug_checks_raise_only_when_enabled(monkeypatch):
    bad = torch.tensor([1.0, float("nan")])
    monkeypatch.setattr(config, "debug_checks", False)
    debug.dcheck_finite(bad, "x")
    debug.dassert(torch.tensor([False]), "never raised when off")
    monkeypatch.setattr(config, "debug_checks", True)
    debug.dcheck_finite((torch.ones(2), torch.arange(3)), "finite and int")
    with pytest.raises(debug.DebugCheckError, match="x: non-finite"):
        debug.dcheck_finite(bad, "x")
    with pytest.raises(debug.DebugCheckError, match="cond"):
        debug.dassert(torch.tensor([True, False]), "cond")


@pytest.mark.parametrize("axis", [None, -1, (-2, -1), 0, ()])
@pytest.mark.parametrize("scale", [1.0, 1e200, 0.0])
def test_norm_fro_matches_jax(axis, scale):
    """Scaled two-pass norm: both packages do the same float64 operations;
    tolerance 1e-14 relative for summation order. Entries of 1e200 would
    overflow an unscaled sum of squares. ``axis=()`` reduces nothing:
    |a| in a's shape."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((3, 4, 5)) * scale
    want = np.asarray(j_norm_fro(a, axis=axis))
    got = norm.norm_fro(_t(a), axis=axis).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-14)
    assert np.isfinite(got).all()
    kd = norm.norm_fro(_t(a), axis=axis, keepdims=True)
    assert kd.shape == np.asarray(
        j_norm_fro(a, axis=axis, keepdims=True)).shape


@pytest.mark.parametrize("da,db,want", [
    (np.float64, np.float64, torch.float64),
    (np.int32, np.float32, torch.float32),
    (np.int32, np.int32, torch.float64),
    (np.float32, np.float64, torch.float64),
])
def test_matmul2_matches_jax(da, db, want):
    """dtype promotion as in the JAX package; values to 1e-5 relative in
    float32 and 1e-13 in float64 (GEMM summation order)."""
    rng = np.random.default_rng(4)
    a = (rng.standard_normal((2, 1, 4, 6)) * 3).astype(da)
    b = (rng.standard_normal((3, 6, 5)) * 3).astype(db)
    got = matmul.matmul2(_t(a), _t(b))
    ref = np.asarray(j_matmul2(a, b))
    assert got.dtype == want
    assert str(got.dtype) == f"torch.{ref.dtype.name}"
    rtol = 1e-5 if want == torch.float32 else 1e-13
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol, atol=rtol)


def _tri_operands(rng, upper):
    t = rng.standard_normal((2, 40, 40)) * 0.1 + 4 * np.eye(40)
    return (np.triu(t) if upper else np.tril(t)), \
        rng.standard_normal((2, 40, 3))


_ARRAY_LIKE_ARGS = {
    "tril": lambda rng: (rng.standard_normal((3, 5, 4)),),
    "triu": lambda rng: (rng.standard_normal((3, 5, 4)),),
    "tril_solve": lambda rng: _tri_operands(rng, False),
    "triu_solve": lambda rng: _tri_operands(rng, True),
    "tril_t_solve": lambda rng: _tri_operands(rng, False),
    "triu_t_solve": lambda rng: _tri_operands(rng, True),
    "matmul2": lambda rng: (rng.standard_normal((2, 2)),
                            rng.standard_normal((2, 2))),
    "norm_fro": lambda rng: (rng.standard_normal((3, 4)),),
}


@pytest.mark.parametrize("name", sorted(_ARRAY_LIKE_ARGS))
@pytest.mark.parametrize("explicit_device", [True, False])
def test_array_likes_match_jax(name, explicit_device, monkeypatch):
    """numpy input, as the JAX package takes it: with ``device="cpu"``,
    and without one, where it goes to ``config.default_device`` (set to
    the CPU here). Values to 1e-13 relative (summation order)."""
    from nd4js_tpu import la as jla
    from nd4js_tpu_torch import la
    args = _ARRAY_LIKE_ARGS[name](np.random.default_rng(5))
    want = np.asarray(getattr(jla, name)(*args))
    if explicit_device:
        got = getattr(la, name)(*args, device=CPU)
    else:
        monkeypatch.setattr(config, "default_device", CPU)
        got = getattr(la, name)(*args)
    assert isinstance(got, torch.Tensor) and got.device.type == CPU
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


def test_matmul2_rejects_bad_operands():
    with pytest.raises(ValueError, match="inner dimensions"):
        matmul.matmul2(torch.zeros(2, 3), torch.zeros(4, 2))
    with pytest.raises(ValueError, match="ndim"):
        matmul.matmul2(torch.zeros(3), torch.zeros(3, 2))
    with pytest.raises(ValueError, match="Invalid dtype"):
        matmul.matmul2(torch.zeros(2, 2, dtype=torch.int16),
                       torch.zeros(2, 2))


@pytest.mark.parametrize("n", [1, 5, 33, 150])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-11),
                                       (np.float32, 1e-4)])
def test_tril_inv_core_matches_jax(n, dtype, tol):
    """Log-depth nilpotent inverse, blocked above 128 (n = 150). Same
    formula in both packages; GEMMs sum in different orders, and κ(L) is
    of order 10, so the tolerance is relative to max|L⁻¹|."""
    rng = np.random.default_rng(5 + n)
    L = np.swapaxes(_well_conditioned_r(rng, (2,), n, dtype), -1, -2)
    want = np.asarray(jtri._tril_inv_core(L))
    got = tri._tril_inv_core(_t(L)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max())
    eye = np.eye(n)
    assert np.abs(L.astype(np.float64) @ got - eye).max() < 100 * tol


@pytest.mark.parametrize("n,block", [(20, None), (70, None), (100, 32),
                                     (130, None)])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-11),
                                       (np.float32, 1e-4)])
def test_triu_solve_blocked_matches_jax(n, block, dtype, tol):
    """Blocked back substitution; n > block runs the block loop (and the
    padding when block does not divide n). x is compared relative to
    max|x| with κ(U) of order 10."""
    rng = np.random.default_rng(7 + n)
    U = _well_conditioned_r(rng, (3,), n, dtype)
    y = rng.standard_normal((3, n, 2)).astype(dtype)
    want = np.asarray(jtri._triu_solve_blocked(U, y, block=block))
    got = tri._triu_solve_blocked(_t(U), _t(y), block=block).numpy()
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max())


def test_triu_solve_broadcasts_like_jax():
    """Public triu_solve with leading dims (2, 1) x (3,), methods block and
    scan; an unknown method raises."""
    rng = np.random.default_rng(9)
    U = _well_conditioned_r(rng, (2, 1), 40, np.float64)
    y = rng.standard_normal((3, 40, 4))
    want = np.asarray(jtri.triu_solve(U, y, method="block"))
    got = tri.triu_solve(_t(U), _t(y), method="block").numpy()
    assert got.shape == want.shape == (2, 3, 40, 4)
    np.testing.assert_allclose(got, want, atol=1e-11 * np.abs(want).max())
    want = np.asarray(jtri.triu_solve(U, y, method="scan"))
    got = tri.triu_solve(_t(U), _t(y), method="scan").numpy()
    np.testing.assert_allclose(got, want, atol=1e-11 * np.abs(want).max())
    with pytest.raises(ValueError):
        tri.triu_solve(_t(U), _t(y), method="nope")


@pytest.mark.parametrize("np_dtype,want", [
    (np.float32, torch.float32), (np.float64, torch.float64),
    (np.int64, torch.float64), (np.bool_, torch.float64)])
def test_from_numpy_applies_dtype_rule(np_dtype, want):
    arr = np.arange(6).reshape(2, 3).astype(np_dtype)
    t = convert.from_numpy(arr, device=CPU)
    assert t.dtype == want and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), arr.astype(t.numpy().dtype))


def test_as_tensor_keeps_a_tensors_device_and_dtype():
    t = torch.arange(4, dtype=torch.int32)
    assert convert.as_tensor(t) is t
    got = convert.as_tensor([[1.0, 2.0]], device=CPU)
    assert got.device.type == "cpu" and got.dtype == torch.float64
