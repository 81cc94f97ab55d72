"""The port's sytrd_panel (by its plain PyTorch version) and sytrd, held
against the JAX package on the CPU: the Pallas panel kernel in interpret
mode and its XLA twin ``_sytrd_panel`` with the rank-2b update, and the
whole ``sytrd``; the wrapper's routing and input checks; and the C
interface the wrapper binds against ``csrc/sytrd_panel.cu``.

Tolerances: in float64 the JAX package's own 1e-11·max|C| for the panel
outputs that scale with C (trailing block, W, d, e) and 1e-11 for the
scale-free V and taus (``tests/test_eigh_hessenberg.py:127-145``). Every
panel is also held to its contract (``panel_backward_error`` in
``tests/test_torch_gpu.py``): late in a reduction the entries grow
sensitive to rounding, so float32 is held to that contract, and its
entries only at the main path's shapes. sytrd: d and e to
1e-11·scale in float64, Q directly to 1e-11·n, orthogonality ≤ 8·eps·n
and reconstruction ≤ 8·eps·n·scale, scale = max(1, max|A|)
(``tests/test_eigh_hessenberg.py:92-111``). The CUDA kernel itself runs
only on the card."""
import functools
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nd4js_tpu.la import sytrd as jsytrd
from nd4js_tpu.ops.sytrd_panel import sytrd_panel as j_sytrd_panel

from nd4js_tpu_torch.la.sytrd import sytrd
from nd4js_tpu_torch.ops import _build
from nd4js_tpu_torch.ops import sytrd_panel as sp
from tests.test_torch_gpu import (SYTRD_C, _sym, _tau_zero,
                                  assert_panel_backward_stable)

CSRC = Path(sp.__file__).resolve().parent.parent / "csrc"
NAMES = ("C_trailing", "V", "W", "taus", "d", "e")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@functools.lru_cache(maxsize=None)
def _jax_panel(nb, m, bk, tau_zero=False):
    """A float64 input and the JAX package's results for it: the Pallas
    kernel in interpret mode (trailing block sliced as la/sytrd.py does)
    and ``_sytrd_panel`` under vmap with la/sytrd.py's XLA update."""
    rng = np.random.default_rng(60 + m + bk)
    c = _tau_zero(rng, nb, m) if tau_zero else _sym(rng, (nb, m, m))
    out = [np.asarray(x) for x in j_sytrd_panel(c, bk, interpret=True)]
    out[0] = out[0][:, bk:, bk:]
    V, W, taus, d, e = (np.asarray(x) for x in jax.vmap(
        lambda cc: jsytrd._sytrd_panel(cc, bk))(c))
    vb, wb = V[:, bk:], W[:, bk:]
    trail = c[:, bk:, bk:] - vb @ np.swapaxes(wb, 1, 2) \
        - wb @ np.swapaxes(vb, 1, 2)
    return c, out, [trail, V, W, taus, d, e]


def _assert_panel_close(got, want, c):
    cmax = np.abs(c).max()
    for name, g, w, scale in zip(NAMES, got, want,
                                 (cmax, 1, cmax, 1, cmax, cmax)):
        g = g.numpy()
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= 1e-11 * scale, (name, np.abs(g - w).max())


@pytest.mark.parametrize("nb,m,bk", [(2, 20, 1), (3, 40, 7), (2, 65, 32),
                                     (3, 100, 63)])
def test_sytrd_panel_ref_matches_the_pallas_kernel_and_its_xla_twin(nb, m,
                                                                     bk):
    c, kern, twin = _jax_panel(nb, m, bk)
    got = sp.sytrd_panel_ref(_t(c), bk)
    _assert_panel_close(got, kern, c)
    _assert_panel_close(got, twin, c)
    assert torch.equal(got[0], got[0].mT)        # mirrored: exactly symmetric
    assert_panel_backward_stable(_t(c), got, bk)


@pytest.mark.parametrize("nb,m,bk", [(2, 20, 1), (3, 40, 7), (2, 65, 32),
                                     (3, 100, 63)])
def test_sytrd_panel_ref_in_float32_is_backward_stable(nb, m, bk):
    """Late in a reduction the entries themselves are sensitive to
    rounding (see the test below), so float32 is held to the contract that
    any correct rounding meets."""
    c, _, _ = _jax_panel(nb, m, bk)
    c32 = _t(c.astype(np.float32))
    got = sp.sytrd_panel_ref(c32, bk)
    assert all(x.dtype == torch.float32 for x in got)
    assert torch.equal(got[0], got[0].mT)
    assert_panel_backward_stable(c32, got, bk)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sytrd_panel_ref_on_columns_with_tau_zero(dtype):
    """The first 47 columns are already tridiagonal and decoupled from the
    rest: τ = 0 and β = the subdiagonal entry, as in the Pallas kernel."""
    c, kern, _ = _jax_panel(2, 96, 63, tau_zero=True)
    c_in = _t(c.astype(dtype))
    got = sp.sytrd_panel_ref(c_in, 63)
    if dtype == np.float64:
        _assert_panel_close(got, kern, c)
    assert_panel_backward_stable(c_in, got, 63)
    assert float(got[3][:, :47].abs().max()) == 0.0
    np.testing.assert_array_equal(kern[3][:, :47], 0.0)
    assert torch.equal(got[5][:, :47], _t(np.diagonal(
        c.astype(dtype), -1, 1, 2)[:, :47]))


def test_panel_entries_late_in_a_reduction_are_sensitive_to_rounding():
    """Why float32 entries are compared only at the main path's shapes:
    at bk = 63 of m = 100 the plain version in float32 differs from itself
    in float64 by hundreds of eps·m·max|C| on this input, while its
    backward error stays below eps·m·max|C|."""
    c = _t(_sym(np.random.default_rng(0), (3, 100, 100)))
    r64 = sp.sytrd_panel_ref(c, 63)
    r32 = sp.sytrd_panel_ref(c.float(), 63)
    unit = np.finfo(np.float32).eps * 100 * float(c.abs().max())
    assert float((r32[4].double() - r64[4]).abs().max()) >= 100 * unit
    assert_panel_backward_stable(c.float(), r32, 63)


def test_sytrd_panel_routes_cpu_tensors_to_the_plain_version():
    c = _t(_sym(np.random.default_rng(61), (2, 30, 30)))
    before = sp.launches
    got = sp.sytrd_panel(c, 9)
    assert sp.launches == before
    for g, w in zip(got, sp.sytrd_panel_ref(c, 9)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("call,err,match", [
    (lambda: sp.sytrd_panel(torch.zeros(2, 8, 8), 8), ValueError, "bk"),
    (lambda: sp.sytrd_panel(torch.zeros(2, 8, 8), 0), ValueError, "bk"),
    (lambda: sp.sytrd_panel(torch.zeros(1, 100, 100), 65), ValueError, "bk"),
    (lambda: sp.sytrd_panel(torch.zeros(2, 8, 9), 3), ValueError, "square"),
    (lambda: sp.sytrd_panel(torch.zeros(8, 8), 3), ValueError, "3-D"),
    (lambda: sp.sytrd_panel(torch.zeros(1, 8, 8, dtype=torch.int32), 3),
     TypeError, "float32 or float64"),
    (lambda: sp.sytrd_panel(torch.zeros(1, 8, 8, device="meta"), 3),
     ValueError, "no kernel"),
])
def test_sytrd_panel_rejects_what_the_kernel_does_not_take(call, err, match):
    with pytest.raises(err, match=match):
        call()


def test_c_signatures_match_the_extern_c_declarations():
    src = (CSRC / "sytrd_panel.cu").read_text()
    extern = src[src.index('extern "C"'):]
    defined = {m.group(1): m.group(2).split(",") for m in re.finditer(
        r"^int (nd4js_\w+)\(([^)]*)\)", extern, re.M)}
    assert sorted(defined) == ["nd4js_sytrd_panel_clusters",
                               "nd4js_sytrd_panel_f32",
                               "nd4js_sytrd_panel_f64"]
    for fn, args in defined.items():
        restype, argtypes = _build._SIGNATURES[fn]
        assert restype is _build._I and len(argtypes) == len(args), fn
        for arg, ctype in zip(args, argtypes):
            assert ctype is (_build._P if "*" in arg else _build._I), (fn, arg)


def test_cuda_source_states_what_it_replaces():
    head = (CSRC / "sytrd_panel.cu").read_text().split("#include")[0]
    assert "ops/sytrd_panel.py::sytrd_panel" in head
    assert "Bound on the H100" in head and "thread-block cluster" in head
    assert "What held the first version back" in head


@functools.lru_cache(maxsize=None)
def _jax_sytrd(shape):
    a = _sym(np.random.default_rng(62 + shape[-1]), shape)
    return a, [np.asarray(x) for x in jax.jit(jsytrd.sytrd)(a)]


def _tridiag(d, e):
    t = np.zeros(d.shape + d.shape[-1:])
    n = d.shape[-1]
    idx = np.arange(n)
    t[..., idx, idx] = d
    t[..., idx[1:], idx[:-1]] = e
    t[..., idx[:-1], idx[1:]] = e
    return t


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (5, 5), (65, 65),
                                   (130, 130), (2, 3, 70, 70)])
def test_sytrd_matches_jax(shape):
    """One to three panels (130 = 64 + 64 + 1), n = 1 and n = 2, and a
    leading-dim batch; use_kernel=False (the plain panel on any device)
    gives the same on the CPU."""
    a, (jd, je, jq) = _jax_sytrd(shape)
    n = shape[-1]
    scale = max(1.0, np.abs(a).max())
    d, e, q = (x.numpy() for x in sytrd(a, device="cpu"))
    assert d.shape == jd.shape and e.shape == je.shape and q.shape == jq.shape
    np.testing.assert_allclose(d, jd, rtol=0, atol=1e-11 * scale)
    np.testing.assert_allclose(e, je, rtol=0, atol=1e-11 * scale)
    np.testing.assert_allclose(q, jq, rtol=0, atol=1e-11 * max(1, n))
    eps = np.finfo(np.float64).eps
    tol = eps * 8 * max(2, n)
    qt = np.swapaxes(q, -1, -2)
    assert np.abs(qt @ q - np.eye(n)).max() <= tol
    assert np.abs(q @ _tridiag(d, e) @ qt - a).max() <= tol * scale
    for x, y in zip(sytrd(a, use_kernel=False, device="cpu"), (d, e, q)):
        np.testing.assert_array_equal(x.numpy(), y)


@pytest.mark.parametrize("n", [5, 130])
def test_sytrd_float32_and_integer_input(n):
    """float32 keeps its dtype and holds the contract with its own eps;
    integers promote to float64."""
    a, _ = _jax_sytrd((n, n))
    d, e, q = sytrd(a.astype(np.float32), device="cpu")
    assert q.dtype == torch.float32
    d, e, q = (x.double().numpy() for x in (d, e, q))
    tol = np.finfo(np.float32).eps * 8 * n
    assert np.abs(q.T @ q - np.eye(n)).max() <= tol
    assert np.abs(q @ _tridiag(d, e) @ q.T - a).max() <= \
        tol * max(1.0, np.abs(a).max())
    ai = np.round(a * 4).astype(np.int64)
    di, _, _ = sytrd(ai, device="cpu")
    assert di.dtype == torch.float64
    np.testing.assert_array_equal(
        di.numpy(), sytrd(ai.astype(np.float64), device="cpu")[0].numpy())


def test_card_tolerance_covers_two_float32_roundings_at_the_path_shapes():
    """The kernel and its plain version are held to SYTRD_C·eps·m·max|C|
    on the card. At the main path's first panels (config 4's 1024² and
    the Gram batch's 512²) the plain version in float32 sits within about
    eps·m·max|C| of itself in float64; two float32 computations differ by
    at most twice that, and SYTRD_C must leave 10× beyond it."""
    rng = np.random.default_rng(63)
    x = rng.standard_normal((4, 512, 512))
    worst = 0.0
    for c in (_t(_sym(rng, (1, 1024, 1024))), _t(np.swapaxes(x, 1, 2) @ x)):
        r64 = sp.sytrd_panel_ref(c, 64)
        r32 = sp.sytrd_panel_ref(c.float(), 64)
        unit = np.finfo(np.float32).eps * c.shape[-1]
        cmax = float(c.abs().max())
        for x32, x64, scale in zip(r32, r64, (cmax, 1, cmax, 1, cmax, cmax)):
            worst = max(worst, float((x32.double() - x64).abs().max())
                        / (unit * scale))
    assert 10 * 2 * worst <= SYTRD_C, worst
