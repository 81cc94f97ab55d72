"""The port's Cholesky and LU kernels, by their plain PyTorch versions,
held against the JAX package's Pallas kernels run in interpret mode on
the CPU (and against its XLA Cholesky base case); the wrappers' routing
and input checks; and the C interface the wrappers bind against the CUDA
sources.

The CUDA kernels themselves run only on the card (tests/test_torch_gpu.py
and chip_smoke.py hold them against these plain versions there)."""
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from nd4js_tpu.la import cholesky as jchol
from nd4js_tpu.ops.chol_leaf import chol_leaf as j_chol_leaf
from nd4js_tpu.ops.lu_panel import lu_gesv as j_lu_gesv
from nd4js_tpu.ops.lu_panel import lu_panel as j_lu_panel

from nd4js_tpu_torch.ops import _build
from nd4js_tpu_torch.ops import chol_leaf as cl
from nd4js_tpu_torch.ops import lu_panel as lp
from tests.test_torch_qr_kernels import assert_backward_stable, x_tolerance

# summation order differs between the packages: 1e-10·max|A| in float64
# and 1e-4·max|A| in float32, on L, on the LU panel, and on L⁻¹ relative
# to max|L⁻¹| (the two invert by different algorithms)
TOL = {np.float64: 1e-10, np.float32: 1e-4}
CSRC = Path(cl.__file__).resolve().parent.parent / "csrc"


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _spd(rng, shape, dtype=np.float64):
    a = rng.standard_normal(shape)
    n = shape[-1]
    return (a @ np.swapaxes(a, -1, -2) / n + 2 * np.eye(n)).astype(dtype)


def _assert_chol_close(got, want, a, dtype):
    l, li = got
    wl, wli = (None if w is None else np.asarray(w) for w in want)
    np.testing.assert_allclose(l.numpy(), wl.astype(l.numpy().dtype),
                               atol=TOL[dtype] * np.abs(np.tril(a)).max())
    assert np.abs(np.triu(l.numpy(), 1)).max() == 0.0
    if wli is None:
        assert li is None
    else:
        np.testing.assert_allclose(li.numpy(), wli.astype(li.numpy().dtype),
                                   atol=TOL[dtype] * np.abs(wli).max())


@pytest.mark.parametrize("n", [8, 33, 64])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_chol_leaf_ref_matches_pallas_kernel_on_symmetric_input(n, dtype):
    """Exactly symmetric input: where the TPU kernel's read of the
    transposed block is the lower triangle too."""
    a = _spd(np.random.default_rng(40 + n), (3, n, n), dtype)
    jl, jli = j_chol_leaf(a, True, interpret=True)
    _assert_chol_close(cl.chol_leaf_ref(_t(a), True), (jl, jli), a, dtype)
    _assert_chol_close(cl.chol_leaf_ref(_t(a), False), (jl, None), a, dtype)


@pytest.mark.parametrize("n", [8, 16, 33, 64])
def test_chol_leaf_ref_reads_only_the_lower_triangle(n):
    """Against the JAX package's own base case (_chol_base, _inv_base,
    compiled, in float64) on the lower triangle alone; the port gets the
    same lower triangle under an upper triangle of garbage, in float64
    and float32, which must not change L or L⁻¹."""
    rng = np.random.default_rng(50 + n)
    a = _spd(rng, (2, n, n), np.float64)
    lower = np.tril(a)
    jl = jax.jit(jchol._chol_base)(lower)
    want = (jl, jax.jit(jchol._inv_base)(jl))
    garbage = lower + np.triu(rng.standard_normal(a.shape) * 1e6, 1)
    for dtype in (np.float64, np.float32):
        got = cl.chol_leaf(_t(garbage.astype(dtype)), True)
        _assert_chol_close(got, want, a, dtype)
        for g, w in zip(got, cl.chol_leaf(_t(lower.astype(dtype)), True)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_chol_leaf_ref_gives_nan_on_non_spd():
    l, li = cl.chol_leaf(_t(-np.eye(4)[None]), True)
    assert torch.isnan(l).any() and torch.isnan(li).any()


def _assert_panel_close(a, dtype):
    want_out, want_rank = (np.asarray(w) for w in j_lu_panel(a, interpret=True))
    out, rank = lp.lu_panel_ref(_t(a))
    assert out.shape == want_out.shape and rank.dtype == torch.int32
    np.testing.assert_array_equal(rank.numpy(), want_rank)
    np.testing.assert_allclose(out.numpy(), want_out,
                               atol=TOL[dtype] * np.abs(a).max())
    return out.numpy(), rank.numpy()


@pytest.mark.parametrize("shape", [(2, 40, 8), (3, 136, 40), (1, 16, 16)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lu_panel_ref_matches_pallas_kernel(shape, dtype):
    """The factored panel to TOL·max|A|; rank exactly equal (the two
    eliminate in the same order with the same pivot rule)."""
    a = np.random.default_rng(60 + shape[1]).standard_normal(shape)
    out, rank = _assert_panel_close(a.astype(dtype), dtype)
    # sorting rows by (rank, index) gives a packed L·U of the permuted panel
    nb, m, b = shape
    for t in range(nb):
        order = np.lexsort((np.arange(m), rank[t]))
        packed = out[t][order].astype(np.float64)
        L = np.tril(packed, -1)[:, :b] + np.eye(m, b)
        U = np.triu(packed[:b])
        np.testing.assert_allclose(L @ U, a[t][order], atol=1e3 * TOL[dtype])


def test_lu_panel_ref_zero_column_and_tied_pivots():
    """A zero column gives a zero L column (pivot 0 divides by 1); tied
    |pivots| (3, −3, 3) go to the lowest row index."""
    a = np.random.default_rng(61).standard_normal((2, 40, 8))
    a[0, :, 3] = 0.0
    a[1, :5, 0] = [1.0, -3.0, 3.0, 2.0, -3.0]
    a[1, 5:, 0] = 0.5
    out, rank = _assert_panel_close(a, np.float64)
    assert rank[1, 1] == 0
    assert np.abs(out[0, rank[0] > 3, 3]).max() == 0.0


@pytest.mark.parametrize("nb,n,k", [(2, 32, 1), (2, 32, 3), (3, 13, 3)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lu_gesv_ref_matches_pallas_kernel(nb, n, k, dtype):
    """x within the forward-error bound of the solve, and the backward
    error within N·eps and 8× the JAX kernel's."""
    rng = np.random.default_rng(70 + n + k)
    a = rng.standard_normal((nb, n, n)).astype(dtype)
    y = rng.standard_normal((nb, n, k)).astype(dtype)
    want = np.asarray(j_lu_gesv(a, y, interpret=True))
    got = lp.lu_gesv_ref(_t(a), _t(y)).numpy()
    assert got.shape == want.shape == (nb, n, k) and got.dtype == want.dtype
    err = np.abs(got - want).max(axis=(-2, -1))
    assert (err <= x_tolerance(a, want, dtype)).all(), err
    assert_backward_stable(a, y, got, want, dtype)


def test_lu_gesv_ref_permutation_and_singular_systems():
    """The 2×2 permutation needs the pivot swap; an all-zero system and a
    rank-one one give inf/nan with no guard."""
    p = np.array([[[0.0, 1.0], [1.0, 0.0]]])
    y = np.array([[[2.0], [3.0]]])
    np.testing.assert_array_equal(lp.lu_gesv_ref(_t(p), _t(y)).numpy(),
                                  [[[3.0], [2.0]]])
    for a in (np.zeros((1, 4, 4)), np.ones((1, 4, 4))):
        x = lp.lu_gesv_ref(_t(a), _t(np.ones((1, 4, 1)))).numpy()
        assert not np.isfinite(x).all()


def test_cpu_tensors_run_the_plain_versions_and_count_no_launch():
    rng = np.random.default_rng(80)
    spd = _t(_spd(rng, (2, 12, 12), np.float64))
    before = (cl.launches, dict(lp.launches))
    for g, w in zip(cl.chol_leaf(spd, True), cl.chol_leaf_ref(spd, True)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    panel = _t(rng.standard_normal((2, 20, 6)))
    for g, w in zip(lp.lu_panel(panel), lp.lu_panel_ref(panel)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    y = _t(rng.standard_normal((2, 12, 2)))
    torch.testing.assert_close(lp.lu_gesv(spd, y), lp.lu_gesv_ref(spd, y),
                               rtol=0, atol=0)
    assert (cl.launches, lp.launches) == before


@pytest.mark.parametrize("call,err,match", [
    (lambda: cl.chol_leaf(torch.zeros(4, 4), True), ValueError, "3-D"),
    (lambda: cl.chol_leaf(torch.zeros(1, 65, 65), True), ValueError,
     "at most 64"),
    (lambda: cl.chol_leaf(torch.zeros(1, 4, 3), False), ValueError,
     "square"),
    (lambda: cl.chol_leaf(torch.zeros(1, 4, 4, device="meta"), False),
     ValueError, "no kernel for device"),
    (lambda: lp.lu_panel(torch.zeros(1, 4, 6)), ValueError, "M >= B"),
    (lambda: lp.lu_panel(torch.zeros(1, 4, 4, dtype=torch.int32)),
     TypeError, "float32 or float64"),
    (lambda: lp.lu_panel(torch.zeros(1, 4, 4, device="meta")), ValueError,
     "no kernel for device"),
    (lambda: lp.lu_gesv(torch.zeros(1, 4, 3), torch.zeros(1, 4, 1)),
     ValueError, "needs a"),
    (lambda: lp.lu_gesv(torch.zeros(1, 4, 4),
                        torch.zeros(1, 4, 1, dtype=torch.float64)),
     ValueError, "share dtype"),
])
def test_wrappers_reject_what_the_kernels_do_not_take(call, err, match):
    """Only CPU tensors fall to the plain version; another device raises."""
    with pytest.raises(err, match=match):
        call()


@pytest.mark.parametrize("name,functions", [
    ("chol_leaf.cu", ["nd4js_chol_leaf_f32", "nd4js_chol_leaf_f64"]),
    ("lu_panel.cu", ["nd4js_lu_panel_f32", "nd4js_lu_panel_f64",
                     "nd4js_lu_panel_clusters", "nd4js_lu_gesv_f32",
                     "nd4js_lu_gesv_f64"]),
])
def test_c_signatures_match_the_extern_c_declarations(name, functions):
    """Each C function of the new sources is bound in _SIGNATURES with as
    many arguments as it declares, pointers and the stream as c_void_p."""
    src = (CSRC / name).read_text()
    extern = src[src.index('extern "C"'):]
    defined = {m.group(1): m.group(2).split(",") for m in re.finditer(
        r"^int (nd4js_\w+)\(([^)]*)\)", extern, re.M)}
    assert sorted(defined) == sorted(functions)
    for fn, args in defined.items():
        restype, argtypes = _build._SIGNATURES[fn]
        assert restype is _build._I and len(argtypes) == len(args), fn
        for arg, ctype in zip(args, argtypes):
            want = _build._P if "*" in arg else _build._I
            assert ctype is want, (fn, arg)


@pytest.mark.parametrize("name,tpu,design,before", [
    ("chol_leaf.cu", "ops/chol_leaf.py::chol_leaf",
     "What held the first version back", ""),
    ("lu_panel.cu", "ops/lu_panel.py::lu_panel",
     "What held the first version back", "Before: 1.6238 ms"),
    ("lu_panel.cu", "ops/lu_panel.py::lu_gesv",
     "What held the first version back", "1.7532 ms"),
])
def test_cuda_sources_state_what_they_replace(name, tpu, design, before):
    """Each note names the TPU kernel it replaces, its bound on the H100,
    its redesign and what held the first version back; lu_panel.cu also
    the first version's times."""
    head = (CSRC / name).read_text().split("#include")[0]
    assert tpu in head and "Bound on the H100" in head
    assert design in head and before in head
