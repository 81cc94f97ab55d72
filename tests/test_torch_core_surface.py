"""The port's core surface held against the JAX package on the CPU, on the
same numpy inputs from fixed seeds (x64 on, as tests/conftest.py sets it):

* ``core.kahan_sum``: the kernel's plain version against the JAX
  ``lax.scan``, bit-equal in float32 and float64 (the same recurrence,
  branch and order; NaN where the scan gives NaN); ``kahan_dot`` and
  ``two_sum`` bit-equal too.
* ``core.ndarray``: values equal and dtypes the same as the JAX
  package's (``array``'s inference: float64 → float32, ints and bools →
  int32, complex128 → complex64; ``asarray`` keeps numpy dtypes;
  ``tabulate``'s int32 grids), ``reduce_elems`` within 1e-12 relative in
  float64 (the fast paths sum in another order), ``slice_elems`` equal,
  negative steps included.
* ``core.wrapper.NDArray``: its surface against the JAX wrapper's,
  values equal.
* ``math``: each of the sixteen names within 4 ulps (1e-15 relative in
  float64, 5e-7 in float32) of jnp's, dtypes equal for tensor inputs;
  ``cbrt`` = |x|^(1/3) with x's sign within 4 ulps of ``jnp.cbrt`` on
  exact cubes, ±0 and negatives (measured: 2 in float32, 1 in float64),
  16 at 1e±30 (measured 10).
* ``core.mm.einsum`` within 1e-13 relative; ``core.cpx.sqrt_of_real``
  within 1 ulp (torch's CPU square root is not always correctly rounded).
* ``help``: the port's overview, and a name's signature and docstring in
  the JAX package's layout.
"""
import contextlib
import io
import operator

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nd4js_tpu as jnd
from nd4js_tpu.core import cpx as jcpx
from nd4js_tpu.core import kahan as jkahan
from nd4js_tpu.core import mm as jmm

import nd4js_tpu_torch as nd
from nd4js_tpu_torch import config
from nd4js_tpu_torch.core import cpx, kahan, mm
from nd4js_tpu_torch.ops import kahan_sum as ks

CPU = "cpu"
DTYPES = [np.float32, np.float64]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Loops of tiny torch ops: one intra-op thread per pytest worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _same_dtype(got, want):
    """A tensor's dtype and a JAX array's are the same type."""
    assert str(got.dtype).removeprefix("torch.") == np.dtype(want.dtype).name


def _bit_equal(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    uint = {4: np.uint32, 8: np.uint64}[got.dtype.itemsize]
    assert np.array_equal(got[~nan].view(uint), want[~nan].view(uint))


def _hard_sum_input(rng, shape, dtype):
    """Entries over 16 decades with cancelling signs: a plain sum loses
    digits, the compensated one must not."""
    mag = 10.0 ** rng.uniform(-8, 8, shape)
    return (rng.standard_normal(shape) * mag).astype(dtype)


# ------------------------------------------------------------- kahan

_jax_kahan = jax.jit(jkahan.kahan_sum, static_argnames="axis")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,axis", [((1000,), None), ((7, 5, 3), None),
                                        ((64, 5, 3), 0), ((5, 64, 3), 1),
                                        ((5, 3, 64), -1), ((0, 4), 0)])
def test_kahan_sum_is_bit_equal_to_the_jax_scan(dtype, shape, axis):
    x = _hard_sum_input(np.random.default_rng(sum(shape)),
                        shape, dtype)
    before = ks.launches
    got = kahan.kahan_sum(torch.from_numpy(x), axis=axis)
    _bit_equal(got, _jax_kahan(x, axis=axis))
    assert ks.launches == before            # the CPU runs the plain version


@pytest.mark.parametrize("dtype", DTYPES)
def test_kahan_sum_of_infinities_and_nan_matches_the_jax_scan(dtype):
    x = np.ones((6, 4), dtype)
    x[2, 0] = np.inf
    x[3, 1], x[4, 1] = np.inf, -np.inf
    x[1, 2] = np.nan
    _bit_equal(kahan.kahan_sum(torch.from_numpy(x), axis=0),
               _jax_kahan(x, axis=0))


@pytest.mark.parametrize("dtype", DTYPES)
def test_kahan_sum_compensates(dtype):
    """[big, 1, −big, 1] sums to 2, where the plain sum gives 0."""
    big = 1e8 if dtype == np.float32 else 1e17
    x = torch.tensor([big, 1.0, -big, 1.0], dtype=torch.from_numpy(
        np.zeros(0, dtype)).dtype)
    assert float(kahan.kahan_sum(x)) == 2.0
    assert float(torch.sum(x)) != 2.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("axis", [-1, 0])
def test_kahan_dot_is_bit_equal_to_the_jax_package(dtype, axis):
    rng = np.random.default_rng(3)
    a = _hard_sum_input(rng, (40, 30), dtype)
    b = rng.standard_normal((40, 30)).astype(dtype)
    want = jax.jit(jkahan.kahan_dot, static_argnames="axis")(a, b, axis=axis)
    _bit_equal(kahan.kahan_dot(torch.from_numpy(a), torch.from_numpy(b),
                               axis=axis), want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_two_sum_is_bit_equal_to_the_jax_package(dtype):
    rng = np.random.default_rng(4)
    a = _hard_sum_input(rng, (100,), dtype)
    b = _hard_sum_input(rng, (100,), dtype)
    s, e = kahan.two_sum(torch.from_numpy(a), torch.from_numpy(b))
    js, je = jkahan.two_sum(jnp.asarray(a), jnp.asarray(b))
    _bit_equal(s, js)
    _bit_equal(e, je)


def test_kahan_sum_refuses_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        kahan.kahan_sum(torch.arange(5))
    with pytest.raises(ValueError):
        ks.kahan_sum_cols(torch.zeros(3, dtype=torch.float32))


# ----------------------------------------------------------- ndarray

@pytest.mark.parametrize("content", [
    [1.5, 2.0], [[1, 2], [3, 4]], [True, False], [1 + 2j, 3.0],
    3.25, 7, np.arange(6.0).reshape(2, 3), np.arange(4, dtype=np.int64),
    np.ones(3, np.float32), np.arange(3, dtype=np.uint8),
    np.array([1 + 1j], np.complex128)],
    ids=["floats", "ints", "bools", "complex", "float", "int", "np-f64",
         "np-i64", "np-f32", "np-u8", "np-c128"])
def test_array_infers_dtypes_as_the_jax_package(content):
    got = nd.array(content, device=CPU)
    want = jnd.array(content)
    _same_dtype(got, want)
    assert np.array_equal(_np(got), np.asarray(want))
    assert got.device.type == CPU


@pytest.mark.parametrize("dtype", ["float64", "int32", "complex128",
                                   np.float32, torch.float64])
def test_array_with_a_dtype_matches_the_jax_package(dtype):
    content = [[0.1, 2.7], [3.0, -4.5]]
    got = nd.array(content, dtype, device=CPU)
    want = jnd.array(content, dtype if not isinstance(dtype, torch.dtype)
                     else "float64")
    _same_dtype(got, want)
    assert np.array_equal(_np(got), np.asarray(want))


def test_array_refuses_an_unknown_dtype_name_as_the_jax_package():
    with pytest.raises(ValueError):
        jnd.array([1.0], "float16")
    with pytest.raises(ValueError):
        nd.array([1.0], "float16", device=CPU)


def test_array_copies_and_asarray_passes_tensors_through():
    t = torch.arange(4.0, dtype=torch.float64)
    a = nd.array(t)
    assert a.dtype == config.default_float and a.data_ptr() != t.data_ptr()
    assert nd.asarray(t) is t
    assert nd.asarray(t, "float32").dtype == torch.float32


@pytest.mark.parametrize("content", [np.arange(6.0).reshape(2, 3),
                                     np.arange(4, dtype=np.int64),
                                     np.ones(2, np.complex128),
                                     np.arange(3.0)[::-1], [1.5, 2.5]],
                         ids=["f64", "i64", "c128", "reversed", "list"])
def test_asarray_keeps_dtypes_as_the_jax_package(content):
    got = nd.asarray(content, device=CPU)
    want = jnd.asarray(content)
    _same_dtype(got, want)
    assert np.array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("case", ["ints", "hilbert", "three-d", "scalar",
                                  "two-arg", "broadcast"])
def test_tabulate_matches_the_jax_package(case):
    shape, dtype, fn = {
        "ints": ((3, 4), "float32", lambda i, j: i * 10 + j),
        "hilbert": ((5, 5), None, lambda i, j: 1 / (i + j + 1)),
        "three-d": ((2, 3, 4), None, lambda i, j, k: i + j * k),
        "scalar": ((), "float64", lambda: 2.5),
        "two-arg": ((4, 2), None, lambda i, j: i - j),
        "broadcast": ((3, 4), None, lambda i, j: 7),
    }[case]
    if case == "two-arg":
        got, want = nd.tabulate(shape, fn, device=CPU), jnd.tabulate(shape, fn)
    else:
        got = nd.tabulate(shape, dtype, fn, device=CPU)
        want = jnd.tabulate(shape, dtype, fn)
    _same_dtype(got, want)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-7)
    assert tuple(got.shape) == shape


def test_tabulate_hands_int32_grids_broadcast_to_the_shape():
    seen = []
    nd.tabulate((2, 3), lambda i, j: seen.extend([i, j]) or i, device=CPU)
    assert [t.dtype for t in seen] == [torch.int32] * 2
    assert [tuple(t.shape) for t in seen] == [(2, 3)] * 2
    with pytest.raises(TypeError):
        nd.tabulate((2, 2), "float32", device=CPU)


def test_zip_elems_matches_the_jax_package():
    rng = np.random.default_rng(5)
    x, y, z = (rng.standard_normal(s) for s in ((3, 4, 1), (1, 1, 5),
                                                (3, 1, 5)))
    f = lambda p, q, r: p * q + r                           # noqa: E731
    got = nd.zip_elems([torch.from_numpy(x), y, z], f)
    want = jnd.zip_elems([x, y, z], lambda p, q, r: p * q + r)
    _same_dtype(got, want)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    single = nd.zip_elems(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(single), x)
    swapped = nd.zip_elems(lambda p: p + 1, [torch.from_numpy(x)])
    np.testing.assert_array_equal(_np(swapped), x + 1)
    cast = nd.zip_elems([torch.from_numpy(x)], lambda p: p, "float32")
    assert cast.dtype == torch.float32
    with pytest.raises(TypeError):
        nd.zip_elems([torch.from_numpy(x), torch.from_numpy(z)])


def test_map_elems_matches_the_jax_package():
    x = np.linspace(-2, 2, 12).reshape(3, 4)
    got = nd.map_elems(torch.from_numpy(x), torch.exp, dtype="float32")
    want = jnd.map_elems(x, jnp.exp, dtype="float32")
    _same_dtype(got, want)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-7)


@pytest.mark.parametrize("fn", ["concat", "stack"])
@pytest.mark.parametrize("axis", [0, 1])
def test_concat_and_stack_promote_as_the_jax_package(fn, axis):
    parts = [np.arange(6, dtype=np.int32).reshape(2, 3),
             np.ones((2, 3), np.float32), np.full((2, 3), 0.1)]
    got = getattr(nd, fn)([torch.from_numpy(p) for p in parts], axis)
    want = getattr(jnd, fn)(parts, axis)
    _same_dtype(got, want)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    forced = getattr(nd, fn)(parts, axis, "float32", device=CPU)
    np.testing.assert_array_equal(
        _np(forced), np.asarray(getattr(jnd, fn)(parts, axis, "float32")))


_REDUCERS = {"add": (operator.add, jnp.add),
             "mul": (torch.mul, jnp.multiply),
             "max": (torch.maximum, jnp.maximum),
             "min": (torch.minimum, jnp.minimum),
             "logaddexp": (torch.logaddexp, jnp.logaddexp)}


@pytest.mark.parametrize("axes", [None, -1, (0, 2), ()])
@pytest.mark.parametrize("name", list(_REDUCERS))
def test_reduce_elems_matches_the_jax_package(name, axes):
    x = np.random.default_rng(6).uniform(0.5, 1.5, (3, 4, 5))
    treduce, jreduce = _REDUCERS[name]
    got = nd.reduce_elems(torch.from_numpy(x), axes, treduce)
    want = jnd.reduce_elems(x, axes, jreduce)
    _same_dtype(got, want)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-12)


def test_reduce_elems_with_an_initial_value_matches_the_jax_package():
    x = np.random.default_rng(7).standard_normal((6, 3))
    got = nd.reduce_elems(torch.from_numpy(x), 0, torch.logaddexp,
                          initial=0.0)
    want = jnd.reduce_elems(x, 0, jnp.logaddexp, initial=0.0)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-12)
    with pytest.raises(TypeError):
        nd.reduce_elems(torch.from_numpy(x))


@pytest.mark.parametrize("spec", [
    (1, slice(1, 3)), ([0, 4, 2], "new"), ([5, 0, -2],),
    ([None, 1, -3], "..."), ("new", 2, [None, None, -2]), ([2, 2, -1],),
    ([None, None, -1], 0, [3, 0, -1])],
    ids=lambda s: repr(s).replace(" ", ""))
def test_slice_elems_matches_the_jax_package(spec):
    x = np.arange(5 * 6 * 4).reshape(5, 6, 4)
    got = nd.slice_elems(torch.from_numpy(x), *spec)
    want = np.asarray(jnd.slice_elems(x, *spec))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_np(got), want)


# ----------------------------------------------------------- wrapper

def test_ndarray_wrapper_matches_the_jax_wrapper():
    rows = [[1.0, 2.0], [3.0, 4.0]]
    a, j = nd.NDArray(rows, device=CPU), jnd.NDArray(rows)
    assert a.shape == j.shape and a.ndim == j.ndim == 2
    assert float(a(1, 0)) == float(j(1, 0)) == 3.0
    for got, want in [(a.T, j.T), (a.transpose(1, 0), j.transpose(1, 0)),
                      (a.transpose(), j.transpose()),
                      (a.reshape(4), j.reshape(4)),
                      (a.reshape((1, 4)), j.reshape((1, 4))),
                      (a.set((0, 0), 9.0), j.set((0, 0), 9.0)),
                      (a.modify((0, 1), lambda v: v * 10),
                       j.modify((0, 1), lambda v: v * 10)),
                      (a @ a, j @ j), (a + 1, j + 1), (2 - a, 2 - j),
                      (a * a, j * j), (a / 2, j / 2), (1 / a, 1 / j),
                      (-a, -j), (3 * a, 3 * j),
                      (a.map_elems(lambda x: x + 1),
                       j.map_elems(lambda x: x + 1)),
                      (a.slice_elems([None, 1], "..."),
                       j.slice_elems([None, 1], "...")),
                      (a.reduce_elems(0, torch.add),
                       j.reduce_elems(0, jnp.add)), (a[1], j[1])]:
        assert isinstance(got, nd.NDArray)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-6)
    assert float(a(0, 0)) == 1.0                    # set is out of place
    assert float(a.reduce_elems(None, torch.add)) == \
        float(j.reduce_elems(None, jnp.add)) == 10.0
    assert [float(r(0)) for r in a] == [float(r(0)) for r in j]
    assert dict(a.elems()) == {k: float(v) for k, v in j.elems()}
    assert len(a) == len(j) == 2
    h = nd.NDArray([[1 + 2j]], device=CPU).H
    assert complex(np.asarray(h)[0, 0]) == 1 - 2j
    assert np.asarray(a, dtype=np.float64).dtype == np.float64


def test_torch_functions_unwrap_the_ndarray():
    a = nd.NDArray(torch.arange(6.0).reshape(2, 3))
    s = torch.sum(a)
    assert isinstance(s, torch.Tensor) and float(s) == 15.0
    st = torch.stack([a, a])
    assert tuple(st.shape) == (2, 2, 3)
    assert nd.wrap(a) is a
    assert isinstance(nd.wrap(torch.ones(1)), nd.NDArray)


# -------------------------------------------------------------- math

_POS = np.linspace(0.25, 4.0, 16).reshape(4, 4)
_SIGNED = np.linspace(-3.0, 3.5, 16).reshape(4, 4)
_MATH_ARGS = {
    "add": (_SIGNED, _POS), "sub": (_SIGNED, _POS), "mul": (_SIGNED, _POS),
    "div": (_SIGNED, _POS), "neg": (_SIGNED,), "abs": (_SIGNED,),
    "sqrt": (_POS,), "exp": (_SIGNED,), "conj": (_SIGNED + 2j * _POS,),
    "is_close": (_POS, _POS + 1e-6), "cbrt": (_SIGNED,),
    "atan2": (_SIGNED, _SIGNED[::-1]), "hypot": (_SIGNED, _POS),
    "sign": (_SIGNED,), "min": (_SIGNED, _POS[::-1]),
    "max": (_SIGNED, _POS[::-1]),
}
_ULPS = {np.float32: 5e-7, np.float64: 1e-15}


def _math_close(got, want, dtype):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    if got.dtype == bool:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=4 * _ULPS[dtype],
                                   atol=1e-300)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(_MATH_ARGS))
def test_math_matches_the_jax_package(name, dtype):
    cdt = np.complex64 if dtype == np.float32 else np.complex128
    args = [a.astype(cdt if np.iscomplexobj(a) else dtype)
            for a in _MATH_ARGS[name]]
    got = getattr(nd.math, name)(*[torch.from_numpy(a.copy())
                                   for a in args])
    want = getattr(jnd.math, name)(*args)
    _same_dtype(got, want)
    _math_close(got, want, dtype)


@pytest.mark.parametrize("name", ["add", "div", "atan2", "hypot",
                                  "is_close"])
def test_math_takes_python_scalars_as_the_jax_package(name):
    """A scalar beside a float64 tensor stays float64 (0.1 is not rounded
    to float32); two scalars give a tensor on the given device (values
    compared: the port's Python float is float32, JAX's under x64 float64)."""
    fn, jfn = getattr(nd.math, name), getattr(jnd.math, name)
    x = _SIGNED[0]
    got, want = fn(torch.from_numpy(x), 0.1), jfn(x, 0.1)
    _same_dtype(got, want)
    _math_close(got, want, np.float64)
    _math_close(fn(0.1, torch.from_numpy(x)), jfn(0.1, x), np.float64)
    pair = fn(3, 2, device=CPU)
    assert pair.device.type == CPU and pair.ndim == 0
    assert float(pair) == pytest.approx(float(jfn(3, 2)), rel=1e-7)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cbrt_of_cubes_zero_and_negatives_matches_the_jax_package(dtype):
    """Exact cubes k³ and k³/8 (|k| ≤ 60), ±0: within 4 ulps of jnp.cbrt
    and of the correctly rounded root (measured: 2 and 1 in float32 and
    float64), the sign of zero kept. At 1e±20 and 1e±30 within 16 ulps of
    jnp.cbrt (measured 10: jnp's float32 cbrt is 10 ulps from the exact
    root there, the port's pow of a rounded 1/3 10 ulps in float64)."""
    k = np.arange(-60, 61)
    cubes = np.concatenate([k ** 3, k ** 3 / 8, [0.0, -0.0]]).astype(dtype)
    wide = np.array([1e-30, -1e30, 1e20, -1e-20, 3.0, -7.5], dtype)
    for x, ulps in ((cubes, 4), (wide, 16)):
        got = _np(nd.math.cbrt(torch.from_numpy(x)))
        want = np.asarray(jnp.cbrt(x))
        exact = np.cbrt(x.astype(np.float64)).astype(dtype)
        ulp = np.spacing(np.abs(exact))
        assert (np.abs(got - want) <= ulps * ulp).all()
        assert np.array_equal(np.signbit(got), np.signbit(want))
    assert (np.abs(_np(nd.math.cbrt(torch.from_numpy(cubes)))
                   - np.cbrt(cubes.astype(np.float64)).astype(dtype))
            <= 4 * np.spacing(np.abs(cubes) ** (1 / 3)).astype(dtype)).all()
    assert nd.math.cbrt(torch.tensor([8])).dtype == torch.get_default_dtype()


def test_sign_of_complex_and_is_close_defaults_match_the_jax_package():
    z = np.array([3 + 4j, 0j, -2j])
    np.testing.assert_allclose(_np(nd.math.sign(torch.from_numpy(z))),
                               np.asarray(jnd.math.sign(z)), rtol=1e-15)
    x, y = np.array([1.0, 1.0, 1.0, 0.0]), np.array([1 + 1e-6, 1.1, 1 + 9e-6,
                                                     5e-9])
    np.testing.assert_array_equal(
        _np(nd.math.is_close(torch.from_numpy(x), torch.from_numpy(y))),
        np.asarray(jnd.math.is_close(x, y)))
    ints = nd.math.is_close(torch.arange(3), torch.tensor([0, 1, 3]))
    np.testing.assert_array_equal(_np(ints), [True, True, False])


# ------------------------------------------------- einsum, sqrt_of_real

@pytest.mark.parametrize("subscripts,shapes", [
    ("kn,bnj->bkj", [(6, 5), (3, 5, 2)]), ("bij,bjk->bik", [(2, 4, 3),
                                                            (2, 3, 5)]),
    ("ii->", [(4, 4)]), ("ij->ji", [(3, 2)])])
def test_einsum_matches_the_jax_package(subscripts, shapes):
    rng = np.random.default_rng(8)
    ops = [rng.standard_normal(s) for s in shapes]
    got = mm.einsum(subscripts, *[torch.from_numpy(o) for o in ops])
    want = jmm.einsum(subscripts, *ops)
    _same_dtype(got, want)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-13,
                               atol=1e-13)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sqrt_of_real_matches_the_jax_package(dtype):
    """Within 1 ulp: torch's CPU square root of a float64 tensor is not
    always correctly rounded (√2 comes out 1 ulp low), XLA's is."""
    x = np.array([4.0, 0.0, -9.0, 2.0, -0.5, np.inf], dtype)
    got = cpx.sqrt_of_real(torch.from_numpy(x))
    want = jcpx.sqrt_of_real(jnp.asarray(x))
    for g, w in zip(got, want):
        g, w = _np(g), np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_max_ulp(g, w, maxulp=1)


# -------------------------------------------------------------- help

def test_help_prints_the_port_overview_and_docstrings():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        nd.help()
    overview = buf.getvalue()
    assert "nd4js_tpu_torch" in overview and "Subpackages" in overview
    assert "CUDA" in overview and "device=" in overview
    assert "TPU" not in overview
    for obj in (nd.la.qr_decomp, nd.core.kahan_sum, nd.NDArray):
        port, ref = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(port):
            nd.help(obj)
        with contextlib.redirect_stdout(ref):
            jnd.help(getattr(jnd.la, "qr_decomp"))
        name = obj.__name__
        lines = port.getvalue().splitlines()
        assert lines[0].startswith(name + "(") and lines[1] == ""
        assert all(not ln or ln.startswith("    ") for ln in lines[2:])
        assert ref.getvalue().startswith("qr_decomp(")
    quiet = io.StringIO()
    with contextlib.redirect_stdout(quiet):
        nd.help(object.__new__(type("Bare", (), {"__doc__": None})))
    assert quiet.getvalue().startswith("(no documentation for")
