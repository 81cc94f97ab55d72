"""The port's ``io`` held against the JAX package's on the CPU: the same
numpy inputs from fixed seeds give byte-identical ``.npy`` bytes, base64
and ``istr`` strings in both packages, and arrays come back bit-exact
(dtype and bytes) across the packages in both directions: the port
writes and the JAX package reads, and the reverse. ``numpy.load`` reads
the port's ``.npy`` bytes and files.
"""
import base64
import io as _pyio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nd4js_tpu import io as jio

from nd4js_tpu_torch import config
from nd4js_tpu_torch import io as tio

CPU = "cpu"
DTYPES = ["int32", "int64", "float32", "float64", "complex64", "complex128",
          "bool"]
SHAPES = [(), (0,), (3, 4, 5)]


def _sample(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 1e3
    if dtype.startswith("complex"):
        x = x + 1j * rng.standard_normal(shape)
    if dtype == "bool":
        return rng.standard_normal(shape) > 0
    return np.asarray(x).astype(dtype)


def _bit_exact(got, want):
    """Same dtype, shape and bytes."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("shape", SHAPES, ids=["0d", "empty", "3d"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_npy_bytes_are_identical_and_numpy_reads_them(dtype, shape):
    x = _sample(dtype, shape)
    got = tio.npy_serialize(torch.from_numpy(np.array(x)))
    assert got == jio.npy_serialize(x)
    _bit_exact(np.load(_pyio.BytesIO(got)), x)


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_npy_round_trips_across_the_packages(dtype, direction):
    x = _sample(dtype, (6, 7), seed=1)
    if direction == "port-to-jax":
        back = jio.npy_deserialize(tio.npy_serialize(torch.from_numpy(x)))
    else:
        back = tio.npy_deserialize(jio.npy_serialize(jnp.asarray(x)),
                                   device=CPU)
        assert isinstance(back, torch.Tensor)
    _bit_exact(back, x)


def test_npy_files_round_trip_and_numpy_loads_them(tmp_path):
    x = _sample("float32", (4, 5, 6), seed=2)
    path = tmp_path / "x.npy"
    tio.save_npy(path, torch.from_numpy(x))
    _bit_exact(np.load(path), x)
    _bit_exact(tio.load_npy(path, device=CPU), x)
    jio.save_npy(tmp_path / "j.npy", x)
    assert path.read_bytes() == (tmp_path / "j.npy").read_bytes()


def test_npy_reads_version_2_as_the_jax_package_and_big_endian_data():
    """Big-endian data the JAX package refuses (jnp has no '>f8'); the
    port reads it as numpy does."""
    x = _sample("float64", (3, 2), seed=3)
    buf = _pyio.BytesIO()
    np.lib.format.write_array(buf, x, version=(2, 0))
    _bit_exact(tio.npy_deserialize(buf.getvalue(), device=CPU), x)
    _bit_exact(jio.npy_deserialize(buf.getvalue()), x)
    buf = _pyio.BytesIO()
    np.lib.format.write_array(buf, x.astype(">f8"))
    _bit_exact(tio.npy_deserialize(buf.getvalue(), device=CPU), x)
    with pytest.raises(TypeError):
        jio.npy_deserialize(buf.getvalue())


def test_npy_refuses_what_the_jax_package_refuses():
    with pytest.raises(ValueError):
        tio.npy_deserialize(b"not an npy file", device=CPU)
    with pytest.raises(ValueError):
        tio.npy_serialize(torch.zeros(2, dtype=torch.float16))
    buf = _pyio.BytesIO()
    np.lib.format.write_array(buf, np.asfortranarray(np.ones((2, 3))))
    with pytest.raises(ValueError):
        tio.npy_deserialize(buf.getvalue(), device=CPU)
    with pytest.raises(ValueError):
        jio.npy_deserialize(buf.getvalue())


@pytest.mark.parametrize("dtype", DTYPES)
def test_b64_strings_are_identical_and_round_trip(dtype):
    x = _sample(dtype, (5, 3), seed=4)
    text = tio.b64_encode(torch.from_numpy(x))
    assert text == jio.b64_encode(x)
    _bit_exact(tio.b64_decode(text, dtype, (5, 3), device=CPU), x)
    _bit_exact(jio.b64_decode(text, dtype, (5, 3)), x)
    tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    _bit_exact(tio.b64_decode(text, tdtype, (5, 3), device=CPU), x)


@pytest.mark.parametrize("pad,linewidth", [(True, 128), (False, 128),
                                           (True, 7)])
@pytest.mark.parametrize("dtype", ["float64", "float32", "int32",
                                   "complex128", "bool"])
def test_istr_strings_are_identical_and_round_trip(dtype, pad, linewidth):
    x = _sample(dtype, (11, 13), seed=5)
    text = tio.istr_stringify(torch.from_numpy(x), pad, linewidth)
    assert text == jio.istr_stringify(x, pad, linewidth)
    _bit_exact(tio.istr_parse(text, device=CPU), x)
    _bit_exact(jio.istr_parse(text), x)
    _bit_exact(tio.istr_parse(jio.istr_stringify(x, pad, linewidth),
                              device=CPU), x)


def test_istr_reads_the_reference_wire_format_as_the_jax_package():
    """Scalars ('[]'), unpadded base64, and the older 'dtype[shape]:b64'
    form."""
    raw = base64.b64encode(np.float64(3.5).tobytes()).decode("ascii")
    out = tio.istr_parse(f"float64[]\n{raw}", device=CPU)
    assert out.shape == () and float(out) == 3.5
    v = np.arange(3, dtype=np.int32)
    raw = base64.b64encode(v.tobytes()).decode("ascii")
    for text in (f"int32[3]\n{raw.rstrip('=')}", f"int32[3]:{raw}",
                 f"int32[3]\n {raw[:2]}\t{raw[2:]}\r\n"):
        _bit_exact(tio.istr_parse(text, device=CPU), v)
        _bit_exact(jio.istr_parse(text), v)
    with pytest.raises(ValueError):
        tio.istr_stringify(np.array([object()]))
    with pytest.raises(ValueError):
        tio.istr_stringify(torch.zeros(2), linewidth=0)


def test_pyon_parses_as_the_jax_package():
    text = "{'descr': '<f8', 'shape': (3, 4), 'x': True}"
    assert tio.pyon_parse(text) == jio.pyon_parse(text) == {
        "descr": "<f8", "shape": (3, 4), "x": True}


def test_deserializers_default_to_the_configured_device(monkeypatch):
    """Without device= a tensor lands on config.default_device (the card
    on the card; here the CPU stands in for it)."""
    monkeypatch.setattr(config, "default_device", "cpu")
    x = np.arange(4.0)
    for got in (tio.npy_deserialize(tio.npy_serialize(x)),
                tio.b64_decode(tio.b64_encode(x), "float64"),
                tio.istr_parse(tio.istr_stringify(x))):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        _bit_exact(got, x)
    assert tio.IS_LITTLE_ENDIAN is True
