"""NumPy ``.npy`` v1.0 serialization, the counterpart of
``nd4js_tpu/io/npy.py``: magic, version, the PyON header dict padded to
a multiple of 64 bytes, raw little-endian data — byte-identical to the
JAX package's and read by ``numpy.load``."""
from __future__ import annotations

import io as _io
import struct

import numpy as np

from ..core.ndarray import asarray
from ._host import to_host
from .pyon import pyon_parse

__all__ = ["npy_serialize", "npy_deserialize", "save_npy", "load_npy"]

_MAGIC = b"\x93NUMPY"

_DTYPE_TO_DESCR = {
    "int32": "<i4", "int64": "<i8", "float32": "<f4", "float64": "<f8",
    "complex64": "<c8", "complex128": "<c16", "bool": "|b1",
}


def npy_serialize(a) -> bytes:
    """Array or tensor -> .npy v1.0 bytes."""
    a = to_host(a)
    descr = _DTYPE_TO_DESCR.get(a.dtype.name)
    if descr is None:
        raise ValueError(f"unsupported dtype {a.dtype}")
    header = ("{'descr': '%s', 'fortran_order': False, 'shape': (%s), }"
              % (descr, "".join(f"{int(s)}," for s in a.shape)))
    # pad so that magic + version + length + header is a multiple of 64
    unpadded = len(_MAGIC) + 2 + 2 + len(header) + 1
    header = header + " " * ((-unpadded) % 64) + "\n"
    out = _io.BytesIO()
    out.write(_MAGIC)
    out.write(b"\x01\x00")
    out.write(struct.pack("<H", len(header)))
    out.write(header.encode("latin1"))
    out.write(np.ascontiguousarray(a).astype(a.dtype.newbyteorder("<"))
              .tobytes())
    return out.getvalue()


def npy_deserialize(data: bytes, device=None):
    """.npy bytes (v1 or v2, C order) -> tensor on ``device``."""
    if data[:6] != _MAGIC:
        raise ValueError("not a .npy file (bad magic)")
    major = data[6]
    if major == 1:
        hlen = struct.unpack("<H", data[8:10])[0]
        off = 10
    elif major == 2:
        hlen = struct.unpack("<I", data[8:12])[0]
        off = 12
    else:
        raise ValueError(f"unsupported .npy version {major}")
    header = pyon_parse(data[off:off + hlen].decode("latin1"))
    shape = tuple(header["shape"])
    if header.get("fortran_order"):
        raise ValueError("fortran_order arrays not supported")
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    arr = np.frombuffer(data, dtype=np.dtype(header["descr"]), count=count,
                        offset=off + hlen).reshape(shape)
    return asarray(arr, device=device)


def save_npy(path, a):
    with open(path, "wb") as fh:
        fh.write(npy_serialize(a))


def load_npy(path, device=None):
    with open(path, "rb") as fh:
        return npy_deserialize(fh.read(), device=device)
