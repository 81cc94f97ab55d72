""""istr" compact text serialization of arrays — the reference's wire
format, the counterpart of ``nd4js_tpu/io/istr.py``.

``istr_stringify`` emits ``dtype[d1,d2,...]``, a newline and the base64
of the little-endian raw bytes, line-wrapped every ``linewidth``
characters (default 128, '='-padded); ``istr_parse`` reads the dtype up
to ``[``, the comma-separated shape up to ``]`` (``[]`` means scalar),
then every remaining character as base64, skipping the whitespace class
``\\f\\n\\r\\t\\v `` and stopping at ``=``. Strings in the older
``dtype[shape]:b64`` form still parse (the ``:`` is skipped too).
"""
from __future__ import annotations

import numpy as np

from ._host import to_host
from .b64 import b64_encode, b64_decode

__all__ = ["istr_stringify", "istr_parse"]

# characters the reference's streaming decoder skips
_SKIP = set("\f\n\r\t\v :")


def istr_stringify(a, pad: bool = True, linewidth: int = 128) -> str:
    """Serialize to the istr text format."""
    a = to_host(a)
    if a.dtype == object:
        raise ValueError("dtype=object not supported")
    if not 0 < linewidth:
        raise ValueError(f"invalid linewidth: {linewidth}")
    shape = ",".join(str(int(s)) for s in a.shape)
    le = np.ascontiguousarray(a.astype(a.dtype.newbyteorder("<")))
    body = b64_encode(le)
    if not pad:
        body = body.rstrip("=")
    body = "\n".join(body[i:i + linewidth]
                     for i in range(0, len(body), linewidth))
    return f"{a.dtype.name}[{shape}]\n{body}"


def istr_parse(text: str, device=None):
    """Parse istr text back to a tensor on ``device``."""
    lb = text.index("[")
    rb = text.index("]", lb)
    dtype = text[:lb].strip()
    if dtype == "":
        raise ValueError("dtype=object not (yet) supported")
    shape_s = text[lb + 1:rb].strip()
    shape = tuple(int(s) for s in shape_s.split(",")) if shape_s else ()
    body = "".join(c for c in text[rb + 1:] if c not in _SKIP)
    body = body.split("=", 1)[0]          # the decoder stops at '='
    body += "=" * (-len(body) % 4)        # Python's b64 wants the padding
    return b64_decode(body, np.dtype(dtype).newbyteorder("<"), shape,
                      device=device)
