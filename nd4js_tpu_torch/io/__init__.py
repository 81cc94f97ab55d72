"""Array serialization, the counterpart of ``nd4js_tpu/io``: ``.npy``
bytes and files, base64, the reference's ``istr`` text format and the
PyON header parser. Wire formats are byte-identical to the JAX
package's. Serializers copy a card tensor to the host once;
deserializers return a tensor on ``device`` (default
``config.default_device``)."""
from .npy import npy_serialize, npy_deserialize, save_npy, load_npy
from .b64 import b64_encode, b64_decode
from .istr import istr_stringify, istr_parse
from .pyon import pyon_parse

__all__ = ["npy_serialize", "npy_deserialize", "save_npy", "load_npy",
           "b64_encode", "b64_decode", "istr_stringify", "istr_parse",
           "pyon_parse", "IS_LITTLE_ENDIAN"]

# the reference's flag; numpy reads and writes either byte order
IS_LITTLE_ENDIAN = True
