"""PyON (Python object notation) parser, used by the ``.npy`` header:
the standard library's ``ast.literal_eval``, as in
``nd4js_tpu/io/pyon.py``."""
from __future__ import annotations

import ast

__all__ = ["pyon_parse"]


def pyon_parse(text: str):
    return ast.literal_eval(text.strip())
