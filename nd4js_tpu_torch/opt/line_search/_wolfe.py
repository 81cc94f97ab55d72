"""The strong-Wolfe engine under its older module name, as in the JAX
package (``nd4js_tpu/opt/line_search/_wolfe.py``): ``wolfe_line_search``
keeps its old signature."""
from ._engine import wolfe_line_search, line_search_engine  # noqa: F401

__all__ = ["wolfe_line_search", "line_search_engine"]
