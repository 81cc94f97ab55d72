"""The port stands alone: nd4js_tpu_torch and chip_smoke.py import
neither JAX nor the JAX package nor the tests, no library decomposition
or compiler stands in for a kernel, and chip_smoke.py fails, printing no
result, where there is no CUDA card."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

import nd4js_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(nd4js_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "nd4js_tpu", "tests")


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_every_module_imports_without_jax_or_the_jax_package():
    """A fresh interpreter with jax made unimportable imports every module
    of the port; afterwards no jax or nd4js_tpu module is loaded."""
    code = (
        "import sys, json, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import nd4js_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'nd4js_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n, m in sys.modules.items() if m is not None and "
        "(n == 'jax' or n.startswith(('jax.', 'jaxlib')) or n == 'nd4js_tpu' "
        "or n.startswith('nd4js_tpu.') or n == 'tests' or "
        "n.startswith('tests.')))\n"
        "print(json.dumps({'modules': mods, 'bad': bad}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    expected = {"nd4js_tpu_torch." + ".".join(
        p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py"}
    assert expected <= set(got["modules"])


def test_the_svd_and_rrqr_modules_are_among_those_checked():
    """The modules of the SVD and rank-revealing QR slice are found by the
    walk above, so they too import without JAX."""
    found = {p.relative_to(PKG).with_suffix("").as_posix()
             for p in PKG.rglob("*.py")}
    assert {"la/svd", "la/svd_jac", "la/svd_gram", "la/rrqr", "la/solve",
            "la/permute", "la/singular_matrix_solve_error",
            "ops/jacobi_sweep", "ops/rrqr_kernel"} <= found


def test_the_general_eigen_modules_and_kernels_are_among_those_checked():
    """The general eigen slice's modules are found by the walk above, and
    its three kernels' sources by the source scans below."""
    found = {p.relative_to(PKG).with_suffix("").as_posix()
             for p in PKG.rglob("*.py")}
    assert {"core/cpx", "la/hessenberg", "la/schur", "la/eigen",
            "ops/bulge_chase", "ops/schur_small", "ops/trevc_solve"} <= found
    sources = {p.name for p in (PKG / "csrc").glob("*.cu")}
    assert {"bulge_chase.cu", "schur_small.cu", "trevc_solve.cu"} <= sources


def test_dt_and_the_opt_modules_are_among_those_checked():
    """``dt``, the single-matrix ``la`` internals and every module of
    ``opt`` are found by the walk above, so they too import without JAX,
    and by the source scans below."""
    found = {p.relative_to(PKG).with_suffix("").as_posix()
             for p in PKG.rglob("*.py")}
    assert {"dt", "core/host", "la/srrqr", "la/urv", "opt/__init__",
            "opt/optimization_error", "opt/polyquad", "opt/_tree",
            "opt/line_search/__init__", "opt/line_search/_engine",
            "opt/line_search/_wolfe", "opt/_lbfgs_solver",
            "opt/_lbfgsb_solver", "opt/lbfgs", "opt/_trust_region", "opt/lm",
            "opt/dogleg", "opt/_trust_region_tls", "opt/odr"} <= found


def test_the_rest_of_la_and_rand_are_among_those_checked():
    """The modules of the rest of ``la`` and of ``rand`` are found by the
    walk above, so they too import without JAX, and by the source scans
    below."""
    found = {p.relative_to(PKG).with_suffix("").as_posix()
             for p in PKG.rglob("*.py")}
    assert {"la/ldl", "la/pldlp", "la/bidiag", "la/svd_dc",
            "la/svd_block_jac", "la/svd_kogbetliantz", "la/svd_classic",
            "la/eye_diag", "la/misc", "rand/__init__", "rand/rng"} <= found


def test_the_rest_of_opt_and_utils_are_among_those_checked():
    """The modules of the rest of ``opt`` and of ``utils`` are found by the
    walk above, so they too import without JAX, and by the source scans
    below."""
    found = {p.relative_to(PKG).with_suffix("").as_posix()
             for p in PKG.rglob("*.py")}
    assert {"opt/lbfgsb", "opt/newton", "opt/fit_lin", "opt/num_grad",
            "opt/gss", "opt/root1d", "opt/nelder_mead", "opt/test_fn",
            "utils/__init__", "utils/geom", "utils/iter", "utils/spatial",
            "utils/integrate", "utils/arrays"} <= found


# the core surface's modules (and the top level, "top"), beside opt and
# utils, whose names the port must cover
SURFACE = ["core", "io", "parallel", "math", "help", "core.kahan",
           "core.ndarray", "core.wrapper", "core.mm", "core.cpx", "top"]


def _module(prefix, pkg):
    import importlib
    return importlib.import_module(prefix if pkg == "top"
                                   else f"{prefix}.{pkg}")


def _bound_names(pkg):
    """The names a module of the JAX package binds at its top: what a
    package's ``__init__`` imports from its own package, what it assigns
    (``__version__`` included) and what its ``__all__`` lists; private
    names aside (a plain module's own imports are its helpers)."""
    rel = Path(*pkg.split("."))
    path = ROOT / "nd4js_tpu" / "__init__.py" if pkg == "top" else \
        ROOT / "nd4js_tpu" / rel / "__init__.py"
    names = set()
    if path.exists():
        names = {a.asname or a.name for node in ast.walk(ast.parse(
            path.read_text())) if isinstance(node, ast.ImportFrom)
            and node.level == 1 for a in node.names}
    else:
        path = (ROOT / "nd4js_tpu" / rel).with_suffix(".py")
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name) and target.id == "__all__":
                    names |= set(ast.literal_eval(node.value))
                elif isinstance(target, ast.Name):
                    names.add(target.id)
    return {n for n in names if not n.startswith("_") or n == "__version__"}


@pytest.mark.parametrize("pkg", ["opt", "utils"] + SURFACE)
def test_every_name_the_jax_package_exports_is_in_the_port(pkg):
    """Every name that ``nd4js_tpu/<pkg>/__init__.py`` (or ``<pkg>.py``)
    imports, assigns or lists in ``__all__``, the submodules
    ``line_search`` and ``test_fn`` of ``opt`` included, is in the port's
    ``__all__``, and the port's ``__all__`` names only what it has; "top"
    is ``nd4js_tpu/__init__.py``, every name it binds."""
    names = _bound_names(pkg)
    port = _module("nd4js_tpu_torch", pkg)
    assert names, pkg
    assert names <= set(port.__all__), sorted(names - set(port.__all__))
    assert all(hasattr(port, n) for n in port.__all__)


@pytest.mark.parametrize("pkg", ["la", "rand", "opt", "utils"] + SURFACE)
def test_every_public_name_of_the_jax_package_is_in_the_port(pkg):
    """Every public function and class of ``nd4js_tpu.la``,
    ``nd4js_tpu.rand``, ``nd4js_tpu.opt`` and ``nd4js_tpu.utils`` (their
    submodules aside) is in the port's, listed in its ``__all__``; for the
    core surface's modules every name of their ``__all__`` (their
    ``dir()`` also lists typing helpers and ``annotations``), and for the
    top level every public name that is not a module. A name callable in
    the JAX package is callable in the port, and a value is a value."""
    import types
    ref = _module("nd4js_tpu", pkg)
    port = _module("nd4js_tpu_torch", pkg)
    if pkg in SURFACE and hasattr(ref, "__all__"):
        names = set(ref.__all__)
    else:
        names = {n for n in dir(ref) if not n.startswith("_")
                 and not isinstance(getattr(ref, n), types.ModuleType)}
    assert names, pkg
    assert names <= set(port.__all__), sorted(names - set(port.__all__))
    assert all(callable(getattr(port, n)) == callable(getattr(ref, n))
               for n in names)


def test_the_core_surface_modules_and_kernel_are_among_those_checked():
    """The core surface's modules are found by the walk above, so they
    too import without JAX, and ``kahan_sum``'s kernel source by the
    source scans below."""
    found = {p.relative_to(PKG).with_suffix("").as_posix()
             for p in PKG.rglob("*.py")}
    assert {"core/kahan", "core/ndarray", "core/wrapper", "math", "help",
            "io/__init__", "io/npy", "io/b64", "io/istr", "io/pyon",
            "parallel/__init__", "parallel/mesh", "ops/kahan_sum",
            "entry"} <= found
    assert (PKG / "csrc" / "kahan_sum.cu").exists()


def test_no_source_of_the_port_imports_jax_or_the_jax_package():
    for path in sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        assert not _top_level_imports(path) & set(FORBIDDEN), path


def test_chip_smoke_imports_only_the_port_torch_numpy_and_stdlib():
    """scipy aside: its L-BFGS-B, imported where it runs, is a witness
    printed beside the port's, never a gate."""
    allowed = {"nd4js_tpu_torch", "torch", "numpy", "scipy", "__future__"}
    extra = _top_level_imports(ROOT / "chip_smoke.py") - allowed
    assert extra <= set(sys.stdlib_module_names), extra


def test_no_library_decomposition_or_compiler_on_the_main_path():
    """torch.linalg, torch.geqrf, cuSOLVER, torch.compile and PyTorch's
    C++ extension tooling appear nowhere in the port (chip_smoke.py may time
    a library call as a yardstick; the port never calls one)."""
    banned = ("torch.linalg", "geqrf", "cusolver", "torch.compile",
              "cpp_extension", "torch/extension.h")
    for path in sorted(PKG.rglob("*")):
        if path.suffix in (".py", ".cu", ".cuh"):
            text = path.read_text().lower()
            assert not [b for b in banned if b.lower() in text], path


def test_chip_smoke_without_a_cuda_card_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         text=True, capture_output=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no CUDA device" in out.stderr
