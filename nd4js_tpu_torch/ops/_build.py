"""Build the package's CUDA kernels, load them with ctypes, launch them.

All ``csrc/*.cu`` files go through ONE ``nvcc`` call into a shared
library with a plain C interface (no PyTorch headers: such a build takes
minutes, this one seconds). The library lands in
``build/nd4js_tpu_torch/<hash of the sources>/`` at the repository root,
a directory that git ignores, and is built anew by each process that
first needs it. A failed build raises with nvcc's output; there is no
fallback. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import signal
import subprocess
import tempfile
import time
from pathlib import Path

import torch

__all__ = ["NVCC_FLAGS", "SMEM_MAX", "SMS", "SM_SMEM", "build",
           "check_operand", "launch", "library", "recorder", "sms"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_ROOT = _PKG.parent / "build" / "nd4js_tpu_torch"
_NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"

# shared memory one block may use on Hopper (227 KB), which decides the
# regime of the kernels that keep a whole matrix there when it fits
SMEM_MAX = 232448
# SMs of an H100 SXM: what a launch plan assumes where no card is asked
SMS = 132
# shared memory of one Hopper SM, of which 1 KB a resident block is reserved
SM_SMEM = 233472

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _D, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, \
    ctypes.c_size_t
# C signatures of csrc/*.cu: every pointer and the stream as c_void_p, a
# real scalar as a double in both precisions, a byte count as size_t
_SIGNATURES = {
    "nd4js_chol_leaf_f32": (_I, [_P, _P, _P, _I, _I, _I, _P]),
    "nd4js_chol_leaf_f64": (_I, [_P, _P, _P, _I, _I, _I, _P]),
    "nd4js_qr_gesv_f32": (_I, [_P, _P] + [_I] * 6 + [_P]),
    "nd4js_qr_gesv_f64": (_I, [_P, _P] + [_I] * 6 + [_P]),
    "nd4js_house_stripe_t_f32": (_I, [_P] * 4 + [_I] * 6 + [_P]),
    "nd4js_house_stripe_t_f64": (_I, [_P] * 4 + [_I] * 6 + [_P]),
    "nd4js_house_stripe_smem": (ctypes.c_size_t, [_I] * 7),
    "nd4js_lu_panel_f32": (_I, [_P, _P] + [_I] * 7 + [_P]),
    "nd4js_lu_panel_f64": (_I, [_P, _P] + [_I] * 7 + [_P]),
    "nd4js_lu_panel_clusters": (_I, [_I] * 5),
    "nd4js_lu_gesv_f32": (_I, [_P] * 5 + [_I] * 6 + [_P]),
    "nd4js_lu_gesv_f64": (_I, [_P] * 5 + [_I] * 6 + [_P]),
    "nd4js_sytrd_panel_f32": (_I, [_P] * 7 + [_I] * 9 + [_P]),
    "nd4js_sytrd_panel_f64": (_I, [_P] * 7 + [_I] * 9 + [_P]),
    "nd4js_sytrd_panel_clusters": (_I, [_I] * 4),
    "nd4js_jacobi_sweeps_f32": (_I, [_P] * 6 + [_I] * 9 + [_P]),
    "nd4js_jacobi_sweeps_f64": (_I, [_P] * 6 + [_I] * 9 + [_P]),
    "nd4js_jacobi_clusters": (_I, [_I] * 5),
    "nd4js_rrqr_f32": (_I, [_P] * 6 + [_I] * 7 + [_P]),
    "nd4js_rrqr_f64": (_I, [_P] * 6 + [_I] * 7 + [_P]),
    "nd4js_rrqr_clusters": (_I, [_I] * 4),
    "nd4js_schur_small_f32": (_I, [_P] * 5 + [_I] * 6 + [_S, _P]),
    "nd4js_schur_small_f64": (_I, [_P] * 5 + [_I] * 6 + [_S, _P]),
    "nd4js_schur_small_blocks_per_sm": (_I, [_I, _I, _S]),
    "nd4js_bulge_chase_f32": (_I, [_P] * 5 + [_I] * 12 + [_S, _P]),
    "nd4js_bulge_chase_f64": (_I, [_P] * 5 + [_I] * 12 + [_S, _P]),
    "nd4js_trevc_solve_f32": (_I, [_P] * 8 + [_I] * 4 + [_D, _I, _P]),
    "nd4js_trevc_solve_f64": (_I, [_P] * 8 + [_I] * 4 + [_D, _I, _P]),
    "nd4js_kahan_sum_f32": (_I, [_P, _P, _I, _I, _P]),
    "nd4js_kahan_sum_f64": (_I, [_P, _P, _I, _I, _P]),
}

_built = None
_lib = None

# None, or a function that :func:`launch` calls as recorder(kernel, fn_name,
# device, args) before each launch (``chip_smoke.py`` records the main
# path's launches with it, to time each distinct one in isolation).
recorder = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(_NVCC_DEFAULT):
        return _NVCC_DEFAULT
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda: "
                       "the CUDA kernels cannot be built")


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def build():
    """Compile every kernel source with one nvcc call.

    Returns (path of the library, seconds the build took, nvcc's output,
    which holds ptxas's registers and shared memory per kernel).
    """
    global _built
    nvcc = _nvcc()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_CSRC.iterdir()):
        digest.update(path.name.encode() + path.read_bytes())
    out_dir = _BUILD_ROOT / digest.hexdigest()[:16]
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libnd4js_kernels.so"
    # build into a private file and rename it into place: a build that
    # was cut off leaves nothing that a later process could load
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc] + NVCC_FLAGS + ["-o", tmp] + [str(s) for s in _sources()]
    t0 = time.perf_counter()
    try:
        # own process group, so a timeout also ends cicc and ptxas
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            log, _ = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise RuntimeError(f"nvcc timed out after 300 s: {' '.join(cmd)}")
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
                f"{log}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _built = (lib, time.perf_counter() - t0, log)
    return _built


def library():
    """The loaded kernel library: the last build() of this process, or
    a new one."""
    global _lib
    if _lib is None:
        path, _, _ = _built if _built is not None else build()
        lib = ctypes.CDLL(str(path))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
    return _lib


def sms(device) -> int:
    """SMs of the CUDA card of ``device`` (needs the card)."""
    return _sms_of(device.index if device.index is not None
                   else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _sms_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_operand(t, name: str, ndim: int):
    """Raise unless ``t`` is a ``ndim``-D float32/float64 tensor; return
    True when it lies on a CUDA device (so the kernel runs) and False on
    the CPU (so the plain version runs). Any other device raises."""
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected a {ndim}-D tensor, got shape "
                         f"{tuple(t.shape)}")
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64 only, got {t.dtype}")
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    if max(t.shape) >= 2 ** 31:
        raise ValueError(f"{name}: dimension too large for the kernel")
    return True


def launch(fn_name: str, device, *args, kernel: str | None = None):
    """Call the C function ``fn_name`` with ``args`` (tensors are passed
    as pointers) and the current stream of ``device``; raise if it
    reports a CUDA error. ``kernel`` names the wrapper for the
    ``recorder`` where two share a C function."""
    if recorder is not None:
        recorder(kernel, fn_name, device, args)
    lib = library()
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn_name)(*ptrs, stream)
    if rc == -2:
        raise RuntimeError(f"{fn_name}: no part of the card can hold one "
                           "cluster of the launch")
    if rc != 0:
        # 1 (cudaErrorInvalidValue) is also what a block asking for more
        # than Hopper's 227 KB of shared memory gets
        raise RuntimeError(f"{fn_name}: launch failed with CUDA error {rc}")
