"""Global configuration for nd4js_tpu_torch.

The counterpart of ``nd4js_tpu/config.py``: the default floating dtype,
the dtype promotion rule of the LA routines, the ``debug_checks`` flag,
and the precision pin of every library-internal matrix product. Adds
the default device, because a PyTorch tensor carries its own.
"""
from __future__ import annotations

import os

import numpy as np
import torch

# A GPU-native library defaults to float32; float64 stays fully supported.
default_float = torch.float32

# Entry points put array-like inputs on this device; tensors keep theirs.
default_device = "cuda"

# TF32 keeps ~3 decimal digits and would break the 1e-5-tier accuracy
# contracts of the decompositions, exactly as the TPU's one-pass bf16
# default did (nd4js_tpu/config.py:20-32). Pin full precision for every
# float32 product and convolution.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

# When True, routines run extra invariant checks (finite outputs, the QR
# orthogonality spot-check) and raise DebugCheckError. Off by default:
# each check synchronises with the device.
debug_checks: bool = bool(int(os.environ.get("ND4JS_TPU_DEBUG", "0")))


def default_float_for(dtype) -> torch.dtype:
    """Floating dtype a given input dtype promotes to for LA routines:
    integers and bools promote to float64, floats are kept
    (nd4js_tpu/config.py:40-51). Accepts torch or numpy dtypes."""
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype
    if dtype.is_floating_point or dtype.is_complex:
        return dtype
    return torch.float64
