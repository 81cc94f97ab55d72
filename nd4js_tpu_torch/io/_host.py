"""The host side of the serializers: a tensor's data in numpy."""
from __future__ import annotations

import numpy as np
import torch


def to_host(a) -> np.ndarray:
    """``a`` as a numpy array; a tensor (on the card or not) is copied to
    the host once."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().resolve_conj().numpy()
    return np.asarray(a)
