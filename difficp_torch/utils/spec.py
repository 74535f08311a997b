"""Dtype and device policy (counterpart of ``difficp_tpu/utils/spec.py``).

Float32 compute everywhere, as in the reference.  Entry points take an explicit
``device``: ``None`` means the CUDA card, and asking for it where CUDA is absent
raises, so nothing silently carries on on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

# Compute dtype for all point-set math.
default_dtype = torch.float32


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def as_tensor(x, device, dtype=None) -> torch.Tensor:
    """Array-like (numpy / list / tensor) -> tensor of ``dtype`` on ``device``."""
    if dtype is None:
        dtype = default_dtype
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def on_cpu(x) -> np.ndarray:
    """Host copy (numpy) of a tensor on any device, or of an array-like,
    e.g. for matplotlib or a checkpoint."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
