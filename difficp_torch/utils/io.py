"""Input canonicalization and padding of ragged point-set collections
(counterpart of ``difficp_tpu/utils/io.py``).

After canonicalization, each structure s is padded to its max size over
frames into a dense (K, Nmax_s, D) tensor with a float mask (K, Nmax_s).
Masked points carry zero weight in every downstream reduction.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


def _is_single_set(x) -> bool:
    return hasattr(x, "shape") and len(x.shape) == 2


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def read_point_sets(x):
    """Canonicalize to nested lists x[k][s] and return (x, K, S, D)
    (reference in_out.py:7-47 semantics)."""
    if _is_single_set(x):
        x = [[x]]
    elif isinstance(x, (list, tuple)):
        if len(x) == 0:
            raise ValueError("empty point set list")
        if _is_single_set(x[0]):
            x = [[xk] for xk in x]
        else:
            x = [list(xk) for xk in x]
    else:
        raise ValueError("Wrong format for input x")

    k = len(x)
    s_all = {len(xk) for xk in x}
    if len(s_all) > 1:
        raise ValueError("All frames should have same number of structures")
    s = s_all.pop()
    d_all = {_host(xks).shape[1] for xk in x for xks in xk}
    if len(d_all) > 1:
        raise ValueError("All point sets should have same axis-1 dimension")
    d = d_all.pop()
    return x, k, s, d


class PaddedFrames(NamedTuple):
    """One structure's point sets across frames, padded to a static size."""
    x: torch.Tensor     # (K, Nmax, D)
    mask: torch.Tensor  # (K, Nmax) 1.0 = real point
    n: np.ndarray       # (K,) true sizes (host-side metadata)

    @property
    def k(self):
        return self.x.shape[0]

    @property
    def nmax(self):
        return self.x.shape[1]


def pad_frames(sets: Sequence, device, nmax: int | None = None,
               pad_to_multiple: int = 8) -> PaddedFrames:
    """Pad a list of (N_k, D) arrays into a dense (K, Nmax, D) + mask.

    Nmax is rounded up to a multiple of ``pad_to_multiple``.  Padded rows
    replicate the frame's first point (keeps kernel matrices finite and
    well-scaled) with mask 0.
    """
    arrs = [_host(s).astype(np.float32) for s in sets]
    k = len(arrs)
    d = arrs[0].shape[1]
    n = np.array([a.shape[0] for a in arrs])
    if nmax is None:
        nmax = int(n.max())
    nmax = -(-nmax // pad_to_multiple) * pad_to_multiple
    x = np.zeros((k, nmax, d), np.float32)
    mask = np.zeros((k, nmax), np.float32)
    for i, a in enumerate(arrs):
        x[i, : a.shape[0]] = a
        x[i, a.shape[0]:] = a[0]  # replicate first point into padding
        mask[i, : a.shape[0]] = 1.0
    return PaddedFrames(x=torch.as_tensor(x, device=device),
                        mask=torch.as_tensor(mask, device=device), n=n)


def pad_structures(x, device) -> list[PaddedFrames]:
    """Canonicalize + pad: a list over structures s of PaddedFrames."""
    nested, k, s, d = read_point_sets(x)
    return [pad_frames([nested[ki][si] for ki in range(k)], device)
            for si in range(s)]
