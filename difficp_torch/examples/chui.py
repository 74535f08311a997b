"""Chui–Rangarajan 2D registration benchmark pairs (counterpart of
``difficp_tpu/examples/chui.py``, a numpy / scipy copy of its loader).

The classic ICP benchmark the reference demos on (5 .mat datasets of 50-105
2D points, reference api/ICP_two_set.py:297-345).  The files are read from
``DIFFICP_CHUI_PATH``, or from the reference diffICP checkout beside this
repository (``../reference/diffICP/examples/chui-data``) when present
(read-only).
"""

from __future__ import annotations

import os

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_DEFAULT_DIRS = [
    os.environ.get("DIFFICP_CHUI_PATH", ""),
    os.path.join(os.path.dirname(_REPO), "reference", "diffICP", "examples", "chui-data"),
]

# variable names inside each .mat file (no general rule, reference
# ICP_two_set.py:304-305)
_X_NAMES = ["x1", "x2", "x3", "x1", "x1"]
_Y_NAMES = ["y1", "y2", "y3", "y2a", "y2a"]


def load_chui(dataset: int, path: str | None = None):
    """Load Chui dataset 1..5; returns (xA, xB) float32 arrays:
    xA = GMM-centroid set, xB = point set to register (reference convention,
    ICP_two_set.py:306-307)."""
    if not 1 <= dataset <= 5:
        raise ValueError(f"Chui datasets are 1..5, not {dataset}")
    import scipy.io

    dirs = [path] if path else [d for d in _DEFAULT_DIRS if d]
    for d in dirs:
        f = os.path.join(d, f"demodata_ex{dataset}.mat")
        if os.path.exists(f):
            mat = scipy.io.loadmat(f)
            xa = np.ascontiguousarray(mat[_X_NAMES[dataset - 1]], np.float32)
            xb = np.ascontiguousarray(mat[_Y_NAMES[dataset - 1]], np.float32)
            return xa, xb
    raise FileNotFoundError(
        f"Chui dataset {dataset} not found in {dirs}; set DIFFICP_CHUI_PATH"
    )
