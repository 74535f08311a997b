"""The eta = 0 self RHS kernels (rows #1 and #4 of PERF.md's kernel table):
the function's own work per launch, from its shapes.

Frozen copies of ``difficp_torch/ops/rhs_self.py``'s
``fwd_ops_per_unordered_pair`` (15 d + 2) and ``bwd_ops_per_unordered_pair``
(34 d + 3), and of ``chip_smoke.py``'s byte counts (``phase_timing``): the
program may change its own counts, the yardstick does not.  Work is counted
per unordered pair of unmasked points, one exponential each; inputs are read
once and outputs written once.
"""

from perfbench.roofline import peaks


def fwd_ops_per_unordered_pair(d: int) -> int:
    """d, r2, k~, p_i.p_j, both v updates, both w updates, dcost (an FMA
    counts as two; constant factors per row)."""
    return 15 * d + 2


def bwd_ops_per_unordered_pair(d: int) -> int:
    """The VJP's dq and dp updates of both rows of a pair, counted as the
    forward's."""
    return 34 * d + 3


def symbols(d: int) -> dict:
    """Kernel name -> the substring of its CUDA symbol in a device trace."""
    return {"rhs_self_fwd": f"rhs_table_kernel<{d}, false",
            "rhs_self_bwd": f"rhs_table_kernel<{d}, true"}


def work(kernel: str, frames: int, points: int, valid, d: int):
    """(operations, exponentials, bytes) of one launch over ``frames`` frames of
    ``points`` slots, ``valid`` the unmasked points of each frame."""
    upairs = float(sum(n * (n - 1) / 2 for n in valid))
    if kernel == "rhs_self_fwd":
        # q, p, m in; v, w, dcost out
        nbytes = 4.0 * frames * points * (2 * d + 1) * 2
        return upairs * fwd_ops_per_unordered_pair(d), upairs, nbytes
    if kernel == "rhs_self_bwd":
        # q, p, m, the cotangents a, b, c in; dq, dp out
        nbytes = 4.0 * (frames * points * (4 * d + 1) + frames + frames * points * 2 * d)
        return upairs * bwd_ops_per_unordered_pair(d), upairs, nbytes
    raise KeyError(kernel)


def launch_bounds(shape: dict) -> dict:
    """Kernel -> (symbol, least ms of one launch) at the cell's self shape
    ``{"frames", "points", "valid", "d"}``."""
    syms = symbols(shape["d"])
    return {k: (syms[k], peaks.least_ms(*work(k, shape["frames"], shape["points"],
                                               shape["valid"], shape["d"])))
            for k in syms}
