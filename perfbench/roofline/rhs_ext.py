"""The eta = 0 ext RHS kernels (rows #6 and #7 of PERF.md's kernel table):
the function's own work per launch, from its shapes.

Frozen copies of ``difficp_torch/ops/rhs_ext.py``'s ``fwd_ops_per_pair``
(5 d + 1), ``dx_ops_per_pair`` (9 d + 1) and ``dqdp_ops_per_pair``
(9 d + 3): the program may change its own counts, the yardstick does not.
Work is counted per (data point, support point) pair, one exponential each,
every slot counted (the grid cells mask no point); inputs are read once and
outputs written once (the dx kernel's row order, an artefact of its route,
is not counted).
"""

from perfbench.roofline import peaks


def fwd_ops_per_pair(d: int) -> int:
    """delta, r2, vx += k p_j, the divergence cost's k (q_j.p_j) (an FMA
    counts as two; per-point factors not counted)."""
    return 5 * d + 1


def dx_ops_per_pair(d: int) -> int:
    """delta, r2, s = k (g'.p_j - c (q_j.p_j)), e += s delta, a += k p_j."""
    return 9 * d + 1


def dqdp_ops_per_pair(d: int) -> int:
    """e, r2, km, s = k (h.p_l) - c km, a += s e, g += k h, n += km."""
    return 9 * d + 3


def symbols(d: int) -> dict:
    """Kernel name -> the substring of its CUDA symbol in a device trace
    (``csrc/direct.cuh``'s kernel on ``ExtFwd``, ``csrc/rhs_ext.cu``'s table
    kernel on ``DxSpec`` and ``DqdpSpec``)."""
    return {"rhs_ext_fwd": f"ExtFwd<{d}, false>",
            "rhs_ext_bwd_dx": f"DxSpec<{d}>",
            "rhs_ext_bwd_dqdp": f"DqdpSpec<{d}>"}


def work(kernel: str, frames: int, support: int, points: int, d: int):
    """(operations, exponentials, bytes) of one launch over ``frames`` frames
    of ``points`` data points and ``support`` support points."""
    pairs = float(frames) * support * points
    # x, mx and q, p, mq in, per frame
    data_in, support_in = points * (d + 1), support * (2 * d + 1)
    if kernel == "rhs_ext_fwd":
        # vx and the per-row dcost partials out
        nbytes = 4.0 * frames * (data_in + support_in + points * (d + 1))
        return pairs * fwd_ops_per_pair(d), pairs, nbytes
    if kernel == "rhs_ext_bwd_dx":
        # gx and gc in besides; dx out
        nbytes = 4.0 * frames * (data_in + points * d + support_in + 1 + points * d)
        return pairs * dx_ops_per_pair(d), pairs, nbytes
    if kernel == "rhs_ext_bwd_dqdp":
        # gx and gc in besides; dq, dp out
        nbytes = 4.0 * frames * (data_in + points * d + support_in + 1 + support * 2 * d)
        return pairs * dqdp_ops_per_pair(d), pairs, nbytes
    raise KeyError(kernel)


def launch_bounds(shape: dict) -> dict:
    """Kernel -> (symbol, least ms of one launch) at the cell's ext shape
    ``{"frames", "support", "points", "d"}``."""
    syms = symbols(shape["d"])
    return {k: (syms[k], peaks.least_ms(*work(k, shape["frames"], shape["support"],
                                               shape["points"], shape["d"])))
            for k in syms}
