"""The top-2 minimum ``kmin2`` (row #8 of PERF.md's kernel table) as the
coverage pass launches it: the work per launch, from its shape.

A frozen copy of ``difficp_torch/ops/kmin2.py``'s ``ops_per_pair`` (3 d + 2):
the program may change its own count, the yardstick does not.  Work is
counted per (point, support point) pair of every set (the grid cells mask
no support point), no exponential.  The bytes are what the coverage pass's
``min_sqdist`` needs: its inputs read once and the first minimum written
once; the second minimum, which the kernel also writes, is not counted.
The operations are the top-2 update's, 2 a pair above the first minimum's
alone; at the coverage pass's shapes the bytes bind.
"""

from perfbench.roofline import peaks


def ops_per_pair(d: int) -> int:
    """delta, r2 in the difference form, and the top-2 update's three
    min/max (an FMA counts as two)."""
    return 3 * d + 2


def symbols(d: int) -> dict:
    """Kernel name -> the substring of its CUDA symbol in a device trace: the
    instance without self-exclusion (``csrc/kmin2.cu``)."""
    return {"kmin2": f"kmin2_kernel<{d}, false>"}


def work(frames: int, points: int, support: int, d: int):
    """(operations, exponentials, bytes) of one launch over ``frames`` sets
    (saved states times frames) of ``points`` points against ``support``
    points each."""
    pairs = float(frames) * points * support
    # x; y and its mask in; m1 out
    nbytes = 4.0 * frames * (points * d + support * (d + 1) + points)
    return pairs * ops_per_pair(d), 0.0, nbytes


def launch_bounds(shape: dict) -> dict:
    """Kernel -> (symbol, least ms of one launch) at a coverage pass's shape
    ``{"frames", "points", "support", "d"}``."""
    syms = symbols(shape["d"])
    return {"kmin2": (syms["kmin2"], peaks.least_ms(*work(shape["frames"], shape["points"],
                                                          shape["support"], shape["d"])))}
