"""``ext_rhs_roofline_pct``: the eta = 0 ext RHS kernels (``ops/rhs_ext.py`` +
``csrc/rhs_ext.cu``, rows #6 and #7: the forward, dx and dq/dp) against
their roofline, at the cell's ext shape."""

from perfbench.metrics._roofline import share
from perfbench.roofline import rhs_ext


def read(run):
    return share(run, rhs_ext, "ext")
