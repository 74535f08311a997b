"""``self_rhs_roofline_pct``: the eta = 0 self RHS kernels (``ops/rhs_self.py``
+ ``csrc/rhs_self.cu``, rows #1 and #4) against their roofline."""

from perfbench.metrics._roofline import share
from perfbench.roofline import rhs_self


def read(run):
    return share(run, rhs_self, "self")
