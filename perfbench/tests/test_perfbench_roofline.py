"""The frozen counts against the kernel table of PERF.md (its least-work
bounds at the main paths' shapes, on the FP32 pipe), and the roofline's
least time against every route's own bound."""

import pytest

from perfbench.roofline import peaks, rhs_self


def self_terms(kernel, m):
    return peaks.terms_ms(*rhs_self.work(kernel, 1, m, [m], 2))


@pytest.mark.parametrize("kernel,m,want", [
    ("rhs_self_fwd", 65536, 1.0256481814925373),
    ("rhs_self_bwd", 65536, 2.275656902686567),
    ("rhs_self_fwd", 380, None),
])
def test_self_counts_reproduce_the_kernel_table(kernel, m, want):
    t = self_terms(kernel, m)
    if want is not None:
        assert t["fp32_pipe"] == pytest.approx(want, rel=1e-12)
    # one exponential per unordered pair at the SFU rate
    assert t["exp"] == pytest.approx(m * (m - 1) / 2 / peaks.EXP_PER_S * 1e3, rel=1e-12)


def test_sfu_rate_is_sixteen_of_256_fp32_lanes():
    assert peaks.EXP_PER_S == pytest.approx(4.1875e12)


@pytest.mark.parametrize("route_ms,kernel", [
    # the table routes' own bounds (PERF.md's kernel table): the self
    # forward's tensor-core route 1.025663831880597 ms at 65,536^2 and the
    # backward's 2.4988900631272726 ms; a route cannot beat the least time,
    # so the least time may not exceed them
    (1.025663831880597, "rhs_self_fwd"),
    (2.4988900631272726, "rhs_self_bwd"),
])
def test_least_time_is_below_every_route(route_ms, kernel):
    least = peaks.least_ms(*rhs_self.work(kernel, 1, 65536, [65536], 2))
    assert least <= route_ms * (1 + 1e-12)


def test_launch_bounds_name_each_kernel_symbol():
    s = rhs_self.launch_bounds({"frames": 1, "points": 8, "valid": [8.0], "d": 2})
    assert set(s) == {"rhs_self_fwd", "rhs_self_bwd"}
    assert all(b > 0 for _, b in s.values())
