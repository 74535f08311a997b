"""The reference against the port's outputs on the CPU at a small size: the
sound outputs pass every limit, perturbed ones fail, and the control (the
reference in TF32 in the program's place) fails at least one."""

import numpy as np
import pytest

from conftest import SEEDS, TINY
from perfbench.harness import window as win
from perfbench.reference import check as rc


@pytest.fixture(scope="module", params=sorted(TINY))
def sampled(request, pending_cells):
    w = request.param
    c, entry, prob, reg = win.setup(w, SEEDS[w], "cpu", TINY[w])
    rec = win.window(entry, prob, reg, "cpu", 0.0, SEEDS[w], False)
    snap = dict(rec["snapshot"], extent=prob["extent"])
    ref = rc.outputs(prob, snap, "float64", "cpu")
    return c["limits"]["limits"], prob, snap, ref


def within(nums, limits):
    return all(nums[k] <= v for k, v in limits.items() if k in nums)


def test_sound_outputs_pass(sampled):
    limits, prob, snap, ref = sampled
    nums = rc.numbers(rc.program_outputs(snap), ref, prob["extent"])
    assert within(nums, limits), nums


@pytest.mark.parametrize("field,number,change", [
    ("x1", "x1_err", lambda x, ref, e: x + 1e-2 * e),
    ("grad", "grad_err", lambda g, ref, e: 2.0 * g),
    ("fe", "fe_err", lambda f, ref, e: f + 1e-2 * ref["fe_scale"]),
    ("gmm_after", "em_err", lambda g, ref, e: dict(g, mu=g["mu"] + 1e-2 * e)),
    ("q0", "q0_diff", lambda q, ref, e: q + 1e-6),
])
def test_perturbed_outputs_fail(sampled, field, number, change):
    limits, prob, snap, ref = sampled
    if number not in limits:
        pytest.skip(f"{number} is not compared in this cell")
    got = rc.program_outputs(snap)
    got[field] = change(got[field] if field == "gmm_after" else np.asarray(got[field]),
                        ref, prob["extent"])
    assert rc.numbers(got, ref, prob["extent"])[number] > limits[number]


def test_the_control_fails(sampled):
    limits, prob, snap, ref = sampled
    ctl = rc.outputs(prob, snap, "tf32", "cpu")
    nums = rc.numbers(rc.control_outputs(ctl), ref, prob["extent"])
    assert not within(nums, limits), nums


def test_a_registration_that_does_not_move_fails(sampled):
    limits, prob, snap, ref = sampled
    still = dict(snap, a0_after=snap["a0_before"])
    ref_still = rc.outputs(prob, still, "float64", "cpu")
    assert rc.stall(ref_still).max() == 1.0
    assert rc.numbers(rc.program_outputs(still), ref_still, prob["extent"])["reg_stall"] \
        > limits["reg_stall"]
