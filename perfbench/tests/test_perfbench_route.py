"""The grid atlas on the port's kernel route, which the route rule of
``difficp_torch/ops/backend.py`` takes once a call's frames together pass
``DENSE_PAIR_LIMIT``, against the float64 grid-support reference
(``reference/ext.py``) with the tolerances of ``test_perfbench_ext.py``, at
3 frames of 500 points, sigma_LDDMM 0.2 (on the CPU the kernel route runs
the kernels' plain versions); then the readers of ``ext_rhs_roofline_pct``
and ``kmin2_roofline_pct`` and their roofline files on synthetic traces."""

import numpy as np
import pytest
import torch

from difficp_torch.utils import profiling
from perfbench.metrics import ext_rhs_roofline_pct, kmin2_roofline_pct
from perfbench.reference import ext as rext
from perfbench.roofline import kmin2, peaks, rhs_ext
from test_perfbench_ext import ATLAS, _reference, case  # noqa: F401


@pytest.fixture
def kernel_rule(monkeypatch, case):  # noqa: F811
    """The limit between one frame's ext RHS pairs and the three frames'."""
    from difficp_torch.ops import backend

    m, n = case["q0"].shape[1], case["x0"].shape[1]
    one_frame = m * (m + n)
    monkeypatch.setattr(backend, "DENSE_PAIR_LIMIT", 2 * one_frame)
    backend.set_backend(None)
    backend.routes.clear()
    yield backend.routes
    backend.routes.clear()


def _port(case, dtype):  # noqa: F811
    """The port's loss, gradient, warped data and coverage distances in
    ``dtype``, on the route the rule picks."""
    from difficp_torch.models import lddmm
    from difficp_torch.ops import backend

    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    lc = ATLAS["lddmm"]
    cfg = lddmm.make_config(sigma=lc["sigma"], lambd=lc["lambd"], version=lc["version"],
                            nt=lc["nt"], scheme=lc["scheme"])
    q0, qm, x0, xm = t(case["q0"]), t(case["qm"]), t(case["x0"]), t(case["xm"])
    p = t(case["p0"]).requires_grad_(True)
    final, _ = lddmm.shoot(cfg, q0, p, x0, qm, xm)
    trajl = lddmm.trajloss(cfg, q0, p, final.cost, qm)
    datal = (t(case["wts"])[..., None] * (final.x - t(case["y"])) ** 2).sum((1, 2)) \
        / (2.0 * case["sig2"])
    (g,) = torch.autograd.grad((trajl + datal).sum(), p)
    with torch.no_grad():
        _, traj = lddmm.shoot(cfg, q0, p, x0, qm, xm, save_traj=True)
        d2 = backend.min_sqdist(traj.x, traj.q, qm)
    return trajl + datal, g, final.x, d2


def test_the_rule_takes_the_kernel_route_and_holds_the_reference(kernel_rule, case):  # noqa: F811
    f_p, g_p, x1_p, d2_p = _port(case, torch.float64)
    routes = dict(kernel_rule)
    for fn in ("lddmm_rhs_ext", "row_order", "data_order", "min_sqdist"):
        assert routes.get((fn, "kernel"), 0) > 0 and (fn, "dense") not in routes, (fn, routes)
    f_r, g_r, x1_r, states = _reference(case, keep=True)
    torch.testing.assert_close(f_r, f_p.detach(), rtol=1e-10, atol=0)
    torch.testing.assert_close(g_r, g_p, rtol=1e-10, atol=1e-14 * float(g_p.abs().max()))
    torch.testing.assert_close(x1_r.detach(), x1_p.detach(), rtol=1e-10, atol=0)
    d2_r = rext.min_sqdist(states, torch.as_tensor(case["qm"], dtype=torch.float64))
    torch.testing.assert_close(d2_r, d2_p, rtol=1e-10, atol=0)


def test_the_kernel_routes_float32_distances_lie_inside_the_band(kernel_rule, case):  # noqa: F811
    """As ``test_perfbench_ext.py`` holds the dense route: inside a quarter
    of the band that ``cover_band`` derives from the reference's float32
    witness."""
    qm = torch.as_tensor(case["qm"], dtype=torch.float64)
    *_, d2_32 = _port(case, torch.float32)
    assert kernel_rule[("min_sqdist", "kernel")] == 1
    _, _, _, states = _reference(case, keep=True)
    d2_64 = rext.min_sqdist(states, qm)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    *_, witness = rext.shoot(ATLAS["lddmm"], f32(case["q0"]), f32(case["p0"]), f32(case["qm"]),
                             f32(case["x0"]), f32(case["xm"]), "float32", keep=True)
    band = rext.cover_band(ATLAS["lddmm"], d2_64, rext.min_sqdist(witness, qm.float()))
    thr = rext.cover_threshold(ATLAS["lddmm"])
    assert 1e-7 < band < 1e-4
    assert float(((d2_32.double() - d2_64).abs() / d2_64.clamp_min(thr)).max()) < band / 4


# ---------------------------------------------------------------------------
# the roofline files against the kernel table, and the two readers
# ---------------------------------------------------------------------------

# PERF.md's kernel table: the least-work bounds at the grid main path's
# shapes (ext: 10 frames, 65,536 points, 380 support points; kmin2: the
# coverage pass's 110 sets), on the FP32 pipe, and the forward's by its
# exponentials
MAIN = {"frames": 10, "support": 380, "points": 65536, "d": 2}


@pytest.mark.parametrize("kernel,term,want", [
    ("rhs_ext_fwd", "exp", 0.05947147462686567),
    ("rhs_ext_bwd_dx", "fp32_pipe", 0.07062237611940299),
    ("rhs_ext_bwd_dqdp", "fp32_pipe", 0.07805631044776119),
])
def test_ext_counts_reproduce_the_kernel_table(kernel, term, want):
    t = peaks.terms_ms(*rhs_ext.work(kernel, MAIN["frames"], MAIN["support"], MAIN["points"],
                                     MAIN["d"]))
    assert t[term] == pytest.approx(want, rel=1e-12)
    assert peaks.least_ms(*rhs_ext.work(kernel, 10, 380, 65536, 2)) == max(
        t["ops"], t["exp"], t["bytes"])


def test_kmin2_count_reproduces_the_kernel_table():
    t = peaks.terms_ms(*kmin2.work(110, 65536, 380, 2))
    assert t["fp32_pipe"] == pytest.approx(0.32709311044776124, rel=1e-12)
    assert t["exp"] == 0.0


def test_the_counts_are_the_programs_at_freezing():
    from difficp_torch.ops import kmin2 as pk
    from difficp_torch.ops import rhs_ext as pe

    for d in (2, 3):
        assert rhs_ext.fwd_ops_per_pair(d) == pe.fwd_ops_per_pair(d)
        assert rhs_ext.dx_ops_per_pair(d) == pe.dx_ops_per_pair(d)
        assert rhs_ext.dqdp_ops_per_pair(d) == pe.dqdp_ops_per_pair(d)
        assert kmin2.ops_per_pair(d) == pk.ops_per_pair(d)


MS = 1_000_000
T0 = 1_700_000_000 * 10 ** 9  # ns since the epoch
K40 = {"frames": 40, "support": 36, "points": 65536, "d": 2}
SYM = {"fwd": "void (anonymous namespace)::direct_kernel<(anonymous namespace)::"
              "ExtFwd<2, false> >((anonymous namespace)::DirectArgs)",
       "fwd_eta": "void (anonymous namespace)::direct_kernel<(anonymous namespace)::"
                  "ExtFwd<2, true> >((anonymous namespace)::DirectArgs)",
       "dx": "void (anonymous namespace)::ext_table_kernel<(anonymous namespace)::"
             "DxSpec<2>, 2, 4, 64>((anonymous namespace)::ExtArgs)",
       "dqdp": "void (anonymous namespace)::ext_table_kernel<(anonymous namespace)::"
               "DqdpSpec<2>, 2, 4, 64>((anonymous namespace)::ExtArgs)",
       "self": "void (anonymous namespace)::rhs_table_kernel<2, false, 4, 64>(TabArgs)",
       "kmin2": "void (anonymous namespace)::kmin2_kernel<2, false>((anonymous namespace)::"
                "K2Args)",
       "kmin2_self": "void (anonymous namespace)::kmin2_kernel<2, true>((anonymous "
                     "namespace)::K2Args)"}


def test_ext_reader_on_a_known_trace():
    """Two forwards of 0.1 ms, a dx of 0.2 and a dq/dp of 0.3 ms; the eta
    instance and a self kernel are not counted."""
    events = [(SYM["fwd"], T0, MS // 10), (SYM["dx"], T0 + MS, MS // 5),
              (SYM["dqdp"], T0 + 2 * MS, 3 * MS // 10), (SYM["fwd"], T0 + 3 * MS, MS // 10),
              (SYM["fwd_eta"], T0 + 4 * MS, 7 * MS), (SYM["self"], T0 + 5 * MS, 9 * MS)]
    run = {"trace": {"events": events}, "shapes": {"ext": K40}}
    b = rhs_ext.launch_bounds(K40)
    want = 100.0 * (2 * b["rhs_ext_fwd"][1] + b["rhs_ext_bwd_dx"][1]
                    + b["rhs_ext_bwd_dqdp"][1]) / 0.7
    assert ext_rhs_roofline_pct.read(run) == pytest.approx(want, rel=1e-12)
    assert 0 < want < 100
    assert ext_rhs_roofline_pct.read(dict(run, shapes={"self": {}})) is None
    assert ext_rhs_roofline_pct.read(dict(run, trace=None)) is None


def _coverage(shape_a, shape_b):
    """Two coverage spans of the given shapes, 100 ms apart; a kmin2 launch of
    0.5 ms after each, a self-excluding one and a launch before the first
    span (neither counted)."""
    S = profiling.Span
    spans = [S("psr.Reg_opt", T0, T0 + 300 * MS, -1, 0, {}),
             S("psr.coverage", T0 + 50 * MS, T0 + 60 * MS, 0, 0, dict(shape_a)),
             S("psr.coverage", T0 + 150 * MS, T0 + 160 * MS, 0, 0, dict(shape_b))]
    events = [(SYM["kmin2"], T0 + 10 * MS, 4 * MS), (SYM["kmin2"], T0 + 58 * MS, MS // 2),
              (SYM["kmin2_self"], T0 + 70 * MS, 6 * MS), (SYM["fwd"], T0 + 80 * MS, MS),
              (SYM["kmin2"], T0 + 165 * MS, MS // 2)]
    return spans, {"trace": {"events": events}, "shapes": {"ext": K40}}


def test_kmin2_reader_on_a_known_trace(monkeypatch):
    """Each launch at the shape of the coverage span that precedes it."""
    a = {"frames": 440, "points": 65536, "support": 36, "d": 2}
    b = {"frames": 110, "points": 65536, "support": 380, "d": 2}
    spans, run = _coverage(a, b)
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    la, lb = kmin2.launch_bounds(a)["kmin2"][1], kmin2.launch_bounds(b)["kmin2"][1]
    want = 100.0 * (la + lb) / 1.0
    assert kmin2_roofline_pct.read(run) == pytest.approx(want, rel=1e-12)
    # the k40 coverage pass is bound by its bytes: x, y and the mask in, the
    # first minimum out
    t = peaks.terms_ms(*kmin2.work(440, 65536, 36, 2))
    assert la == t["bytes"] > t["ops"]
    assert t["bytes"] == pytest.approx(4.0 * 440 * (65536 * 3 + 36 * 3) / 3.35e9, rel=1e-12)


@pytest.mark.parametrize("case_", ["untraced", "no_spans", "no_coverage", "older_program"])
def test_kmin2_reader_finds_nothing(monkeypatch, case_):
    """None, and no error: an untraced run, a window with no span, one with
    no coverage span (the parent's program, or a cell without a coverage
    pass), and a program without the recorder."""
    shape = {"frames": 440, "points": 65536, "support": 36, "d": 2}
    spans, run = _coverage(shape, shape)
    if case_ == "untraced":
        monkeypatch.setattr(profiling, "spans", lambda: spans)
        run = dict(run, trace=None)
    elif case_ == "no_spans":
        monkeypatch.setattr(profiling, "spans", lambda: [])
    elif case_ == "no_coverage":
        monkeypatch.setattr(profiling, "spans", lambda: spans[:1])
    else:
        monkeypatch.delattr(profiling, "spans")
    assert kmin2_roofline_pct.read(run) is None
