"""Lane-batched L-BFGS with a single-loop strong-Wolfe line search
(counterpart of ``difficp_tpu/utils/lbfgs.py``).

The JAX package vmaps one L-BFGS over K frames.  Here the K frames are lanes
on the leading axis of one tensor and run in lockstep, with the semantics of
``vmap`` over ``lax.while_loop``: a loop runs while any lane's condition
holds, every iteration evaluates all lanes at once, and a lane whose condition
is false keeps its carry unchanged (``torch.where`` per lane).  No Python
branch looks at a single lane.

Contract (reference optim.py:10-110, as in the JAX package):

- up to ``nmax`` outer steps of ``inner`` quasi-Newton iterations each;
- ONE value+grad per line-search iteration: bracketing and zoom share one
  loop whose phase is a per-lane flag; the accepted trial's (value, grad) is
  threaded into the next iteration, so no step re-evaluates the objective;
- best-so-far tracking over every evaluation, line-search trials included;
- non-finite or aberrant (> errthresh) trials are rejected inside the search;
- warm state threads across calls: ``alpha0``, ``alpha_qn0``, ``memory0``,
  ``value0``/``grad0``/``aux0`` and ``stall0`` (see ``LBFGSResult``).

``lossfn(params)`` takes params of the shape of ``p0`` (K, ...) and returns
per-lane values (K,) (and an aux pytree of per-lane tensors with
``has_aux``).  Lanes must be independent: the gradient of the sum of the
values is each lane's own gradient.

With a process ``group`` the parameters are this rank's shard of a sharded
vector and the loss is the group's (the same on every rank): every dot
product is summed over the group, the infinity norms are its maximum and the
sizes count its whole vector, so every scalar that steers a branch is the
group's and every rank takes the same decisions (the collectives XLA inserts
for the JAX package's L-BFGS on sharded arrays).  The finiteness masks of the
gradient are elementwise and steer no branch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from difficp_torch.utils import profiling
from difficp_torch.utils.integrators import tree_map


class LBFGSResult(NamedTuple):
    params: torch.Tensor   # best parameters found, shape of p0
    loss: torch.Tensor     # (K,) best loss value
    n_steps: torch.Tensor  # (K,) outer steps taken
    change: torch.Tensor   # (K,) last relative parameter change (rms)
    alpha: torch.Tensor    # (K,) warm start of the next call's first search
    alpha_qn: torch.Tensor  # (K,) adaptive quasi-Newton trial scale
    aux: any               # with has_aux: aux of the best evaluation
    n_evals: torch.Tensor  # (K,) line-search evaluations (entry excluded)
    memory: "LBFGSMemory"  # final curvature memory, thread as memory0
    grad: torch.Tensor     # gradient at ``params``, shape of p0
    stalled: torch.Tensor  # (K,) lane frozen at f32 resolution this call


class LBFGSMemory(NamedTuple):
    """Circular (s, y) curvature memory, one per lane."""
    S: torch.Tensor      # (K, m, n) step differences, newest at (pos-1) % m
    Y: torch.Tensor      # (K, m, n) gradient differences
    rho: torch.Tensor    # (K, m) 1 / <s, y>
    pos: torch.Tensor    # (K,) next write slot
    count: torch.Tensor  # (K,) number of valid pairs (<= m)


def zero_memory(k: int, n: int, memory_size: int = 20, dtype=torch.float32,
                device=None) -> LBFGSMemory:
    """Empty curvature memory for K lanes of an ``n``-parameter problem
    (count == 0 behaves exactly like passing no memory)."""
    return LBFGSMemory(
        S=torch.zeros((k, memory_size, n), dtype=dtype, device=device),
        Y=torch.zeros((k, memory_size, n), dtype=dtype, device=device),
        rho=torch.zeros((k, memory_size), dtype=dtype, device=device),
        pos=torch.zeros((k,), dtype=torch.long, device=device),
        count=torch.zeros((k,), dtype=torch.long, device=device),
    )


# steps below this are exact-zero / denormal artifacts, never real steps
_ALPHA_DEGENERATE = 1e-25

_C1 = 1e-4   # Armijo (sufficient decrease) constant
_C2 = 0.9    # strong-Wolfe curvature constant

# torch.optim.LBFGS default inner stopping tolerances (reference optim.py:27)
_TOL_CHANGE = 1e-9
_TOL_GRAD = 1e-7


def _dot(a, b):
    """Per-lane dot product of (K, n) tensors."""
    return (a * b).sum(-1)


def _lane(mask, t):
    """Broadcast a (K,) lane mask against a (K, ...) tensor."""
    return mask.reshape(mask.shape + (1,) * (t.dim() - mask.dim()))


def _sel(mask, a, b):
    """Per-lane select over tensors or aux pytrees."""
    return tree_map(lambda x, y: torch.where(_lane(mask, x), x, y), a, b)


def _scal(v, k, dtype, device, default):
    """(K,) tensor from None / scalar / tensor."""
    if v is None:
        v = default
    return torch.as_tensor(v, dtype=dtype, device=device).expand(k).clone()


def _value_and_grad(lossfn, shape, has_aux):
    def vg(x):
        xr = x.detach().reshape(shape).requires_grad_(True)
        with torch.enable_grad():
            out = lossfn(xr)
            f, aux = out if has_aux else (out, ())
            (g,) = torch.autograd.grad(f.sum(), xr)
        return f.detach(), tree_map(torch.Tensor.detach, aux), \
            g.reshape(x.shape)

    return vg


def _seed_core(lossfn: Callable, p0):
    """(l0, seed): one value+grad and the classical first-step seed
    ~ min(1, 1/||g0||) per lane; a non-finite entry falls back to 1.0."""
    k = p0.shape[0]
    with profiling.span("lbfgs.entry"):
        l0, _, g0 = _value_and_grad(lossfn, p0.shape, False)(p0.reshape(k, -1))
    n = float(g0.shape[1])
    g0_norm = torch.sqrt(_dot(g0, g0) / max(n, 1.0)) * torch.sqrt(
        torch.tensor(n, dtype=l0.dtype, device=l0.device))
    seed = torch.minimum(torch.ones_like(g0_norm),
                         1.0 / torch.clamp_min(g0_norm, 1e-12))
    ok = torch.isfinite(l0) & torch.isfinite(seed)
    return l0, torch.where(ok, seed, torch.ones_like(seed)).float()


def seed_alpha_for(lossfn: Callable, p0) -> torch.Tensor:
    """Per-lane zoom line-search seed ~ min(1, 1/||g0||) for ``lossfn`` at
    ``p0``."""
    return _seed_core(lossfn, p0)[1]


def _cubic_min(a, fa, dga, b, fb, dgb):
    """Minimizer of the cubic through (a, fa, dga), (b, fb, dgb)
    (Nocedal & Wright eq. 3.59); NaN/inf on degenerate input."""
    d1 = dga + dgb - 3.0 * (fa - fb) / (a - b)
    d2 = torch.sqrt(torch.clamp_min(d1 * d1 - dga * dgb, 0.0)) * torch.sign(b - a)
    return b - (b - a) * (dgb + d2 - d1) / (dgb - dga + 2.0 * d2)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _linesearch(vg, max_steps, errthresh, x, fx, gx, d, a1,
                best_x, best_f, best_g, best_aux, dot=_dot):
    """Strong-Wolfe line search, one batched ``vg`` evaluation per iteration.

    Invariants: (a_lo, f_lo, dg_lo, g_lo) is the best Armijo-satisfying point
    seen (a_lo = 0 initially), so the budget-exhausted fallback accepts lo.
    Trials with non-finite or aberrant loss fail Armijo and shrink the
    bracket; a divergent trial met while bracketing backs off by 1/64.
    A trial's span ends at the next pass's read of the loop condition.
    """
    search = profiling.span("lbfgs.linesearch")
    dg0 = dot(gx, d)
    descent = torch.isfinite(dg0) & (dg0 < 0)
    kk = fx.shape[0]
    dev = fx.device
    zero = torch.zeros_like(fx)
    false = torch.zeros((kk,), dtype=torch.bool, device=dev)
    c = dict(
        k=torch.zeros((kk,), dtype=torch.long, device=dev), done=~descent,
        in_zoom=false, was_acc=false, was_edge=false,
        a_lo=zero, f_lo=fx, dg_lo=dg0, g_lo=gx,
        a_hi=zero + torch.inf, f_hi=zero + torch.inf, dg_hi=zero,
        a=torch.clamp_min(a1, 1e-30).to(fx.dtype),
        acc_a=zero, acc_f=fx, acc_g=gx,
        bx=best_x, bf=best_f, bg=best_g, baux=best_aux,
    )
    trials, trial = 0, profiling.OFF
    while True:
        pred = ~c["done"] & (c["k"] < max_steps)
        more = bool(pred.any())
        trial.end()
        if not more:
            break
        trial = profiling.span("lbfgs.eval")
        trials += 1
        a = c["a"]
        in_zoom = c["in_zoom"]
        a_lo, f_lo, dg_lo, g_lo = c["a_lo"], c["f_lo"], c["dg_lo"], c["g_lo"]
        a_hi, f_hi, dg_hi = c["a_hi"], c["f_hi"], c["dg_hi"]
        xa = x + a[:, None] * d
        fa, aux, ga = vg(xa)
        dga = dot(ga, d)
        okf = torch.isfinite(fa) & (fa <= errthresh)
        # best-so-far at every evaluation (reference optim.py:34-47)
        bb = okf & (fa < c["bf"])
        bf = torch.where(bb, fa, c["bf"])
        bx = _sel(bb, xa, c["bx"])
        bg = _sel(bb, ga, c["bg"])
        baux = _sel(bb, aux, c["baux"])

        armijo = okf & (fa <= fx + _C1 * a * dg0)
        strong = armijo & (dga.abs() <= -_C2 * dg0)
        brk_div = ~okf & ~in_zoom
        hi_cond = ~brk_div & (~armijo | (fa >= f_lo))
        accept = ~hi_cond & strong
        flip = (okf & ~hi_cond & ~strong) & torch.where(
            in_zoom, dga * (a_hi - a_lo) >= 0, dga >= 0)
        na_hi = torch.where(hi_cond, a, torch.where(flip, a_lo, a_hi))
        nf_hi = torch.where(hi_cond, fa, torch.where(flip, f_lo, f_hi))
        ndg_hi = torch.where(hi_cond, dga, torch.where(flip, dg_lo, dg_hi))
        lo_upd = ~hi_cond & ~strong & okf
        na_lo = torch.where(lo_upd, a, a_lo)
        nf_lo = torch.where(lo_upd, fa, f_lo)
        ndg_lo = torch.where(lo_upd, dga, dg_lo)
        ng_lo = _sel(lo_upd, ga, g_lo)
        nzoom = in_zoom | hi_cond | flip

        # zoom: cubic clamped into the 10%-margin interior; two consecutive
        # edge hugs -> bisect
        cube = _cubic_min(na_lo, nf_lo, ndg_lo, na_hi, nf_hi, ndg_hi)
        amin = torch.minimum(na_lo, na_hi)
        amax = torch.maximum(na_lo, na_hi)
        w = amax - amin
        lo_edge = amin + 0.1 * w
        hi_edge = amax - 0.1 * w
        clamped = _clip(cube, lo_edge, hi_edge)
        at_edge = (clamped <= lo_edge) | (clamped >= hi_edge)
        mid = 0.5 * (na_lo + na_hi)
        use_bisect = ~torch.isfinite(cube) | (at_edge & c["was_edge"])
        z_next = torch.where(use_bisect, mid, clamped)
        nwas_edge = at_edge & ~use_bisect
        # bracketing growth: cubic extrapolation clamped to [2a, 10a]
        grow = _cubic_min(a_lo, f_lo, dg_lo, a, fa, dga)
        grow = torch.where(torch.isfinite(grow), _clip(grow, 2.0 * a, 10.0 * a),
                           2.0 * a)
        a_next = torch.where(nzoom, z_next, grow)
        a_next = torch.where(brk_div, a * (1.0 / 64.0), a_next)

        new = dict(
            k=c["k"] + 1, done=c["done"] | accept, in_zoom=nzoom,
            was_acc=c["was_acc"] | accept, was_edge=nwas_edge,
            a_lo=na_lo, f_lo=nf_lo, dg_lo=ndg_lo, g_lo=ng_lo,
            a_hi=na_hi, f_hi=nf_hi, dg_hi=ndg_hi, a=a_next,
            acc_a=torch.where(accept, a, c["acc_a"]),
            acc_f=torch.where(accept, fa, c["acc_f"]),
            acc_g=_sel(accept, ga, c["acc_g"]),
            bx=bx, bf=bf, bg=bg, baux=baux,
        )
        c = {key: _sel(pred, new[key], c[key]) for key in c}

    done = c["done"]
    acc_a = torch.where(done, c["acc_a"], c["a_lo"])
    acc_f = torch.where(done, c["acc_f"], c["f_lo"])
    acc_g = _sel(done, c["acc_g"], c["g_lo"])
    search.end(trials=trials)
    return (acc_a, acc_f, acc_g, c["was_acc"], c["bx"], c["bf"], c["bg"],
            c["baux"], c["k"])


def _two_loop(g, S, Y, rho, pos, count, m: int, dot=_dot):
    """L-BFGS two-loop recursion over each lane's circular memory; masked
    for a partially filled memory; newest-pair gamma scaling."""
    lanes = torch.arange(g.shape[0], device=g.device)
    idx = [(pos - 1 - j) % m for j in range(m)]  # newest -> oldest
    q = g
    als = []
    for j, kj in enumerate(idx):
        valid = j < count
        al = torch.where(valid, rho[lanes, kj] * dot(S[lanes, kj], q),
                         torch.zeros_like(q[:, 0]))
        q = q - al[:, None] * Y[lanes, kj]
        als.append(al)
    newest = (pos - 1) % m
    sy = dot(S[lanes, newest], Y[lanes, newest])
    yy = dot(Y[lanes, newest], Y[lanes, newest])
    gamma = torch.where(count > 0, sy / torch.clamp_min(yy, 1e-30),
                        torch.ones_like(sy))
    r = gamma[:, None] * q
    for j in reversed(range(m)):
        kj = idx[j]
        valid = j < count
        beta = torch.where(valid, rho[lanes, kj] * dot(Y[lanes, kj], r),
                           torch.zeros_like(r[:, 0]))
        r = r + (als[j] - beta)[:, None] * S[lanes, kj]
    return -r


def lbfgs_optimize(
    lossfn: Callable,
    p0,
    nmax: int = 10,
    inner: int = 20,
    tol: float = 1e-3,
    errthresh: float = 1e8,
    memory_size: int = 20,
    max_linesearch_steps: int = 25,
    alpha0=None,
    alpha_qn0=None,
    has_aux: bool = False,
    memory0: LBFGSMemory | None = None,
    value0=None,
    grad0=None,
    aux0=None,
    stall0=None,
    group=None,
) -> LBFGSResult:
    """Minimize ``lossfn(params)`` per lane, starting from ``p0`` (K, ...).

    ``alpha0``: warm-start step sizes for the first line search (None, a
    non-positive or non-finite entry falls back to the internal
    min(1, 1/||g0||) seed).  ``memory0``: curvature memory of a previous call,
    whose size (pairs a lane) overrides ``memory_size``.
    ``value0``/``grad0`` (both or neither, with ``aux0`` under ``has_aux``):
    loss and gradient AT ``p0`` on the IDENTICAL objective; skips the entry
    evaluation.  ``stall0``: lanes frozen by a previous call on the same
    objective make no evaluation.  ``group``: p0 is this rank's shard and
    the reductions are the group's (module docstring); the memory holds the
    shard's (s, y) pairs.
    """
    if (value0 is None) != (grad0 is None):
        raise ValueError("value0 and grad0 must be given together")
    if value0 is not None and has_aux and aux0 is None:
        raise ValueError("aux0 is required with value0/grad0 when has_aux")
    call = profiling.span("lbfgs.optimize")
    shape = p0.shape
    kk = shape[0]
    x0 = p0.detach().reshape(kk, -1)
    n = x0.shape[1]
    # a carried memory keeps its own size
    m = int(memory_size) if memory0 is None else int(memory0.S.shape[1])
    dev = x0.device
    if group is None:
        dot, inf_norm, n_all = _dot, (lambda t: t.abs().amax(-1)), n
    else:
        from difficp_torch.parallel.launch import all_reduce

        def dot(a, b):
            return all_reduce(_dot(a, b), group)

        def inf_norm(t):
            return all_reduce(t.abs().amax(-1), group, "max")

        n_all = int(all_reduce(torch.tensor(float(n), device=dev), group))
    vg = _value_and_grad(lossfn, shape, has_aux)
    errthresh = torch.tensor(errthresh, dtype=x0.dtype, device=dev)

    entry = profiling.OFF
    if value0 is not None:
        f0 = torch.as_tensor(value0, device=dev).detach()
        g0 = grad0.detach().reshape(kk, n)
        baux0 = aux0 if has_aux else ()
    else:
        # ends at the first read that waits on it, the outer loop's condition
        entry = profiling.span("lbfgs.entry")
        f0, baux0, g0 = vg(x0)
    fd = f0.dtype
    g0c = torch.where(torch.isfinite(g0), g0, torch.zeros_like(g0))
    gnorm = torch.sqrt(dot(g0c, g0c))
    seed = torch.minimum(torch.ones_like(gnorm), 1.0 / torch.clamp_min(gnorm, 1e-12))
    seed = torch.where(torch.isfinite(seed), seed, torch.ones_like(seed)).float()
    a0v = _scal(alpha0, kk, torch.float32, dev, 0.0)
    warm_ok = (a0v > _ALPHA_DEGENERATE) & torch.isfinite(a0v)
    alpha_h = torch.where(warm_ok, a0v, seed)
    aqn0v = _scal(alpha_qn0, kk, torch.float32, dev, 1.0)
    aqn0v = torch.where(torch.isfinite(aqn0v) & (aqn0v > _ALPHA_DEGENERATE),
                        torch.clamp_max(aqn0v, 1.0), torch.ones_like(aqn0v))
    best_f0 = torch.where(torch.isfinite(f0), f0, torch.full_like(f0, torch.inf))

    if memory0 is None:
        memory0 = zero_memory(kk, n, m, x0.dtype, dev)
    S, Y, rho = memory0.S, memory0.Y, memory0.rho.to(fd)
    pos, count = memory0.pos.long(), memory0.count.long()
    count0 = count
    lanes = torch.arange(kk, device=dev)

    stall_v = _scal(stall0, kk, torch.bool, dev, False)
    ls_steps = int(max_linesearch_steps)

    def inner_step(c, active):
        g_clean = torch.where(torch.isfinite(c["gx"]), c["gx"],
                              torch.zeros_like(c["gx"]))
        d = _two_loop(g_clean, c["S"], c["Y"], c["rho"], c["pos"], c["count"], m, dot)
        dg = dot(g_clean, d)
        # non-descent quasi-Newton direction: steepest descent
        d = torch.where(_lane(dg < 0, d), d, -g_clean)
        # a frozen lane searches nothing (zero direction = no descent)
        d = torch.where(_lane(active & c["act"], d), d, torch.zeros_like(d))
        a1 = torch.where(c["count"] == 0, alpha_h.to(fd), c["aqn"].to(fd))
        acc_a, acc_f, acc_g, acc_ok, bx, bf, bg, baux, ls_k = _linesearch(
            vg, ls_steps, errthresh, c["x"], c["fx"], c["gx"], d, a1,
            c["bx"], c["bf"], c["bg"], c["baux"], dot)
        fx, gx, aqn = c["fx"], c["gx"], c["aqn"]
        # only true strong-Wolfe accepts with real relative progress move the
        # adaptive trial scale; /256 per-update shrink clamp
        progress = (fx - acc_f) > 1e-9 * fx.abs()
        taken_ok = (acc_a > _ALPHA_DEGENERATE) & acc_ok & progress
        aqn = torch.where(
            taken_ok,
            torch.minimum(torch.maximum(8.0 * acc_a.float(), aqn / 256.0),
                          torch.ones_like(aqn)),
            aqn)
        s = acc_a[:, None] * d
        y = acc_g - gx
        sy = dot(s, y)
        sn = torch.sqrt(dot(s, s))
        yn = torch.sqrt(dot(y, y))
        good = ((acc_a > _ALPHA_DEGENERATE) & torch.isfinite(sy)
                & (sy > 1e-10 * torch.clamp_min(sn * yn, 1e-30)))
        rho_new = 1.0 / torch.clamp_min(sy, 1e-30)
        pos_ = c["pos"]
        S_new, Y_new, rho_set = c["S"].clone(), c["Y"].clone(), c["rho"].clone()
        S_new[lanes, pos_] = s
        Y_new[lanes, pos_] = y
        rho_set[lanes, pos_] = rho_new
        S_ = _sel(good, S_new, c["S"])
        Y_ = _sel(good, Y_new, c["Y"])
        rho_ = _sel(good, rho_set, c["rho"])
        npos = torch.where(good, (pos_ + 1) % m, pos_)
        ncount = torch.where(good, torch.clamp_max(c["count"] + 1, m), c["count"])
        # first TRULY accepted steepest-descent step: the next call's seed
        a_first = torch.where(
            (c["a_first"] <= 0) & acc_ok & (c["count"] == 0)
            & (acc_a > _ALPHA_DEGENERATE),
            acc_a.float(), c["a_first"])
        # torch inner stopping rule (LBFGS defaults, reference optim.py:27)
        df = fx - acc_f
        step_inf = inf_norm(s)
        g_inf = inf_norm(acc_g)
        stopped = (((df <= _TOL_CHANGE) & (step_inf <= _TOL_CHANGE))
                   | (g_inf <= _TOL_GRAD))
        return dict(c, x=c["x"] + s, fx=acc_f, gx=acc_g, S=S_, Y=Y_, rho=rho_,
                    pos=npos, count=ncount, bx=bx, bf=bf, bg=bg, baux=baux,
                    a_first=a_first, act=c["act"] & ~stopped,
                    nev=c["nev"] + ls_k, aqn=aqn,
                    ever_step=c["ever_step"] | (acc_a > _ALPHA_DEGENERATE))

    def outer_cond(c):
        keep = (c["i"] < nmax) & (c["change"] > tol * torch.clamp_min(c["ref"], 1e-30))
        return ((c["i"] == 0) & ~stall_v) | keep

    c = dict(
        i=torch.zeros((kk,), dtype=torch.long, device=dev),
        x=x0, fx=f0, gx=g0, S=S, Y=Y, rho=rho, pos=pos, count=count,
        bx=x0, bf=best_f0, bg=g0, baux=baux0,
        a_first=torch.zeros((kk,), dtype=torch.float32, device=dev),
        change=torch.where(stall_v, 0.0, torch.inf).float(),
        ref=torch.ones((kk,), dtype=torch.float32, device=dev),
        nev=torch.zeros((kk,), dtype=torch.long, device=dev),
        aqn=aqn0v,
        ever_step=torch.zeros((kk,), dtype=torch.bool, device=dev),
    )
    while True:
        active = outer_cond(c)
        more = bool(active.any())
        entry.end()
        if not more:
            break
        prev = c["x"]
        b = dict(c, act=active)
        for _ in range(inner):
            b = inner_step(b, active)
        dx = b["x"] - prev
        b["change"] = torch.sqrt(dot(dx, dx) / max(n_all, 1)).float()
        b["ref"] = torch.sqrt(dot(prev, prev) / max(n_all, 1)).float()
        b["i"] = c["i"] + 1
        c = {key: _sel(active, b[key], c[key]) for key in c}

    i, change, ref = c["i"], c["change"], c["ref"]
    # stalled-out: only lanes whose last outer step moved at f32-noise level
    # AND that carried warm evidence into this call
    warm_evidence = warm_ok | (count0 > 0)
    stalled_out = stall_v | ((change <= 1e-8 * torch.clamp_min(ref, 1e-30))
                             & warm_evidence)
    # warm start of the next call: the first truly accepted step, inside an
    # asymmetric trust window around this call's seed
    prev_seed = torch.where(torch.isfinite(alpha_h) & (alpha_h > 0.0), alpha_h,
                            torch.ones_like(alpha_h))
    a_first = c["a_first"]
    ok = torch.isfinite(a_first) & (a_first > _ALPHA_DEGENERATE)
    alpha = torch.where(ok, _clip(a_first, prev_seed / 4096.0, prev_seed * 16.0),
                        prev_seed)
    # cold-seed bootstrap: a cold lane that took no step anywhere passes the
    # floor of the probed range as its next seed
    probe_floor = float(10.0 ** -(ls_steps - 1))
    cold = ~warm_evidence & ~stall_v
    alpha = torch.where(~c["ever_step"] & (i > 0) & cold,
                        torch.clamp_min(prev_seed * probe_floor, 1e-20), alpha)
    call.end()
    return LBFGSResult(
        params=c["bx"].reshape(shape), loss=c["bf"], n_steps=i, change=change,
        alpha=alpha, alpha_qn=c["aqn"], aux=c["baux"] if has_aux else None,
        n_evals=c["nev"],
        memory=LBFGSMemory(S=c["S"], Y=c["Y"], rho=c["rho"], pos=c["pos"],
                           count=c["count"]),
        grad=c["bg"].reshape(shape), stalled=stalled_out)
