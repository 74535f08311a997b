"""Bilinear pair-polynomial compiler: the gradcomponent (eta != 0) RHS
forwards and their VJPs as generic kernel-sums (counterpart of
``difficp_tpu/ops/pair_poly.py``).

Every pairwise Gaussian reduction of the fused LDDMM RHS has the form

    L = sum_ij k_ij S_ij,   k_ij = exp(-|q_i - q_j|^2 / 2 sigma^2),

where the pair density S is a polynomial in row-side quantities (q_i, p_i,
cotangents, masks) and column-side ones (q_j, p_j, ...).  Its gradients are
again such sums:

    dL/d(row var v at l) = sum_j k_lj [dS/dv - u delta S]       (q vars)
    dL/d(col var v at l) = the row form of the swapped polynomial

and any such polynomial evaluates as one generic kernel-sum: group the terms
by their column monomial (the payload table), run ``ops/ksum.py`` once, then
recombine with the row monomials.  ``BP`` is the algebra (a copy of the JAX
package's, pure Python), ``eval_polys`` the evaluation.

The recombination is one coefficient matrix per polynomial set, built once:
with A (..., n_cm, Nx) the kernel-sum table, W (n_out n_rm, n_cm) the
coefficients and R (..., n_rm, Nx) the row monomials, every output at once is
sum_rm (W A)[o, rm] R[rm] -- one product and one weighted sum, where the JAX
package issues one operation per term (650 terms in the d = 2 self
backward).  The product is a plain float32 matrix product, run in full FP32.

Monomial magnitudes: coordinates must be centered by the caller
(``ksum.mm_center``); the expansion of delta powers into raw monomials
cancels like (R / sigma)^k in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from difficp_torch.ops import ksum as _ksum

_EPS = 1e-30

# Self forward evaluations take the symmetric generic kernel-sum from this many
# points on, while the union table has at most _SYM_MAX_COLS columns (the JAX
# package's routing, pair_poly.py:47-53; on the card both are the same kernel
# over ordered pairs)
_SYM_MIN_M = 32768
_SYM_MAX_COLS = 192


class BP:
    """Bilinear-separable pair polynomial: dict {(row_mono, col_mono): c}
    with monomials as sorted tuples of variable names."""

    __slots__ = ("t",)

    def __init__(self, t=None):
        self.t = dict(t) if t else {}

    @staticmethod
    def const(c):
        return BP({((), ()): float(c)}) if c else BP()

    @staticmethod
    def rvar(name):
        return BP({((name,), ()): 1.0})

    @staticmethod
    def cvar(name):
        return BP({((), (name,)): 1.0})

    def _acc(self, key, c):
        v = self.t.get(key, 0.0) + c
        if abs(v) < _EPS:
            self.t.pop(key, None)
        else:
            self.t[key] = v

    def __add__(self, other):
        if not isinstance(other, BP):
            other = BP.const(other)
        out = BP(self.t)
        for k, c in other.t.items():
            out._acc(k, c)
        return out

    __radd__ = __add__

    def __neg__(self):
        return BP({k: -c for k, c in self.t.items()})

    def __sub__(self, other):
        return self + (-other if isinstance(other, BP) else BP.const(-other))

    def __rsub__(self, other):
        return (-self) + other

    def __mul__(self, other):
        if not isinstance(other, BP):
            return BP({k: c * float(other) for k, c in self.t.items()}
                      if other else None)
        out = BP()
        for (rm1, cm1), c1 in self.t.items():
            for (rm2, cm2), c2 in other.t.items():
                key = (tuple(sorted(rm1 + rm2)), tuple(sorted(cm1 + cm2)))
                out._acc(key, c1 * c2)
        return out

    __rmul__ = __mul__

    def swap(self):
        """Exchange row and column roles (valid under the symmetric kernel)."""
        return BP({(cm, rm): c for (rm, cm), c in self.t.items()})

    def diff(self, var, side):
        """Partial derivative wrt a row-side (side=0) or column-side (side=1)
        occurrence of ``var``."""
        out = BP()
        for (rm, cm), c in self.t.items():
            mono = rm if side == 0 else cm
            n = mono.count(var)
            if n == 0:
                continue
            reduced = list(mono)
            reduced.remove(var)
            reduced = tuple(reduced)
            key = (reduced, cm) if side == 0 else (rm, reduced)
            out._acc(key, c * n)
        return out

    def col_monomials(self):
        return {cm for (_, cm) in self.t}


def _dot_bp(a, b):
    out = BP()
    for x, y in zip(a, b):
        out = out + x * y
    return out


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

class _Plan:
    """What ``eval_polys`` needs of a polynomial set, built once: the output
    names, the column and row monomials with their product builders, and the
    coefficient matrix W (n_out n_rm, n_cm)."""

    def __init__(self, polys):
        self.names = list(polys)
        self.cms = sorted({cm for p in polys.values() for cm in p.col_monomials()})
        self.rms = sorted({rm for p in polys.values() for (rm, _) in p.t})
        self.col_vars = sorted({n for cm in self.cms for n in cm})
        self.row_vars = sorted({n for rm in self.rms for n in rm})
        ci = {n: i for i, n in enumerate(self.col_vars)}
        ri = {n: i for i, n in enumerate(self.row_vars)}
        self.col_monos = _ksum.Monomials([tuple(ci[n] for n in cm) for cm in self.cms])
        self.row_monos = _ksum.Monomials([tuple(ri[n] for n in rm) for rm in self.rms])
        cidx = {cm: i for i, cm in enumerate(self.cms)}
        ridx = {rm: i for i, rm in enumerate(self.rms)}
        w = np.zeros((len(self.names), len(self.rms), len(self.cms)))
        for o, name in enumerate(self.names):
            for (rm, cm), c in polys[name].t.items():
                w[o, ridx[rm], cidx[cm]] += c
        self.w = torch.tensor(w.reshape(-1, len(self.cms)))
        self._w_on = {}
        # the symmetric table: coordinates first, the mask (binary) once
        self.sym_ok = all("m" in cm for cm in self.cms)

    def weights(self, device, dtype):
        if (device, dtype) not in self._w_on:
            self._w_on[device, dtype] = self.w.to(device, dtype)
        return self._w_on[device, dtype]


_PLANS = {}


def _plan(polys):
    key = id(polys)
    if key not in _PLANS or _PLANS[key][0] is not polys:
        _PLANS[key] = (polys, _Plan(polys))
    return _PLANS[key][1]


def _sym_table(plan, x, col_vals, sigma):
    """The union kernel-sum table through the symmetric generic kernel-sum
    (self set: rows == cols == x).  Every column monomial must carry the
    binary mask variable m, which the kernel-sum applies once (m^k == m)."""
    d = x.shape[-1]
    coord = [f"q{e}" for e in range(d)]
    names = coord + sorted({n for cm in plan.cms for n in cm} - set(coord) - {"m"})
    row_of = {n: i for i, n in enumerate(names)}
    var_rows = [col_vals[n] for n in names] + [col_vals["m"]]
    monos = tuple(tuple(row_of[n] for n in cm if n != "m") for cm in plan.cms)
    if not plan.sym_ok:
        raise ValueError(f"sym kernel-sum column monomial without mask m: {plan.cms}")
    return _ksum.pairwise_ksum_sym(var_rows, d, len(names), monos, sigma)


def _eval(polys, x, y, row_vals, col_vals, sigma, sym=False):
    """(..., Nx, n_out) outputs of ``polys`` in their insertion order."""
    plan = _plan(polys)
    if sym:
        if x is not y:
            raise ValueError("sym=True requires a self evaluation (x is y)")
        a = _sym_table(plan, x, col_vals, sigma).transpose(-1, -2)  # (..., n_cm, Nx)
    else:
        cvals = torch.stack([col_vals[n] for n in plan.col_vars], -2)
        table = plan.col_monos(torch.ones_like(cvals[..., 0, :]), cvals)
        a = _ksum.ksum(x.contiguous(), y.contiguous(), table.contiguous(), None,
                       float(sigma))
    rvals = torch.stack([row_vals[n] for n in plan.row_vars], -2)
    r = plan.row_monos(torch.ones_like(rvals[..., 0, :]), rvals)  # (..., n_rm, Nx)
    with _ksum.full_fp32_matmul():
        wa = plan.weights(a.device, a.dtype) @ a  # (..., n_out n_rm, Nx)
    wa = wa.unflatten(-2, (len(plan.names), len(plan.rms)))
    return (wa * r.unsqueeze(-3)).sum(-2).transpose(-1, -2)


def eval_polys(polys, x, y, row_vals, col_vals, sigma, sym=False):
    """Evaluate {name: BP} as out[name][..., i] = sum_j k(x_i - y_j) P_ij.

    ``row_vals`` / ``col_vals``: {var: (..., Nx) / (..., Ny) tensor}.  One
    generic kernel-sum evaluates every polynomial at once (the union of their
    column-monomial tables), then the coefficient-matrix recombination.
    Masks must be encoded as polynomial variables.  ``sym=True`` (only when
    x is y) builds the table as the symmetric kernel-sum does."""
    out = _eval(polys, x, y, row_vals, col_vals, sigma, sym)
    return {name: out[..., i] for i, name in enumerate(_plan(polys).names)}


# ---------------------------------------------------------------------------
# fused-RHS pair densities (any eta) and their backward polynomials
# ---------------------------------------------------------------------------

def _q(e, side):
    return (BP.rvar if side == 0 else BP.cvar)(f"q{e}")


def _self_component_polys(d, u, eta):
    """The output densities of the fused self RHS, mask factors included
    (reference LDDMM.py:100-116,176-216):

      vq_i  = m_i sum_j k m_j (p_j + eta u delta)
      Gq_i  = m_i sum_j k m_j (-u (p_i.p_j) delta
                               - eta (u^2 (delta.c) delta - u c)
                               + eta^2 u^2 (d2 u - (d+2)) delta),
              c = p_i - p_j
      dc    = sum_i m_i sum_j k m_j (-u (p_i.delta) + eta u (d2 u - d))

    Returns ``(vq[d], gq[d], dc)``; the forward evaluates them, the backward
    differentiates their cotangent-weighted combination."""
    delta = [_q(e, 0) - _q(e, 1) for e in range(d)]
    d2 = _dot_bp(delta, delta)
    rp = [BP.rvar(f"p{e}") for e in range(d)]
    cp = [BP.cvar(f"p{e}") for e in range(d)]
    mm = BP.rvar("m") * BP.cvar("m")

    vq = [mm * (cp[e] + (eta * u) * delta[e]) for e in range(d)]
    pp = _dot_bp(rp, cp)
    cvec = [rp[e] - cp[e] for e in range(d)]
    gq = [
        mm * ((-u) * pp * delta[e]
              - eta * ((u * u) * _dot_bp(delta, cvec) * delta[e]
                       - u * cvec[e])
              + (eta * eta * u * u) * (u * d2 - (d + 2)) * delta[e])
        for e in range(d)
    ]
    dc = mm * ((-u) * _dot_bp(rp, delta) + (eta * u) * (u * d2 - d))
    return vq, gq, dc


def _ext_component_polys(d, u, eta):
    """Output densities of the ext cross terms: rows are data points x (their
    coordinates bound to the row q vars), columns the support (q, p);
    ``dcx`` is the x-side logdet cost with the +u (delta.p_j) sign
    (reference LDDMM.py:120-138)."""
    delta = [_q(e, 0) - _q(e, 1) for e in range(d)]
    d2 = _dot_bp(delta, delta)
    cp = [BP.cvar(f"p{e}") for e in range(d)]
    mm = BP.rvar("m") * BP.cvar("m")
    vx = [mm * (cp[e] + (eta * u) * delta[e]) for e in range(d)]
    dcx = mm * (u * _dot_bp(cp, delta) + (eta * u) * (u * d2 - d))
    return vx, dcx


def _rhs_pair_density(d, u, eta, self_pair: bool):
    """The cotangent-weighted pair density S_ij of the fused RHS,

    L = sum_i gv_i.vq_i + gg_i.(-Gq_i) + gc * dcost  ==  sum_ij k_ij S_ij,

    from the shared component densities.  ``self_pair=False`` is the ext
    cross density: gv plays the gx role and dc is the x-side cost.  Row
    vars: q, p, g (= gv), h (= gg), m, C (= gc broadcast); col vars: q, p, m."""
    rg = [BP.rvar(f"g{e}") for e in range(d)]
    rc = BP.rvar("C")
    if self_pair:
        vq, gq, dc = _self_component_polys(d, u, eta)
        rh = [BP.rvar(f"h{e}") for e in range(d)]
        return _dot_bp(rg, vq) - _dot_bp(rh, gq) + rc * dc
    vx, dcx = _ext_component_polys(d, u, eta)
    return _dot_bp(rg, vx) + rc * dcx


_POLY_CACHE = {}


def _self_fwd_polys(d, sigma, eta, withlogdet):
    key = ("selffwd", d, float(sigma), float(eta), bool(withlogdet))
    if key not in _POLY_CACHE:
        u = 1.0 / (float(sigma) ** 2)
        vq, gq, dc = _self_component_polys(d, u, float(eta))
        polys = {f"vq{e}": vq[e] for e in range(d)}
        polys.update({f"gq{e}": gq[e] for e in range(d)})
        if withlogdet:
            polys["dc"] = dc
        _POLY_CACHE[key] = polys
    return _POLY_CACHE[key]


def _use_sym(m, polys):
    ncols = len({cm for p in polys.values() for cm in p.col_monomials()})
    return m >= _SYM_MIN_M and ncols <= _SYM_MAX_COLS


def _coords(vals, q, p=None):
    d = q.shape[-1]
    for e in range(d):
        vals[f"q{e}"] = q[..., e]
        if p is not None:
            vals[f"p{e}"] = p[..., e]
    return vals


def rhs_self_fwd_poly(q, p, mask, sigma, eta, withlogdet):
    """(vq, Gq, dc) of the fused self RHS for any eta, from the same component
    densities as the backward (the caller centers q); dc per frame.  The JAX
    package's generated self forward, taken from ``rhs_self._POLY_FWD_MIN_M``
    points on (``rhs_self.eta_forward``)."""
    m, d = q.shape[-2], q.shape[-1]
    vals = _coords({"m": mask}, q, p)
    polys = _self_fwd_polys(d, sigma, eta, withlogdet)
    out = _eval(polys, q, q, vals, vals, sigma, sym=_use_sym(m, polys))
    dc = out[..., 2 * d].sum(-1) if withlogdet else q.new_zeros(q.shape[:-2])
    return out[..., :d], out[..., d:2 * d], dc


def _ext_fwd_polys(d, sigma, eta, withlogdet):
    key = ("extfwd", d, float(sigma), float(eta), bool(withlogdet))
    if key not in _POLY_CACHE:
        u = 1.0 / (float(sigma) ** 2)
        vx, dcx = _ext_component_polys(d, u, float(eta))
        polys = {f"vx{e}": vx[e] for e in range(d)}
        if withlogdet:
            polys["dcx"] = dcx
        _POLY_CACHE[key] = polys
    return _POLY_CACHE[key]


def rhs_ext_fwd_poly(q, p, x, mask_q, mask_x, sigma, eta, withlogdet):
    """(vx, dc) of the ext cross terms for any eta (the caller centers q and x
    by the same shift); dc per frame."""
    d = x.shape[-1]
    xvals = _coords({"m": mask_x}, x)
    qvals = _coords({"m": mask_q}, q, p)
    out = _eval(_ext_fwd_polys(d, sigma, eta, withlogdet), x, q, xvals, qvals, sigma)
    dc = out[..., d].sum(-1) if withlogdet else x.new_zeros(x.shape[:-2])
    return out[..., :d], dc


def _grad_polys(s, d, u, sides=("row", "col")):
    """Backward polynomials of L = sum_ij k S: outputs dq*/dp* per side.

    Row side:  dq_e = dS/drq_e - u delta_e S,  dp_e = dS/drp_e
    Col side (relabeled through the swapped polynomial so every output is a
    row-indexed kernel-sum):  dq_e += swap(dS/dcq_e) - u delta_e swap(S),
    dp_e += swap(dS/dcp_e).  Outputs in the order dq0.., dp0..
    """
    delta = [_q(e, 0) - _q(e, 1) for e in range(d)]
    dq, dp = {}, {}
    for e in range(d):
        pq = BP()
        pp_ = BP()
        if "row" in sides:
            pq = pq + s.diff(f"q{e}", 0) - u * (delta[e] * s)
            pp_ = pp_ + s.diff(f"p{e}", 0)
        if "col" in sides:
            sw = s.swap()
            pq = pq + sw.diff(f"q{e}", 0) - u * (delta[e] * sw)
            pp_ = pp_ + sw.diff(f"p{e}", 0)
        dq[f"dq{e}"] = pq
        dp[f"dp{e}"] = pp_
    return {**dq, **dp}


def _self_bwd_polys(d, sigma, eta):
    key = ("self", d, float(sigma), float(eta))
    if key not in _POLY_CACHE:
        u = 1.0 / (float(sigma) ** 2)
        s = _rhs_pair_density(d, u, float(eta), self_pair=True)
        _POLY_CACHE[key] = _grad_polys(s, d, u)
    return _POLY_CACHE[key]


def _frame_scalar(gc, like):
    """A per-frame scalar cotangent broadcast over the points of ``like``
    (..., N)."""
    gc = torch.as_tensor(gc, dtype=like.dtype, device=like.device)
    return gc[..., None].expand(like.shape) if gc.dim() else gc.expand(like.shape)


def rhs_self_bwd_poly(q, p, mask, gv, gg, gc, sigma, eta):
    """(dq, dp) of the fused self RHS for any eta, the generated backward (the
    caller centers q); gc is the per-frame cotangent of dc.  Always the
    ordered kernel-sum, as in the JAX package."""
    d = q.shape[-1]
    vals = _coords({"m": mask, "C": _frame_scalar(gc, mask)}, q, p)
    for e in range(d):
        vals[f"g{e}"] = gv[..., e]
        vals[f"h{e}"] = gg[..., e]
    out = _eval(_self_bwd_polys(d, sigma, eta), q, q, vals, vals, sigma)
    return out[..., :d], out[..., d:2 * d]


def _col_side_polys(s, d, u):
    """The column side's gradient polynomials of L = sum_ij k S, relabeled
    through the swapped density so each is a row-indexed kernel-sum with the
    column set as rows (its delta is q_col - q_row)."""
    sw = s.swap()
    delta = [_q(e, 0) - _q(e, 1) for e in range(d)]
    col = {f"dq{e}": sw.diff(f"q{e}", 0) - u * (delta[e] * sw) for e in range(d)}
    col.update({f"dp{e}": sw.diff(f"p{e}", 0) for e in range(d)})
    return col


def _ext_bwd_polys(d, sigma, eta):
    u = 1.0 / (float(sigma) ** 2)
    key = ("ext", d, float(sigma), float(eta))
    if key not in _POLY_CACHE:
        s = _rhs_pair_density(d, u, float(eta), self_pair=False)
        # rows = data points x (outputs dx); cols = support (q, p), whose
        # outputs evaluate in the reverse direction (rows = q)
        row = _grad_polys(s, d, u, sides=("row",))
        dx = {f"dx{e}": row[f"dq{e}"] for e in range(d)}
        _POLY_CACHE[key] = (dx, _col_side_polys(s, d, u))
    return _POLY_CACHE[key]


def rhs_ext_bwd_poly(q, p, x, mask_q, mask_x, gx, gc, sigma, eta):
    """(dq, dp, dx) of the ext cross terms (vx and the x-side logdet cost) for
    any eta, the generated backward (the caller centers q and x by the same
    shift): one kernel-sum with the data as rows (dx), one with the support
    as rows (dq, dp)."""
    d = x.shape[-1]
    dx_polys, dqp_polys = _ext_bwd_polys(d, sigma, eta)
    zx = mask_x.new_zeros(mask_x.shape)
    zq = mask_q.new_zeros(mask_q.shape)
    xvals = _coords({"m": mask_x, "C": _frame_scalar(gc, mask_x)}, x)
    qvals = _coords({"m": mask_q, "C": zq}, q, p)  # C is x-side
    for e in range(d):
        xvals[f"g{e}"] = gx[..., e]
        xvals[f"p{e}"] = zx  # x rows carry no p
        qvals[f"g{e}"] = zq
    dx = _eval(dx_polys, x, q, xvals, qvals, sigma)
    out = _eval(dqp_polys, q, x, qvals, xvals, sigma)
    return out[..., :d], out[..., d:2 * d], dx


# ---------------------------------------------------------------------------
# the ring's cross ops (parallel/ring.py): rows and columns are different sets
# ---------------------------------------------------------------------------

def _cross_bwd_polys(d, sigma, eta):
    """Backward polynomials of the cross fused RHS: the row outputs (dq, dp
    of the rows, which hold the cotangents gv, gg, gc) and the column outputs
    (of the rotating shard), kept apart."""
    key = ("cross", d, float(sigma), float(eta))
    if key not in _POLY_CACHE:
        u = 1.0 / (float(sigma) ** 2)
        s = _rhs_pair_density(d, u, float(eta), self_pair=True)
        _POLY_CACHE[key] = (_grad_polys(s, d, u, sides=("row",)), _col_side_polys(s, d, u))
    return _POLY_CACHE[key]


def rhs_cross_bwd_poly(qr, pr, mr, qc, pc, mc, gv, gg, gc, sigma, eta):
    """(dq_row, dp_row, dq_col, dp_col) of the cross fused RHS for any eta,
    the generated backward: one kernel-sum with the rows as rows, one with
    the columns as rows.  The caller centers both sides by one shift; gc is
    the per-frame cotangent of dc."""
    d = qr.shape[-1]
    row_polys, col_polys = _cross_bwd_polys(d, sigma, eta)
    zc = mc.new_zeros(mc.shape)
    rvals = _coords({"m": mr, "C": _frame_scalar(gc, mr)}, qr, pr)
    cvals = _coords({"m": mc, "C": zc}, qc, pc)
    for e in range(d):
        rvals[f"g{e}"] = gv[..., e]
        rvals[f"h{e}"] = gg[..., e]
        cvals[f"g{e}"] = zc
        cvals[f"h{e}"] = zc
    out_r = _eval(row_polys, qr, qc, rvals, cvals, sigma)
    out_c = _eval(col_polys, qc, qr, cvals, rvals, sigma)
    return out_r[..., :d], out_r[..., d:2 * d], out_c[..., :d], out_c[..., d:2 * d]


def _ham_density(d, u, eta):
    """Pair density of the cross Hamiltonian share (reference
    LDDMM.py:142-159):
    sum_ij k m_i m_j [1/2 (p_i.p_j) + eta u (p_i.delta) - 1/2 eta^2 u (d2 u - d)]."""
    delta = [_q(e, 0) - _q(e, 1) for e in range(d)]
    d2 = _dot_bp(delta, delta)
    rp = [BP.rvar(f"p{e}") for e in range(d)]
    cp = [BP.cvar(f"p{e}") for e in range(d)]
    s = 0.5 * _dot_bp(rp, cp)
    if eta:
        s = s + (eta * u) * _dot_bp(rp, delta)
        s = s - (0.5 * eta * eta * u) * (u * d2 - d)
    return BP.rvar("m") * BP.cvar("m") * s


def _ham_cross_polys(d, sigma, eta):
    """(row, col): the value h with the row side's gradient in one direction,
    the column side's gradient in the other."""
    key = ("hamx", d, float(sigma), float(eta))
    if key not in _POLY_CACHE:
        u = 1.0 / (float(sigma) ** 2)
        s = _ham_density(d, u, float(eta))
        row = _grad_polys(s, d, u, sides=("row",))
        row["h"] = s
        _POLY_CACHE[key] = (row, _col_side_polys(s, d, u))
    return _POLY_CACHE[key]


def _ham_value_polys(d, sigma, eta):
    key = ("hamx_value", d, float(sigma), float(eta))
    if key not in _POLY_CACHE:
        _POLY_CACHE[key] = {"h": _ham_cross_polys(d, sigma, eta)[0]["h"]}
    return _POLY_CACHE[key]


def hamiltonian_cross_poly(qr, pr, mr, qc, pc, mc, sigma, eta, grad_sides=()):
    """The cross Hamiltonian share H(rows; columns) per frame and, for each
    of "row" / "col" in ``grad_sides``, that side's gradient (dq_*, dp_*).
    The caller centers both sides by one shift."""
    d = qr.shape[-1]
    row_polys, col_polys = _ham_cross_polys(d, sigma, eta)
    rvals = _coords({"m": mr}, qr, pr)
    cvals = _coords({"m": mc}, qc, pc)
    want = row_polys if "row" in grad_sides else _ham_value_polys(d, sigma, eta)
    out_r = _eval(want, qr, qc, rvals, cvals, sigma)
    names = list(want)
    res = {"h": out_r[..., names.index("h")].sum(-1)}
    if "row" in grad_sides:
        res["dq_row"], res["dp_row"] = out_r[..., :d], out_r[..., d:2 * d]
    if "col" in grad_sides:
        out_c = _eval(col_polys, qc, qr, cvals, rvals, sigma)
        res["dq_col"], res["dp_col"] = out_c[..., :d], out_c[..., d:2 * d]
    return res
