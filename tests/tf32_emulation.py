"""The tensor-core kernels' arithmetic emulated on the CPU, for the tests of
``csrc/ksum.cu``, ``csrc/rhs_self.cu`` and ``csrc/rhs_ext.cu``: TF32
rounding, the 3xTF32 products with the tensor cores' truncating
accumulation, and the table schemes of the eta = 0 self RHS and of the ext
backward (a table centred on each block of rows in the rows' order, then
the kernels' epilogues).
"""

import numpy as np
import torch

from difficp_torch.ops import ksum as KS
from difficp_torch.ops import rhs_self as RS

# csrc/rhs_self.cu: columns a staged tile holds below kLongJMinCols columns
# (kShortJ) and from there on (kLongJ); csrc/rhs_ext.cu's (kTileCols)
RHS_SHORT_TILE, RHS_LONG_TILE, RHS_LONG_TILE_MIN_COLS = 32, 64, 8192
EXT_TILE = 64


def tf32_rna(v):
    """Round float32 to TF32 (10 mantissa bits) to nearest, ties away from
    zero, on the float32 bits through an int32 view: cvt.rna.tf32.f32."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_rz(v):
    """The TF32 value the tensor cores read from a float32 register: its top
    19 bits (truncation)."""
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def rz_float32(v):
    """float64 to float32, rounded toward zero."""
    f = v.float()
    return torch.where(f.double().abs() > v.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def ksum_3xtf32(x, y, table, my, sigma, passes=3, tile=KS.TILE_COLS, k_hi=tf32_rna):
    """The kernels' arithmetic on the CPU: k = exp2(-u log2(e) r2 / 2) in
    float32; P = m T; P = P_hi + P_lo with P_hi = rna(P), P_lo = rna(P -
    P_hi) (the prep kernel); k_hi = rna(k) and k_lo = k - k_hi, which the
    tensor cores read truncated to TF32.  Per tile of y, k-step by k-step (8
    columns), the kernel's three products in its order, k_lo P_hi, k_hi P_lo,
    k_hi P_hi: each adds the exact sum of its 8 products (TF32 by TF32 is
    exact) to the tile's accumulators and truncates the result to float32
    (toward zero), as the tensor cores accumulate; how they align the
    addends within one k-step is not modelled.  Each tile's sums are then
    added to the running totals in float32, rounded to nearest.  passes=1
    keeps k_hi P_hi alone: one TF32 product.  ``k_hi`` rounds k to its TF32
    part (tf32_rz for the ext kernels, which truncate).  Returns (..., C,
    Nx)."""
    c2 = np.float32(-0.5 / sigma ** 2 * 1.4426950408889634)
    d = x[..., :, None, :] - y[..., None, :, :]
    k = torch.exp2(c2 * (d * d).sum(-1))  # (..., Nx, Ny)
    p = (table * my[..., None, :]).transpose(-1, -2)  # (..., Ny, C)
    k_hi, p_hi = k_hi(k), tf32_rna(p)
    k_lo, p_lo = tf32_rz(k - k_hi), tf32_rna(p - p_hi)
    products = [(k_lo, p_hi), (k_hi, p_lo), (k_hi, p_hi)][3 - passes:]
    products = [(a.double(), b.double()) for a, b in products]
    acc = torch.zeros((*x.shape[:-1], table.shape[-2]), dtype=torch.float32)
    for j in range(0, y.shape[-2], tile):
        part = torch.zeros_like(acc)
        for s in range(j, min(j + tile, y.shape[-2]), 8):
            sl = slice(s, s + 8)
            for a, b in products:
                part = rz_float32(part.double() + a[..., sl] @ b[..., sl, :])
        acc = acc + part
    return acc.transpose(-1, -2)


def _column(name, y, p, a, b):
    """One payload column of the table (named as the JAX package's
    _bwd_col_table) over the columns' centred coordinates y and their p, a,
    b: (..., N)."""
    yb, yp = (y * b).sum(-1), (y * p).sum(-1)
    kind, idx = name[0], name[1:]
    terms = {
        "one": lambda: torch.ones_like(yp), "q": lambda e: y[..., e], "p": lambda f: p[..., f],
        "qp": lambda e, f: y[..., e] * p[..., f], "G": lambda f: a[..., f],
        "qG": lambda e, f: y[..., e] * a[..., f], "Hp": lambda e, f: b[..., e] * p[..., f],
        "Hqp": lambda f: yb * p[..., f], "qHp": lambda r, e, f: y[..., r] * b[..., e] * p[..., f],
        "qHqp": lambda r, f: y[..., r] * yb * p[..., f],
        "qqp": lambda r, s, f: y[..., r] * y[..., s] * p[..., f],
        "qq": lambda r, s: y[..., r] * y[..., s], "pq": lambda: yp,
        "qpq": lambda r: y[..., r] * yp}
    return terms[kind](*idx)


def table_scheme(qr, pr, mr, qc, pc, mc, sigma, order, backward=False, a=None, b=None,
                 c=0.0, withlogdet=True, rows=None, tile=None, ac=None, bc=None):
    """The eta = 0 table kernels' arithmetic in float32 for one frame: the
    rows (qr, pr, mr: (M, D), (M)) taken in ``order`` (int, (Mo,), -1 in
    padding slots) in blocks of ``rows`` slots (RS.block_rows by default);
    each block's table (RS.fwd_table, or RS.bwd_table with the
    cotangents a, b of the rows, and ac, bc of the columns, by default a and
    b: the self case) built on the columns (qc, pc, mc: (N, D), (N)) centred
    on the block's masked
    centroid; its sums by ksum_3xtf32 in tiles of ``tile`` columns (the
    kernel's by default); then the kernels' epilogues with the row's
    coordinates centred alike.  Returns (v, w, dc) or (dq, dp) per row, in
    the rows' own order."""
    d = qr.shape[-1]
    rows = RS.block_rows(qr) if rows is None else rows
    if tile is None:
        tile = RHS_LONG_TILE if qc.shape[0] >= RHS_LONG_TILE_MIN_COLS else RHS_SHORT_TILE
    names = RS.bwd_table(d) if backward else RS.fwd_table(d)
    col = {n: i for i, n in enumerate(names)}
    u = 1.0 / sigma ** 2
    nb = -(-order.shape[0] // rows)
    blk = torch.full((nb * rows,), -1, dtype=torch.long)
    blk[:order.shape[0]] = order.long()
    blk = blk.reshape(nb, rows)
    ok = blk >= 0
    i = blk.clamp_min(0)
    x_raw, m = qr[i], mr[i] * ok
    cen = (x_raw * m[..., None]).sum(1) / m.sum(1).clamp_min(1.0)[:, None]
    y = qc[None] - cen[:, None]
    ac, bc = a if ac is None else ac, b if bc is None else bc
    pcs, acs, bcs = (torch.zeros_like(pc) if t is None else t for t in (pc, ac, bc))
    pcs, acs, bcs = (t[None].expand(nb, -1, -1) for t in (pcs, acs, bcs))
    table = torch.stack([_column(n, y, pcs, acs, bcs) for n in names], -2)
    sums = ksum_3xtf32(x_raw, qc[None].expand(nb, -1, -1), table,
                       mc[None].expand(nb, -1), sigma, tile=tile)  # (nb, C, rows)

    def A(*name):
        return sums[:, col[name]]

    x = x_raw - cen[:, None]
    p = pr[i]
    if not backward:
        pap = sum(p[..., e] * A("p", e) for e in range(d))
        v = [m * A("p", f) for f in range(d)]
        w = [u * m * (x[..., f] * pap - sum(p[..., e] * A("qp", f, e) for e in range(d)))
             for f in range(d)]
        dc = -u * m * ((p * x).sum(-1) * A("one") - sum(p[..., e] * A("q", e)
                                                         for e in range(d)))
        outs = (torch.stack(v, -1), torch.stack(w, -1), dc if withlogdet else 0.0 * dc)
    else:
        al, bl = a[i], b[i]
        c = c if withlogdet else 0.0

        def pair(r, s):
            return (r, s) if r <= s else (s, r)

        dp = []
        for f in range(d):
            s = A("Hqp", f) + sum(bl[..., e] * (x[..., e] * A("p", f) - A("qp", e, f))
                                  - x[..., e] * A("Hp", e, f) for e in range(d))
            lap = x[..., f] * A("one") - A("q", f)
            dp.append(m * (A("G", f) + u * (s - c * lap)))
        xap = sum(x[..., e] * A("p", e) for e in range(d))
        dq = []
        for r in range(d):
            xr = x[..., r]
            t125 = sum(-al[..., f] * (xr * A("p", f) - A("qp", r, f))
                       - p[..., f] * (xr * A("G", f) - A("qG", r, f))
                       + p[..., f] * (bl[..., r] * A("p", f) - A("Hp", r, f)) for f in range(d))
            t3a = sum(p[..., f] * sum(bl[..., e] * (x[..., e] * (xr * A("p", f) - A("qp", r, f))
                                                    - xr * A("qp", e, f)
                                                    + A("qqp", *pair(e, r), f))
                                      for e in range(d)) for f in range(d))
            t3b = sum(p[..., f] * (A("qHqp", r, f) - xr * A("Hqp", f)
                                   + sum(x[..., e] * (xr * A("Hp", e, f) - A("qHp", r, e, f))
                                         for e in range(d))) for f in range(d))
            t4a = sum(p[..., f] * (x[..., f] * (xr * A("one") - A("q", r)) - xr * A("q", f)
                                   + A("qq", *pair(f, r))) for f in range(d))
            t4b = (xr * xap - xr * A("pq") + A("qpq", r)
                   - sum(x[..., e] * A("qp", r, e) for e in range(d)))
            t6 = -c * (p[..., r] * A("one") - A("p", r))
            dq.append(m * u * (t125 + t6 + u * (c * (t4a - t4b) - (t3a - t3b))))
        outs = (torch.stack(dq, -1), torch.stack(dp, -1))
    # back to the rows' own order
    res = []
    for o in outs:
        flat = o.reshape(nb * rows, *o.shape[2:])
        out = torch.zeros((qr.shape[0], *o.shape[2:]), dtype=torch.float32)
        out[blk.reshape(-1)[ok.reshape(-1)]] = flat[ok.reshape(-1)]
        res.append(out)
    return res


def _ext_column(name, y, v):
    """One payload column of the ext backward's tables over the columns'
    centred coordinates y and their payload v (p for dx, gx for dq/dp):
    (..., N).  Names as ``rhs_ext.dx_table`` and ``rhs_ext.dqdp_table``."""
    yv = (y * v).sum(-1)
    kind, idx = name[0], name[1:]
    terms = {
        "p": lambda e: v[..., e], "qp": lambda a, e: y[..., a] * v[..., e],
        "qdp": lambda: yv, "qqdp": lambda a: y[..., a] * yv,
        "G": lambda f: v[..., f], "xG": lambda a, f: y[..., a] * v[..., f],
        "m": lambda: torch.ones_like(yv), "mx": lambda f: y[..., f],
        "mxx": lambda a, b: y[..., a] * y[..., b]}
    return terms[kind](*idx)


def _exact_sums(xr, yc, table, my, sigma):
    """sum_j k_ij m_j T_c(j) in float64: (..., C, Nx)."""
    u = 1.0 / sigma ** 2
    d = xr.double()[..., :, None, :] - yc.double()[..., None, :, :]
    k = torch.exp(-0.5 * u * (d * d).sum(-1))
    return (k @ (table.double() * my.double()[..., None, :]).transpose(-1, -2)).transpose(-1, -2)


def ext_table_scheme(x, mx, gx, q, p, mq, gc, sigma, withlogdet, which, order, rows,
                     tile=EXT_TILE, chunk=None, exact=False, passes=3):
    """The ext backward table kernels' arithmetic for one frame (csrc/rhs_ext.cu).
    ``which`` "dx": rows the data x (N, D) with mx and gx, taken in ``order``
    (int, (No,), -1 in padding slots) in blocks of ``rows`` slots; columns the
    support (q, p, mq), table ``rhs_ext.dx_table``.  "dqdp": rows the support
    in ``order``; columns the data, cut into chunks of ``chunk`` columns
    (all of them by default), table ``rhs_ext.dqdp_table``; each chunk's
    outputs go through the epilogue apart and are summed in chunk order.
    Each block's table is built on the columns centred on the block's masked
    centroid; its sums by ksum_3xtf32 (k_hi truncated) in tiles of ``tile``
    columns, the kernel's by default, or in
    float64 throughout when ``exact`` (no TF32, no truncation: the tables
    and epilogues alone); ``passes`` as ksum_3xtf32's.  Returns (dx,) or
    (dq, dp) in the rows' own order, float32 (float64 when exact)."""
    from difficp_torch.ops import rhs_ext as RE

    d = x.shape[-1]
    u = 1.0 / sigma ** 2
    cc = float(gc) if withlogdet else 0.0
    if which == "dx":
        rq, rm, rv, cq, cv, cm = x, mx, gx, q, p, mq
        names = RE.dx_table(d)
    else:
        rq, rm, rv, cq, cv, cm = q, mq, p, x, gx, mx
        names = RE.dqdp_table(d)
    if exact:
        rq, rm, rv, cq, cv, cm = (t.double() for t in (rq, rm, rv, cq, cv, cm))
    col = {n: i for i, n in enumerate(names)}
    nb = -(-order.shape[0] // rows)
    blk = torch.full((nb * rows,), -1, dtype=torch.long)
    blk[:order.shape[0]] = order.long()
    blk = blk.reshape(nb, rows)
    ok = blk >= 0
    i = blk.clamp_min(0)
    r_raw, m = rq[i], rm[i] * ok
    cen = (r_raw * m[..., None]).sum(1) / m.sum(1).clamp_min(1.0)[:, None]
    xr, v = r_raw - cen[:, None], rv[i]
    n_cols = cq.shape[0]
    chunk = n_cols if chunk is None else chunk
    outs = None
    for lo in range(0, n_cols, chunk):
        sl = slice(lo, min(lo + chunk, n_cols))
        y = cq[None, sl] - cen[:, None]
        cvs = cv[None, sl].expand(nb, -1, -1)
        table = torch.stack([_ext_column(n, y, cvs) for n in names], -2)
        args = (r_raw, cq[None, sl].expand(nb, -1, -1), table, cm[None, sl].expand(nb, -1),
                sigma)
        sums = (_exact_sums(*args) if exact
                else ksum_3xtf32(*args, passes=passes, tile=tile, k_hi=tf32_rz))

        def A(*name):
            return sums[:, col[name]]

        if which == "dx":
            big_g = m[..., None] * v
            cl = u * cc * m
            sgp = sum(big_g[..., e] * A("p", e) for e in range(d))
            sxp = sum(xr[..., e] * A("p", e) for e in range(d))
            res = []
            for f in range(d):
                t = -u * (xr[..., f] * sgp - sum(big_g[..., e] * A("qp", f, e)
                                                  for e in range(d)))
                t = t - u * cl * (xr[..., f] * sxp - xr[..., f] * A("qdp")
                                  - sum(xr[..., e] * A("qp", f, e) for e in range(d))
                                  + A("qqdp", f))
                res.append(t + cl * A("p", f))
            part = (torch.stack(res, -1),)
        else:
            def sym(a, b):
                return (a, b) if a <= b else (b, a)

            qp = (xr * v).sum(-1)
            spx = sum(v[..., f] * A("mx", f) for f in range(d))
            dp = [m * (A("G", f) + u * cc * (A("mx", f) - xr[..., f] * A("m")))
                  for f in range(d)]
            dq = []
            for e in range(d):
                t = u * sum(v[..., f] * (A("xG", e, f) - xr[..., e] * A("G", f))
                            for f in range(d))
                t = t + u * u * cc * (sum(v[..., f] * A("mxx", *sym(e, f)) for f in range(d))
                                      - qp * A("mx", e) - xr[..., e] * spx
                                      + xr[..., e] * qp * A("m"))
                dq.append(m * (t - u * cc * v[..., e] * A("m")))
            part = (torch.stack(dq, -1), torch.stack(dp, -1))
        outs = part if outs is None else tuple(a + b for a, b in zip(outs, part))
    res = []
    for o in outs:
        flat = o.reshape(nb * rows, d)
        out = torch.zeros((rq.shape[0], d), dtype=o.dtype)
        out[blk.reshape(-1)[ok.reshape(-1)]] = flat[ok.reshape(-1)]
        res.append(out)
    return res
