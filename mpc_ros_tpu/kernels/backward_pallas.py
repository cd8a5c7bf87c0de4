"""Per-lane helpers shared by the whole-solve kernel and the XLA lane path.

Every per-scenario value is one vector over a block of lanes (the batch
axis); small state/control matrices are Python lists of such vectors, so
an 8x8-per-lane product is a handful of elementwise FMAs per lane. Each
lane owns a different matrix, so there is nothing for a matrix unit here.

Holds the packed-parameter layout (`pack_params`, `P_*` rows), Horner
evaluation of the reference polynomial and its derivatives, and the exact
9-combo 2-dim box QP.
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp

_COMBOS = list(itertools.product(range(3), repeat=2))

# packed-parameter row indices
P_WCTE, P_WETH, P_WVEL, P_WANG, P_WACC, P_WDANG, P_WDACC = range(7)
P_RVEL, P_RCTE, P_RETH, P_DT, P_LF = range(7, 12)
N_PAR = 12


def pack_params(p, B: int, dtype) -> jnp.ndarray:
    """Stack the MPCParams leaves the kernel needs into (N_PAR, B).

    Row P_LF (the bicycle wheelbase, traced/per-lane sweepable) is only
    read by the kernel's bicycle specialization."""
    rows = [p.w_cte, p.w_etheta, p.w_vel, p.w_angvel, p.w_accel,
            p.w_angvel_d, p.w_accel_d, p.ref_vel, p.ref_cte, p.ref_etheta,
            p.dt, p.lf]
    return jnp.stack([
        jnp.broadcast_to(jnp.asarray(r, dtype), (B,)) for r in rows
    ])


def _polyval_tile(c, x):
    """Horner evaluation of f(x) = sum_i c[i] x^i per lane.
    c: (P, V...) coefficient rows (an array or a list of rows), x: (V...)
    — any polynomial order (the reference's cubic is just P=4)."""
    P = len(c)
    acc = c[P - 1]
    for i in range(P - 2, -1, -1):
        acc = c[i] + x * acc
    return jnp.broadcast_to(acc, x.shape)


def _polyder_tile(c, x):
    """f'(x) for the same representation (zero for constant polys)."""
    P = len(c)
    if P == 1:
        return jnp.zeros_like(x)
    acc = (P - 1.0) * c[P - 1]
    for i in range(P - 2, 0, -1):
        acc = float(i) * c[i] + x * acc
    return jnp.broadcast_to(acc, x.shape)


def _polyder2_tile(c, x):
    """f''(x) — the cte row's exact state curvature for the DDP
    second-order backward pass (SolverConfig.ddp)."""
    P = len(c)
    if P <= 2:
        return jnp.zeros_like(x)
    acc = float((P - 1) * (P - 2)) * c[P - 1]
    for i in range(P - 2, 1, -1):
        acc = float(i * (i - 1)) * c[i] + x * acc
    return jnp.broadcast_to(acc, x.shape)


def _boxqp_tile(Quu, Qu, lbd, ubd):
    """Exact 2-dim box QP per lane on lists of per-lane vectors.

    Quu ((a, b), (c, d)), Qu (q0, q1), lbd/ubd (lo0, lo1)/(hi0, hi1) ->
    the step (k0, k1) and the selected inverse entries (j00, j01, j10,
    j11): the caller assembles the feedback rows as
    K[0] = -(j00 Qus[0] + j01 Qus[1]), K[1] = -(j10 Qus[0] + j11 Qus[1]).

    Active-set enumeration over the 9 clamp combos, specialized per combo:
    a clamped dimension collapses the masked 2x2 solve to a 1-D (or 0-D)
    closed form, so the whole enumeration needs 3 reciprocals (1/a, 1/d,
    1/det), and the feedback matrix is assembled once from the selected
    inverse entries instead of masked-accumulating K rows over all 9
    combos."""
    (a, b), (c, d) = Quu
    det = a * d - b * c
    rdet = 1.0 / det
    ra = 1.0 / a
    rd = 1.0 / d
    # both-free inverse entries
    i00, i01 = d * rdet, -b * rdet
    i10, i11 = -c * rdet, a * rdet
    targ0 = {1: lbd[0], 2: ubd[0]}
    targ1 = {1: lbd[1], 2: ubd[1]}

    def lam_viol(lam, side):
        return jnp.maximum(-lam if side == 1 else lam, 0.0)

    cand_d = []
    cand_viol = []
    for c0, c1 in _COMBOS:
        if c0 == 0 and c1 == 0:
            d0 = -(i00 * Qu[0] + i01 * Qu[1])
            d1 = -(i10 * Qu[0] + i11 * Qu[1])
            viol = (jnp.maximum(lbd[0] - d0, 0.0)
                    + jnp.maximum(d0 - ubd[0], 0.0)
                    + jnp.maximum(lbd[1] - d1, 0.0)
                    + jnp.maximum(d1 - ubd[1], 0.0))
        elif c0 == 0:                      # u1 clamped, u0 free
            d1 = targ1[c1]
            d0 = -(Qu[0] + b * d1) * ra
            lam1 = Qu[1] + c * d0 + d * d1
            viol = (jnp.maximum(lbd[0] - d0, 0.0)
                    + jnp.maximum(d0 - ubd[0], 0.0)
                    + lam_viol(lam1, c1) + 1e-12)
        elif c1 == 0:                      # u0 clamped, u1 free
            d0 = targ0[c0]
            d1 = -(Qu[1] + c * d0) * rd
            lam0 = Qu[0] + a * d0 + b * d1
            viol = (jnp.maximum(lbd[1] - d1, 0.0)
                    + jnp.maximum(d1 - ubd[1], 0.0)
                    + lam_viol(lam0, c0) + 1e-12)
        else:                              # both clamped
            d0 = targ0[c0]
            d1 = targ1[c1]
            lam0 = Qu[0] + a * d0 + b * d1
            lam1 = Qu[1] + c * d0 + d * d1
            viol = lam_viol(lam0, c0) + lam_viol(lam1, c1) + 2e-12
        cand_d.append((d0, d1))
        cand_viol.append(viol)

    best_viol = cand_viol[0]
    for v in cand_viol[1:]:
        best_viol = jnp.minimum(best_viol, v)

    # winner-take-first select via masks (ties broken by combo order);
    # select scalars (step + inverse entries), not K rows
    zeros = jnp.zeros_like(best_viol)
    picked, k0, k1 = zeros, zeros, zeros
    j00, j01, j10, j11 = zeros, zeros, zeros, zeros
    for idx, (c0, c1) in enumerate(_COMBOS):
        is_best = jnp.logical_and(cand_viol[idx] <= best_viol, picked < 0.5)
        sel = is_best.astype(zeros.dtype)
        picked = picked + sel
        d0, d1 = cand_d[idx]
        k0 = k0 + sel * d0
        k1 = k1 + sel * d1
        if c0 == 0 and c1 == 0:
            j00 = j00 + sel * i00
            j01 = j01 + sel * i01
            j10 = j10 + sel * i10
            j11 = j11 + sel * i11
        elif c0 == 0:                      # only u0 free: row0 = -Qus[0]/a
            j00 = j00 + sel * ra
        elif c1 == 0:                      # only u1 free: row1 = -Qus[1]/d
            j11 = j11 + sel * rd
    return (k0, k1), (j00, j01, j10, j11)
