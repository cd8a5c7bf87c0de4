"""Lane-major batched solver — the throughput path.

The per-scenario solver (ilqr.py) keeps tensors scenario-major: a vmapped
batch stores stage matrices as (B, T, 8, 8), so every tiny (8, 8) matrix
sits in the minor dimensions and every batched operation works on 8-wide
rows.

This module re-implements the IDENTICAL algorithm with the batch as the
minor-most axis — A is (T, 8, 8, B) — so every operation is a dense
lane-parallel elementwise op or a batched small contraction over the
batch.

Same math as ilqr.solve (tested for agreement): control-limited Riccati with
exact per-stage 2-dim box QPs, parallel-in-alpha line search, per-lane
Levenberg regularization and convergence masks. On a GPU (float32, no grid
costmaps) the whole solve runs as one kernel (kernels/solve_pallas.py);
`_use_kernel` is the one place that choice is made. Costmap obstacle
solves (omaps=...) use the XLA lane paths. Per-scenario MPCParams leaves
of shape (B,) ride the lanes, including through the kernel's
packed-parameter rows — Monte-Carlo weight sweeps need no recompilation.
"""

from __future__ import annotations

import functools
import itertools
from typing import Optional

import jax
import jax.numpy as jnp

from ..config import MPCParams, SolverConfig
from .types import SolveResult

# active-set enumeration tables (see boxqp.py)
_COMBOS = list(itertools.product(range(3), repeat=2))
_NC = len(_COMBOS)

# scan unroll factor (1 = plain scan)
_UNROLL = 1


def _pl(p: MPCParams, name, dtype):
    return jnp.asarray(getattr(p, name), dtype)


# ---------------------------------------------------------------- dynamics


# Horner evaluation + derivative, batch-last: coeffs (P, B), x (..., B)
# -> (..., B), any polynomial order. One implementation shared with the
# whole-solve kernel (a duplicate here once let a cubic-only regression
# hide on one path).
from ..kernels.backward_pallas import (_polyval_tile as _polyval_bl,
                                       _polyder_tile as _polyder_bl)


def _step_bl(s, u, coeffs, dt, sign, model="diff_drive", p=None):
    """Augmented step, batch-last. s: (..., 8, B), u: (..., 2, B),
    coeffs: (P, B). Leading dims broadcast (used for the alpha axis).

    `model` is static: "diff_drive" advances theta by omega*dt; "bicycle"
    by v/lf*delta*dt (models/bicycle.py; lf is a per-lane MPCParams leaf).
    """
    x, y, th, v, cte, eth = (s[..., i, :] for i in range(6))
    w = u[..., 0, :]
    a = u[..., 1, :]
    f0 = _polyval_bl(coeffs, x)
    if model == "bicycle":
        inc = v * w * (dt / jnp.asarray(p.lf, x.dtype))
    else:
        inc = w * dt
    rows = [
        x + v * jnp.cos(th) * dt,
        y + v * jnp.sin(th) * dt,
        th + inc,
        v + a * dt,
        (f0 - y) + sign * v * jnp.sin(eth) * dt,
        eth + inc,
        w,
        a,
    ]
    return jnp.stack(rows, axis=-2)


def _state_cost_bl(s, p: MPCParams, dtype):
    """Tracking cost per lane from augmented state (..., 8, B) -> (..., B)."""
    v = s[..., 3, :]
    cte = s[..., 4, :]
    eth = s[..., 5, :]
    return (_pl(p, "w_cte", dtype) * (cte - _pl(p, "ref_cte", dtype)) ** 2
            + _pl(p, "w_etheta", dtype) * (eth - _pl(p, "ref_etheta", dtype)) ** 2
            + _pl(p, "w_vel", dtype) * (v - _pl(p, "ref_vel", dtype)) ** 2)


def _ctrl_cost_bl(u, pu, rate_on, p: MPCParams, dtype):
    """Control + rate cost: u, pu (..., 2, B); rate_on scalar mask."""
    w = u[..., 0, :]
    a = u[..., 1, :]
    dw = w - pu[..., 0, :]
    da = a - pu[..., 1, :]
    return (_pl(p, "w_angvel", dtype) * w**2 + _pl(p, "w_accel", dtype) * a**2
            + rate_on * (_pl(p, "w_angvel_d", dtype) * dw**2
                         + _pl(p, "w_accel_d", dtype) * da**2))


def _rollout_and_cost(s0, us, coeffs, dt, sign, p, dtype, T,
                      model="diff_drive"):
    """Roll (8, B) through us (T, 2, B); return ss (T+1, 8, B), cost (B,)."""

    def body(carry, inp):
        s, acc, t = carry
        u = inp
        rate_on = jnp.where(t >= 1, 1.0, 0.0).astype(dtype)
        acc = acc + _state_cost_bl(s, p, dtype) + _ctrl_cost_bl(
            u, s[6:8], rate_on, p, dtype)
        s_next = _step_bl(s, u, coeffs, dt, sign, model, p)
        return (s_next, acc, t + 1), s_next

    B = s0.shape[-1]
    init = (s0, jnp.zeros((B,), dtype), jnp.asarray(0, jnp.int32))
    (s_f, acc, _), ss_tail = jax.lax.scan(body, init, us, unroll=_UNROLL)
    cost = acc + _state_cost_bl(s_f, p, dtype)
    ss = jnp.concatenate([s0[None], ss_tail], axis=0)
    return ss, cost


def _terminal_bl(s_T, p, dtype):
    """Terminal value expansion, batch-last: V_s (8, B), V_ss (8, 8, B)."""
    B = s_T.shape[-1]
    zero = jnp.zeros((B,), dtype)
    wv = _pl(p, "w_vel", dtype)
    wc = _pl(p, "w_cte", dtype)
    we = _pl(p, "w_etheta", dtype)
    bz = lambda q: jnp.broadcast_to(q, (B,))
    V_s = jnp.stack([
        zero, zero, zero,
        2.0 * wv * (s_T[3] - _pl(p, "ref_vel", dtype)),
        2.0 * wc * (s_T[4] - _pl(p, "ref_cte", dtype)),
        2.0 * we * (s_T[5] - _pl(p, "ref_etheta", dtype)),
        zero, zero,
    ], axis=-2)
    diag = [zero, zero, zero, bz(2.0 * wv), bz(2.0 * wc), bz(2.0 * we),
            zero, zero]
    V_ss = jnp.stack(
        [jnp.stack([diag[i] if i == j else zero for j in range(8)], axis=-2)
         for i in range(8)], axis=-3)
    return V_s, V_ss


# ----------------------------------------------------------------- box QP


def _inv2_bl(M):
    """Closed-form inverse of (..., 2, 2, B) matrices."""
    a = M[..., 0, 0, :]
    b = M[..., 0, 1, :]
    c = M[..., 1, 0, :]
    d = M[..., 1, 1, :]
    det = a * d - b * c
    row0 = jnp.stack([d, -b], axis=-2)
    row1 = jnp.stack([-c, a], axis=-2)
    return jnp.stack([row0, row1], axis=-3) / det[..., None, None, :]


def _boxqp_bl(Q, q, lb, ub, Qus):
    """Exact 2-dim box QP by active-set enumeration, batch-last.

    Q (2,2,B), q (2,B), lb/ub (2,B), Qus (2,8,B) ->
    d (2,B), K (2,8,B) with zero rows for clamped dims.
    """
    dtype = Q.dtype
    B = Q.shape[-1]
    f = jnp.asarray([[1.0 if s == 0 else 0.0 for s in c] for c in _COMBOS],
                    dtype)[:, :, None]            # (9, 2, 1)
    at_lo = jnp.asarray([[1.0 if s == 1 else 0.0 for s in c] for c in _COMBOS],
                        dtype)[:, :, None]
    at_hi = jnp.asarray([[1.0 if s == 2 else 0.0 for s in c] for c in _COMBOS],
                        dtype)[:, :, None]
    d_clamp = at_lo * lb[None] + at_hi * ub[None]  # (9, 2, B)

    ff = f[:, :, None, :] * f[:, None, :, :]       # (9, 2, 2, 1)
    eye = jnp.eye(2, dtype=dtype)[None, :, :, None]
    # free rows keep Q on free cols; clamped rows become identity rows
    M = Q[None] * ff + (1.0 - f)[:, :, None, :] * eye
    Qd = jnp.einsum("ijb,cjb->cib", Q, d_clamp)
    rhs = f * (-(q[None] + Qd)) + (1.0 - f) * d_clamp
    Minv = _inv2_bl(M)                             # (9, 2, 2, B)
    d = jnp.einsum("cijb,cjb->cib", Minv, rhs)     # (9, 2, B)
    lam = q[None] + jnp.einsum("ijb,cjb->cib", Q, d)

    viol = jnp.sum(
        f * (jnp.maximum(lb[None] - d, 0.0) + jnp.maximum(d - ub[None], 0.0))
        + at_lo * jnp.maximum(-lam, 0.0) + at_hi * jnp.maximum(lam, 0.0),
        axis=-2)                                   # (9, B)
    viol = viol + 1e-12 * jnp.sum(1.0 - f, axis=-2)
    best = jnp.argmin(viol, axis=0)                # (B,)
    sel = jax.nn.one_hot(best, _NC, dtype=dtype, axis=0)  # (9, B)
    d_best = jnp.einsum("cb,cib->ib", sel, d)
    f_best = jnp.einsum("cb,cib->ib", sel, jnp.broadcast_to(f, d.shape))
    Minv_best = jnp.einsum("cb,cijb->ijb", sel, Minv)
    K = jnp.einsum("ijb,jnb->inb", Minv_best, -(f_best[:, None, :] * Qus))
    return d_best, f_best, K


# ---------------------------------------------------------------- passes


def _stage_linexp_bl(s, u, coeffs, dt, sign, rate_on, p, dtype,
                     model="diff_drive"):
    """Single-stage Jacobians + exact cost quadratics, batch-last.

    s (8, B), u (2, B) -> A (8,8,B), Bm (8,2,B), l_s (8,B), l_u (2,B),
    l_ss (8,8,B), l_uu (2,2,B), l_us (2,8,B). Used INSIDE the backward scan
    so the big (T, 8, 8, B) stage arrays are never materialized in HBM —
    each step recomputes its linearization from the 40 KB trajectory slice
    (compute is nearly free next to the saved memory traffic).
    """
    B = s.shape[-1]
    x = s[0]
    th = s[2]
    v = s[3]
    eth = s[5]
    pu = s[6:8]
    ct, st = jnp.cos(th), jnp.sin(th)
    ce, se = jnp.cos(eth), jnp.sin(eth)
    fp = _polyder_bl(coeffs, x)
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    dt_ = jnp.asarray(dt, dtype)
    bz = lambda q: jnp.broadcast_to(q, x.shape)

    def M(rows):
        return jnp.stack([jnp.stack(r, axis=-2) for r in rows], axis=-3)

    z2 = [zero, zero]
    if model == "bicycle":
        k_lf = dt_ / jnp.asarray(p.lf, dtype)     # per-lane when lf is (B,)
        dth_dv = bz(u[0] * k_lf)                  # d(theta')/dv = delta*dt/lf
        dth_du0 = bz(v * k_lf)                    # d(theta')/ddelta
    else:
        dth_dv = zero
        dth_du0 = dt_ * one
    A = M([
        [one, zero, -v * st * dt_, ct * dt_, zero, zero] + z2,
        [zero, one, v * ct * dt_, st * dt_, zero, zero] + z2,
        [zero, zero, one, dth_dv, zero, zero] + z2,
        [zero, zero, zero, one, zero, zero] + z2,
        [fp, -one, zero, sign * se * dt_, zero, sign * v * ce * dt_] + z2,
        [zero, zero, zero, dth_dv, zero, one] + z2,
        [zero] * 8,
        [zero] * 8,
    ])
    Bm = M([
        z2, z2,
        [dth_du0, zero],
        [zero, dt_ * one],
        z2,
        [dth_du0, zero],
        [one, zero],
        [zero, one],
    ])

    wv = _pl(p, "w_vel", dtype)
    wc = _pl(p, "w_cte", dtype)
    we = _pl(p, "w_etheta", dtype)
    ww = _pl(p, "w_angvel", dtype)
    wa = _pl(p, "w_accel", dtype)
    wdw = _pl(p, "w_angvel_d", dtype) * rate_on
    wda = _pl(p, "w_accel_d", dtype) * rate_on
    du = u - pu
    l_s = jnp.stack([
        zero, zero, zero,
        2.0 * wv * (v - _pl(p, "ref_vel", dtype)),
        2.0 * wc * (s[4] - _pl(p, "ref_cte", dtype)),
        2.0 * we * (eth - _pl(p, "ref_etheta", dtype)),
        bz(-2.0 * wdw * du[0]),
        bz(-2.0 * wda * du[1]),
    ], axis=-2)
    l_u = jnp.stack([
        bz(2.0 * ww * u[0] + 2.0 * wdw * du[0]),
        bz(2.0 * wa * u[1] + 2.0 * wda * du[1]),
    ], axis=-2)
    diag_s = [zero, zero, zero, bz(2.0 * wv), bz(2.0 * wc), bz(2.0 * we),
              bz(2.0 * wdw), bz(2.0 * wda)]
    l_ss = M([[diag_s[i] if i == j else zero for j in range(8)]
              for i in range(8)])
    l_uu = M([
        [bz(2.0 * (ww + wdw)), zero],
        [zero, bz(2.0 * (wa + wda))],
    ])
    l_us = M([
        [zero] * 6 + [bz(-2.0 * wdw), zero],
        [zero] * 6 + [zero, bz(-2.0 * wda)],
    ])
    return A, Bm, l_s, l_u, l_ss, l_uu, l_us


def _backward_bl(ss, us, coeffs, dt, sign, p, V_s, V_ss, lb, ub, mu,
                 omaps=None, blobs=None, model="diff_drive", ddp=False,
                 ddp_mask=None, inv_scale=None):
    """Control-limited Riccati scan, batch-last. mu: (B,).

    Stage Jacobians/quadratics are materialized for all T stages up front
    (one vmapped elementwise pass — fully parallel) and the scan reads them
    as xs."""
    dtype = ss.dtype
    T = us.shape[0]
    i_scl = (jnp.asarray(1.0, dtype) if inv_scale is None
             else jnp.asarray(inv_scale, dtype))
    eye2 = jnp.eye(2, dtype=dtype)[:, :, None]
    rate = jnp.concatenate([jnp.zeros((1,), dtype), jnp.ones((T - 1,), dtype)])
    A, Bm, l_s, l_u, l_ss, l_uu, l_us = jax.vmap(
        lambda s_t, u_t, r_t: _stage_linexp_bl(
            s_t, u_t, coeffs, dt, sign, r_t, p, dtype, model)
    )(ss[:-1], us, rate)
    if omaps is not None:
        from ..models.obstacles import (obstacle_cost_grad_bl,
                                        obstacle_curv_bl)

        _, gx, gy = obstacle_cost_grad_bl(omaps, ss[:-1, 0], ss[:-1, 1])
        l_s = l_s.at[:, 0].add(gx).at[:, 1].add(gy)
        # PSD second-difference curvature: without it the grid term has
        # no stiffness (bilinear pure second derivatives are zero) and
        # hard lanes die in rejected-step spirals (see obstacle_curv_bl)
        hxx, hyy = obstacle_curv_bl(omaps, ss[:-1, 0], ss[:-1, 1])
        l_ss = l_ss.at[:, 0, 0].add(hxx).at[:, 1, 1].add(hyy)
    if blobs is not None:
        from ..models.obstacles import blob_concave_bl, blob_terms_bl

        _, gx, gy, hxx, hxy, hyy = blob_terms_bl(
            *blobs, ss[:-1, 0], ss[:-1, 1])
        if ddp and ddp_mask is not None:
            # ddp = exact Hessians, gated: add the blob penalty's concave
            # -2 g v I part (GN keeps only the PSD outer product) once the
            # lane is past the gate — it collapses the ridge-sliding tail
            # (census: obstacle max 60 -> ~22 iterations) while the gate
            # keeps the early, basin-unsettled iterations convex
            corr = blob_concave_bl(*blobs, ss[:-1, 0], ss[:-1, 1]) * ddp_mask
            hxx = hxx - corr
            hyy = hyy - corr
        l_s = l_s.at[:, 0].add(gx).at[:, 1].add(gy)
        l_ss = (l_ss.at[:, 0, 0].add(hxx).at[:, 0, 1].add(hxy)
                .at[:, 1, 0].add(hxy).at[:, 1, 1].add(hyy))

    if ddp:
        # exact second-order dynamics data per stage (SolverConfig.ddp):
        # the only nonzero d2f/ds2 entries of the FG_eval dynamics are
        # rows 0/1 (v cos/sin theta) and row 4 (f(x) and v sin(etheta))
        from ..kernels.backward_pallas import _polyder2_tile as _polyder2_bl

        th_t = ss[:-1, 2]
        dd_xs = jnp.stack([
            ss[:-1, 3],                       # v
            jnp.cos(th_t), jnp.sin(th_t),
            jnp.sin(ss[:-1, 5]), jnp.cos(ss[:-1, 5]),
            jax.vmap(lambda x: _polyder2_bl(coeffs, x))(ss[:-1, 0]),
        ], axis=1)                            # (T, 6, B)
    else:
        dd_xs = jnp.zeros((us.shape[0], 0) + ss.shape[2:], dtype)
    dt_c = jnp.asarray(dt, dtype)
    lf_c = _pl(p, "lf", dtype) if model == "bicycle" else None

    def step(carry, inp):
        Vs, Vss = carry
        A_t, B_t, ls, lu, lss, luu, lus, u_t, dd_t = inp
        Qs = ls + jnp.einsum("kib,kb->ib", A_t, Vs)
        Qu = lu + jnp.einsum("kmb,kb->mb", B_t, Vs)
        VA = jnp.einsum("kmb,mjb->kjb", Vss, A_t)
        Qss = lss + jnp.einsum("kib,kjb->ijb", A_t, VA)
        Qus = lus + jnp.einsum("kmb,kjb->mjb", B_t, VA)
        VB = jnp.einsum("kmb,mjb->kjb", Vss, B_t)
        Quu = luu + jnp.einsum("kmb,kjb->mjb", B_t, VB)
        Quu = 0.5 * (Quu + jnp.swapaxes(Quu, 0, 1))
        if ddp:
            # per-lane hybrid gate (ddp_mask in [0,1]): Gauss-Newton far
            # from the optimum, exact Hessian for the endgame — DDP terms
            # applied from a cold start make the early quadratic model
            # indefinite and burn ~6 rejected-step iterations per hard
            # lane while mu ramps (measured); gated, they only accelerate
            v_t, ct_t, st_t, se_t, ce_t, fpp_t = (dd_t[i] for i in range(6))
            g = 1.0 if ddp_mask is None else ddp_mask
            q22 = -v_t * dt_c * (Vs[0] * ct_t + Vs[1] * st_t) * g
            q23 = dt_c * (Vs[1] * ct_t - Vs[0] * st_t) * g
            q00 = Vs[4] * fpp_t * g
            q55 = -sign * dt_c * v_t * se_t * Vs[4] * g
            q35 = sign * dt_c * ce_t * Vs[4] * g
            Qss = (Qss.at[2, 2].add(q22).at[2, 3].add(q23)
                   .at[3, 2].add(q23).at[0, 0].add(q00)
                   .at[5, 5].add(q55).at[3, 5].add(q35).at[5, 3].add(q35))
            if model == "bicycle":
                # theta rows 2/5: d2(v/lf * delta * dt)/dv ddelta
                Qus = Qus.at[0, 3].add((Vs[2] + Vs[5]) * (dt_c / lf_c) * g)
        Quu_reg = Quu + mu[None, None, :] * eye2

        k, free, K = _boxqp_bl(Quu_reg, Qu, lb - u_t, ub - u_t, Qus)

        KtQuu = jnp.einsum("mib,mkb->ikb", K, Quu)
        Vs_n = (Qs + jnp.einsum("ikb,kb->ib", KtQuu, k)
                + jnp.einsum("mib,mb->ib", K, Qu)
                + jnp.einsum("mib,mb->ib", Qus, k))
        KtQus = jnp.einsum("mib,mjb->ijb", K, Qus)
        Vss_n = (Qss + jnp.einsum("ikb,kjb->ijb", KtQuu, K)
                 + KtQus + jnp.swapaxes(KtQus, 0, 1))
        Vss_n = 0.5 * (Vss_n + jnp.swapaxes(Vss_n, 0, 1))

        dV1 = jnp.einsum("mb,mb->b", k, Qu)
        dV2 = 0.5 * jnp.einsum("mb,mkb,kb->b", k, Quu, k)
        # pg on the weight-scale-NORMALIZED gradient (see batch_solve_lane:
        # Q_u / s == the c=1 problem's Q_u for uniform weight scalings)
        pg = jnp.max(jnp.abs(u_t - jnp.clip(u_t - Qu * i_scl, lb, ub)),
                     axis=0)
        return (Vs_n, Vss_n), (k, K, dV1, dV2, pg)

    (_, _), (ks, Ks, dV1s, dV2s, pgs) = jax.lax.scan(
        step, (V_s, V_ss), (A, Bm, l_s, l_u, l_ss, l_uu, l_us, us, dd_xs),
        reverse=True, unroll=_UNROLL)
    return ks, Ks, jnp.sum(dV1s, 0), jnp.sum(dV2s, 0), jnp.max(pgs, 0)


def _forward_multi_alpha_bl(ss_bar, us_bar, ks, Ks, alphas, coeffs, dt, sign,
                            lb, ub, p, dtype, model="diff_drive"):
    """All-alpha forward rollouts in one scan, batch-last.

    Carry (n_ls, 8, B); returns ss (T+1, n_ls, 8, B), us (T, n_ls, 2, B),
    costs (n_ls, B).
    """
    n_ls = alphas.shape[0]
    B = ss_bar.shape[-1]
    s0 = jnp.broadcast_to(ss_bar[0][None], (n_ls, 8, B))

    def body(carry, inp):
        s_all, acc, t = carry
        s_b, u_b, k, K = inp                       # (8,B), (2,B), (2,B), (2,8,B)
        du = jnp.einsum("mjb,ajb->amb", K, s_all - s_b[None])
        u_all = u_b[None] + alphas[:, None, None] * k[None] + du
        u_all = jnp.clip(u_all, lb[None], ub[None])
        rate_on = jnp.where(t >= 1, 1.0, 0.0).astype(dtype)
        acc = acc + _state_cost_bl(s_all, p, dtype) + _ctrl_cost_bl(
            u_all, s_all[:, 6:8], rate_on, p, dtype)
        s_next = _step_bl(s_all, u_all, coeffs, dt, sign, model, p)
        return (s_next, acc, t + 1), (s_next, u_all)

    init = (s0, jnp.zeros((n_ls, B), dtype), jnp.asarray(0, jnp.int32))
    (s_f, acc, _), (ss_tail, us_new) = jax.lax.scan(
        body, init, (ss_bar[:-1], us_bar, ks, Ks), unroll=_UNROLL)
    costs = acc + _state_cost_bl(s_f, p, dtype)
    ss_new = jnp.concatenate([s0[None], ss_tail], axis=0)
    return ss_new, us_new, costs


# ------------------------------------------------------------------ solve


def _use_kernel(cfg: SolverConfig, dtype, has_omaps: bool) -> bool:
    """The lane solver's engine choice, made here and nowhere else.

    "auto" runs the whole-solve kernel when the default backend is a GPU
    and the problem is one the kernel carries (float32, no grid costmaps),
    and the XLA lane path otherwise. "xla" always runs the XLA lane path.
    "mega" demands the kernel and raises where it cannot run: on a CPU it
    does not fall back to the Pallas interpreter (tests call
    kernels.solve_pallas with interpret=True explicitly)."""
    if cfg.backward == "xla":
        return False
    fits = dtype == jnp.float32 and not has_omaps
    on_gpu = jax.default_backend() == "gpu"
    if cfg.backward == "mega":
        if not on_gpu:
            raise ValueError(
                "backward='mega' runs the whole-solve kernel, which is "
                f"compiled for the GPU only (default backend: "
                f"{jax.default_backend()!r}); use 'auto' or 'xla'")
        if not fits:
            raise ValueError(
                "backward='mega' needs a float32 problem without grid "
                "costmaps (omaps); use 'auto' or 'xla'")
        return True
    return fits and on_gpu


@functools.partial(jax.jit, static_argnames=("cfg",))
def batch_solve_lane(z0s: jnp.ndarray, coeffs: jnp.ndarray, p: MPCParams,
                     cfg: SolverConfig,
                     u_init: Optional[jnp.ndarray] = None,
                     omaps=None, blobs=None,
                     refs: Optional[jnp.ndarray] = None) -> SolveResult:
    """Lane-major batched solve. z0s (B, 6), coeffs (B, P>=4); returns
    batch-major SolveResult identical (within fp tolerance) to
    engine.batch_solve. Per-scenario MPCParams leaves of shape (B,) are
    supported (they broadcast lane-wise).

    `omaps`: optional batched ObstacleMap (leaves with leading B) adding
    per-scenario costmap grid penalties; grid solves use the XLA paths (the
    whole-solve kernel does not sample grids).
    `blobs`: optional batched GaussianObstacles (leaves (B, K)) — the
    parametric obstacle fast path: smooth analytic gradient + Gauss-Newton
    curvature, evaluated inside the whole-solve kernel. Use
    `models.obstacles.fit_gaussians_to_map` to convert grids.

    `refs`: optional (B, n_steps, 3) per-scenario time-indexed
    (ref_cte, ref_etheta, ref_vel) setpoint profiles (trajectory-tracking
    mode; see solver.ilqr.solve). The kernel evaluates them natively;
    the XLA lane stages do not carry per-stage setpoints, so non-kernel
    configurations delegate to engine.batch_solve (identical semantics,
    vmap path)."""
    dtype = z0s.dtype
    B = z0s.shape[0]
    T = cfg.n_controls
    sign = cfg.cte_vsin_sign
    model = cfg.model
    if model not in ("diff_drive", "bicycle"):
        # the lane-major stages are hand-specialized per family; a silent
        # diff_drive fallback would solve custom families (model_from_step)
        # with the WRONG dynamics. Those run the registry-generic vmap path.
        raise ValueError(
            f"batch_solve_lane supports the lane-specialized families "
            f"('diff_drive', 'bicycle'), got {model!r}; use "
            f"engine.batch_solve for registry-defined families")
    dt = jnp.asarray(p.dt, dtype)
    zT = jnp.swapaxes(z0s, 0, 1)                   # (6, B)
    cT = jnp.swapaxes(coeffs, 0, 1)                # (P, B)
    from ..models.base import get_model

    blb, bub = get_model(model).control_bounds(p, dtype)  # (2,) or (2, B)
    lb = jnp.broadcast_to(blb if blb.ndim == 2 else blb[:, None], (2, B))
    ub = jnp.broadcast_to(bub if bub.ndim == 2 else bub[:, None], (2, B))

    s0 = jnp.concatenate([zT, jnp.zeros((2, B), dtype)], axis=0)
    if u_init is None:
        us0 = jnp.zeros((T, 2, B), dtype)
    else:
        # u_init arrives batch-major (B, T, 2) like engine.batch_solve
        us0 = jnp.clip(jnp.moveaxis(jnp.asarray(u_init, dtype), 0, -1),
                       lb[None], ub[None])
    bl = blobs.lane() if blobs is not None else None  # 4x (K, B)

    def _obs_cost_knots(ss_):
        """Total obstacle penalty over all knots; ss_ (T+1, 8, B) or with
        extra leading dims -> (..., B)."""
        from ..models.obstacles import blob_terms_bl, obstacle_cost_grad_bl

        tot = 0.0
        if omaps is not None:
            val, _, _ = obstacle_cost_grad_bl(
                omaps, ss_[..., 0, :], ss_[..., 1, :])
            tot = tot + jnp.sum(val, axis=0)
        if bl is not None:
            val = blob_terms_bl(*bl, ss_[..., 0, :], ss_[..., 1, :])[0]
            tot = tot + jnp.sum(val, axis=0)
        return tot

    use_mega = _use_kernel(cfg, dtype, omaps is not None)
    use_ddp = cfg.ddp_for(dtype)
    n_ls = cfg.ls_for(dtype)

    if refs is not None and not use_mega:
        # the XLA lane stages keep the scalar FG_eval setpoints; per-stage
        # profiles run on the registry vmap path off-kernel. Parametric
        # blobs ride the vmap too ((B, K) leaves mapped per scenario);
        # grid omaps have no per-scenario vmap form and refuse
        if omaps is not None:
            raise ValueError(
                "batch_solve_lane(refs=...) with grid omaps is not "
                "supported: neither the whole-solve kernel nor the vmap "
                "fallback carries batched grid terms")
        import dataclasses as _dc

        u_bm = None if u_init is None else jnp.asarray(u_init, dtype)
        refs_bm = jnp.asarray(refs, dtype)
        per_lane = {f.name: jnp.ndim(getattr(p, f.name)) >= 1
                    for f in _dc.fields(MPCParams)}
        if not any(per_lane.values()):
            from ..engine.batch import batch_solve

            return batch_solve(z0s, coeffs, p, cfg, u_init=u_bm,
                               refs=refs_bm, blobs=blobs)
        # per-scenario (B,)-shaped params leaves: map them through the vmap
        # (closing p over the vmap un-mapped would leak (B,) leaves into a
        # single-scenario solve and fail with an obscure trace error)
        from ..solver import ilqr

        p_axes = MPCParams(**{n: (0 if b else None)
                              for n, b in per_lane.items()})
        u_ax = None if u_bm is None else 0
        b_ax = None if blobs is None else 0
        return jax.vmap(
            lambda z, c, pp, u, r, b: ilqr.solve(z, c, pp, cfg, u_init=u,
                                                 refs=r, blobs=b),
            in_axes=(0, 0, p_axes, u_ax, 0, b_ax),
        )(z0s, coeffs, p, u_bm, refs_bm, blobs)

    if use_mega:
        # the kernel does its own rollout; return before tracing the XLA
        # rollout below (it would be dead code)
        from ..kernels.backward_pallas import pack_params
        from ..kernels.solve_pallas import solve_pallas_scheduled

        refsT = (None if refs is None
                 else jnp.moveaxis(jnp.asarray(refs, dtype), 0, -1))
        pp = pack_params(p, B, dtype)
        (ss_f, us_f, cost_f, conv_f, iters_f, gnorm_f, mu_f,
         _done_f) = solve_pallas_scheduled(
            zT, cT, pp, lb, ub, us0, cfg, dtype=dtype, blobs=bl,
            refs=refsT)
        return SolveResult(
            us=jnp.moveaxis(us_f, -1, 0),
            zs=jnp.moveaxis(ss_f[:, :6, :], -1, 0),
            cost=cost_f,
            converged=conv_f > 0.5,
            n_iters=iters_f.astype(jnp.int32),
            grad_norm=gnorm_f,
            reg=mu_f,
        )

    has_obs = omaps is not None or bl is not None
    ss0, cost0 = _rollout_and_cost(s0, us0, cT, dt, sign, p, dtype, T, model)
    if has_obs:
        cost0 = cost0 + _obs_cost_knots(ss0)

    tol_grad = jnp.asarray(cfg.tol_grad_for(dtype), dtype)
    tol_cost = jnp.asarray(
        max(cfg.tol_cost, 10.0 * float(jnp.finfo(dtype).eps)), dtype)
    # one-sided weight-scale equivariance (scalar or per-lane with
    # (B,)-shaped weight leaves) — shared resolution in
    # models/costs.scaled_solver_knobs; see the ilqr.solve comment
    from ..models.costs import scaled_solver_knobs

    mu_min, mu_max, inv_scl, cost_guard = scaled_solver_knobs(
        cfg, p, dtype, has_obstacles=bl is not None,
        has_omaps=omaps is not None)
    mu_factor = jnp.asarray(cfg.mu_factor, dtype)
    alphas = jnp.asarray(0.5, dtype) ** jnp.arange(n_ls, dtype=dtype)

    def cond(st):
        it, done = st[4], st[5]
        if cfg.done_frac >= 1.0:
            keep_going = jnp.logical_not(jnp.all(done))
        else:
            keep_going = jnp.mean(done.astype(dtype)) < cfg.done_frac
        return jnp.logical_and(it < cfg.max_sqp_iters, keep_going)


    def body(st):
        ss, us, cost, mu, it, done, gnorm, n_small, conv, iters = st
        # blob ensembles cap the auto gate at 0.75 (basin stability with
        # the exact blob curvature); the policy lives in
        # SolverConfig.gate_for so the three engines cannot drift
        gate_eff = cfg.gate_for(bl is not None, dtype,
                                has_omaps=omaps is not None)
        dmask = ((gnorm < gate_eff).astype(dtype) if use_ddp else None)
        V_s, V_ss = _terminal_bl(ss[-1], p, dtype)
        if omaps is not None:
            from ..models.obstacles import (obstacle_cost_grad_bl,
                                            obstacle_curv_bl)

            _, gxT, gyT = obstacle_cost_grad_bl(omaps, ss[-1, 0], ss[-1, 1])
            V_s = V_s.at[0].add(gxT).at[1].add(gyT)
            hxxT, hyyT = obstacle_curv_bl(omaps, ss[-1, 0], ss[-1, 1])
            V_ss = V_ss.at[0, 0].add(hxxT).at[1, 1].add(hyyT)
        if bl is not None:
            from ..models.obstacles import blob_concave_bl, blob_terms_bl

            _, gxT, gyT, hxxT, hxyT, hyyT = blob_terms_bl(
                *bl, ss[-1, 0], ss[-1, 1])
            if dmask is not None:
                corrT = blob_concave_bl(*bl, ss[-1, 0], ss[-1, 1]) * dmask
                hxxT = hxxT - corrT
                hyyT = hyyT - corrT
            V_s = V_s.at[0].add(gxT).at[1].add(gyT)
            V_ss = (V_ss.at[0, 0].add(hxxT).at[0, 1].add(hxyT)
                    .at[1, 0].add(hxyT).at[1, 1].add(hyyT))
        ks, Ks, dV1, dV2, pg = _backward_bl(
            ss, us, cT, dt, sign, p, V_s, V_ss, lb, ub, mu, omaps, bl,
            model, ddp=use_ddp, ddp_mask=dmask, inv_scale=inv_scl)

        pred_decrease = -(dV1 + dV2)
        tiny_model = pred_decrease <= tol_cost * (cost_guard + jnp.abs(cost))

        act = jnp.logical_not(done)                         # still-solving lanes
        ss_all, us_all, costs_all = _forward_multi_alpha_bl(
            ss, us, ks, Ks, alphas, cT, dt, sign, lb, ub, p, dtype,
            model)
        if has_obs:
            # ss_all (T+1, n_ls, 8, B): add per-candidate obstacle cost
            costs_all = costs_all + jax.vmap(
                _obs_cost_knots, in_axes=1, out_axes=0)(ss_all)
        improved = costs_all < cost[None]               # (n_ls, B)
        accepted = jnp.any(improved, axis=0)            # (B,)
        pick = jnp.argmin(jnp.where(
            improved, jnp.arange(n_ls)[:, None],
            n_ls + 1), axis=0)                          # (B,)
        sel = jax.nn.one_hot(pick, n_ls, dtype=dtype, axis=0)
        ss_n = jnp.einsum("ab,taib->tib", sel, ss_all)
        us_n = jnp.einsum("ab,tamb->tmb", sel, us_all)
        cost_n = jnp.einsum("ab,ab->b", sel, costs_all)
        upd_x = jnp.logical_and(act, accepted)
        ss2 = jnp.where(upd_x[None, None, :], ss_n, ss)
        us2 = jnp.where(upd_x[None, None, :], us_n, us)
        cost2 = jnp.where(upd_x, cost_n, cost)
        upd = jnp.logical_and(act, accepted)
        mu2 = jnp.where(
            upd, jnp.maximum(mu / mu_factor, mu_min),
            jnp.where(act, jnp.minimum(mu * mu_factor, mu_max), mu))

        small_step = jnp.logical_and(
            accepted,
            jnp.abs(cost - cost2) <= tol_cost * (cost_guard + jnp.abs(cost)))
        n_small2 = jnp.where(act, jnp.where(small_step, n_small + 1, 0),
                             n_small)
        # tiny predicted decrease = optimum only with the trust region
        # open; under inflated mu it is a stall only if the step was ALSO
        # rejected — accepted tiny steps keep iterating while mu decays
        # toward an honest certificate (see ilqr.py) — per lane
        mu_open = mu <= mu_min * mu_factor
        converged_now = jnp.logical_or(
            jnp.logical_or(pg < tol_grad, n_small2 >= 2),
            jnp.logical_and(tiny_model, mu_open))
        stalled = jnp.logical_or(
            jnp.logical_and(jnp.logical_not(accepted), mu2 >= mu_max),
            jnp.logical_and(jnp.logical_and(tiny_model,
                                            jnp.logical_not(mu_open)),
                            jnp.logical_not(accepted)))
        done2 = jnp.where(act, jnp.logical_or(converged_now, stalled), done)
        conv2 = jnp.where(act, converged_now, conv)
        gnorm2 = jnp.where(act, pg, gnorm)
        iters2 = iters + act.astype(jnp.int32)
        return (ss2, us2, cost2, mu2, it + 1, done2, gnorm2, n_small2, conv2,
                iters2)

    init = (ss0, us0, cost0,
            jnp.broadcast_to(mu_min, (B,)).astype(dtype),
            jnp.asarray(0, jnp.int32),
            jnp.zeros((B,), bool),
            jnp.full((B,), jnp.inf, dtype),
            jnp.zeros((B,), jnp.int32),
            jnp.zeros((B,), bool),
            jnp.zeros((B,), jnp.int32))
    ss_f, us_f, cost_f, mu_f, _, done_f, gnorm_f, _, conv_f, iters_f = (
        jax.lax.while_loop(cond, body, init))

    return SolveResult(
        us=jnp.moveaxis(us_f, -1, 0),              # (B, T, 2)
        zs=jnp.moveaxis(ss_f[:, :6, :], -1, 0),    # (B, N, 6)
        cost=cost_f,
        converged=conv_f,
        n_iters=iters_f,
        grad_norm=gnorm_f,
        reg=mu_f,
    )
