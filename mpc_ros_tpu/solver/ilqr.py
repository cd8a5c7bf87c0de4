"""Control-limited iLQR / SQP solver — the CppAD+Ipopt replacement.

Solves the reference NLP (/root/reference/mpc_ros/src/mpc_planner.cpp:265-402)
in condensed (single-shooting) form: states are eliminated through the
dynamics, so the decision variables are the T = N-1 controls, and the box
bounds on (omega, accel) are handled exactly by a control-limited Riccati
backward pass (per-stage 2-dim box QP solved by active-set enumeration).
Stationary points coincide with the full NLP's KKT points, which is what the
oracle-matching tests assert.

Design notes:
* one `lax.scan` per backward/forward pass (static shapes, compiles once),
* analytic linearization + exact quadratic cost expansion (no per-iteration
  autodiff graphs) — batched (T, 8, 8) linear algebra that XLA fuses and that
  the batched lane path mirrors in its whole-solve kernel,
* fixed iteration caps with convergence masks (`lax.while_loop`) so the whole
  solve jits and `vmap`s over scenario batches,
* dtype-polymorphic: f32 on the accelerator, f64 under the CPU oracle tests.

The reference cold-starts every cycle and re-tapes its AD graph per solve
(quirk Q9); here the compiled program is reused and `u_init` enables
warm starting (shift of the previous solution) as an explicit improvement.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..config import MPCParams, SolverConfig
from ..models import diff_drive as dd
from ..models.base import Model, get_model
from ..models.costs import total_cost, stage_expansion_aug
from ..models.obstacles import ObstacleMap, obstacle_cost, obstacle_grad_xy
from .boxqp import solve_boxqp_2d
from .types import SolveResult

_S = dd.AUG_STATE_DIM   # 8
_M = dd.CONTROL_DIM     # 2


def _rollout_aug(z0, us, coeffs, dt, sign, mdl: Model, p: MPCParams):
    """Augmented-state rollout: returns ss (T+1, 8) with s = (z, prev_u)."""
    s0 = jnp.concatenate([z0, jnp.zeros((_M,), z0.dtype)])

    def body(s, u):
        s_next = mdl.aug_step(s, u, coeffs, dt, sign, p)
        return s_next, s_next

    _, ss = jax.lax.scan(body, s0, us)
    return jnp.concatenate([s0[None], ss], axis=0)


def _linearize_and_expand(ss, us, coeffs, p: MPCParams, dt, sign,
                          mdl: Model, omap=None, blobs=None, refs=None):
    """Per-stage Jacobians and exact cost quadratics along a trajectory.

    With an ObstacleMap, the costmap penalty's analytic (x, y) gradient
    AND the PSD second-difference curvature enter l_s / l_ss (same terms
    as the lane path). With GaussianObstacles (leaves (K,)), the exact
    gradient AND the PSD Gauss-Newton curvature enter l_s / l_ss."""
    T = us.shape[0]
    rate_on = jnp.concatenate(
        [jnp.zeros((1,), ss.dtype), jnp.ones((T - 1,), ss.dtype)]
    )
    A, B = jax.vmap(
        lambda s, u: mdl.aug_step_jacobians(s, u, coeffs, dt, sign, p)
    )(ss[:-1], us)
    if refs is None:
        l_s, l_u, l_ss, l_uu, l_us = jax.vmap(
            lambda s, u, r: stage_expansion_aug(s, u, r, p)
        )(ss[:-1], us, rate_on)
    else:
        l_s, l_u, l_ss, l_uu, l_us = jax.vmap(
            lambda s, u, r, rr: stage_expansion_aug(s, u, r, p, rr)
        )(ss[:-1], us, rate_on, refs[:-1])
    if omap is not None:
        from ..models.obstacles import obstacle_curv_xy

        g = obstacle_grad_xy(omap, ss[:-1, :2])              # (T, 2)
        l_s = l_s.at[:, 0:2].add(g)
        # PSD second-difference curvature — same term as the lane path
        # (bilinear pure second derivatives are zero; without stiffness
        # hard scenarios die in rejected-step spirals, see obstacle_curv_bl)
        hxx, hyy = obstacle_curv_xy(omap, ss[:-1, :2])
        l_ss = l_ss.at[:, 0, 0].add(hxx).at[:, 1, 1].add(hyy)
    if blobs is not None:
        from ..models.obstacles import blob_terms_bl

        _, gx, gy, hxx, hxy, hyy = blob_terms_bl(
            blobs.cx, blobs.cy, blobs.gamma, blobs.w, ss[:-1, 0], ss[:-1, 1])
        l_s = l_s.at[:, 0].add(gx).at[:, 1].add(gy)
        l_ss = (l_ss.at[:, 0, 0].add(hxx).at[:, 0, 1].add(hxy)
                .at[:, 1, 0].add(hxy).at[:, 1, 1].add(hyy))
    return A, B, l_s, l_u, l_ss, l_uu, l_us


def _terminal_expansion(s_T, p: MPCParams, omap=None, blobs=None,
                        ref3_T=None):
    """Gradient/Hessian of the terminal tracking cost (exact, closed form;
    plus the terminal knot's obstacle gradient when an ObstacleMap is set).
    `ref3_T` (3,) = the last knot's (ref_cte, ref_etheta, ref_vel) row.
    """
    dtype = s_T.dtype
    from ..models.costs import ref_state_vector, state_weights

    wz6, ref6 = state_weights(p, dtype)
    if ref3_T is not None:
        ref6 = ref_state_vector(p, dtype, ref3_T)
    # padded to the augmented state (prev-control rows carry no terminal
    # weight)
    wz = jnp.zeros((_S,), dtype).at[: dd.STATE_DIM].set(wz6)
    ref = jnp.zeros((_S,), dtype).at[: dd.STATE_DIM].set(ref6)
    V_s = 2.0 * wz * (s_T - ref)
    V_ss = jnp.diag(2.0 * wz)
    if omap is not None:
        from ..models.obstacles import obstacle_curv_xy

        V_s = V_s.at[0:2].add(obstacle_grad_xy(omap, s_T[:2]))
        hxxT, hyyT = obstacle_curv_xy(omap, s_T[:2])
        V_ss = V_ss.at[0, 0].add(hxxT).at[1, 1].add(hyyT)
    if blobs is not None:
        from ..models.obstacles import blob_terms_bl

        _, gx, gy, hxx, hxy, hyy = blob_terms_bl(
            blobs.cx, blobs.cy, blobs.gamma, blobs.w, s_T[0], s_T[1])
        V_s = V_s.at[0].add(gx).at[1].add(gy)
        V_ss = (V_ss.at[0, 0].add(hxx).at[0, 1].add(hxy)
                .at[1, 0].add(hxy).at[1, 1].add(hyy))
    return V_s, V_ss


def step_hessians(ss, us, coeffs, dt, sign, mdl: Model, p: MPCParams):
    """Exact per-stage dynamics Hessians d2f_k/d(s,u)2 via JAX autodiff:
    (T, 8, 10, 10). Generic over the model registry — any family defined
    by `model_from_step` gets exact second-order terms for free (JAX
    tracing replaces CppAD's tape at second order too; the lane/megakernel
    paths hand-derive the same entries for their two families)."""

    def h(s_t, u_t):
        su = jnp.concatenate([s_t, u_t])
        f = lambda q: mdl.aug_step(q[:_S], q[_S:], coeffs, dt, sign, p)
        return jax.jacfwd(jax.jacfwd(f))(su)

    return jax.vmap(h)(ss[:-1], us)


def backward_pass(A, B, l_s, l_u, l_ss, l_uu, l_us, V_s, V_ss,
                  us, lb, ub, mu, H=None, ddp_gate_val=None,
                  inv_scale=None):
    """Control-limited Riccati recursion (sequential `lax.scan`, reverse).

    `H` (T, 8, 10, 10) = exact dynamics Hessians (step_hessians): when
    given, the full-DDP contraction sum_k Vs_k H_k is added to the Q
    expansion, scaled by `ddp_gate_val` (the 0/1 hybrid GN->DDP gate —
    see SolverConfig.ddp).

    Returns feedforwards k (T,2), feedbacks K (T,2,8), expected-improvement
    terms (dV1, dV2), and the max projected-gradient norm over stages.
    """
    if H is None:
        H = jnp.zeros((us.shape[0], 0, _S + _M, _S + _M), us.dtype)
    gate = (jnp.asarray(0.0, us.dtype) if ddp_gate_val is None
            else ddp_gate_val)
    # weight-scale normalization of the pg MEASUREMENT (see solve):
    # pg on Q_u / s == the c=1 problem's pg for uniform weight scalings
    iscl = (jnp.asarray(1.0, us.dtype) if inv_scale is None
            else jnp.asarray(inv_scale, us.dtype))

    def step(carry, inp):
        Vs, Vss = carry
        A_t, B_t, ls_t, lu_t, lss_t, luu_t, lus_t, u_t, H_t = inp

        Q_s = ls_t + A_t.T @ Vs
        Q_u = lu_t + B_t.T @ Vs
        Q_ss = lss_t + A_t.T @ Vss @ A_t
        Q_us = lus_t + B_t.T @ Vss @ A_t
        Q_uu = luu_t + B_t.T @ Vss @ B_t
        if H_t.shape[0]:
            D = jnp.einsum("kij,k->ij", H_t, Vs) * gate
            Q_ss = Q_ss + D[:_S, :_S]
            Q_us = Q_us + D[_S:, :_S]
            Q_uu = Q_uu + D[_S:, _S:]
        Q_uu = 0.5 * (Q_uu + Q_uu.T)
        Q_uu_reg = Q_uu + mu * jnp.eye(_M, dtype=A_t.dtype)

        lbd = lb - u_t
        ubd = ub - u_t
        k, free, Minv = solve_boxqp_2d(Q_uu_reg, Q_u, lbd, ubd)
        K = Minv @ (-(free[:, None] * Q_us))

        Vs_new = Q_s + K.T @ Q_uu @ k + K.T @ Q_u + Q_us.T @ k
        KtQus = K.T @ Q_us
        Vss_new = Q_ss + K.T @ Q_uu @ K + KtQus + KtQus.T
        Vss_new = 0.5 * (Vss_new + Vss_new.T)

        dV1 = k @ Q_u
        dV2 = 0.5 * k @ Q_uu @ k
        # Projected gradient: zero when the KKT conditions hold on the box.
        pg = jnp.max(jnp.abs(u_t - jnp.clip(u_t - Q_u * iscl, lb, ub)))
        return (Vs_new, Vss_new), (k, K, dV1, dV2, pg)

    (_, _), (ks, Ks, dV1s, dV2s, pgs) = jax.lax.scan(
        step, (V_s, V_ss), (A, B, l_s, l_u, l_ss, l_uu, l_us, us, H),
        reverse=True
    )
    return ks, Ks, jnp.sum(dV1s), jnp.sum(dV2s), jnp.max(pgs)


def backward_pass_parallel(A, B, l_s, l_u, l_ss, l_uu, l_us, V_s, V_ss,
                           us, lb, ub, mu, n_sweeps: int = 8,
                           inv_scale=None):
    """EXACT control-limited horizon-parallel backward pass: O(log T)
    associative-scan Riccati with clamped-dimension elimination, iterated
    to an active-set fixed point (solver/riccati.parallel_gains_boxed).

    Matches the sequential control-limited pass under saturation once the
    clamp pattern stabilizes (the sweep loop exits early on a stable
    pattern — MPC-family problems pay 2-3 sweeps, n_sweeps caps it;
    equality pinned by tests/test_riccati.py::test_boxed_parallel_*). The
    one remaining divergence is inflated mu after rejected steps: the value
    recursion folds mu into l_uu (the elements need SPD R up front) while
    the sequential pass regularizes only each stage QP — an O(mu)
    difference that vanishes at the mu_init floor where convergence is
    declared. Depth O(n_sweeps log T) vs the sequential O(T); opt in for
    long horizons (SolverConfig.horizon_parallel).
    """
    from .riccati import parallel_gains_boxed

    lbd = lb[None, :] - us
    ubd = ub[None, :] - us
    ks, Ks, Q_u, Q_uu, _ = parallel_gains_boxed(
        A, B, l_s, l_u, l_ss, l_uu, l_us, V_s, V_ss, lbd, ubd, mu=mu,
        n_sweeps=n_sweeps)
    dV1 = jnp.sum(jnp.einsum("tm,tm->t", ks, Q_u))
    dV2 = 0.5 * jnp.sum(jnp.einsum("tm,tmk,tk->t", ks, Q_uu, ks))
    iscl = (jnp.asarray(1.0, us.dtype) if inv_scale is None
            else jnp.asarray(inv_scale, us.dtype))
    pg = jnp.max(jnp.abs(us - jnp.clip(us - Q_u * iscl, lb, ub)))
    return ks, Ks, dV1, dV2, pg


def forward_pass_multi_alpha(ss_bar, us_bar, ks, Ks, alphas, z0, coeffs,
                             p: MPCParams, dt, lb, ub, sign, mdl: Model,
                             omap=None, blobs=None, refs=None):
    """Closed-loop rollouts for ALL candidate step sizes in ONE scan.

    A sequential backtracking line search costs up-to-`ls_iters` rollout
    scans, and under `vmap` the whole batch pays the max trip count of any
    lane. Evaluating the K alphas simultaneously (carry (K, 8)) keeps one
    scan per SQP iteration: K times the FLOPs — which the device has to spare —
    for 1/K-th the sequential steps.

    Returns ss (K, T+1, 8), us (K, T, 2), costs (K,).
    """
    K_ls = alphas.shape[0]
    s0 = jnp.concatenate([z0, jnp.zeros((_M,), z0.dtype)])
    s0_all = jnp.broadcast_to(s0, (K_ls, _S))

    def body(s_all, inp):
        s_b, u_b, k, Kg = inp
        u_all = u_b + alphas[:, None] * k + (s_all - s_b) @ Kg.T
        u_all = jnp.clip(u_all, lb, ub)
        s_next = mdl.aug_step(s_all, u_all, coeffs, dt, sign, p)
        return s_next, (s_next, u_all)

    _, (ss_tail, us_new) = jax.lax.scan(body, s0_all, (ss_bar[:-1], us_bar, ks, Ks))
    ss_new = jnp.concatenate([s0_all[None], ss_tail], axis=0)   # (T+1, K, 8)
    ss_new = jnp.swapaxes(ss_new, 0, 1)                          # (K, T+1, 8)
    us_new = jnp.swapaxes(us_new, 0, 1)                          # (K, T, 2)
    costs = jax.vmap(lambda zs, us: _traj_cost(zs, us, p, omap, blobs, refs))(
        ss_new[:, :, : dd.STATE_DIM], us_new
    )
    return ss_new, us_new, costs


def _traj_cost(zs, us, p: MPCParams, omap=None, blobs=None, refs=None):
    """FG_eval objective + (optional) obstacle penalties over all knots."""
    J = total_cost(zs, us, p, refs)
    if omap is not None:
        J = J + obstacle_cost(omap, zs[:, :2])
    if blobs is not None:
        from ..models.obstacles import blob_cost

        J = J + blob_cost(blobs, zs[:, :2])
    return J


def solve(z0: jnp.ndarray, coeffs: jnp.ndarray, p: MPCParams,
          cfg: SolverConfig, u_init: Optional[jnp.ndarray] = None,
          omap: Optional[ObstacleMap] = None, blobs=None,
          refs: Optional[jnp.ndarray] = None) -> SolveResult:
    """Solve one NMPC problem. z0: (6,), coeffs: (poly_order+1,).

    `omap` adds a grid-costmap obstacle penalty over the predicted horizon;
    `blobs` (GaussianObstacles, leaves (K,)) the parametric equivalent
    (absent from the reference NLP; see models/obstacles.py).

    `refs` (N, 3) upgrades the scalar (ref_cte, ref_etheta, ref_vel)
    setpoints to per-knot profiles — the time-indexed objective behind
    direct trajectory tracking and per-stage speed scheduling (the
    reference keeps them constant over the horizon,
    /root/reference/mpc_ros/src/mpc_planner.cpp:122-130). None = the
    scalar FG_eval objective, bit-for-bit.

    Cold start (u_init=None) rolls the plant under zero controls — the
    feasible analog of the reference's zero initialization
    (/root/reference/mpc_ros/src/mpc_planner.cpp:288-300).
    """
    dtype = z0.dtype
    T = cfg.n_controls
    dt = jnp.asarray(p.dt, dtype)
    mdl = get_model(cfg.model)
    lb, ub = mdl.control_bounds(p, dtype)

    if u_init is None:
        us0 = jnp.zeros((T, _M), dtype)
    else:
        us0 = jnp.clip(jnp.asarray(u_init, dtype), lb, ub)
    if cfg.ddp != "auto" and bool(cfg.ddp) and cfg.horizon_parallel:
        # the associative-scan elements need SPD stage quadratics up front, so
        # the gated DDP contraction is sequential-path only — silently
        # running GN would let users attribute GN behavior to ddp
        # (ddp="auto" resolves to GN here instead of raising)
        raise ValueError(
            "SolverConfig.ddp is not supported with horizon_parallel "
            "(the scan elements need SPD stage quadratics); pick one")
    use_ddp = cfg.ddp_for(dtype)
    n_ls = cfg.ls_for(dtype)
    sign = cfg.cte_vsin_sign
    if refs is not None:
        refs = jnp.asarray(refs, dtype)
    ss0 = _rollout_aug(z0, us0, coeffs, dt, sign, mdl, p)
    cost0 = _traj_cost(ss0[:, : dd.STATE_DIM], us0, p, omap, blobs, refs)

    tol_grad = jnp.asarray(cfg.tol_grad_for(dtype), dtype)
    # relative cost tolerance can't be tighter than the dtype resolves
    tol_cost = jnp.asarray(
        max(cfg.tol_cost, 10.0 * float(jnp.finfo(dtype).eps)), dtype
    )
    # one-sided weight-scale equivariance (SolverConfig.scale_adaptive):
    # mu lives in COST units -> floor and ceiling scale with s; the
    # projected gradient's clipped plateau lives in CONTROL units, so
    # instead of scaling its thresholds (which would re-enter the plateau
    # and mis-engage the DDP gate) the MEASUREMENT is normalized — pg is
    # computed on Q_u / s, which equals the c=1 problem's Q_u exactly for
    # uniform scalings; tol_grad / ddp_gate comparisons stay in c=1 units
    # verbatim. The relative-cost guards' absolute floor scales too:
    # tol*(s+|J|) == s * tol*(1+|J1|) (a plain 1+|J| breaks exactness on
    # lanes whose costs are O(1)). One resolution shared by all engines:
    # models/costs.scaled_solver_knobs.
    from ..models.costs import scaled_solver_knobs

    mu_min, mu_max, inv_scl, cost_guard = scaled_solver_knobs(
        cfg, p, dtype, has_obstacles=blobs is not None,
        has_omaps=omap is not None)
    mu_factor = jnp.asarray(cfg.mu_factor, dtype)

    def cond(state):
        _, _, _, mu, it, done, _, _, _ = state
        return jnp.logical_and(it < cfg.max_sqp_iters, jnp.logical_not(done))

    def body(state):
        ss, us, cost, mu, it, done, gnorm, n_small, _ = state
        A, B, l_s, l_u, l_ss, l_uu, l_us = _linearize_and_expand(
            ss, us, coeffs, p, dt, sign, mdl, omap, blobs, refs
        )
        V_s, V_ss = _terminal_expansion(
            ss[-1], p, omap, blobs, None if refs is None else refs[-1]
        )
        if cfg.horizon_parallel:
            # the associative-scan elements need SPD stage quadratics up
            # front; the gated DDP contraction is sequential-path only
            ks, Ks, dV1, dV2, pg = backward_pass_parallel(
                A, B, l_s, l_u, l_ss, l_uu, l_us, V_s, V_ss, us, lb, ub,
                mu, inv_scale=inv_scl
            )
        elif use_ddp:
            H = step_hessians(ss, us, coeffs, dt, sign, mdl, p)
            # obstacle ensembles cap the auto gate at 0.75 and restore the
            # blob Hessian's concave part — same rules as the lane/mega
            # paths (the policy lives in SolverConfig.gate_for)
            gate_val = cfg.gate_for(blobs is not None, dtype,
                                    has_omaps=omap is not None)
            g = (gnorm < jnp.asarray(gate_val, dtype)).astype(dtype)
            if blobs is not None:
                from ..models.obstacles import blob_concave_bl

                corr = blob_concave_bl(
                    blobs.cx, blobs.cy, blobs.gamma, blobs.w,
                    ss[:-1, 0], ss[:-1, 1]) * g
                l_ss = (l_ss.at[:, 0, 0].add(-corr)
                        .at[:, 1, 1].add(-corr))
                corrT = blob_concave_bl(
                    blobs.cx, blobs.cy, blobs.gamma, blobs.w,
                    ss[-1, 0], ss[-1, 1]) * g
                V_ss = V_ss.at[0, 0].add(-corrT).at[1, 1].add(-corrT)
            ks, Ks, dV1, dV2, pg = backward_pass(
                A, B, l_s, l_u, l_ss, l_uu, l_us, V_s, V_ss, us, lb, ub,
                mu, H=H, ddp_gate_val=g, inv_scale=inv_scl
            )
        else:
            ks, Ks, dV1, dV2, pg = backward_pass(
                A, B, l_s, l_u, l_ss, l_uu, l_us, V_s, V_ss, us, lb, ub,
                mu, inv_scale=inv_scl
            )
        # Expected full-step improvement -(dV1 + dV2); when the model predicts
        # no meaningful decrease we are at a (numerical) optimum — the
        # standard iLQR stop, and the one that matters in f32 where strict
        # line-search decreases drown in roundoff near convergence.
        pred_decrease = -(dV1 + dV2)
        tiny_model = pred_decrease <= tol_cost * (cost_guard + jnp.abs(cost))

        # Parallel-in-alpha line search: largest step size with a cost
        # decrease wins (identical accept rule to sequential backtracking,
        # evaluated in one rollout scan).
        alphas = jnp.asarray(0.5, dtype) ** jnp.arange(n_ls, dtype=dtype)
        ss_all, us_all, costs_all = forward_pass_multi_alpha(
            ss, us, ks, Ks, alphas, z0, coeffs, p, dt, lb, ub, sign, mdl,
            omap, blobs, refs
        )
        improved = costs_all < cost
        accepted = jnp.any(improved)
        # first (largest-alpha) improving candidate
        pick = jnp.argmin(
            jnp.where(improved, jnp.arange(n_ls), n_ls + 1)
        )
        ss_n = ss_all[pick]
        us_n = us_all[pick]
        cost_n = costs_all[pick]

        ss2 = jnp.where(accepted, ss_n, ss)
        us2 = jnp.where(accepted, us_n, us)
        cost2 = jnp.where(accepted, cost_n, cost)
        mu2 = jnp.where(accepted, jnp.maximum(mu / mu_factor, mu_min),
                        jnp.minimum(mu * mu_factor, mu_max))

        # Convergence is gradient-driven (the KKT measure); the cost-based
        # stop only fires after two consecutive negligible decreases, so a
        # single flat line search near the optimum doesn't end the solve
        # while the projected gradient is still loose.
        small_step = jnp.logical_and(
            accepted,
            jnp.abs(cost - cost2) <= tol_cost * (cost_guard + jnp.abs(cost))
        )
        n_small2 = jnp.where(small_step, n_small + 1, 0)
        # a tiny predicted decrease certifies an optimum only while the
        # trust region is essentially open; under inflated damping (mu
        # ramped by rejected steps) the Newton step is crushed and a tiny
        # prediction means STALLED, not converged — the solve still stops
        # (same done criterion), but the label stays honest. Round-4
        # refinement: that stall verdict requires the step to have been
        # REJECTED too — an ACCEPTED tiny-model step keeps iterating (each
        # acceptance decays mu toward open, so within ~2 iterations either
        # mu_open or the two-consecutive-tiny-decreases criterion fires),
        # which removes the race that let DDP endgames at a true optimum
        # stop one iteration before an honest certificate (the round-3
        # "converged iterate labeled stalled" note)
        mu_open = mu <= mu_min * mu_factor
        converged = jnp.logical_or(
            jnp.logical_or(pg < tol_grad, n_small2 >= 2),
            jnp.logical_and(tiny_model, mu_open),
        )
        stalled = jnp.logical_or(
            jnp.logical_and(jnp.logical_not(accepted), mu2 >= mu_max),
            jnp.logical_and(jnp.logical_and(tiny_model,
                                            jnp.logical_not(mu_open)),
                            jnp.logical_not(accepted)),
        )
        done2 = jnp.logical_or(converged, stalled)
        return (ss2, us2, cost2, mu2, it + 1, done2, pg, n_small2, converged)

    init = (ss0, us0, cost0, mu_min, jnp.asarray(0, jnp.int32),
            jnp.asarray(False), jnp.asarray(jnp.inf, dtype),
            jnp.asarray(0, jnp.int32), jnp.asarray(False))
    (ss_f, us_f, cost_f, mu_f, it_f, done_f, gnorm_f, _,
     conv_f) = jax.lax.while_loop(cond, body, init)
    return SolveResult(
        us=us_f,
        zs=ss_f[:, : dd.STATE_DIM],
        cost=cost_f,
        converged=conv_f,
        n_iters=it_f,
        grad_norm=gnorm_f,
        reg=mu_f,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def solve_jit(z0, coeffs, p: MPCParams, cfg: SolverConfig,
              refs=None) -> SolveResult:
    """Jitted single solve (compiled once per SolverConfig)."""
    return solve(z0, coeffs, p, cfg, refs=refs)
