"""Path-tracking NMPC cost — FG_eval-exact, with analytic quadratic expansion.

Reproduces the reference objective exactly
(/root/reference/mpc_ros/src/mpc_planner.cpp:122-147):

    J = sum_{i<N}   w_cte    (cte_i - ref_cte)^2
                  + w_etheta (etheta_i - ref_etheta)^2
                  + w_vel    (v_i - ref_vel)^2
      + sum_{i<N-1} w_angvel omega_i^2 + w_accel a_i^2
      + sum_{i<N-2} w_angvel_d (omega_{i+1}-omega_i)^2
                  + w_accel_d (a_{i+1}-a_i)^2

Because the cost is quadratic in (v, cte, etheta, u), its gradients are linear
and Hessians constant: the quadratic expansion below is EXACT (Gauss-Newton ==
full Newton for the cost part), which is what lets the SQP stack converge to
Ipopt's optimum at tight tolerance.

Stage decomposition over the augmented state s = (z, prev_u):
    stage i (i = 0..T-1):  state_cost(z_i) + control_cost(u_i)
                           + [i>=1] rate_cost(u_i - prev_u_i)
    terminal:              state_cost(z_T)
with T = N-1. Summing stages reproduces J exactly (prev_u_i == u_{i-1} by the
augmented dynamics).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import MPCParams
from .diff_drive import STATE_DIM, CONTROL_DIM, AUG_STATE_DIM, V, CTE, ETHETA


def _ref3_cols(p: MPCParams, ref3):
    """The three tracked setpoints: scalars from `p`, or per-stage rows.

    `ref3` is an optional (..., 3) array with columns
    (ref_cte, ref_etheta, ref_vel) — one row per horizon knot. It upgrades
    the reference's constant setpoints
    (/root/reference/mpc_ros/src/mpc_planner.cpp:122-130, where ref_cte /
    ref_etheta / ref_v are scalars for the whole horizon) to time-indexed
    profiles, which is what direct trajectory tracking (a reference that
    moves in TIME — the upstream repo's `ref_trajectory_tracking` mode,
    /root/reference/README.md:43-46) and per-stage speed scheduling need.
    `None` keeps the scalar FG_eval behavior bit-for-bit.
    """
    if ref3 is None:
        return p.ref_cte, p.ref_etheta, p.ref_vel
    return ref3[..., 0], ref3[..., 1], ref3[..., 2]


def ref_state_vector(p: MPCParams, dtype, ref3=None, batch_shape=()):
    """(..., 6) setpoint vector: zeros except the tracked (v, cte, etheta)
    entries. With `ref3` the result carries the per-stage rows."""
    rc, re, rv = _ref3_cols(p, ref3)
    shape = (jnp.shape(rc) or batch_shape) + (STATE_DIM,)
    ref = jnp.zeros(shape, dtype)
    ref = ref.at[..., V].set(jnp.asarray(rv, dtype))
    ref = ref.at[..., CTE].set(jnp.asarray(rc, dtype))
    ref = ref.at[..., ETHETA].set(jnp.asarray(re, dtype))
    return ref


def state_weights(p: MPCParams, dtype):
    """(wz, ref): the tracked-state weight and setpoint vectors shared by
    the stage expansion here and the solver's terminal expansion — ONE
    definition so a new tracked term cannot desynchronize them."""
    wz = jnp.zeros((STATE_DIM,), dtype)
    wz = wz.at[V].set(jnp.asarray(p.w_vel, dtype))
    wz = wz.at[CTE].set(jnp.asarray(p.w_cte, dtype))
    wz = wz.at[ETHETA].set(jnp.asarray(p.w_etheta, dtype))
    ref = jnp.zeros((STATE_DIM,), dtype)
    ref = ref.at[V].set(jnp.asarray(p.ref_vel, dtype))
    ref = ref.at[CTE].set(jnp.asarray(p.ref_cte, dtype))
    ref = ref.at[ETHETA].set(jnp.asarray(p.ref_etheta, dtype))
    return wz, ref


# the default MPCParams weight sum (100+100+100+100+50+10+10): the
# normalization anchor of the solver's weight-scale proxy
W_DEFAULT_SUM = 470.0


def weight_scale(p: MPCParams, dtype):
    """One-sided cost-magnitude proxy s = max(1, sum(weights)/470) —
    scalar or per-lane, following the param leaves' shape.

    The solver's absolute knobs (mu floor/ceiling, pg tolerance, DDP
    gate) are in cost units; scaling them by s makes uniformly up-scaled
    problems solve with EXACTLY the c=1 iterates (the iLQR update is
    equivariant under J -> cJ with mu -> c mu; at power-of-two c the f32
    iterates are bit-identical up to degenerate box-QP active-set ties).
    One-sided: down-scaled weights keep the
    absolute mu floor that measurably rescues their early-engaged DDP
    model (SolverConfig.scale_adaptive docstring; PERF.md census)."""
    s = (p.w_cte + p.w_etheta + p.w_vel + p.w_angvel + p.w_accel
         + p.w_angvel_d + p.w_accel_d) * (1.0 / W_DEFAULT_SUM)
    return jnp.maximum(jnp.asarray(s, dtype), jnp.asarray(1.0, dtype))


def scaled_solver_knobs(cfg, p: MPCParams, dtype,
                        has_obstacles: bool = False,
                        has_omaps: bool = False):
    """The ONE resolution of the weight-scale-equivariant solver knobs
    shared by the ilqr, lane, and sharded engines (the megakernel
    computes the same quantities in-kernel from its params tile):
    (mu_min, mu_max, inv_scale_or_None, cost_guard) with mu bounds scaled
    by s = weight_scale(p), the pg-normalization reciprocal 1/s, and the
    relative-cost guard floor s (tol*(s+|J|) — exactly equivariant).
    `has_obstacles` (parametric blobs) and `has_omaps` (grid costmaps)
    feed the horizon-aware mu-floor resolution (SolverConfig.mu_init_for
    — the long-horizon damped-early-DDP pair excludes both obstacle
    representations)."""
    mu_min = jnp.asarray(
        cfg.mu_init_for(dtype, has_obstacles, has_omaps), dtype)
    mu_max = jnp.asarray(cfg.mu_max, dtype)
    if not cfg.scale_adaptive:
        return mu_min, mu_max, None, jnp.asarray(1.0, dtype)
    wscl = weight_scale(p, dtype)
    return mu_min * wscl, mu_max * wscl, 1.0 / wscl, wscl


def state_cost(z: jnp.ndarray, p: MPCParams, ref3=None) -> jnp.ndarray:
    """Per-knot tracking cost on (cte, etheta, v). z: (..., 6); `ref3`
    (..., 3) optionally replaces the scalar setpoints per knot."""
    rc, re, rv = _ref3_cols(p, ref3)
    return (
        p.w_cte * (z[..., CTE] - rc) ** 2
        + p.w_etheta * (z[..., ETHETA] - re) ** 2
        + p.w_vel * (z[..., V] - rv) ** 2
    )


def total_cost(zs: jnp.ndarray, us: jnp.ndarray, p: MPCParams,
               ref3=None) -> jnp.ndarray:
    """Full objective over a trajectory. zs: (N, 6), us: (N-1, 2);
    `ref3` (N, 3) = per-knot (ref_cte, ref_etheta, ref_vel) profile."""
    J = jnp.sum(state_cost(zs, p, ref3))
    J = J + jnp.sum(p.w_angvel * us[:, 0] ** 2 + p.w_accel * us[:, 1] ** 2)
    du = us[1:] - us[:-1]
    J = J + jnp.sum(p.w_angvel_d * du[:, 0] ** 2 + p.w_accel_d * du[:, 1] ** 2)
    return J


def stage_cost_aug(s: jnp.ndarray, u: jnp.ndarray, rate_on, p: MPCParams,
                   ref3=None) -> jnp.ndarray:
    """Stage cost on augmented state s = (z, prev_u); `rate_on` masks the
    rate term off at stage 0 (where prev_u is a placeholder). `ref3`
    (..., 3) = this stage's (ref_cte, ref_etheta, ref_vel) row."""
    z = s[..., :STATE_DIM]
    pu = s[..., STATE_DIM:]
    du = u - pu
    c = state_cost(z, p, ref3)
    c = c + p.w_angvel * u[..., 0] ** 2 + p.w_accel * u[..., 1] ** 2
    c = c + rate_on * (p.w_angvel_d * du[..., 0] ** 2 + p.w_accel_d * du[..., 1] ** 2)
    return c


def stage_expansion_aug(s: jnp.ndarray, u: jnp.ndarray, rate_on, p: MPCParams,
                        ref3=None):
    """Exact quadratic expansion of `stage_cost_aug` around (s, u).

    Returns (l_s, l_u, l_ss, l_uu, l_us) with shapes
    (8,), (2,), (8,8), (2,2), (2,8). All closed-form (the cost is quadratic).
    `ref3` (3,) shifts this stage's setpoints; only the gradient moves
    (the Hessian is setpoint-independent).
    """
    dtype = s.dtype
    z = s[..., :STATE_DIM]
    pu = s[..., STATE_DIM:]
    du = u - pu

    wz, ref = state_weights(p, dtype)
    if ref3 is not None:
        ref = ref_state_vector(p, dtype, ref3)

    wu = jnp.stack([jnp.asarray(p.w_angvel, dtype), jnp.asarray(p.w_accel, dtype)])
    wd = rate_on * jnp.stack(
        [jnp.asarray(p.w_angvel_d, dtype), jnp.asarray(p.w_accel_d, dtype)]
    )

    # gradients
    g_z = 2.0 * wz * (z - ref)
    g_pu = -2.0 * wd * du
    l_s = jnp.concatenate([g_z, g_pu], axis=-1)
    l_u = 2.0 * wu * u + 2.0 * wd * du

    # Hessians (constant, diagonal blocks)
    l_ss = jnp.zeros((AUG_STATE_DIM, AUG_STATE_DIM), dtype)
    l_ss = l_ss.at[jnp.arange(STATE_DIM), jnp.arange(STATE_DIM)].set(2.0 * wz)
    idx_pu = STATE_DIM + jnp.arange(CONTROL_DIM)
    l_ss = l_ss.at[idx_pu, idx_pu].set(2.0 * wd)

    l_uu = jnp.diag(2.0 * (wu + wd))

    l_us = jnp.zeros((CONTROL_DIM, AUG_STATE_DIM), dtype)
    l_us = l_us.at[jnp.arange(CONTROL_DIM), idx_pu].set(-2.0 * wd)
    return l_s, l_u, l_ss, l_uu, l_us
