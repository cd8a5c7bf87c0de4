"""Golden CPU oracle: the reference NLP solved exactly as Ipopt saw it.

Reconstructs the EXACT NLP that `CppAD::ipopt::solve` received from the
reference (/root/reference/mpc_ros/src/mpc_planner.cpp:265-375):

* decision vector [x(N), y(N), theta(N), v(N), cte(N), etheta(N),
  omega(N-1), a(N-1)],
* objective fg[0] (via the same `total_cost` the batched solver minimizes),
* 6N constraints: per-block initial row g[block] = vars[block] pinned to the
  measured state, then N-1 dynamics defects per block,
* box bounds: states +-bound_value, |omega| <= max_angvel,
  |a| <= max_throttle,
* cold start: zeros except the initial state
  (/root/reference/mpc_ros/src/mpc_planner.cpp:288-300).

Solved in float64 with scipy (SLSQP active-set SQP by default; trust-constr
interior-point available — the closer analog of Ipopt). Ipopt itself is not
a dependency; this oracle substitutes for it in the
regression-tolerance tests (SURVEY.md §7.2-2a). Runs on CPU, numpy only at
the scipy boundary; gradients are exact via jax in float64.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np

from ..config import MPCParams, SolverConfig


@dataclasses.dataclass
class OracleResult:
    us: np.ndarray        # (N-1, 2)
    zs: np.ndarray        # (N, 6)
    cost: float
    success: bool
    status: str
    kkt_violation: float  # max |dynamics defect| at the solution


@functools.lru_cache(maxsize=32)
def _nlp_funcs(N: int, cte_vsin_sign: float, extra_cost, model: str):
    """Jitted objective/constraints (+ derivatives) of the flat
    reference-layout vector, taking (v, coeffs, p, refs) so one
    compilation serves every scenario of a shape."""
    import jax
    import jax.numpy as jnp

    from ..models.base import get_model
    from ..models.costs import total_cost

    mdl = get_model(model)

    def unpack(v):
        zs = jnp.stack([v[i * N:(i + 1) * N] for i in range(6)], axis=-1)
        us = jnp.stack(
            [v[6 * N:6 * N + (N - 1)], v[6 * N + (N - 1):]], axis=-1
        )
        return zs, us

    def objective(v, coeffs, p, refs):
        zs, us = unpack(v)
        c = total_cost(zs, us, p, refs)
        if extra_cost is not None:
            c = c + extra_cost(zs, us)
        return c

    def constraints(v, coeffs, p, refs):
        zs, us = unpack(v)
        # per-block initial rows followed by the N-1 defects of that block,
        # matching fg[1 + block_start + {0, 1+i}] in FG_eval
        preds = jax.vmap(lambda z, u: mdl.step(z, u, coeffs, p.dt,
                                               cte_vsin_sign, p))(zs[:-1], us)
        defects = zs[1:] - preds                       # (N-1, 6)
        rows = [jnp.concatenate([zs[0, j:j + 1], defects[:, j]]) for j in range(6)]
        return jnp.concatenate(rows)

    return (jax.jit(objective), jax.jit(jax.grad(objective)),
            jax.jit(constraints), jax.jit(jax.jacfwd(constraints)))


def _build_funcs(coeffs: np.ndarray, p: MPCParams, N: int,
                 cte_vsin_sign: float = 1.0, extra_cost=None,
                 model: str = "diff_drive", refs=None):
    """Objective/constraints on the flat reference-layout vector (jax f64)."""
    import jax
    import jax.numpy as jnp

    assert jax.config.jax_enable_x64, "oracle requires float64 (enable x64)"
    coeffs = jnp.asarray(coeffs, jnp.float64)
    p64 = p.astype(jnp.float64)
    if refs is not None:
        refs = jnp.asarray(refs, jnp.float64)
    fns = _nlp_funcs(N, float(cte_vsin_sign), extra_cost, model)
    return tuple((lambda v, f=f: f(v, coeffs, p64, refs)) for f in fns)


def solve_oracle(z0: np.ndarray, coeffs: np.ndarray, p: MPCParams,
                 cfg: SolverConfig, method: str = "SLSQP",
                 u_init: Optional[np.ndarray] = None,
                 maxiter: int = 500, extra_cost=None,
                 refs: Optional[np.ndarray] = None) -> OracleResult:
    """Solve the full reference NLP in float64 on CPU.

    `extra_cost(zs, us) -> scalar` (jax f64) is added to the objective —
    used to verify obstacle-penalty solves against the same NLP.
    `refs` (N, 3) = per-knot (ref_cte, ref_etheta, ref_vel) profile, the
    time-indexed objective of the trajectory-tracking mode."""
    from scipy import optimize

    N = cfg.n_steps
    n_vars = cfg.n_vars
    z0 = np.asarray(z0, np.float64)

    obj, grad, con, jac = _build_funcs(np.asarray(coeffs), p, N,
                                       cfg.cte_vsin_sign, extra_cost,
                                       cfg.model, refs)

    # cold start: zeros + initial state write-in
    v0 = np.zeros(n_vars)
    for j in range(6):
        v0[j * N] = z0[j]
    if u_init is not None:
        u_init = np.asarray(u_init, np.float64)
        v0[6 * N:6 * N + (N - 1)] = u_init[:, 0]
        v0[6 * N + (N - 1):] = u_init[:, 1]

    bv = float(p.bound_value)
    # per-model actuator bounds (diff_drive: |omega|<=max_angvel;
    # bicycle: |delta|<=max_steer; both: |a|<=max_throttle)
    from ..models.base import get_model
    import jax.numpy as jnp

    u_lb, u_ub = get_model(cfg.model).control_bounds(p, jnp.float64)
    lb = np.concatenate([
        np.full(6 * N, -bv),
        np.full(N - 1, float(u_lb[0])), np.full(N - 1, float(u_lb[1])),
    ])
    # honor asymmetric model boxes (e.g. throttle in [0, 1]); the built-in
    # families are symmetric, so their NLPs are unchanged
    ub = np.concatenate([
        np.full(6 * N, bv),
        np.full(N - 1, float(u_ub[0])), np.full(N - 1, float(u_ub[1])),
    ])

    # constraint targets: 0 except initial rows pinned to the state
    g_target = np.zeros(6 * N)
    for j in range(6):
        g_target[j * N] = z0[j]

    def g_fun(v):
        return np.asarray(con(v)) - g_target

    def g_jac(v):
        return np.asarray(jac(v))

    if method == "SLSQP":
        res = optimize.minimize(
            lambda v: float(obj(v)), v0, jac=lambda v: np.asarray(grad(v)),
            bounds=optimize.Bounds(lb, ub),
            constraints=[{"type": "eq", "fun": g_fun, "jac": g_jac}],
            method="SLSQP", options={"maxiter": maxiter, "ftol": 1e-14},
        )
    elif method == "trust-constr":
        res = optimize.minimize(
            lambda v: float(obj(v)), v0, jac=lambda v: np.asarray(grad(v)),
            bounds=optimize.Bounds(lb, ub),
            constraints=[optimize.NonlinearConstraint(g_fun, 0.0, 0.0, jac=g_jac)],
            method="trust-constr",
            options={"maxiter": maxiter * 4, "gtol": 1e-12, "xtol": 1e-14},
        )
    else:
        raise ValueError(f"unknown oracle method: {method}")

    v = res.x
    zs = np.stack([v[i * N:(i + 1) * N] for i in range(6)], axis=-1)
    us = np.stack([v[6 * N:6 * N + (N - 1)], v[6 * N + (N - 1):]], axis=-1)
    kkt = float(np.max(np.abs(g_fun(v))))
    return OracleResult(
        us=us, zs=zs, cost=float(res.fun), success=bool(res.success),
        status=str(getattr(res, "message", "")), kkt_violation=kkt,
    )
