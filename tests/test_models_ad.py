"""Autodiff-built vehicle families (models.base.model_from_step).

The reference's CppAD workflow is: write the dynamics on AD<double>, the
vendored engine tapes + differentiates them (SURVEY.md §2.2). The
JAX equivalent must offer the same capability — a user writes ONLY
a step function and gets a solver-ready model — not just hand-derived
Jacobian families. These tests pin that path:

* make_jacobians == the hand-derived closed forms (diff_drive, bicycle);
* an autodiff clone of diff_drive solves identically to the analytic one;
* a genuinely new family (velocity-damped drive, no hand math anywhere)
  runs end-to-end through solve_jit and the vmapped batch engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_ros_tpu.config import MPCParams, SolverConfig
from mpc_ros_tpu.engine.batch import batch_solve, make_random_scenarios
from mpc_ros_tpu.models import bicycle, diff_drive, get_model
from mpc_ros_tpu.models.base import make_jacobians, model_from_step
from mpc_ros_tpu.solver.ilqr import solve_jit


def _rand_zu(key, batch, dtype=jnp.float64):
    kz, ku, kc = jax.random.split(key, 3)
    z = jax.random.normal(kz, batch + (6,), dtype)
    u = jax.random.normal(ku, batch + (2,), dtype)
    coeffs = 0.3 * jax.random.normal(kc, (4,), dtype)
    return z, u, coeffs


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_ad_jacobians_match_analytic_diff_drive(sign):
    p = MPCParams().astype(jnp.float64)
    step = lambda z, u, c, dt, s, p: diff_drive.step(z, u, c, dt, s)
    jac_ad = make_jacobians(step)
    z, u, coeffs = _rand_zu(jax.random.PRNGKey(0), (17,))
    A_ad, B_ad = jac_ad(z, u, coeffs, 0.1, sign, p)
    A, B = diff_drive.step_jacobians(z, u, coeffs, 0.1, sign)
    np.testing.assert_allclose(A_ad, A, rtol=0, atol=1e-12)
    np.testing.assert_allclose(B_ad, B, rtol=0, atol=1e-12)


def test_ad_jacobians_match_analytic_bicycle():
    p = MPCParams().astype(jnp.float64)
    jac_ad = make_jacobians(bicycle.step)
    z, u, coeffs = _rand_zu(jax.random.PRNGKey(1), (11,))
    A_ad, B_ad = jac_ad(z, u, coeffs, 0.1, 1.0, p)
    A, B = bicycle.step_jacobians(z, u, coeffs, 0.1, 1.0, p)
    np.testing.assert_allclose(A_ad, A, rtol=0, atol=1e-12)
    np.testing.assert_allclose(B_ad, B, rtol=0, atol=1e-12)


def test_ad_jacobians_unbatched_shape():
    p = MPCParams().astype(jnp.float64)
    jac_ad = make_jacobians(bicycle.step)
    z, u, coeffs = _rand_zu(jax.random.PRNGKey(2), ())
    A, B = jac_ad(z, u, coeffs, 0.1, 1.0, p)
    assert A.shape == (6, 6) and B.shape == (6, 2)


def _register_ad_clone():
    dd = get_model("diff_drive")
    return model_from_step(
        "diff_drive_ad",
        lambda z, u, c, dt, s, p: diff_drive.step(z, u, c, dt, s),
        dd.control_bounds,
        allow_override=True,   # idempotent across tests in one process
    )


def test_ad_model_solver_parity():
    """solve_jit(model='diff_drive_ad') == solve_jit(model='diff_drive')."""
    _register_ad_clone()
    dtype = jnp.float64
    p = MPCParams().astype(dtype)
    z0 = jnp.asarray([0.0, 0.4, 0.2, 0.3, 0.0, 0.0], dtype)
    coeffs = jnp.asarray([0.1, 0.3, -0.05, 0.01], dtype)
    cfg_a = SolverConfig(n_steps=15, max_sqp_iters=40, backward="xla")
    cfg_b = SolverConfig(n_steps=15, max_sqp_iters=40, backward="xla",
                         model="diff_drive_ad")
    res_a = solve_jit(z0, coeffs, p, cfg_a)
    res_b = solve_jit(z0, coeffs, p, cfg_b)
    assert bool(res_a.converged) and bool(res_b.converged)
    np.testing.assert_allclose(res_b.us, res_a.us, rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(res_b.cost), float(res_a.cost),
                               rtol=1e-12)


def _register_damped():
    """A genuinely new family, zero hand math: diff drive with linear
    velocity drag (v' = v + (a - k v) dt) — e.g. a robot whose base bleeds
    speed when coasting."""
    K_DRAG = 0.35

    def step(z, u, coeffs, dt, sign, p):
        z_next = diff_drive.step(z, u, coeffs, dt, sign)
        v = z[..., diff_drive.V]
        return z_next.at[..., diff_drive.V].add(-K_DRAG * v * dt)

    return model_from_step(
        "damped_drive", step, get_model("diff_drive").control_bounds,
        allow_override=True)   # idempotent across tests in one process


def test_custom_ad_family_end_to_end():
    _register_damped()
    dtype = jnp.float64
    p = MPCParams().astype(dtype)
    z0 = jnp.asarray([0.0, 0.3, -0.1, 0.2, 0.0, 0.0], dtype)
    coeffs = jnp.asarray([0.0, 0.2, 0.0, 0.0], dtype)
    cfg = SolverConfig(n_steps=12, max_sqp_iters=50, backward="xla",
                       model="damped_drive")
    res = solve_jit(z0, coeffs, p, cfg)
    assert bool(res.converged)
    lb, ub = get_model("damped_drive").control_bounds(p, dtype)
    assert bool(jnp.all(res.us >= lb - 1e-9))
    assert bool(jnp.all(res.us <= ub + 1e-9))
    # the drag actually bites: the model's own rollout under the returned
    # controls ends slower than the undamped plant under the same controls
    mdl = get_model("damped_drive")
    zs_damped = mdl.rollout(z0, res.us, coeffs, p.dt, 1.0, p)
    zs_plain = diff_drive.rollout(z0, res.us, coeffs, float(p.dt))
    assert float(zs_damped[-1, diff_drive.V]) < float(
        zs_plain[-1, diff_drive.V])


def test_custom_ad_family_batched():
    _register_damped()
    dtype = jnp.float64
    p = MPCParams().astype(dtype)
    cfg = SolverConfig(n_steps=10, max_sqp_iters=30, backward="xla",
                       model="damped_drive")
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(3), 8, dtype)
    res = batch_solve(z0s, coeffs, p, cfg)
    assert res.us.shape == (8, cfg.n_controls, 2)
    assert bool(jnp.all(jnp.isfinite(res.us)))
    # batched == single, lane by lane
    single = solve_jit(z0s[2], coeffs[2], p, cfg)
    np.testing.assert_allclose(res.us[2], single.us, rtol=0, atol=1e-10)


def test_registry_refuses_silent_override():
    """Registering an existing family name raises unless explicitly
    overridden — a silent replacement of 'diff_drive' would reroute every
    solve through the new dynamics with no symptom."""
    import pytest

    from mpc_ros_tpu.models.base import get_model, model_from_step

    with pytest.raises(ValueError, match="already registered"):
        model_from_step(
            "diff_drive",
            lambda z, u, c, dt, s, p: z,
            get_model("diff_drive").control_bounds)
