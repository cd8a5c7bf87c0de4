"""Solver tests: golden NLPs, oracle match, warm start, batching.

The oracle-match tests are the framework's substitute for the reference's
`CppAD_Ipopt` golden check (/root/reference/assets/document/example/
CppAD_Ipopt.cpp:88-165): known-solution NLPs verified at tight tolerance,
plus the headline requirement — solver control sequences within 1e-3 of
the (Ipopt-equivalent) full-NLP solution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_ros_tpu.config import MPCParams, SolverConfig
from mpc_ros_tpu.models import diff_drive as dd
from mpc_ros_tpu.models.costs import total_cost
from mpc_ros_tpu.solver import ilqr
from mpc_ros_tpu.solver.oracle import solve_oracle


def scenario(seed=0, v0=0.3, curve=0.2):
    """A representative tracking scenario: robot slightly off a curved path."""
    coeffs = np.array([0.05, -0.1, curve, -0.02])
    cte = coeffs[0]
    etheta = float(np.arctan(coeffs[1]))
    z0 = np.array([0.0, 0.0, 0.0, v0, cte, etheta])
    return z0, coeffs


def params64():
    return MPCParams(
        dt=0.1, ref_vel=0.5, w_cte=100.0, w_etheta=100.0, w_vel=100.0,
        w_angvel=100.0, w_accel=50.0, w_angvel_d=10.0, w_accel_d=10.0,
        max_angvel=1.0, max_throttle=1.0,
    ).astype(jnp.float64)


def test_solver_decreases_cost_and_converges():
    z0, coeffs = scenario()
    p = params64()
    # tight tolerances: drive the projected gradient itself down
    cfg = SolverConfig(n_steps=10, tol_grad=1e-8, tol_cost=0.0)
    res = ilqr.solve(jnp.asarray(z0), jnp.asarray(coeffs), p, cfg)
    us0 = jnp.zeros((cfg.n_controls, 2))
    zs0 = dd.rollout(jnp.asarray(z0), us0, jnp.asarray(coeffs), p.dt,
                     cfg.cte_vsin_sign)
    assert float(res.cost) < float(total_cost(zs0, us0, p))
    assert bool(res.converged)
    assert float(res.grad_norm) < 1e-6


def test_solution_is_dynamically_feasible():
    z0, coeffs = scenario()
    p = params64()
    cfg = SolverConfig(n_steps=10)
    res = ilqr.solve(jnp.asarray(z0), jnp.asarray(coeffs), p, cfg)
    zs_roll = dd.rollout(jnp.asarray(z0), res.us, jnp.asarray(coeffs), p.dt,
                         cfg.cte_vsin_sign)
    np.testing.assert_allclose(np.asarray(res.zs), np.asarray(zs_roll), atol=1e-12)
    # controls respect the box
    assert float(jnp.max(jnp.abs(res.us[:, 0]))) <= float(p.max_angvel) + 1e-12
    assert float(jnp.max(jnp.abs(res.us[:, 1]))) <= float(p.max_throttle) + 1e-12


@pytest.mark.parametrize("n_steps", [10, 30])
def test_matches_ipopt_oracle(n_steps):
    """Headline: control sequence within 1e-3 of the full-NLP optimum."""
    z0, coeffs = scenario()
    p = params64()
    cfg = SolverConfig(n_steps=n_steps, max_sqp_iters=200, tol_grad=1e-10)
    res = ilqr.solve(jnp.asarray(z0), jnp.asarray(coeffs), p, cfg)
    orc = solve_oracle(z0, coeffs, p, cfg)
    assert orc.success, orc.status
    assert orc.kkt_violation < 1e-7
    dev = np.max(np.abs(np.asarray(res.us) - orc.us))
    assert dev < 1e-3, f"control deviation vs oracle: {dev}"
    np.testing.assert_allclose(float(res.cost), orc.cost, rtol=1e-5)


def test_matches_oracle_with_active_box_constraints():
    """Saturated case: tight omega bound forces an active control constraint."""
    z0, coeffs = scenario(curve=0.6)
    z0[4] = 0.5   # large cte -> aggressive correction -> saturation
    p = MPCParams(
        dt=0.1, ref_vel=0.8, w_cte=500.0, w_etheta=100.0, w_vel=100.0,
        w_angvel=10.0, w_accel=10.0, w_angvel_d=1.0, w_accel_d=1.0,
        max_angvel=0.3, max_throttle=0.5,
    ).astype(jnp.float64)
    cfg = SolverConfig(n_steps=12, max_sqp_iters=300, tol_grad=1e-10)
    res = ilqr.solve(jnp.asarray(z0), jnp.asarray(coeffs), p, cfg)
    # solver must actually saturate
    assert float(jnp.max(jnp.abs(res.us[:, 0]))) > 0.3 - 1e-6
    orc = solve_oracle(z0, coeffs, p, cfg)
    assert orc.success, orc.status
    dev = np.max(np.abs(np.asarray(res.us) - orc.us))
    assert dev < 1e-3, f"control deviation vs oracle (saturated): {dev}"


def test_warm_start_reduces_iterations():
    z0, coeffs = scenario()
    p = params64()
    cfg = SolverConfig(n_steps=20)
    res_cold = ilqr.solve(jnp.asarray(z0), jnp.asarray(coeffs), p, cfg)
    # shifted previous solution as warm start (the reference never did this
    # — quirk Q9 — it is this design's free win)
    u_shift = jnp.concatenate([res_cold.us[1:], res_cold.us[-1:]])
    res_warm = ilqr.solve(jnp.asarray(z0), jnp.asarray(coeffs), p, cfg,
                          u_init=u_shift)
    assert int(res_warm.n_iters) <= int(res_cold.n_iters)
    np.testing.assert_allclose(float(res_warm.cost), float(res_cold.cost),
                               rtol=1e-5, atol=1e-8)


def test_vmap_batch_consistency():
    """Batched solves must equal per-scenario solves (batch-vs-single)."""
    p = params64()
    cfg = SolverConfig(n_steps=10)
    rng = np.random.default_rng(7)
    B = 8
    z0s = np.zeros((B, 6))
    z0s[:, 3] = 0.3
    z0s[:, 4] = rng.normal(size=B) * 0.3
    z0s[:, 5] = rng.normal(size=B) * 0.2
    coeffs = rng.normal(size=(B, 4)) * np.array([0.1, 0.2, 0.1, 0.02])
    batched = jax.vmap(lambda z, c: ilqr.solve(z, c, p, cfg))(
        jnp.asarray(z0s), jnp.asarray(coeffs)
    )
    for i in range(B):
        single = ilqr.solve(jnp.asarray(z0s[i]), jnp.asarray(coeffs[i]), p, cfg)
        np.testing.assert_allclose(
            np.asarray(batched.us[i]), np.asarray(single.us), atol=1e-8
        )


def test_f32_close_to_f64():
    z0, coeffs = scenario()
    p64 = params64()
    cfg = SolverConfig(n_steps=10)
    res64 = ilqr.solve(jnp.asarray(z0), jnp.asarray(coeffs), p64, cfg)
    p32 = p64.astype(jnp.float32)
    res32 = ilqr.solve(jnp.asarray(z0, jnp.float32),
                       jnp.asarray(coeffs, jnp.float32), p32, cfg)
    assert res32.us.dtype == jnp.float32
    dev = np.max(np.abs(np.asarray(res32.us) - np.asarray(res64.us)))
    assert dev < 5e-3, f"f32 vs f64 control deviation: {dev}"


def test_oracle_golden_hs071_analog():
    """Sanity-check the oracle machinery itself on a tiny golden NLP with a
    known solution (pattern of the reference's CppAD_Ipopt example)."""
    from scipy.optimize import minimize, NonlinearConstraint, Bounds

    # min x1*x4*(x1+x2+x3) + x3  s.t. prod >= 25, sum sq = 40, 1<=x<=5
    f = lambda x: x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]
    res = minimize(
        f, [1.0, 5.0, 5.0, 1.0],
        bounds=Bounds(np.ones(4), np.full(4, 5.0)),
        constraints=[
            NonlinearConstraint(lambda x: x[0] * x[1] * x[2] * x[3], 25.0, np.inf),
            NonlinearConstraint(lambda x: np.sum(x**2), 40.0, 40.0),
        ],
        method="SLSQP", options={"ftol": 1e-12, "maxiter": 200},
    )
    want = np.array([1.000000, 4.743000, 3.82115, 1.379408])
    np.testing.assert_allclose(res.x, want, rtol=1e-5)


def test_long_horizon_n100_converges():
    """The reference's cfg allows mpc_steps up to 100
    (/root/reference/mpc_ros/cfg/MPCPlanner.cfg:22); the solver must handle
    the full range. N=100 interior solve, both sequential and
    horizon-parallel backward passes."""
    z0, coeffs = scenario()
    p = params64()
    for hp in (False, True):
        cfg = SolverConfig(n_steps=100, max_sqp_iters=150, tol_grad=1e-8,
                           tol_cost=0.0, horizon_parallel=hp)
        res = ilqr.solve(jnp.asarray(z0), jnp.asarray(coeffs), p, cfg)
        assert bool(res.converged), f"horizon_parallel={hp}"
        # N=100 conditioning: ~2e-6 is the f64 floor for this problem
        assert float(res.grad_norm) < 1e-5
        assert res.us.shape == (99, 2)
        zs_roll = dd.rollout(jnp.asarray(z0), res.us, jnp.asarray(coeffs),
                             p.dt, cfg.cte_vsin_sign)
        np.testing.assert_allclose(np.asarray(res.zs), np.asarray(zs_roll),
                                   atol=1e-10)


def test_n100_production_cap_convergence():
    """Pins VERDICT r1 item 2: at the reference's max horizon
    (/root/reference/mpc_ros/cfg/MPCPlanner.cfg:22, mpc_steps max 100) the
    PRODUCTION iteration cap (bench default max(12, 0.45*N) = 45) must
    converge >= 99% of the random scenario ensemble in f32 — no hand-raised
    per-run cap."""
    from mpc_ros_tpu.engine import batch_solve, make_random_scenarios

    B = 512
    p = MPCParams().astype(jnp.float32)
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), B,
                                        jnp.float32)
    cap = max(12, round(0.45 * 100))  # the bench.py default formula
    cfg = SolverConfig(n_steps=100, max_sqp_iters=cap, ls_iters=5,
                       tol_grad=1e-4)
    res = batch_solve(z0s, coeffs, p, cfg)
    conv = float(jnp.mean(res.converged.astype(jnp.float32)))
    assert conv >= 0.99, f"N=100 converged fraction {conv:.4f} < 0.99"
    assert bool(jnp.all(jnp.isfinite(res.cost)))


def test_lane_solver_n100():
    from mpc_ros_tpu.engine import batch_solve_lane

    # gentle references: a 10 s horizon sweeps ~3.5 m of the robot-frame
    # cubic; wild random curvatures at that range are not representative
    rng = np.random.default_rng(11)
    B = 16
    coeffs = np.zeros((B, 4))
    coeffs[:, 0] = rng.normal(size=B) * 0.15
    coeffs[:, 1] = rng.normal(size=B) * 0.05
    z0s = np.zeros((B, 6))
    z0s[:, 3] = 0.3
    z0s[:, 4] = coeffs[:, 0]
    z0s[:, 5] = np.arctan(coeffs[:, 1])
    p = params64()
    cfg = SolverConfig(n_steps=100, max_sqp_iters=30)
    res = batch_solve_lane(jnp.asarray(z0s), jnp.asarray(coeffs), p, cfg)
    assert bool(jnp.all(jnp.isfinite(res.cost)))
    assert float(jnp.mean(res.converged.astype(jnp.float64))) > 0.9


def test_lane_solver_noncubic_reference_matches_vmapped():
    """poly_order != 3 must flow through the lane solver and kernels' Horner
    evaluation, matching the per-scenario solver (which uses ops.poly) —
    regression for the silent cubic truncation."""
    import jax

    from mpc_ros_tpu.solver import ilqr
    from mpc_ros_tpu.solver.batch_lane import batch_solve_lane

    dtype = jnp.float64
    B = 4
    for order in (2, 4):
        cfg = SolverConfig(n_steps=10, poly_order=order)
        rng = np.random.default_rng(order)
        z0s = jnp.asarray(rng.normal(0, 0.3, (B, 6)))
        coeffs = jnp.asarray(rng.normal(0, 0.1, (B, order + 1)))
        p = MPCParams().astype(dtype)
        r_vm = jax.vmap(lambda z, c: ilqr.solve(z, c, p, cfg))(z0s, coeffs)
        r_ln = batch_solve_lane(z0s, coeffs, p, cfg)
        np.testing.assert_allclose(np.asarray(r_ln.us), np.asarray(r_vm.us),
                                   atol=1e-6)


def test_straggler_ensembles_converge_at_production_caps():
    """VERDICT r1 item 7: the bicycle and obstacle ensembles' tails are
    slow (accepting alpha=1 every iteration, linear convergence — not
    stalls: reg stays at mu_init), so their production cap is 30 (bench.py
    `hard` floor). Pins conv >= 0.99 for both at that cap, f32."""
    from mpc_ros_tpu.engine import batch_solve, make_random_scenarios
    from mpc_ros_tpu.models.obstacles import GaussianObstacles

    B = 512
    dtype = jnp.float32
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), B, dtype)

    cfg = SolverConfig(n_steps=30, max_sqp_iters=30, ls_iters=5,
                       tol_grad=1e-4, model="bicycle")
    p_bike = MPCParams(lf=0.25, max_steer=0.6).astype(dtype)
    res = batch_solve(z0s, coeffs, p_bike, cfg)
    conv = float(jnp.mean(res.converged.astype(dtype)))
    assert conv >= 0.99, f"bicycle conv {conv:.4f} < 0.99 @ 30 iters"

    K = 4
    centers = jax.random.uniform(jax.random.PRNGKey(1), (B, 2), dtype,
                                 0.3, 1.2)
    blobs = GaussianObstacles.from_sigmas(
        jnp.concatenate([centers[:, :1],
                         jnp.full((B, K - 1), 50.0, dtype)], axis=1),
        jnp.concatenate([centers[:, 1:],
                         jnp.full((B, K - 1), 50.0, dtype)], axis=1),
        jnp.full((B, K), 0.3, dtype), jnp.full((B, K), 100.0, dtype))
    cfg_o = SolverConfig(n_steps=30, max_sqp_iters=30, ls_iters=5,
                         tol_grad=1e-4)
    p = MPCParams().astype(dtype)
    res_o = jax.vmap(lambda z, c, bl: ilqr.solve(z, c, p, cfg_o, blobs=bl))(
        z0s, coeffs, blobs)
    conv_o = float(jnp.mean(res_o.converged.astype(dtype)))
    assert conv_o >= 0.99, f"obstacles conv {conv_o:.4f} < 0.99 @ 30 iters"
