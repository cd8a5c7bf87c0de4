"""Batch engine + sharded sweep tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np

from mpc_ros_tpu.config import MPCParams, SolverConfig
from mpc_ros_tpu.engine import batch_solve, batch_solve_swept, make_random_scenarios
from mpc_ros_tpu.parallel import make_mesh, sharded_sweep


def test_batch_solve_shapes():
    key = jax.random.PRNGKey(0)
    z0s, coeffs = make_random_scenarios(key, 16, dtype=jnp.float64)
    p = MPCParams().astype(jnp.float64)
    cfg = SolverConfig(n_steps=10)
    res = batch_solve(z0s, coeffs, p, cfg)
    assert res.us.shape == (16, 9, 2)
    assert res.zs.shape == (16, 10, 6)
    assert bool(jnp.all(jnp.isfinite(res.cost)))
    assert float(jnp.mean(res.converged.astype(jnp.float64))) > 0.9


def test_swept_params_differ_per_scenario():
    key = jax.random.PRNGKey(1)
    B = 4
    z0s, coeffs = make_random_scenarios(key, B, dtype=jnp.float64)
    base = MPCParams().astype(jnp.float64)
    # sweep the cte weight; higher weight must not increase the cte cost term
    w_cte = jnp.asarray([1.0, 10.0, 100.0, 1000.0], jnp.float64)
    ps = jax.tree.map(lambda leaf: jnp.broadcast_to(leaf, (B,)), base)
    ps = ps.replace(w_cte=w_cte)
    # identical scenario for all four
    z0s = jnp.broadcast_to(z0s[0], z0s.shape)
    coeffs = jnp.broadcast_to(coeffs[0], coeffs.shape)
    res = batch_solve_swept(z0s, coeffs, ps, SolverConfig(n_steps=10))
    ctes = np.abs(np.asarray(res.zs[:, -1, 4]))  # terminal |cte|
    # monotone trend: heavier cte weight -> smaller terminal cte
    assert ctes[3] <= ctes[0] + 1e-9


def test_sharded_sweep_matches_unsharded():
    mesh = make_mesh()  # 8 CPU devices on the data axis
    key = jax.random.PRNGKey(2)
    B = 32
    z0s, coeffs = make_random_scenarios(key, B, dtype=jnp.float64)
    p = MPCParams().astype(jnp.float64)
    cfg = SolverConfig(n_steps=10)
    res_sh, stats = sharded_sweep(mesh, z0s, coeffs, p, cfg)
    res = batch_solve(z0s, coeffs, p, cfg)
    np.testing.assert_allclose(np.asarray(res_sh.us), np.asarray(res.us), atol=1e-10)
    np.testing.assert_allclose(
        float(stats.mean_cost), float(jnp.mean(res.cost)), rtol=1e-12
    )
    np.testing.assert_allclose(
        float(stats.max_cost), float(jnp.max(res.cost)), rtol=1e-12
    )
    np.testing.assert_allclose(
        float(stats.converged_frac),
        float(jnp.mean(res.converged.astype(jnp.float64))), rtol=1e-12
    )


def test_sharded_sweep_deterministic():
    mesh = make_mesh()
    key = jax.random.PRNGKey(3)
    z0s, coeffs = make_random_scenarios(key, 16, dtype=jnp.float64)
    p = MPCParams().astype(jnp.float64)
    cfg = SolverConfig(n_steps=10)
    _, s1 = sharded_sweep(mesh, z0s, coeffs, p, cfg)
    _, s2 = sharded_sweep(mesh, z0s, coeffs, p, cfg)
    assert float(s1.mean_cost) == float(s2.mean_cost)


def test_lane_solver_matches_vmapped():
    """The lane-major batched path must agree with the per-scenario solver."""
    from mpc_ros_tpu.engine import batch_solve_lane

    key = jax.random.PRNGKey(5)
    z0s, coeffs = make_random_scenarios(key, 32, dtype=jnp.float64)
    p = MPCParams().astype(jnp.float64)
    cfg = SolverConfig(n_steps=20)
    r_ref = batch_solve(z0s, coeffs, p, cfg)
    r_ln = batch_solve_lane(z0s, coeffs, p, cfg)
    np.testing.assert_allclose(np.asarray(r_ln.us), np.asarray(r_ref.us),
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(r_ln.cost), np.asarray(r_ref.cost),
                               rtol=1e-10)
    assert bool(jnp.all(r_ln.converged == r_ref.converged))


def test_lane_solver_warm_start():
    from mpc_ros_tpu.engine import batch_solve_lane

    key = jax.random.PRNGKey(6)
    z0s, coeffs = make_random_scenarios(key, 8, dtype=jnp.float64)
    p = MPCParams().astype(jnp.float64)
    cfg = SolverConfig(n_steps=15)
    cold = batch_solve_lane(z0s, coeffs, p, cfg)
    warm = batch_solve_lane(z0s, coeffs, p, cfg, u_init=cold.us)
    assert int(jnp.max(warm.n_iters)) <= int(jnp.max(cold.n_iters))
    np.testing.assert_allclose(np.asarray(warm.cost), np.asarray(cold.cost),
                               rtol=1e-6)


def test_extreme_param_regimes_no_nans():
    """Property: the lane solver never emits NaN/Inf controls across
    extreme-but-legal parameter regimes (huge/tiny weights, tiny dt, tight
    actuator bounds, aggressive references). Lanes may fail to converge;
    they must fail SAFE (finite iterates, converged=False)."""
    import numpy as np

    from mpc_ros_tpu.solver.batch_lane import batch_solve_lane

    dtype = jnp.float64
    rng = np.random.default_rng(11)
    B = 16
    regimes = dict(
        w_cte=10.0 ** rng.uniform(-3, 5, B),
        w_etheta=10.0 ** rng.uniform(-3, 5, B),
        w_vel=10.0 ** rng.uniform(-3, 5, B),
        w_angvel=10.0 ** rng.uniform(-3, 4, B),
        w_accel=10.0 ** rng.uniform(-3, 4, B),
        w_angvel_d=10.0 ** rng.uniform(-3, 4, B),
        w_accel_d=10.0 ** rng.uniform(-3, 4, B),
        dt=10.0 ** rng.uniform(-3, 0, B),
        ref_vel=rng.uniform(0.01, 3.0, B),
        max_angvel=rng.uniform(0.05, 3.0, B),
        max_throttle=rng.uniform(0.05, 3.0, B),
    )
    p = MPCParams(**{k: jnp.asarray(v) for k, v in regimes.items()}
                  ).astype(dtype)
    z0s = jnp.asarray(rng.normal(0, 1.0, (B, 6)))
    coeffs = jnp.asarray(rng.normal(0, 0.5, (B, 4)))
    cfg = SolverConfig(n_steps=15, max_sqp_iters=15, tol_grad=1e-5)
    res = batch_solve_lane(z0s, coeffs, p, cfg)
    assert bool(jnp.all(jnp.isfinite(res.us))), "non-finite controls"
    assert bool(jnp.all(jnp.isfinite(res.cost))), "non-finite cost"
    # controls respect per-scenario actuator bounds
    lb0 = jnp.asarray(regimes["max_angvel"])[:, None]
    lb1 = jnp.asarray(regimes["max_throttle"])[:, None]
    assert bool(jnp.all(jnp.abs(res.us[:, :, 0]) <= lb0 + 1e-9))
    assert bool(jnp.all(jnp.abs(res.us[:, :, 1]) <= lb1 + 1e-9))


def test_tuning_sweep_custom_family_any_batch():
    """tuning_sweep dispatches registry-defined custom families to the
    model-generic vmapped engine even when the batch is a multiple of 128
    (the lane path is diff_drive/bicycle-only)."""
    from mpc_ros_tpu.engine.sweep import sample_weight_candidates, tuning_sweep
    from mpc_ros_tpu.models.base import model_from_step
    from mpc_ros_tpu.models.diff_drive import step as dd_step

    def step(z, u, coeffs, dt, sign, p):   # model_from_step signature
        return dd_step(z, u, coeffs, dt, sign)

    model_from_step("testfam_sweep", step,
                    lambda p, dtype: (jnp.asarray([-1.0, -1.0], dtype),
                                      jnp.asarray([1.0, 1.0], dtype)))
    cands = sample_weight_candidates(jax.random.PRNGKey(0), 4, MPCParams(),
                                     dtype=jnp.float32)
    cfg = SolverConfig(n_steps=8, max_sqp_iters=4, model="testfam_sweep")
    sw = tuning_sweep(jax.random.PRNGKey(1), cands, 32, cfg,
                      dtype=jnp.float32)   # 4*32 = 128: lane-eligible size
    assert np.isfinite(float(jnp.min(sw.mean_cost)))


def test_sharded_horizon_solve_matches_batch_solve():
    """The (data x time)-sharded FULL solve (VERDICT r1 item 5: the time
    axis doing real work in a real solve) must match the per-scenario
    batched solver on the virtual 8-device mesh."""
    from mpc_ros_tpu.parallel import sharded_horizon_solve

    mesh = make_mesh(n_data=4, n_time=2)
    cfg = SolverConfig(n_steps=17, max_sqp_iters=25, tol_grad=1e-6,
                       horizon_parallel=True)
    p = MPCParams().astype(jnp.float32)
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), 16,
                                        jnp.float32)
    res = sharded_horizon_solve(mesh, z0s, coeffs, p, cfg)
    ref = batch_solve(z0s, coeffs, p, cfg)
    assert float(jnp.mean(res.converged.astype(jnp.float32))) == 1.0
    np.testing.assert_allclose(np.asarray(res.us), np.asarray(ref.us),
                               atol=2e-4)


def test_sharded_horizon_solve_saturated():
    """Time-sharded solve with ACTIVE control bounds (the exact boxed
    parallel pass under sharding)."""
    from mpc_ros_tpu.parallel import sharded_horizon_solve

    mesh = make_mesh(n_data=4, n_time=2)
    # horizon_parallel EXPLICIT so the unsharded reference resolves the
    # same GN solver profile as the time-sharded engine (which normalizes
    # its cfg to horizon_parallel=True — see parallel/sharded.py)
    cfg = SolverConfig(n_steps=16, max_sqp_iters=25, tol_grad=1e-6,
                       horizon_parallel=True)
    p = MPCParams(max_angvel=0.3, max_throttle=0.2,
                  w_cte=300.0).astype(jnp.float32)
    B = 16
    rng = np.random.default_rng(5)
    coeffs = jnp.asarray(
        np.stack([0.4 * rng.normal(size=B), 0.8 * rng.normal(size=B),
                  0.3 * rng.normal(size=B), np.zeros(B)], axis=-1),
        jnp.float32)
    z0s = jnp.zeros((B, 6), jnp.float32).at[:, 4].set(coeffs[:, 0]).at[
        :, 5].set(jnp.arctan(coeffs[:, 1]))
    res = sharded_horizon_solve(mesh, z0s, coeffs, p, cfg)
    ref = batch_solve(z0s, coeffs, p, cfg)
    us = np.asarray(ref.us)
    assert (np.abs(us[:, :, 0]) > 0.3 - 1e-7).sum() >= 10, "not saturated"
    # f32 + different iteration orders: 1e-3 is the framework's control
    # deviation spec (BASELINE.md)
    np.testing.assert_allclose(np.asarray(res.us), us, atol=1e-3)


def test_sharded_receding_rollout_matches_unsharded():
    """Sharded fleet serving (warm-start banks resident per device) equals
    the single-device receding rollout."""
    from mpc_ros_tpu.engine.receding import receding_horizon_rollout
    from mpc_ros_tpu.parallel import sharded_receding_rollout

    mesh = make_mesh(n_data=4, n_time=2)
    cfg = SolverConfig(n_steps=10, max_sqp_iters=8, tol_grad=1e-4)
    p = MPCParams().astype(jnp.float32)
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(2), 16,
                                        jnp.float32)
    tr, mean_cost, warm_iters = sharded_receding_rollout(
        mesh, z0s, coeffs, p, cfg, n_cycles=6)
    ref = receding_horizon_rollout(z0s, coeffs, p, cfg, n_cycles=6)
    np.testing.assert_allclose(np.asarray(tr.us), np.asarray(ref.us),
                               atol=1e-5)
    # warm starts actually engage: iterations after the cold cycle drop
    assert float(warm_iters) < float(jnp.mean(
        ref.iters[0].astype(jnp.float32)))


def test_sweep_ddp_ranks_correctly_and_beats_gn_iterations():
    """The tuning sweep's DDP correctness property (VERDICT r3 item 4,
    PERF.md): on the bench's fixed candidate draw, the DDP
    sweep must (a) keep selecting the same best candidate it selects on
    hardware (index 5 — GN mis-ranks to 4 because its unconverged
    extreme-weight solves inflate their cte estimates), and (b) spend
    FEWER mean iterations than GN on EVERY candidate — the
    machine-independent form of 'ddp within ~10% of the GN sweep time'.

    The 'scale-invariant gate' hypothesis for an apparent ddp sweep
    regression was censused and REFUTED (tools/probe_gate_scale*.py;
    PERF.md 'Tried and rejected'): the regression was session variance,
    and every weight-scaled gate variant measured worse or neutral. This test pins the properties the
    sweep actually needs."""
    import dataclasses

    from mpc_ros_tpu.engine.sweep import (sample_weight_candidates,
                                          tuning_sweep)

    cands = sample_weight_candidates(jax.random.PRNGKey(3), 8, MPCParams(),
                                     dtype=jnp.float32)
    cfg = SolverConfig(n_steps=30, max_sqp_iters=12, ls_iters=4, ddp=True,
                       tol_grad=1e-4)
    sw_ddp = tuning_sweep(jax.random.PRNGKey(4), cands, 1024, cfg)
    sw_gn = tuning_sweep(jax.random.PRNGKey(4), cands, 1024,
                         dataclasses.replace(cfg, ddp=False, ls_iters=5))
    assert sw_ddp.best_index == 5
    # GN's ranking is polluted by unconverged extreme-weight lanes
    assert float(jnp.min(sw_ddp.converged_frac)) > float(
        jnp.min(sw_gn.converged_frac))
    it_ddp = np.asarray(sw_ddp.mean_iters)
    it_gn = np.asarray(sw_gn.mean_iters)
    assert (it_ddp < it_gn).all(), (it_ddp, it_gn)


def test_presorted_solve_matches_direct():
    """Host-side difficulty presort (engine.presort): per-scenario solves
    are independent, so solving in difficulty order and restoring the
    caller order must reproduce the direct solve BIT-exactly; the fitted
    ridge keys must also beat the unsorted tile-max on the ensemble they
    were calibrated on (the mechanism's entire point)."""
    from mpc_ros_tpu.engine.presort import (fit_difficulty_model,
                                            predict_difficulty,
                                            solve_presorted)
    from mpc_ros_tpu.solver.batch_lane import batch_solve_lane

    B = 4096
    dtype = jnp.float32
    p = MPCParams().astype(dtype)
    cfg = SolverConfig(n_steps=30, max_sqp_iters=12, ls_iters=4, ddp=True,
                       tol_grad=1e-4)
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(11), B, dtype)
    direct = batch_solve_lane(z0s, coeffs, p, cfg)
    model = fit_difficulty_model(z0s, coeffs, np.asarray(direct.n_iters))

    zc, cc = make_random_scenarios(jax.random.PRNGKey(12), B, dtype)
    ref = batch_solve_lane(zc, cc, p, cfg)
    pres = solve_presorted(zc, cc, p, cfg, model=model)
    back = pres.unpermuted_host()
    np.testing.assert_array_equal(np.asarray(ref.us), back.us)
    np.testing.assert_array_equal(np.asarray(ref.n_iters), back.n_iters)
    np.testing.assert_array_equal(np.asarray(ref.converged), back.converged)

    # tile-max improvement on a held-out draw from the same distribution
    tile = 128   # CPU lane path: use the lane width as the tile proxy
    it = np.asarray(ref.n_iters, np.float64)
    keys = predict_difficulty(model, np.asarray(zc), np.asarray(cc))
    srt = it[np.argsort(keys, kind="stable")]
    tm_unsorted = it.reshape(-1, tile).max(1).mean()
    tm_sorted = srt.reshape(-1, tile).max(1).mean()
    assert tm_sorted < tm_unsorted - 0.3, (tm_sorted, tm_unsorted)


def test_tuning_sweep_presort_ranking_invariant():
    """Round-5: tuning_sweep presorts its shared scenario set by predicted
    difficulty (default on — the consumer is per-candidate reductions,
    permutation-invariant by construction). The ranking and statistics
    must match the unsorted sweep up to reduction-order f32 noise."""
    from mpc_ros_tpu.engine.sweep import (sample_weight_candidates,
                                          tuning_sweep)

    cands = sample_weight_candidates(jax.random.PRNGKey(3), 4, MPCParams(),
                                     dtype=jnp.float32)
    cfg = SolverConfig(n_steps=20, max_sqp_iters=12, tol_grad=1e-4)
    sw_s = tuning_sweep(jax.random.PRNGKey(4), cands, 512, cfg,
                        presort=True)
    sw_u = tuning_sweep(jax.random.PRNGKey(4), cands, 512, cfg,
                        presort=False)
    assert sw_s.best_index == sw_u.best_index
    np.testing.assert_allclose(np.asarray(sw_s.converged_frac),
                               np.asarray(sw_u.converged_frac), atol=1e-6)
    np.testing.assert_allclose(np.asarray(sw_s.mean_terminal_cte),
                               np.asarray(sw_u.mean_terminal_cte),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(sw_s.mean_iters),
                               np.asarray(sw_u.mean_iters),
                               rtol=1e-4, atol=1e-5)


def test_analytic_u_init_same_optima_fewer_iterations():
    """Round-5 opt-in cold-start init (engine.analytic_u_init): the
    proportional-steer guess reaches the SAME optimum on every lane of
    the bench ensemble with measurably fewer iterations than the zero
    cold start (the zero init stays the default for reference parity)."""
    from mpc_ros_tpu.engine import analytic_u_init
    from mpc_ros_tpu.solver.batch_lane import batch_solve_lane

    B = 1024
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), B)
    p = MPCParams().astype(jnp.float32)
    cfg = SolverConfig(n_steps=30, max_sqp_iters=12, tol_grad=1e-4,
                       backward="xla")
    r0 = batch_solve_lane(z0s, coeffs, p, cfg)
    u = analytic_u_init(z0s, coeffs, p, cfg)
    assert u.shape == (B, cfg.n_controls, 2)
    r1 = batch_solve_lane(z0s, coeffs, p, cfg, u_init=u)
    rel = np.abs(np.asarray(r1.cost) - np.asarray(r0.cost)) \
        / (1.0 + np.abs(np.asarray(r0.cost)))
    assert float((rel < 1e-3).mean()) == 1.0
    assert float(np.mean(np.asarray(r1.converged))) >= \
        float(np.mean(np.asarray(r0.converged)))
    assert (float(np.mean(np.asarray(r1.n_iters)))
            <= float(np.mean(np.asarray(r0.n_iters))) - 0.15)


def test_analytic_u_init_per_lane_bounds():
    """Per-robot (B,)-shaped control-bound leaves must broadcast into the
    (B, T, 2) guess ((2, B) bounds need the horizon axis inserted, not a
    flat broadcast_to) and clip each lane by ITS OWN bounds."""
    from mpc_ros_tpu.engine import analytic_u_init

    B = 256
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(3), B)
    wmax = np.full(B, 1.5, np.float32)
    wmax[::2] = 0.05                      # tight-steer half of the fleet
    p = MPCParams(max_angvel=jnp.asarray(wmax)).astype(jnp.float32)
    cfg = SolverConfig(n_steps=30)
    u = analytic_u_init(z0s, coeffs, p, cfg)
    assert u.shape == (B, cfg.n_controls, 2)
    w = np.asarray(u[:, :, 0])
    assert float(np.abs(w[::2]).max()) <= 0.05 + 1e-6
    # the loose half must not have been clipped by the tight bound
    assert float(np.abs(w[1::2]).max()) > 0.05
