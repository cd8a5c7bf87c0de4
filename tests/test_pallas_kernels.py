"""Whole-solve kernel tests (Pallas interpret mode on the CPU) against the
XLA lane solver, plus the wrapper's blocking, padding and lowering."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_ros_tpu.config import MPCParams, SolverConfig
from mpc_ros_tpu.solver import batch_lane as bl
from mpc_ros_tpu.kernels.backward_pallas import pack_params


def test_megakernel_interpret_matches_lane_solver():
    """Whole-solve megakernel (interpret mode) vs the XLA lane solver:
    same controls, convergence flags and iteration counts."""
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.kernels.backward_pallas import pack_params
    from mpc_ros_tpu.kernels.solve_pallas import solve_pallas

    dtype = jnp.float32
    B = 128
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), B, dtype)
    p = MPCParams().astype(dtype)
    cfg = SolverConfig(n_steps=12, max_sqp_iters=8, tol_grad=1e-3,
                       backward="xla", trig="exact")
    r_x = bl.batch_solve_lane(z0s, coeffs, p, cfg)

    zT = jnp.swapaxes(z0s, 0, 1)
    cT = jnp.swapaxes(coeffs, 0, 1)
    pp = pack_params(p, B, dtype)
    lb = jnp.broadcast_to(jnp.asarray([-1.0, -1.0], dtype)[:, None], (2, B))
    u0 = jnp.zeros((cfg.n_controls, 2, B), dtype)
    ss, us, cost, conv, iters, gnorm, mu, _done = solve_pallas(
        zT, cT, pp, lb, -lb, u0, cfg, interpret=True)
    du = float(jnp.max(jnp.abs(jnp.moveaxis(us, -1, 0) - r_x.us)))
    assert du < 2e-3, du
    np.testing.assert_allclose(np.asarray(conv),
                               np.asarray(r_x.converged, dtype=np.float32))
    np.testing.assert_allclose(
        np.asarray(iters), np.asarray(r_x.n_iters, dtype=np.float32))


def test_megakernel_wide_tile_interpret_matches_lane_solver():
    """A batch spread over several programs (16 blocks of 64 lanes) must
    agree with the XLA lane solver exactly like a single block does."""
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.kernels.backward_pallas import pack_params
    from mpc_ros_tpu.kernels.solve_pallas import lane_block, solve_pallas

    dtype = jnp.float32
    B = 1024
    assert lane_block(B) == 64 and lane_block(B, 1024) == 1024
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(2), B, dtype)
    p = MPCParams().astype(dtype)
    cfg = SolverConfig(n_steps=12, max_sqp_iters=6, tol_grad=1e-3,
                       backward="xla", trig="exact")
    r_x = bl.batch_solve_lane(z0s, coeffs, p, cfg)

    zT = jnp.swapaxes(z0s, 0, 1)
    cT = jnp.swapaxes(coeffs, 0, 1)
    pp = pack_params(p, B, dtype)
    lb = jnp.broadcast_to(jnp.asarray([-1.0, -1.0], dtype)[:, None], (2, B))
    u0 = jnp.zeros((cfg.n_controls, 2, B), dtype)
    ss, us, cost, conv, iters, gnorm, mu, _done = solve_pallas(
        zT, cT, pp, lb, -lb, u0, cfg, interpret=True)
    du = float(jnp.max(jnp.abs(jnp.moveaxis(us, -1, 0) - r_x.us)))
    assert du < 2e-3, du
    np.testing.assert_allclose(np.asarray(conv),
                               np.asarray(r_x.converged, dtype=np.float32))
    np.testing.assert_allclose(
        np.asarray(iters), np.asarray(r_x.n_iters, dtype=np.float32))


def test_megakernel_per_scenario_params_interpret():
    """Per-scenario MPCParams leaves (B,) must flow through the packed
    parameter tile: two different w_cte values in one batch produce the
    same controls as two separate uniform-param solves."""
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.kernels.backward_pallas import pack_params
    from mpc_ros_tpu.kernels.solve_pallas import solve_pallas

    dtype = jnp.float32
    B = 128
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(3), B, dtype)
    cfg = SolverConfig(n_steps=8, max_sqp_iters=5, tol_grad=1e-3,
                       backward="xla")
    w = jnp.where(jnp.arange(B) < B // 2, 40.0, 400.0).astype(dtype)
    p_swept = MPCParams(w_cte=w).astype(dtype)

    zT = jnp.swapaxes(z0s, 0, 1)
    cT = jnp.swapaxes(coeffs, 0, 1)
    lb = jnp.broadcast_to(jnp.asarray([-1.0, -1.0], dtype)[:, None], (2, B))
    u0 = jnp.zeros((cfg.n_controls, 2, B), dtype)
    _, us, *_ = solve_pallas(zT, cT, pack_params(p_swept, B, dtype),
                             lb, -lb, u0, cfg, interpret=True)

    for half, wv in ((slice(0, B // 2), 40.0), (slice(B // 2, B), 400.0)):
        p_u = MPCParams(w_cte=wv).astype(dtype)
        r = bl.batch_solve_lane(z0s[half], coeffs[half], p_u, cfg)
        du = float(jnp.max(jnp.abs(
            jnp.moveaxis(us[..., half], -1, 0) - r.us)))
        assert du < 2e-3, (wv, du)


def test_megakernel_done_frac_early_exit():
    """done_frac < 1 must reach the megakernel's per-tile exit: with a
    loose fraction the tile stops earlier (never later) than a full run
    and still returns finite, usable iterates."""
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.kernels.backward_pallas import pack_params
    from mpc_ros_tpu.kernels.solve_pallas import solve_pallas

    dtype = jnp.float32
    B = 128
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(5), B, dtype)
    p = MPCParams().astype(dtype)
    zT = jnp.swapaxes(z0s, 0, 1)
    cT = jnp.swapaxes(coeffs, 0, 1)
    pp = pack_params(p, B, dtype)
    lb = jnp.broadcast_to(jnp.asarray([-1.0, -1.0], dtype)[:, None], (2, B))
    u0 = jnp.zeros((11, 2, B), dtype)

    def run(frac):
        cfg = SolverConfig(n_steps=12, max_sqp_iters=20, tol_grad=1e-5,
                           done_frac=frac)
        out = solve_pallas(zT, cT, pp, lb, -lb, u0, cfg, interpret=True)
        return out[1], out[4]          # us, iters

    us_full, it_full = run(1.0)
    us_part, it_part = run(0.5)
    assert float(jnp.max(it_part)) <= float(jnp.max(it_full))
    assert float(jnp.max(it_part)) < 20.0  # actually exited early
    assert bool(jnp.all(jnp.isfinite(us_part)))


def test_megakernel_sorted_schedule_interpret():
    """Sorted two-pass schedule vs one long pass: same convergence quality,
    matching controls on converged lanes, per-lane iteration totals within
    the budget, and lane order restored after the sort/unsort."""
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.kernels.backward_pallas import pack_params
    from mpc_ros_tpu.kernels.solve_pallas import solve_pallas_scheduled

    dtype = jnp.float32
    B = 256
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(7), B, dtype)
    p = MPCParams().astype(dtype)
    zT = jnp.swapaxes(z0s, 0, 1)
    cT = jnp.swapaxes(coeffs, 0, 1)
    pp = pack_params(p, B, dtype)
    lb = jnp.broadcast_to(jnp.asarray([-1.0, -1.0], dtype)[:, None], (2, B))

    def run(schedule):
        cfg = SolverConfig(n_steps=12, max_sqp_iters=10, tol_grad=1e-3,
                           schedule=schedule, presolve_iters=3)
        u0 = jnp.zeros((cfg.n_controls, 2, B), dtype)
        return solve_pallas_scheduled(zT, cT, pp, lb, -lb, u0, cfg,
                                      interpret=True)

    ss1, us1, cost1, conv1, it1, gn1, mu1, done1 = run("single")
    ss2, us2, cost2, conv2, it2, gn2, mu2, done2 = run("sorted")

    # convergence quality preserved (mu/small-step state restarts at the
    # pass boundary, so per-lane flags may shift by a hair, not in bulk)
    f1 = float(jnp.mean(conv1))
    f2 = float(jnp.mean(conv2))
    assert f2 >= f1 - 0.05, (f1, f2)
    # lanes converged under BOTH schedules reached the same optimum
    both = (conv1 > 0.5) & (conv2 > 0.5)
    assert float(jnp.sum(both)) > 0.8 * B
    du = float(jnp.max(jnp.where(both[None, None, :],
                                 jnp.abs(us1 - us2), 0.0)))
    assert du < 2e-3, du
    # iteration totals: presolve + continuation never exceeds the budget
    assert float(jnp.max(it2)) <= 10.0 + 1e-6
    assert bool(jnp.all(jnp.isfinite(us2)))
    # costs line up lane-by-lane on converged lanes (order restored)
    dc = jnp.where(both, jnp.abs(cost1 - cost2)
                   / jnp.maximum(1.0, jnp.abs(cost1)), 0.0)
    assert float(jnp.max(dc)) < 1e-2


def test_megakernel_auto_schedule_small_batch_is_single_pass():
    """schedule='auto' below the batch threshold must be bit-identical to
    'single' (the scheduled driver falls through to one kernel call)."""
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.kernels.backward_pallas import pack_params
    from mpc_ros_tpu.kernels.solve_pallas import solve_pallas_scheduled

    dtype = jnp.float32
    B = 128
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(9), B, dtype)
    p = MPCParams().astype(dtype)
    zT = jnp.swapaxes(z0s, 0, 1)
    cT = jnp.swapaxes(coeffs, 0, 1)
    pp = pack_params(p, B, dtype)
    lb = jnp.broadcast_to(jnp.asarray([-1.0, -1.0], dtype)[:, None], (2, B))
    u0 = jnp.zeros((11, 2, B), dtype)

    outs = {}
    for schedule in ("auto", "single"):
        cfg = SolverConfig(n_steps=12, max_sqp_iters=8, tol_grad=1e-3,
                           schedule=schedule)
        outs[schedule] = solve_pallas_scheduled(
            zT, cT, pp, lb, -lb, u0, cfg, interpret=True)
    for a, b in zip(outs["auto"], outs["single"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_megakernel_fast_trig_matches_exact():
    """trig='fast' (transcendental-free rollouts: etheta=theta+phi identity
    + Taylor rotation composition) vs trig='exact': controls within f32
    solve noise, same convergence fraction."""
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.kernels.backward_pallas import pack_params
    from mpc_ros_tpu.kernels.solve_pallas import solve_pallas

    dtype = jnp.float32
    B = 256
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(11), B, dtype)
    p = MPCParams().astype(dtype)
    zT = jnp.swapaxes(z0s, 0, 1)
    cT = jnp.swapaxes(coeffs, 0, 1)
    pp = pack_params(p, B, dtype)
    lb = jnp.broadcast_to(jnp.asarray([-1.0, -1.0], dtype)[:, None], (2, B))
    u0 = jnp.zeros((11, 2, B), dtype)

    outs = {}
    for trig in ("fast", "exact"):
        cfg = SolverConfig(n_steps=12, max_sqp_iters=10, tol_grad=1e-3,
                           trig=trig)
        outs[trig] = solve_pallas(zT, cT, pp, lb, -lb, u0, cfg,
                                  interpret=True)
    us_f, us_e = outs["fast"][1], outs["exact"][1]
    conv_f, conv_e = outs["fast"][3], outs["exact"][3]
    both = (conv_f > 0.5) & (conv_e > 0.5)
    assert float(jnp.mean(both.astype(jnp.float32))) > 0.9
    du = float(jnp.max(jnp.where(both[None, None, :],
                                 jnp.abs(us_f - us_e), 0.0)))
    assert du < 5e-4, du
    assert abs(float(jnp.mean(conv_f)) - float(jnp.mean(conv_e))) < 0.05


def test_fast_trig_rotation_accuracy_at_domain_edge():
    """The Taylor rotation step must track exact sin/cos to ~1e-6 over a
    full rollout at the domain edge |omega*dt| = 1 rad/step."""
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.kernels.backward_pallas import pack_params
    from mpc_ros_tpu.kernels.solve_pallas import solve_pallas

    dtype = jnp.float32
    B = 128
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(13), B, dtype)
    p = MPCParams(max_angvel=10.0).astype(dtype)   # |omega*dt| up to 1.0
    zT = jnp.swapaxes(z0s, 0, 1)
    cT = jnp.swapaxes(coeffs, 0, 1)
    pp = pack_params(p, B, dtype)
    lb = jnp.broadcast_to(jnp.asarray([-10.0, -1.0], dtype)[:, None], (2, B))
    # saturated initial spin: every step rotates by the full 1 rad
    u0 = jnp.concatenate([jnp.full((11, 1, B), 10.0, dtype),
                          jnp.zeros((11, 1, B), dtype)], axis=1)

    outs = {}
    for trig in ("fast", "exact"):
        cfg = SolverConfig(n_steps=12, max_sqp_iters=1, ls_iters=1,
                           tol_grad=1e-9, trig=trig)
        outs[trig] = solve_pallas(zT, cT, pp, lb, -lb, u0, cfg,
                                  interpret=True)
    # one iteration from the same start: trajectories differ only by the
    # trig scheme
    ds = float(jnp.max(jnp.abs(outs["fast"][0] - outs["exact"][0])))
    assert ds < 1e-4, ds


def test_megakernel_bicycle_matches_lane_solver():
    """Bicycle-family megakernel (interpret mode) vs the XLA lane solver:
    the heading rows gain a v-dependence (A[2,3] = A[5,3] = delta*dt/lf,
    B rows 2/5 scale v/lf — models/bicycle.py) and the steering bound
    replaces max_angvel; controls, convergence and iteration counts must
    still match the lane path exactly like the diff-drive kernel does."""
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.kernels.backward_pallas import pack_params
    from mpc_ros_tpu.kernels.solve_pallas import solve_pallas
    from mpc_ros_tpu.models.base import get_model

    dtype = jnp.float32
    B = 128
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(7), B, dtype)
    p = MPCParams().astype(dtype)
    cfg = SolverConfig(n_steps=12, max_sqp_iters=8, tol_grad=1e-3,
                       backward="xla", trig="exact", model="bicycle")
    r_x = bl.batch_solve_lane(z0s, coeffs, p, cfg)

    zT = jnp.swapaxes(z0s, 0, 1)
    cT = jnp.swapaxes(coeffs, 0, 1)
    pp = pack_params(p, B, dtype)
    blb, _ = get_model("bicycle").control_bounds(p, dtype)
    lb = jnp.broadcast_to(blb[:, None], (2, B))
    u0 = jnp.zeros((cfg.n_controls, 2, B), dtype)
    ss, us, cost, conv, iters, gnorm, mu, _done = solve_pallas(
        zT, cT, pp, lb, -lb, u0, cfg, interpret=True)
    du = float(jnp.max(jnp.abs(jnp.moveaxis(us, -1, 0) - r_x.us)))
    assert du < 2e-3, du
    np.testing.assert_allclose(np.asarray(conv),
                               np.asarray(r_x.converged, dtype=np.float32))
    np.testing.assert_allclose(
        np.asarray(iters), np.asarray(r_x.n_iters, dtype=np.float32))


def test_megakernel_bicycle_per_lane_wheelbase():
    """The wheelbase rides the params pack (P_LF): a mixed-fleet batch with
    two lf values must reproduce the two uniform-lf solves — the megakernel
    sweep axis the bicycle family was added for."""
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.kernels.backward_pallas import pack_params
    from mpc_ros_tpu.kernels.solve_pallas import solve_pallas
    from mpc_ros_tpu.models.base import get_model

    dtype = jnp.float32
    B = 128
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(8), B, dtype)
    cfg = SolverConfig(n_steps=10, max_sqp_iters=6, tol_grad=1e-3,
                       backward="xla", trig="exact", model="bicycle")
    lf = jnp.where(jnp.arange(B) < B // 2, 0.3, 0.8).astype(dtype)
    p_swept = MPCParams(lf=lf).astype(dtype)

    zT = jnp.swapaxes(z0s, 0, 1)
    cT = jnp.swapaxes(coeffs, 0, 1)
    blb, _ = get_model("bicycle").control_bounds(p_swept, dtype)
    lb = jnp.broadcast_to(blb[:, None], (2, B))
    u0 = jnp.zeros((cfg.n_controls, 2, B), dtype)
    _, us, *_ = solve_pallas(zT, cT, pack_params(p_swept, B, dtype),
                             lb, -lb, u0, cfg, interpret=True)

    for half, lfv in ((slice(0, B // 2), 0.3), (slice(B // 2, B), 0.8)):
        p_u = MPCParams(lf=lfv).astype(dtype)
        r = bl.batch_solve_lane(z0s[half], coeffs[half], p_u, cfg)
        du = float(jnp.max(jnp.abs(
            jnp.moveaxis(us[..., half], -1, 0) - r.us)))
        assert du < 2e-3, (lfv, du)


def test_megakernel_bicycle_fast_trig():
    """Bicycle fast-trig mode: the heading increment is (v/lf)*delta*dt
    (state-dependent, unlike diff-drive's control-only omega*dt); the
    Taylor rotation carry must still agree with exact trig on converged
    lanes."""
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.kernels.backward_pallas import pack_params
    from mpc_ros_tpu.kernels.solve_pallas import solve_pallas
    from mpc_ros_tpu.models.base import get_model

    dtype = jnp.float32
    B = 128
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(9), B, dtype)
    p = MPCParams().astype(dtype)
    zT = jnp.swapaxes(z0s, 0, 1)
    cT = jnp.swapaxes(coeffs, 0, 1)
    pp = pack_params(p, B, dtype)
    blb, _ = get_model("bicycle").control_bounds(p, dtype)
    lb = jnp.broadcast_to(blb[:, None], (2, B))
    u0 = jnp.zeros((11, 2, B), dtype)

    outs = {}
    for trig in ("fast", "exact"):
        cfg = SolverConfig(n_steps=12, max_sqp_iters=8, tol_grad=1e-3,
                           trig=trig, model="bicycle")
        outs[trig] = solve_pallas(zT, cT, pp, lb, -lb, u0, cfg,
                                  interpret=True)
    us_f, us_e = outs["fast"][1], outs["exact"][1]
    conv_f, conv_e = outs["fast"][3], outs["exact"][3]
    both = (conv_f > 0.5) & (conv_e > 0.5)
    assert float(jnp.mean(both.astype(jnp.float32))) > 0.9
    du = float(jnp.max(jnp.where(both[None, None, :],
                                 jnp.abs(us_f - us_e), 0.0)))
    assert du < 5e-4, du


def test_megakernel_non_cubic_references():
    """The kernels must carry ANY polynomial order end-to-end (the specs
    once hard-coded 4 coefficient rows, silently truncating quartics):
    megakernel == XLA lane solver for P=3 (quadratic) and P=5 (quartic)."""
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.kernels.backward_pallas import pack_params
    from mpc_ros_tpu.kernels.solve_pallas import solve_pallas

    dtype = jnp.float32
    B = 128
    for order in (2, 4):
        cfg = SolverConfig(n_steps=10, max_sqp_iters=6, tol_grad=1e-3,
                           backward="xla", trig="exact", poly_order=order)
        z0s, c4 = make_random_scenarios(jax.random.PRNGKey(4), B, dtype)
        if order == 2:
            coeffs = c4[:, :3]
        else:
            coeffs = jnp.concatenate(
                [c4, jnp.full((B, 1), 0.05, dtype)], axis=1)
        r_x = bl.batch_solve_lane(z0s, coeffs, p := MPCParams().astype(dtype),
                                  cfg)
        zT = jnp.swapaxes(z0s, 0, 1)
        cT = jnp.swapaxes(coeffs, 0, 1)
        pp = pack_params(p, B, dtype)
        lb = jnp.broadcast_to(jnp.asarray([-1.0, -1.0], dtype)[:, None],
                              (2, B))
        u0 = jnp.zeros((cfg.n_controls, 2, B), dtype)
        _, us, *_ = solve_pallas(zT, cT, pp, lb, -lb, u0, cfg,
                                 interpret=True)
        du = float(jnp.max(jnp.abs(jnp.moveaxis(us, -1, 0) - r_x.us)))
        assert du < 2e-3, (order, du)
        # and the quartic term actually matters: a cubic-truncated solve
        # must differ (guards against silent truncation regressions)
        if order == 4:
            _, us3, *_ = solve_pallas(zT, cT[:4], pp, lb, -lb, u0, cfg,
                                      interpret=True)
            assert float(jnp.max(jnp.abs(us3 - us))) > 1e-4


def test_lane_solver_rejects_unknown_family():
    """Custom registry families must not silently get diff_drive dynamics
    on the lane path — they run engine.batch_solve instead."""
    import pytest
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.models.base import model_from_step
    from mpc_ros_tpu.models.diff_drive import step as dd_step

    model_from_step("testfam_lane", dd_step,
                    lambda p, dtype: (jnp.asarray([-1.0, -1.0], dtype),
                                      jnp.asarray([1.0, 1.0], dtype)))
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), 4, jnp.float32)
    cfg = SolverConfig(n_steps=8, model="testfam_lane")
    with pytest.raises(ValueError, match="lane-specialized"):
        bl.batch_solve_lane(z0s, coeffs, MPCParams().astype(jnp.float32), cfg)


def test_lane_solver_honors_asymmetric_bounds():
    """Model-provided (lb, ub) flow through unmodified (the lane path once
    assumed ub == -lb): a family with accel in [-0.2, +1.0] must saturate
    at +1.0 on a speed-up scenario and never exceed -0.2 braking."""
    from mpc_ros_tpu.models import bicycle, diff_drive
    from mpc_ros_tpu.models.base import Model, register_model

    asym = Model(
        name="dd_asym",
        step=diff_drive.MODEL.step,
        step_jacobians=diff_drive.MODEL.step_jacobians,
        aug_step=diff_drive.MODEL.aug_step,
        aug_step_jacobians=diff_drive.MODEL.aug_step_jacobians,
        control_bounds=lambda p, dtype: (
            jnp.asarray([-1.0, -0.2], dtype), jnp.asarray([1.0, 1.0], dtype)),
    )
    register_model(asym)
    import mpc_ros_tpu.solver.batch_lane as _bl

    # patch the family gate for this synthetic diff-drive twin
    orig = bl.batch_solve_lane
    z0 = jnp.asarray([[0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], jnp.float32)
    z0 = jnp.tile(z0, (4, 1))
    coeffs = jnp.zeros((4, 4), jnp.float32)
    p = MPCParams(ref_vel=2.0, w_vel=500.0).astype(jnp.float32)
    cfg = SolverConfig(n_steps=10, backward="xla")
    # simulate via the public diff_drive family but asymmetric params is
    # not expressible; instead call the internal path with the asym model
    # by monkeypatching get_model's return for 'diff_drive'
    import mpc_ros_tpu.models.base as base

    orig_get = base.get_model
    try:
        base.get_model = lambda name: asym if name == "diff_drive" \
            else orig_get(name)
        res = bl.batch_solve_lane(z0, coeffs, p, cfg)
    finally:
        base.get_model = orig_get
    us = np.asarray(res.us)
    assert us[..., 1].max() > 0.9          # saturates the +1.0 accel bound
    assert us[..., 1].min() >= -0.2 - 1e-6  # never below the -0.2 floor


def test_bicycle_fast_trig_extended_domain():
    """The bicycle's heading increment v/lf*delta*dt is not bounded by
    config like diff-drive's omega*dt; its fast-trig path runs the Taylor
    on the HALF angle + double-angle composition, staying accurate to
    ~1e-5 through |d| = 2 rad/step (v=10, lf=0.25, delta=0.5, dt=0.1)."""
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.kernels.backward_pallas import pack_params
    from mpc_ros_tpu.kernels.solve_pallas import solve_pallas
    from mpc_ros_tpu.models.base import get_model

    dtype = jnp.float32
    B = 128
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(11), B, dtype)
    z0s = z0s.at[:, 3].set(10.0)               # fast vehicle
    p = MPCParams(lf=0.25, max_steer=0.5, max_throttle=1.0).astype(dtype)
    zT = jnp.swapaxes(z0s, 0, 1)
    cT = jnp.swapaxes(coeffs, 0, 1)
    pp = pack_params(p, B, dtype)
    blb, _ = get_model("bicycle").control_bounds(p, dtype)
    lb = jnp.broadcast_to(blb[:, None], (2, B))
    # saturated steering at v=10: d = 10/0.25*0.5*0.1 = 2.0 rad/step
    u0 = jnp.concatenate([jnp.full((9, 1, B), 0.5, dtype),
                          jnp.zeros((9, 1, B), dtype)], axis=1)
    outs = {}
    for trig in ("fast", "exact"):
        cfg = SolverConfig(n_steps=10, max_sqp_iters=1, ls_iters=1,
                           tol_grad=1e-9, trig=trig, model="bicycle")
        outs[trig] = solve_pallas(zT, cT, pp, lb, -lb, u0, cfg,
                                  interpret=True)
    ds = float(jnp.max(jnp.abs(outs["fast"][0] - outs["exact"][0])))
    assert ds < 1e-3, ds


def test_megakernel_compact_schedule_interpret():
    """Compact straggler schedule vs one long pass: same solution on lanes
    converged under both, conv fraction preserved (the straggler pass gets
    a fresh budget, so it can only help), lane order restored."""
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.kernels.backward_pallas import pack_params
    from mpc_ros_tpu.kernels.solve_pallas import solve_pallas_scheduled

    dtype = jnp.float32
    B = 512
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(7), B, dtype)
    p = MPCParams().astype(dtype)
    zT = jnp.swapaxes(z0s, 0, 1)
    cT = jnp.swapaxes(coeffs, 0, 1)
    pp = pack_params(p, B, dtype)
    lb = jnp.broadcast_to(jnp.asarray([-1.0, -1.0], dtype)[:, None], (2, B))

    def run(schedule):
        cfg = SolverConfig(n_steps=12, max_sqp_iters=10, tol_grad=1e-3,
                           schedule=schedule, compact_frac=0.9,
                           compact_tail=0.25)
        u0 = jnp.zeros((cfg.n_controls, 2, B), dtype)
        return solve_pallas_scheduled(zT, cT, pp, lb, -lb, u0, cfg,
                                      interpret=True)

    ss1, us1, cost1, conv1, it1, gn1, mu1, done1 = run("single")
    ss2, us2, cost2, conv2, it2, gn2, mu2, done2 = run("compact")

    f1 = float(jnp.mean(conv1))
    f2 = float(jnp.mean(conv2))
    assert f2 >= f1 - 1e-6, (f1, f2)
    both = (conv1 > 0.5) & (conv2 > 0.5)
    assert float(jnp.sum(both)) > 0.8 * B
    du = float(jnp.max(jnp.where(both[None, None, :],
                                 jnp.abs(us1 - us2), 0.0)))
    assert du < 2e-3, du
    assert bool(jnp.all(jnp.isfinite(us2)))
    dc = float(jnp.max(jnp.where(both, jnp.abs(cost1 - cost2), 0.0)))
    assert dc < 1e-2 * (1.0 + float(jnp.max(jnp.abs(cost1)))), dc


def test_megakernel_refs_constant_profile_matches_scalar_setpoints():
    """A per-stage setpoint profile that just broadcasts the scalar
    (ref_cte, ref_etheta, ref_vel) params must reproduce the no-refs
    megakernel solve EXACTLY — the kernel reads the same values from the
    profile buffer instead of the params pack."""
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.kernels.backward_pallas import pack_params
    from mpc_ros_tpu.kernels.solve_pallas import solve_pallas

    dtype = jnp.float32
    B = 256
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(11), B, dtype)
    p = MPCParams().astype(dtype)
    cfg = SolverConfig(n_steps=10, max_sqp_iters=6, tol_grad=1e-3,
                       backward="xla", trig="exact")
    zT = jnp.swapaxes(z0s, 0, 1)
    cT = jnp.swapaxes(coeffs, 0, 1)
    pp = pack_params(p, B, dtype)
    lb = jnp.broadcast_to(jnp.asarray([-1.0, -1.0], dtype)[:, None], (2, B))
    u0 = jnp.zeros((cfg.n_controls, 2, B), dtype)
    base = solve_pallas(zT, cT, pp, lb, -lb, u0, cfg, interpret=True)
    ref_row = jnp.asarray([p.ref_cte, p.ref_etheta, p.ref_vel], dtype)
    refs = jnp.broadcast_to(ref_row[None, :, None],
                            (cfg.n_steps, 3, B)).astype(dtype)
    with_refs = solve_pallas(zT, cT, pp, lb, -lb, u0, cfg, interpret=True,
                             refs=refs)
    for a, b in zip(base, with_refs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_megakernel_refs_matches_vmap_ilqr_refs():
    """Megakernel per-stage setpoint profiles (interpret mode) vs the
    registry vmap path (engine.batch_solve(refs=...), which is
    oracle-tested in test_traj_refs.py): same controls on a ramped
    per-stage speed/cte profile."""
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.engine.batch import batch_solve
    from mpc_ros_tpu.kernels.backward_pallas import pack_params
    from mpc_ros_tpu.kernels.solve_pallas import solve_pallas

    dtype = jnp.float32
    B = 128
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(12), B, dtype)
    p = MPCParams().astype(dtype)
    cfg = SolverConfig(n_steps=10, max_sqp_iters=8, tol_grad=1e-3,
                       backward="xla", trig="exact")
    N = cfg.n_steps
    # ramped speed schedule + a slewing cte setpoint, different per lane
    tgrid = jnp.linspace(0.0, 1.0, N, dtype=dtype)
    v_prof = 0.2 + 0.6 * tgrid[None, :] * jnp.linspace(
        0.5, 1.0, B, dtype=dtype)[:, None]
    cte_prof = 0.1 * jnp.sin(3.0 * tgrid)[None, :] * jnp.ones((B, 1), dtype)
    refs_bm = jnp.stack(
        [cte_prof, jnp.zeros((B, N), dtype), v_prof], axis=-1)  # (B, N, 3)
    r_ref = batch_solve(z0s, coeffs, p, cfg, refs=refs_bm)

    zT = jnp.swapaxes(z0s, 0, 1)
    cT = jnp.swapaxes(coeffs, 0, 1)
    pp = pack_params(p, B, dtype)
    lb = jnp.broadcast_to(jnp.asarray([-1.0, -1.0], dtype)[:, None], (2, B))
    u0 = jnp.zeros((cfg.n_controls, 2, B), dtype)
    refsT = jnp.moveaxis(refs_bm, 0, -1)                        # (N, 3, B)
    ss, us, cost, conv, iters, gnorm, mu, _done = solve_pallas(
        zT, cT, pp, lb, -lb, u0, cfg, interpret=True, refs=refsT)
    du = float(jnp.max(jnp.abs(jnp.moveaxis(us, -1, 0) - r_ref.us)))
    assert du < 2e-3, du
    # the profile must actually matter: controls differ from the scalar-
    # setpoint solve
    base = solve_pallas(zT, cT, pp, lb, -lb, u0, cfg, interpret=True)
    assert float(jnp.max(jnp.abs(base[1] - us))) > 1e-3


def test_batch_solve_lane_refs_fallback_matches_vmap():
    """On non-kernel configurations batch_solve_lane(refs=...) delegates
    to engine.batch_solve — identical results. Since round 4 parametric
    blobs ride the fallback too (obstacle-aware trajectory tracking
    off-kernel, leaves (B, K) mapped per scenario); grid omaps still refuse
    instead of silently dropping terms."""
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.engine.batch import batch_solve
    from mpc_ros_tpu.models.obstacles import GaussianObstacles

    dtype = jnp.float32
    B = 16
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(13), B, dtype)
    p = MPCParams().astype(dtype)
    cfg = SolverConfig(n_steps=8, max_sqp_iters=6, backward="xla")
    N = cfg.n_steps
    refs = jnp.stack([jnp.zeros((B, N), dtype), jnp.zeros((B, N), dtype),
                      jnp.full((B, N), 0.4, dtype)], axis=-1)
    r_lane = bl.batch_solve_lane(z0s, coeffs, p, cfg, refs=refs)
    r_vmap = batch_solve(z0s, coeffs, p, cfg, refs=refs)
    np.testing.assert_allclose(np.asarray(r_lane.us), np.asarray(r_vmap.us),
                               atol=1e-6)
    blobs = GaussianObstacles(cx=jnp.full((B, 1), 0.4, dtype),
                              cy=jnp.full((B, 1), 0.1, dtype),
                              gamma=jnp.full((B, 1), 5.0, dtype),
                              w=jnp.full((B, 1), 20.0, dtype))
    r_lane_b = bl.batch_solve_lane(z0s, coeffs, p, cfg, refs=refs,
                                   blobs=blobs)
    r_vmap_b = batch_solve(z0s, coeffs, p, cfg, refs=refs, blobs=blobs)
    np.testing.assert_allclose(np.asarray(r_lane_b.us),
                               np.asarray(r_vmap_b.us), atol=1e-6)
    # the blob terms must actually matter
    assert float(jnp.max(jnp.abs(r_lane_b.us - r_lane.us))) > 1e-4
    # grid omaps on the refs fallback still refuse
    from mpc_ros_tpu.models.obstacles import gaussian_blob_map

    omaps = jax.vmap(lambda _: gaussian_blob_map((0.5, 0.1)))(
        jnp.arange(B, dtype=dtype))
    with pytest.raises(ValueError, match="grid omaps"):
        bl.batch_solve_lane(z0s, coeffs, p, cfg, refs=refs, omaps=omaps)


def test_schedule_auto_resolves_to_compact_at_long_horizon(monkeypatch):
    """"auto" resolves to the compact straggler schedule for
    n_steps > 36 (round 5: the long-horizon pair moved the measured
    crossover from >32 — single wins N=36, compact wins N=40 and up;
    see solve_pallas_scheduled) and stays the single pass at short
    horizons (where DDP collapsed the tail and compact measured
    slower)."""
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.kernels import solve_pallas as sp
    from mpc_ros_tpu.kernels.backward_pallas import pack_params

    dtype = jnp.float32
    B = 128
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(1), B, dtype)
    zT = jnp.swapaxes(z0s, 0, 1)
    cT = jnp.swapaxes(coeffs, 0, 1)
    pp = pack_params(MPCParams().astype(dtype), B, dtype)
    lb = jnp.broadcast_to(jnp.asarray([-1.0, -1.0], dtype)[:, None], (2, B))

    calls = []
    orig = sp._solve_compact

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(sp, "_solve_compact", spy)
    for n_steps, expect in ((38, 1), (34, 0), (12, 0)):
        calls.clear()
        cfg = SolverConfig(n_steps=n_steps, max_sqp_iters=2, ls_iters=2,
                           tol_grad=1e-3, schedule="auto")
        u0 = jnp.zeros((cfg.n_controls, 2, B), dtype)
        sp.solve_pallas_scheduled(zT, cT, pp, lb, -lb, u0, cfg,
                                  interpret=True)
        assert len(calls) == expect, (n_steps, calls)


def test_compact_pair_two_policy_rescue_interpret():
    """Round-5 two-policy compaction (long-horizon pair): pass 1 runs
    the fast (gate 1.5, mu 1e-2) policy, the straggler pass reverts the
    gate to 0.75 with a doubled budget, and pass-1 STALLED lanes
    re-enter the rescue (done cleared, mu reset). Pinned vs the single
    pass at the same auto config: conv never worse, finite outputs,
    same solution on mutually-converged same-basin lanes."""
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.kernels.backward_pallas import pack_params
    from mpc_ros_tpu.kernels.solve_pallas import solve_pallas_scheduled

    dtype = jnp.float32
    B = 2048
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(9), B, dtype)
    p = MPCParams().astype(dtype)
    zT = jnp.swapaxes(z0s, 0, 1)
    cT = jnp.swapaxes(coeffs, 0, 1)
    pp = pack_params(p, B, dtype)
    lb = jnp.broadcast_to(jnp.asarray([-1.0, -1.0], dtype)[:, None], (2, B))

    def run(schedule):
        # n_steps=38 > 36 so schedule="auto" genuinely resolves to the
        # compact path (review finding: at 34 the round-5 crossover move
        # made auto==single and this test compared single vs single)
        cfg = SolverConfig(n_steps=38, max_sqp_iters=6, tol_grad=1e-3,
                           schedule=schedule, compact_frac=0.9,
                           compact_tail=0.5)
        assert cfg._long_horizon_pair(dtype, False)
        u0 = jnp.zeros((cfg.n_controls, 2, B), dtype)
        return solve_pallas_scheduled(zT, cT, pp, lb, -lb, u0, cfg,
                                      interpret=True)

    from mpc_ros_tpu.kernels import solve_pallas as _sp

    calls = []
    orig_compact = _sp._solve_compact

    def _spy(*a, **k):
        calls.append(1)
        return orig_compact(*a, **k)

    _sp._solve_compact = _spy
    try:
        ss1, us1, cost1, conv1, it1, gn1, mu1, done1 = run("single")
        assert not calls
        ss2, us2, cost2, conv2, it2, gn2, mu2, done2 = run("auto")
        assert calls, "auto did not route through the compact rescue"
    finally:
        _sp._solve_compact = orig_compact
    f1, f2 = float(jnp.mean(conv1)), float(jnp.mean(conv2))
    assert f2 >= f1 - 1e-6, (f1, f2)
    assert bool(jnp.all(jnp.isfinite(us2)))
    both = (conv1 > 0.5) & (conv2 > 0.5)
    rel = jnp.abs(cost1 - cost2) / (1.0 + jnp.abs(cost1))
    same = both & (rel < 1e-3)
    assert float(jnp.mean(same.astype(jnp.float32))) > 0.8
    du = float(jnp.max(jnp.where(same[None, None, :],
                                 jnp.abs(us1 - us2), 0.0)))
    assert du < 5e-3, du


def test_compact_pair_rescue_weight_scale_equivariant():
    """Weight-scale equivariance THROUGH the compact pair path,
    stalled-lane rescue included: with weights uniformly scaled by a
    power of two (exact in f32, scale_adaptive on), the scheduled solve
    produces the SAME iterates — pinned lane-for-lane on the stalled
    lanes the rescue resets. The rescue's mu reset carries the per-lane
    weight scale (an unscaled reset resumes up-scaled lanes under-damped
    by s; on this ensemble the ceiling-stalled lanes re-reject either
    way, so the reset scaling is belt-and-braces consistency with the
    in-kernel scaled floor — this test pins the end-to-end equivariance
    property that any such divergence would break)."""
    import dataclasses as _dc

    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.kernels.solve_pallas import (solve_pallas,
                                                  solve_pallas_scheduled)

    dtype = jnp.float32
    B = 1024
    # harder draw than the bench ensemble: at cap 6 / tol 1e-4 it leaves
    # a couple of genuinely STALLED pass-1 lanes (done, unconverged) —
    # the class whose mu the rescue resets (probed; asserted below)
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(9), B, dtype,
                                        pose_scale=0.8, curve_scale=0.6)
    zT = jnp.swapaxes(z0s, 0, 1)
    cT = jnp.swapaxes(coeffs, 0, 1)
    lb = jnp.broadcast_to(jnp.asarray([-1.0, -1.0], dtype)[:, None], (2, B))
    wnames = {"w_cte", "w_etheta", "w_vel", "w_angvel", "w_accel",
              "w_angvel_d", "w_accel_d"}
    p1 = MPCParams().astype(dtype)
    # c=32: a large power-of-two scale makes the un-scaled rescue
    # reset's damping gap (1e-2 vs 0.32) big enough to flip f32 iterates
    c = 32.0
    p2 = MPCParams(**{
        f.name: (getattr(p1, f.name) * c if f.name in wnames
                 else getattr(p1, f.name))
        for f in _dc.fields(MPCParams)})
    # auto resolves to the compact pair at N=38; the tight cap +
    # fractions route lanes through pass 2
    # mu_max=1.0: a low ceiling makes the rejected hard lanes hit the
    # stall verdict inside the cap (the default 1e8 ceiling is never
    # reached in 6 iterations) — with scale_adaptive the ceiling scales
    # with s, so the stall pattern itself is equivariant
    cfg = SolverConfig(n_steps=38, max_sqp_iters=6, tol_grad=1e-4,
                       schedule="auto", compact_frac=0.9, compact_tail=0.5,
                       mu_max=1.0)
    assert cfg._long_horizon_pair(dtype, False)
    u0 = jnp.zeros((cfg.n_controls, 2, B), dtype)

    def run(p):
        pp = pack_params(p, B, dtype)
        return solve_pallas_scheduled(zT, cT, pp, lb, -lb, u0, cfg,
                                      interpret=True)

    # pass-1-only replica: identify the stalled lanes the rescue resets
    cfg1 = _dc.replace(cfg, schedule="single", done_frac=cfg.compact_frac)
    pp1 = pack_params(p1, B, dtype)
    _, _, _, cv_p1, _, _, _, dn_p1 = solve_pallas(
        zT, cT, pp1, lb, -lb, u0, cfg1, dtype=dtype, interpret=True)
    stalled = np.asarray((dn_p1 > 0.5) & (cv_p1 < 0.5))
    assert stalled.sum() >= 1, "ensemble no longer stalls — re-probe"

    ss1, us1, cost1, conv1, it1, gn1, mu1, done1 = run(p1)
    ss2, us2, cost2, conv2, it2, gn2, mu2, done2 = run(p2)
    i1, i2 = np.asarray(it1), np.asarray(it2)
    same = i1 == i2
    assert same.mean() >= 0.98, same.mean()
    np.testing.assert_array_equal(np.asarray(us1)[..., same],
                                  np.asarray(us2)[..., same])
    np.testing.assert_allclose(np.asarray(cost2), c * np.asarray(cost1),
                               rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(conv1)[same],
                                  np.asarray(conv2)[same])
    # the rescued (stalled) lanes themselves must be equivariant — the
    # unscaled mu reset diverged exactly these
    np.testing.assert_array_equal(i1[stalled], i2[stalled])
    np.testing.assert_array_equal(np.asarray(us1)[..., stalled],
                                  np.asarray(us2)[..., stalled])
