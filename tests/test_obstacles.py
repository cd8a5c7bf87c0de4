"""Obstacle costmap penalty tests."""

import jax
import jax.numpy as jnp
import numpy as np

from mpc_ros_tpu.config import MPCParams, SolverConfig
from mpc_ros_tpu.models.obstacles import (bilinear_sample,
                                          gaussian_blob_map, obstacle_cost,
                                          obstacle_grad_xy)
from mpc_ros_tpu.solver import ilqr


def test_bilinear_sample_exact_on_grid_points():
    grid = jnp.asarray(np.arange(16, dtype=np.float64).reshape(4, 4))
    origin = jnp.asarray([0.0, 0.0])
    res = 1.0
    for iy in range(3):
        for ix in range(3):
            v = bilinear_sample(grid, origin, res,
                                jnp.asarray([float(ix), float(iy)]))
            assert float(v) == float(grid[iy, ix])
    # midpoint average
    v = bilinear_sample(grid, origin, res, jnp.asarray([0.5, 0.5]))
    assert float(v) == float((grid[0, 0] + grid[0, 1] + grid[1, 0] + grid[1, 1]) / 4)


def test_grad_matches_autodiff_inside_cells():
    omap = gaussian_blob_map((0.5, -0.2), weight=10.0, dtype=jnp.float64)
    pts = jnp.asarray([[0.33, 0.11], [0.81, -0.44], [-0.7, 0.9]])
    g = obstacle_grad_xy(omap, pts)
    for i in range(len(pts)):
        g_ad = jax.grad(lambda xy: obstacle_cost(omap, xy))(pts[i])
        np.testing.assert_allclose(np.asarray(g[i]), np.asarray(g_ad),
                                   rtol=1e-9, atol=1e-9)


def test_outside_map_is_free():
    omap = gaussian_blob_map((0.0, 0.0), weight=10.0, dtype=jnp.float64)
    # far outside: clamped border cells are ~0 for a centered blob
    v = obstacle_cost(omap, jnp.asarray([[100.0, 100.0]]))
    assert float(v) < 1e-6


def test_solver_steers_around_obstacle():
    """A blob on the straight-ahead path must push the optimal trajectory
    sideways vs the obstacle-free solve."""
    dtype = jnp.float64
    z0 = jnp.asarray([0.0, 0.0, 0.0, 0.5, 0.0, 0.0], dtype)
    coeffs = jnp.zeros((4,), dtype)          # straight reference y=0
    p = MPCParams(ref_vel=0.5, w_cte=50.0).astype(dtype)
    cfg = SolverConfig(n_steps=20)
    free = ilqr.solve(z0, coeffs, p, cfg)
    # blob slightly off-axis: a local method cannot break an exact symmetry
    # (zero lateral gradient on the ridge), matching iLQR semantics
    omap = gaussian_blob_map((0.6, 0.05), sigma=0.25, weight=200.0,
                             dtype=dtype)
    blocked = ilqr.solve(z0, coeffs, p, cfg, omap=omap)
    # free solution hugs y=0; blocked one must deviate laterally AWAY from
    # the blob (negative y)
    max_dev_free = float(jnp.max(jnp.abs(free.zs[:, 1])))
    assert max_dev_free < 0.02
    assert float(jnp.min(blocked.zs[:, 1])) < -0.03
    # and the blocked trajectory has lower TOTAL (tracking+obstacle) cost
    # than the free trajectory evaluated under the obstacle
    from mpc_ros_tpu.solver.ilqr import _traj_cost
    J_free_under_obs = float(_traj_cost(free.zs, free.us, p, omap))
    assert float(blocked.cost) < J_free_under_obs


def test_batched_obstacle_solves():
    dtype = jnp.float32
    B = 8
    z0s = jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 0.5, 0.0, 0.0], dtype), (B, 1))
    coeffs = jnp.zeros((B, 4), dtype)
    p = MPCParams(ref_vel=0.5, w_cte=50.0).astype(dtype)
    cfg = SolverConfig(n_steps=10, tol_grad=1e-3)
    centers = jnp.stack([jnp.linspace(0.3, 1.0, B),
                         jnp.zeros((B,), dtype)], axis=-1)
    omaps = jax.vmap(lambda c: gaussian_blob_map(
        (c[0], c[1]), sigma=0.25, weight=100.0, dtype=dtype))(centers)
    res = jax.vmap(lambda z, c, m: ilqr.solve(z, c, p, cfg, omap=m))(
        z0s, coeffs, omaps)
    assert res.us.shape == (B, 9, 2)
    assert bool(jnp.all(jnp.isfinite(res.cost)))


def test_lane_solver_obstacles_match_vmapped():
    """Lane solver with batched obstacle maps must agree with the vmapped
    per-scenario obstacle solves."""
    from mpc_ros_tpu.solver.batch_lane import batch_solve_lane

    dtype = jnp.float64
    B = 8
    z0s = jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 0.5, 0.0, 0.0], dtype), (B, 1))
    coeffs = jnp.zeros((B, 4), dtype)
    p = MPCParams(ref_vel=0.5, w_cte=50.0).astype(dtype)
    cfg = SolverConfig(n_steps=10)
    centers = jnp.stack([jnp.linspace(0.3, 1.0, B),
                         jnp.full((B,), 0.05, dtype)], axis=-1)
    omaps = jax.vmap(lambda c: gaussian_blob_map(
        (c[0], c[1]), sigma=0.25, weight=100.0, dtype=dtype))(centers)
    r_vm = jax.vmap(lambda z, c, m: ilqr.solve(z, c, p, cfg, omap=m))(
        z0s, coeffs, omaps)
    r_ln = batch_solve_lane(z0s, coeffs, p, cfg, omaps=omaps)
    np.testing.assert_allclose(np.asarray(r_ln.us), np.asarray(r_vm.us),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(r_ln.cost), np.asarray(r_vm.cost),
                               rtol=1e-8)


def test_lane_obstacle_sampling_matches_single():
    """obstacle_cost_grad_bl must agree with the per-map functions."""
    from mpc_ros_tpu.models.obstacles import obstacle_cost_grad_bl

    dtype = jnp.float64
    B = 4
    centers = jnp.stack([jnp.linspace(-0.5, 0.6, B),
                         jnp.linspace(0.2, -0.3, B)], axis=-1)
    omaps = jax.vmap(lambda c: gaussian_blob_map(
        (c[0], c[1]), weight=7.0, dtype=dtype))(centers)
    rng = np.random.default_rng(0)
    pts = jnp.asarray(rng.uniform(-1.5, 1.5, size=(5, 2, B)))
    val, dx, dy = obstacle_cost_grad_bl(omaps, pts[:, 0], pts[:, 1])
    for b in range(B):
        omap_b = jax.tree.map(lambda leaf: leaf[b], omaps)
        for i in range(5):
            xy = jnp.asarray([pts[i, 0, b], pts[i, 1, b]])
            v_ref = obstacle_cost(omap_b, xy[None])
            g_ref = obstacle_grad_xy(omap_b, xy)
            np.testing.assert_allclose(float(val[i, b]), float(v_ref),
                                       rtol=1e-10)
            np.testing.assert_allclose(
                [float(dx[i, b]), float(dy[i, b])],
                np.asarray(g_ref), rtol=1e-10, atol=1e-12)


# ----------------------------- parametric (Gaussian-blob) obstacle path


def _mk_blobs(B, dtype, cx=0.6, cy=0.05, sigma=0.25, w=100.0, K=2):
    """B scenarios x K blobs; the second blob is far away (inert)."""
    from mpc_ros_tpu.models.obstacles import GaussianObstacles

    cxs = jnp.stack([jnp.full((B,), cx, dtype),
                     jnp.full((B,), 50.0, dtype)], axis=-1)[:, :K]
    cys = jnp.stack([jnp.full((B,), cy, dtype),
                     jnp.full((B,), 50.0, dtype)], axis=-1)[:, :K]
    return GaussianObstacles.from_sigmas(
        cxs, cys, jnp.full((B, K), sigma, dtype), jnp.full((B, K), w, dtype))


def test_blob_terms_match_autodiff():
    """blob_terms_bl value+gradient vs autodiff of the scalar blob cost."""
    from mpc_ros_tpu.models.obstacles import (GaussianObstacles, blob_cost,
                                              blob_terms_bl)

    dtype = jnp.float64
    rng = np.random.default_rng(1)
    B, K = 3, 4
    blobs = GaussianObstacles.from_sigmas(
        jnp.asarray(rng.uniform(-1, 1, (B, K))),
        jnp.asarray(rng.uniform(-1, 1, (B, K))),
        jnp.asarray(rng.uniform(0.2, 0.6, (B, K))),
        jnp.asarray(rng.uniform(1.0, 30.0, (B, K))))
    pts = jnp.asarray(rng.uniform(-1.5, 1.5, (5, 2, B)))
    val, gx, gy, hxx, hxy, hyy = blob_terms_bl(
        *blobs.lane(), pts[:, 0], pts[:, 1])
    for b in range(B):
        single = jax.tree.map(lambda leaf: leaf[b], blobs)
        for i in range(5):
            xy = jnp.asarray([pts[i, 0, b], pts[i, 1, b]])
            v_ref = blob_cost(single, xy[None])
            g_ref = jax.grad(lambda q: blob_cost(single, q[None]))(xy)
            np.testing.assert_allclose(float(val[i, b]), float(v_ref),
                                       rtol=1e-12)
            np.testing.assert_allclose(
                [float(gx[i, b]), float(gy[i, b])], np.asarray(g_ref),
                rtol=1e-12, atol=1e-14)
    # GN curvature is the PSD part: h = 4 g^2 v d d^T => hxx*hyy >= hxy^2
    assert bool(jnp.all(hxx * hyy >= hxy**2 - 1e-12))
    assert bool(jnp.all(hxx >= 0)) and bool(jnp.all(hyy >= 0))


def test_lane_blob_solver_steers_around_obstacle():
    from mpc_ros_tpu.solver.batch_lane import batch_solve_lane

    dtype = jnp.float64
    B = 4
    z0s = jnp.tile(jnp.asarray([0.0, 0.0, 0.0, 0.5, 0.0, 0.0], dtype), (B, 1))
    coeffs = jnp.zeros((B, 4), dtype)
    p = MPCParams(ref_vel=0.5, w_cte=50.0).astype(dtype)
    cfg = SolverConfig(n_steps=20)
    free = batch_solve_lane(z0s, coeffs, p, cfg)
    blobs = _mk_blobs(B, dtype, w=200.0)
    blocked = batch_solve_lane(z0s, coeffs, p, cfg, blobs=blobs)
    assert float(jnp.max(jnp.abs(free.zs[:, :, 1]))) < 0.02
    assert float(jnp.min(blocked.zs[:, :, 1])) < -0.03
    assert bool(jnp.all(blocked.converged))


def test_lane_blob_solver_matches_oracle():
    """Blob-penalized lane solve vs the float64 scipy oracle on the SAME
    penalized NLP (exact gradient; GN curvature only changes the path to
    the optimum, not the optimum)."""
    from mpc_ros_tpu.models.obstacles import blob_cost
    from mpc_ros_tpu.solver.batch_lane import batch_solve_lane
    from mpc_ros_tpu.solver.oracle import solve_oracle

    dtype = jnp.float64
    z0 = np.array([0.0, 0.0, 0.0, 0.5, 0.0, 0.0])
    coeffs = np.array([0.0, 0.1, 0.0, 0.0])
    p = MPCParams(ref_vel=0.5, w_cte=50.0).astype(dtype)
    cfg = SolverConfig(n_steps=10)
    blobs = _mk_blobs(1, dtype, cx=0.5, cy=0.12, sigma=0.3, w=40.0)
    single = jax.tree.map(lambda leaf: leaf[0], blobs)

    def extra(zs, us):
        return blob_cost(single, zs[:, :2])

    orc = solve_oracle(z0, coeffs, p, cfg, extra_cost=extra)
    assert orc.success
    r = batch_solve_lane(jnp.asarray(z0, dtype)[None],
                         jnp.asarray(coeffs, dtype)[None], p, cfg,
                         blobs=blobs)
    np.testing.assert_allclose(np.asarray(r.us[0]), orc.us, atol=5e-5)


def test_megakernel_blobs_interpret_matches_xla_lane():
    """Megakernel with blob terms (interpret mode) vs the XLA lane solver
    with the same blobs: same controls / flags / iteration counts."""
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.kernels.backward_pallas import pack_params
    from mpc_ros_tpu.kernels.solve_pallas import solve_pallas
    from mpc_ros_tpu.solver.batch_lane import batch_solve_lane

    dtype = jnp.float32
    B = 128
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), B, dtype)
    p = MPCParams().astype(dtype)
    cfg = SolverConfig(n_steps=12, max_sqp_iters=8, tol_grad=1e-3,
                       backward="xla", trig="exact")
    blobs = _mk_blobs(B, dtype, cx=0.4, cy=0.1, sigma=0.3, w=30.0)
    r_x = batch_solve_lane(z0s, coeffs, p, cfg, blobs=blobs)

    zT = jnp.swapaxes(z0s, 0, 1)
    cT = jnp.swapaxes(coeffs, 0, 1)
    pp = pack_params(p, B, dtype)
    lb = jnp.broadcast_to(jnp.asarray([-1.0, -1.0], dtype)[:, None], (2, B))
    u0 = jnp.zeros((cfg.n_controls, 2, B), dtype)
    ss, us, cost, conv, iters, gnorm, mu, _done = solve_pallas(
        zT, cT, pp, lb, -lb, u0, cfg, interpret=True, blobs=blobs.lane())
    du = float(jnp.max(jnp.abs(jnp.moveaxis(us, -1, 0) - r_x.us)))
    assert du < 2e-3, du
    np.testing.assert_allclose(np.asarray(conv),
                               np.asarray(r_x.converged, dtype=np.float32))
    np.testing.assert_allclose(
        np.asarray(iters), np.asarray(r_x.n_iters, dtype=np.float32))


def test_fit_gaussians_recovers_grid_blob():
    """Greedy peak peeling on a one-blob grid recovers center/field."""
    from mpc_ros_tpu.models.obstacles import (blob_cost, fit_gaussians_to_map,
                                              obstacle_cost)

    omap = gaussian_blob_map((0.5, -0.3), sigma=0.35, weight=20.0,
                             dtype=jnp.float64)
    fit = fit_gaussians_to_map(omap, n_blobs=2)
    assert abs(float(fit.cx[0]) - 0.5) < 0.07
    assert abs(float(fit.cy[0]) + 0.3) < 0.07
    rng = np.random.default_rng(2)
    pts = jnp.asarray(rng.uniform(-1.0, 1.0, (64, 2)))
    v_grid = np.asarray([float(obstacle_cost(omap, pts[i:i + 1]))
                         for i in range(len(pts))])
    v_blob = np.asarray([float(blob_cost(fit, pts[i:i + 1]))
                         for i in range(len(pts))])
    # field agreement within 10% of the peak penalty
    assert np.max(np.abs(v_grid - v_blob)) < 0.1 * 20.0


def test_planner_tracking_with_costmap_steers_away():
    """The live planner consumes a robot-frame costmap: with a blob ahead
    slightly left, the commanded angular velocity must steer right
    relative to the obstacle-free command."""
    from mpc_ros_tpu.config import PlannerConfig
    from mpc_ros_tpu.planner import MPCPlanner

    p = MPCParams(dt=0.1, ref_vel=0.5, w_cte=50.0)
    plan = np.stack([np.linspace(0, 5, 100), np.zeros(100),
                     np.zeros(100)], axis=1)

    def run(with_map):
        planner = MPCPlanner(params=p, solver_cfg=SolverConfig(n_steps=10),
                             planner_cfg=PlannerConfig(local_plan_length=2.0,
                                                       delay_mode=False))
        planner.initialize()
        planner.set_plan(plan, np.array([0.0, 0.0, 0.0]))
        if with_map:
            planner.tracker.obstacle_map = gaussian_blob_map(
                (0.6, 0.06), sigma=0.25, weight=300.0, dtype=jnp.float64)
        ok, (v, w), info = planner.compute_velocity_commands(
            np.array([0.0, 0.0, 0.0]), (0.5, 0.0))
        assert ok
        return w

    w_free = run(False)
    w_obs = run(True)
    assert w_obs < w_free - 1e-3, (w_free, w_obs)


def test_planner_tracking_with_blobs_steers_away():
    """Same as the costmap planner test but with the parametric obstacle
    field set on the tracker; also checks warm-started cycles recompile
    nothing (same jitted callable both cycles)."""
    from mpc_ros_tpu.config import PlannerConfig
    from mpc_ros_tpu.models.obstacles import GaussianObstacles
    from mpc_ros_tpu.planner import MPCPlanner

    p = MPCParams(dt=0.1, ref_vel=0.5, w_cte=50.0)
    plan = np.stack([np.linspace(0, 5, 100), np.zeros(100),
                     np.zeros(100)], axis=1)

    def run(with_blobs):
        planner = MPCPlanner(params=p, solver_cfg=SolverConfig(n_steps=10),
                             planner_cfg=PlannerConfig(local_plan_length=2.0,
                                                       delay_mode=False))
        planner.initialize()
        planner.set_plan(plan, np.array([0.0, 0.0, 0.0]))
        if with_blobs:
            # world-frame via the public API (the tracker snapshot is
            # re-derived from world_obstacles every cycle; the robot pose
            # is the origin here, so world == robot frame)
            planner.set_obstacles(GaussianObstacles.from_sigmas(
                jnp.asarray([0.6]), jnp.asarray([0.06]),
                jnp.asarray([0.25]), jnp.asarray([300.0])))
        ws = []
        for _ in range(2):   # cold then warm-started cycle
            ok, (v, w), info = planner.compute_velocity_commands(
                np.array([0.0, 0.0, 0.0]), (0.5, 0.0))
            assert ok
            ws.append(w)
        return ws

    w_free = run(False)
    w_obs = run(True)
    assert w_obs[0] < w_free[0] - 1e-3, (w_free, w_obs)
    assert w_obs[1] < w_free[1] - 1e-3, (w_free, w_obs)


def test_spline_sampling_c1_and_convergence():
    """sampling="spline" (round 4): the C1 quadratic-B-spline costmap
    reconstruction must (a) carry a continuous analytic gradient (matches
    the numeric derivative of its own value field), (b) approximate the
    grid field within the documented ~1-cell smoothing, and (c) fix the
    kink-certificate class: conv >= 0.99 on the bench grid ensemble where
    bilinear reads ~0.95 (the round-2/3 weak corner)."""
    import jax

    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.models.obstacles import (_spline_terms_xy,
                                              gaussian_blob_map)
    from mpc_ros_tpu.solver.batch_lane import batch_solve_lane

    omap = gaussian_blob_map((0.8, 0.5), sigma=0.3, weight=100.0,
                             sampling="spline")
    xs = np.linspace(0.55, 0.75, 801)
    pts = jnp.asarray(np.stack([xs, np.full_like(xs, 0.4)], -1))
    val, dx, _, hxx, hyy = _spline_terms_xy(omap, pts)
    num_dx = np.gradient(np.asarray(val), xs)
    scale = np.abs(num_dx).max()
    assert np.max(np.abs(np.asarray(dx)[5:-5] - num_dx[5:-5])) < 2e-3 * scale
    assert (np.asarray(hxx) >= 0).all() and (np.asarray(hyy) >= 0).all()

    # approximation: spline field within ~1-cell smoothing of the truth
    omap_b = gaussian_blob_map((0.8, 0.5), sigma=0.3, weight=100.0)
    from mpc_ros_tpu.models.obstacles import obstacle_cost

    grid_pts = jnp.asarray(np.stack(np.meshgrid(np.linspace(-1, 2, 40),
                                                np.linspace(-1, 2, 40)),
                                    -1).reshape(-1, 2))
    vs = np.asarray(jax.vmap(lambda q: obstacle_cost(omap, q[None]))(grid_pts))
    vb = np.asarray(jax.vmap(lambda q: obstacle_cost(omap_b, q[None]))(grid_pts))
    assert np.max(np.abs(vs - vb)) < 0.05 * vb.max()

    # convergence on the bench grid ensemble (small B CPU slice)
    B = 1024
    dtype = jnp.float32
    p = MPCParams().astype(dtype)
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), B, dtype)
    centers = jax.random.uniform(jax.random.PRNGKey(1), (B, 2), dtype,
                                 0.3, 1.2)
    cfg = SolverConfig(n_steps=30, max_sqp_iters=30, ls_iters=4,
                       tol_grad=1e-4, ddp=True)
    convs = {}
    for samp in ("bilinear", "spline"):
        omaps = jax.vmap(lambda c: gaussian_blob_map(
            (c[0], c[1]), sigma=0.3, weight=100.0,
            sampling=samp))(centers)
        r = batch_solve_lane(z0s, coeffs, p, cfg, omaps=omaps)
        convs[samp] = float(np.mean(np.asarray(r.converged)))
    assert convs["spline"] >= 0.99, convs
    assert convs["spline"] > convs["bilinear"], convs


def test_spline_coeff_planes_match_stencil():
    """Round-5 (VERDICT r4 item 4): precomputed per-cell bi-quadratic
    coefficient planes evaluate the SAME spline surface as the 9-tap
    stencil — value, gradient, curvature, masks — on both the unbatched
    and the lane-major batched paths, including the border strip and
    out-of-map points."""
    import jax

    from mpc_ros_tpu.models.obstacles import (ObstacleMap,
                                              _spline_terms_bl,
                                              _spline_terms_xy,
                                              gaussian_blob_map)

    omap = gaussian_blob_map((0.4, -0.2), sigma=0.35, extent=4.0,
                             cells=32, weight=70.0, sampling="spline")
    omap_c = omap.with_spline_coeffs()
    rng = np.random.default_rng(0)
    # interior, border strip, and out-of-map points
    pts = np.concatenate([
        rng.uniform(-1.8, 1.8, (200, 2)),
        rng.uniform(1.9, 2.4, (50, 2)) * rng.choice([-1, 1], (50, 2)),
    ]).astype(np.float32)
    a = _spline_terms_xy(omap, jnp.asarray(pts))
    b = _spline_terms_xy(omap_c, jnp.asarray(pts))
    for ta, tb in zip(a, b):
        np.testing.assert_allclose(np.asarray(ta), np.asarray(tb),
                                   rtol=1e-4, atol=1e-3)

    # batched lane path: B maps, batch-last points
    B = 8
    centers = rng.uniform(-0.8, 0.8, (B, 2)).astype(np.float32)
    mk = lambda samp: jax.vmap(lambda c: gaussian_blob_map(
        (c[0], c[1]), sigma=0.35, cells=32, weight=70.0,
        sampling=samp))(jnp.asarray(centers))
    om_b = mk("spline")
    om_cb = mk("spline_coeff")
    assert om_cb.coeff is not None and om_cb.coeff.shape == (B, 32, 32, 9)
    x = jnp.asarray(rng.uniform(-2.2, 2.2, (40, B)).astype(np.float32))
    y = jnp.asarray(rng.uniform(-2.2, 2.2, (40, B)).astype(np.float32))
    for ta, tb in zip(_spline_terms_bl(om_b, x, y),
                      _spline_terms_bl(om_cb, x, y)):
        np.testing.assert_allclose(np.asarray(ta), np.asarray(tb),
                                   rtol=1e-4, atol=1e-3)


def test_spline_coeff_solver_path():
    """The coefficient-plane maps run through the batched grid solver with
    the same results as the stencil maps (same surface -> same optima)."""
    import jax

    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.models.obstacles import gaussian_blob_map
    from mpc_ros_tpu.solver.batch_lane import batch_solve_lane

    B = 128
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), B)
    centers = jax.random.uniform(jax.random.PRNGKey(1), (B, 2),
                                 jnp.float32, 0.3, 1.2)
    mk = lambda samp: jax.vmap(lambda c: gaussian_blob_map(
        (c[0], c[1]), sigma=0.3, weight=100.0,
        sampling=samp))(centers)
    p = MPCParams().astype(jnp.float32)
    cfg = SolverConfig(n_steps=20, max_sqp_iters=20, tol_grad=1e-4)
    r_s = batch_solve_lane(z0s, coeffs, p, cfg, omaps=mk("spline"))
    r_c = batch_solve_lane(z0s, coeffs, p, cfg, omaps=mk("spline_coeff"))
    assert float(np.mean(np.asarray(r_c.converged))) >= 0.98
    rel = np.abs(np.asarray(r_c.cost) - np.asarray(r_s.cost)) \
        / (1.0 + np.abs(np.asarray(r_s.cost)))
    assert float(rel.max()) < 1e-3, rel.max()


def test_spline_coeff_tiny_grid_guard():
    """The >=3x3 spline grid guard must fire on the coefficient-plane
    route too (the early return to the packed-gather twin used to skip
    it, leaving clip(idx, 1, W-2) with an inverted range on 2x2 grids)."""
    import pytest

    from mpc_ros_tpu.models.obstacles import (ObstacleMap,
                                              spline_coeff_planes)

    tiny = jnp.zeros((2, 2), jnp.float32)
    with pytest.raises(AssertionError):
        spline_coeff_planes(tiny)
    om = ObstacleMap(grid=tiny, origin=jnp.zeros(2),
                     resolution=jnp.asarray(0.1),
                     weight=jnp.asarray(1.0), sampling="spline_coeff")
    with pytest.raises(AssertionError):
        om.with_spline_coeffs()
