"""Hybrid GN->DDP backward pass (SolverConfig.ddp) — round-3 tail killer.

The census (PERF.md) showed the iteration-count tail is the
large-residual scenario class (high heading error at speed on curved
references) where Gauss-Newton converges only linearly while accepting
full steps. The exact second-order dynamics terms restore local quadratic
convergence; gated per lane on the projected gradient they never hurt
(applied cold they burn ~6 rejected-step iterations while mu ramps).

Pinned here: same optimum as GN, the tail collapse itself, megakernel ==
XLA lane path under ddp, and every ensemble's convergence AT its
production cap (VERDICT r2 item 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_ros_tpu.config import MPCParams, SolverConfig
from mpc_ros_tpu.engine import make_random_scenarios
from mpc_ros_tpu.solver.batch_lane import batch_solve_lane

_BASE = dict(n_steps=30, ls_iters=5, tol_grad=1e-4, backward="xla")
# GN baselines need ddp=False EXPLICITLY: since round 5 the default is
# ddp="auto", which resolves to the hybrid on f32 (config.py ddp_for)
_GN = dict(_BASE, ddp=False)


def test_ddp_auto_profile():
    """ddp='auto' (the round-5 default) resolves per compute dtype: f32
    production paths run the hybrid with the 4-candidate line search; f64
    oracle/regression work keeps pure GN with the 8-candidate ladder.
    Backward modes that cannot carry second-order terms resolve to GN
    (only an EXPLICIT ddp=True raises there); explicit values verbatim."""
    cfg = SolverConfig()
    assert cfg.ddp == "auto" and cfg.ls_iters is None
    assert cfg.ddp_for(jnp.float32) is True
    assert cfg.ddp_for(jnp.float64) is False
    assert cfg.ls_for(jnp.float32) == 4
    assert cfg.ls_for(jnp.float64) == 8
    assert SolverConfig(horizon_parallel=True).ddp_for(jnp.float32) is False
    with pytest.raises(ValueError, match="backward"):
        SolverConfig(backward="pallas")
    assert SolverConfig(ddp=True).ddp_for(jnp.float64) is True
    assert SolverConfig(ddp=False).ddp_for(jnp.float32) is False
    assert SolverConfig(ls_iters=6).ls_for(jnp.float32) == 6
    assert SolverConfig(ddp=False).ls_for(jnp.float32) == 8


def test_ddp_same_optimum_as_gn():
    B = 512
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), B)
    p = MPCParams().astype(jnp.float32)
    r_gn = batch_solve_lane(z0s, coeffs, p,
                            SolverConfig(**_GN, max_sqp_iters=60))
    r_dd = batch_solve_lane(z0s, coeffs, p,
                            SolverConfig(**_BASE, max_sqp_iters=60,
                                         ddp=True))
    rel = np.asarray(jnp.abs(r_dd.cost - r_gn.cost)
                     / (1.0 + jnp.abs(r_gn.cost)))
    assert rel.max() < 1e-4, rel.max()
    assert np.asarray(r_dd.converged).all()


def test_ddp_collapses_iteration_tail():
    """The census tail lane (28 GN iterations) converges in <= 8 under
    the gated DDP pass; ensemble-wide max drops below the 12-iteration
    production cap with margin."""
    B = 4096
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), B)
    p = MPCParams().astype(jnp.float32)
    r_gn = batch_solve_lane(z0s, coeffs, p,
                            SolverConfig(**_GN, max_sqp_iters=60))
    r_dd = batch_solve_lane(z0s, coeffs, p,
                            SolverConfig(**_BASE, max_sqp_iters=60,
                                         ddp=True))
    it_gn = np.asarray(r_gn.n_iters)
    it_dd = np.asarray(r_dd.n_iters)
    assert it_gn.max() >= 15          # the tail exists under GN
    assert it_dd.max() <= 8, it_dd.max()
    assert it_dd.mean() < it_gn.mean()
    # the gate matters: ungated DDP (gate=inf applies from iteration 2;
    # to see the cold-start pathology you would need gate on iteration 1,
    # which the implementation never does by construction: gnorm starts
    # at +inf) — assert the gated pass never REGRESSES a lane badly
    assert (it_dd <= it_gn + 2).all()


def test_ddp_megakernel_matches_xla():
    B = 256
    for model in ("diff_drive", "bicycle"):
        z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(1), B)
        p = MPCParams().astype(jnp.float32)
        kw = dict(n_steps=12, max_sqp_iters=10, ls_iters=5, tol_grad=1e-4,
                  model=model, ddp=True)
        r_x = batch_solve_lane(z0s, coeffs, p,
                               SolverConfig(**kw, backward="xla"))
        from mpc_ros_tpu.kernels.backward_pallas import pack_params
        from mpc_ros_tpu.kernels.solve_pallas import solve_pallas
        from mpc_ros_tpu.models.base import get_model

        zT = jnp.swapaxes(z0s, 0, 1)
        cT = jnp.swapaxes(coeffs, 0, 1)
        pp = pack_params(p, B, jnp.float32)
        lb, ub = get_model(model).control_bounds(p, jnp.float32)
        lb = jnp.broadcast_to(lb[:, None], (2, B))
        ub = jnp.broadcast_to(ub[:, None], (2, B))
        us0 = jnp.zeros((11, 2, B), jnp.float32)
        out = solve_pallas(zT, cT, pp, lb, ub, us0,
                           SolverConfig(**kw, trig="exact"),
                           interpret=True)
        us_m, iters_m = out[1], out[4]
        us_x = jnp.moveaxis(r_x.us, 0, -1)
        np.testing.assert_array_equal(np.asarray(iters_m),
                                      np.asarray(r_x.n_iters))
        assert float(jnp.max(jnp.abs(us_m - us_x))) < 1e-3


# ---- every ensemble's convergence AT its production cap (VERDICT r2 #3) --

def test_conv_at_production_cap_diff_drive():
    """Headline config: N=30, cap 12, ddp on -> full convergence."""
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), 4096)
    r = batch_solve_lane(z0s, coeffs, MPCParams().astype(jnp.float32),
                         SolverConfig(**_BASE, max_sqp_iters=12, ddp=True))
    assert float(np.mean(np.asarray(r.converged))) >= 0.9995


def test_conv_at_production_cap_bicycle():
    """Bicycle family at the same cap-12 + ddp operating point the bench
    uses (was 0.990 at cap 30 under GN — VERDICT r2 item 3 asked >=0.995)."""
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(5), 4096)
    p = MPCParams().astype(jnp.float32)
    r = batch_solve_lane(z0s, coeffs, p,
                         SolverConfig(**_BASE, max_sqp_iters=12,
                                      model="bicycle", ddp=True))
    assert float(np.mean(np.asarray(r.converged))) >= 0.995


def test_conv_at_production_cap_obstacles():
    """Parametric-obstacle ensemble at its cap-30 production setting."""
    from mpc_ros_tpu.models.obstacles import GaussianObstacles

    B = 4096
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), B)
    centers = jax.random.uniform(jax.random.PRNGKey(1), (B, 2),
                                 jnp.float32, 0.3, 1.2)
    K = 4
    cxs = jnp.concatenate([centers[:, :1], jnp.full((B, K - 1), 50.0)], 1)
    cys = jnp.concatenate([centers[:, 1:], jnp.full((B, K - 1), 50.0)], 1)
    blobs = GaussianObstacles.from_sigmas(
        cxs, cys, jnp.full((B, K), 0.3), jnp.full((B, K), 100.0))
    r = batch_solve_lane(z0s, coeffs, MPCParams().astype(jnp.float32),
                         SolverConfig(**_BASE, max_sqp_iters=30, ddp=True),
                         blobs=blobs)
    assert float(np.mean(np.asarray(r.converged))) >= 0.995


def test_ddp_vmap_path_matches_lane_path():
    """The vmap/ilqr path computes the DDP terms GENERICALLY (jax.hessian
    of the registered model's step — step_hessians) while the lane and
    megakernel paths hand-derive the same entries; the two independent
    derivations must agree: identical iteration counts, controls to f32
    noise."""
    from mpc_ros_tpu.engine.batch import batch_solve

    B = 128
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), B)
    p = MPCParams().astype(jnp.float32)
    for model in ("diff_drive", "bicycle"):
        cfg = SolverConfig(n_steps=14, max_sqp_iters=20, ls_iters=5,
                           tol_grad=1e-4, backward="xla", ddp=True,
                           model=model)
        r_v = batch_solve(z0s, coeffs, p, cfg)
        r_l = batch_solve_lane(z0s, coeffs, p, cfg)
        np.testing.assert_array_equal(np.asarray(r_v.n_iters),
                                      np.asarray(r_l.n_iters))
        assert float(jnp.max(jnp.abs(r_v.us - r_l.us))) < 1e-3


def test_ddp_custom_model_family():
    """Any family defined by `model_from_step` gets exact second-order
    terms for free (autodiff at second order replaces CppAD's tape there
    too): a custom tricycle-ish family solves with ddp on and reaches the
    same optimum as GN."""
    from mpc_ros_tpu.engine.batch import batch_solve
    from mpc_ros_tpu.models.base import model_from_step
    from mpc_ros_tpu.ops.poly import polyeval

    def step(z, u, coeffs, dt, sign, p):
        x, y, th, v, cte, eth = (z[..., i] for i in range(6))
        w, a = u[..., 0], u[..., 1]
        dt = jnp.asarray(dt, z.dtype)
        f0 = polyeval(coeffs, x)
        dth = w * (1.0 + 0.1 * v) * dt     # mildly speed-coupled steering
        return jnp.stack([
            x + v * jnp.cos(th) * dt,
            y + v * jnp.sin(th) * dt,
            th + dth,
            v + a * dt,
            (f0 - y) + sign * v * jnp.sin(eth) * dt,
            eth + dth,
        ], axis=-1)

    def bounds(p, dtype):
        return (jnp.asarray([-1.0, -1.0], dtype),
                jnp.asarray([1.0, 1.0], dtype))

    model_from_step("tricycle_ddp_test", step, bounds,
                    allow_override=True)
    B = 64
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(2), B)
    p = MPCParams().astype(jnp.float32)
    kw = dict(n_steps=12, max_sqp_iters=40, ls_iters=5, tol_grad=1e-4,
              model="tricycle_ddp_test")
    r_gn = batch_solve(z0s, coeffs, p, SolverConfig(**kw, ddp=False))
    r_dd = batch_solve(z0s, coeffs, p, SolverConfig(**kw, ddp=True))
    assert np.asarray(r_dd.converged).mean() >= 0.98
    rel = np.asarray(jnp.abs(r_dd.cost - r_gn.cost)
                     / (1.0 + jnp.abs(r_gn.cost)))
    assert rel.max() < 1e-4
    assert float(jnp.mean(r_dd.n_iters)) <= float(jnp.mean(r_gn.n_iters))


def test_ddp_megakernel_matches_xla_with_blobs():
    """The gated exact blob curvature runs in both the megakernel
    (obs_terms gate) and the XLA lane path (blob_concave_bl) — identical
    iteration counts, controls to f32 noise."""
    from mpc_ros_tpu.kernels.backward_pallas import pack_params
    from mpc_ros_tpu.kernels.solve_pallas import solve_pallas
    from mpc_ros_tpu.models.base import get_model
    from mpc_ros_tpu.models.obstacles import GaussianObstacles

    B = 256
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(1), B)
    centers = jax.random.uniform(jax.random.PRNGKey(2), (B, 2),
                                 jnp.float32, 0.3, 1.2)
    blobs = GaussianObstacles.from_sigmas(
        centers[:, :1], centers[:, 1:],
        jnp.full((B, 1), 0.3), jnp.full((B, 1), 100.0))
    p = MPCParams().astype(jnp.float32)
    kw = dict(n_steps=12, max_sqp_iters=12, ls_iters=5, tol_grad=1e-4,
              ddp=True)
    r_x = batch_solve_lane(z0s, coeffs, p,
                           SolverConfig(**kw, backward="xla"), blobs=blobs)
    zT = jnp.swapaxes(z0s, 0, 1)
    cT = jnp.swapaxes(coeffs, 0, 1)
    pp = pack_params(p, B, jnp.float32)
    lb, ub = get_model("diff_drive").control_bounds(p, jnp.float32)
    lb = jnp.broadcast_to(lb[:, None], (2, B))
    ub = jnp.broadcast_to(ub[:, None], (2, B))
    us0 = jnp.zeros((11, 2, B), jnp.float32)
    out = solve_pallas(zT, cT, pp, lb, ub, us0,
                       SolverConfig(**kw, trig="exact"),
                       interpret=True, blobs=blobs.lane())
    us_m, iters_m = out[1], out[4]
    np.testing.assert_array_equal(np.asarray(iters_m),
                                  np.asarray(r_x.n_iters))
    us_x = jnp.moveaxis(r_x.us, 0, -1)
    assert float(jnp.max(jnp.abs(us_m - us_x))) < 2e-3


def test_ddp_vmap_matches_lane_with_blobs():
    """With obstacle fields, the vmap/ilqr DDP path applies the same gated
    blob concave correction and 0.75 gate cap as the lane path — the two
    engines must stay in lockstep (review finding: this combination was
    unpinned)."""
    from mpc_ros_tpu.engine.batch import batch_solve
    from mpc_ros_tpu.models.obstacles import GaussianObstacles

    B = 64
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(3), B)
    centers = jax.random.uniform(jax.random.PRNGKey(4), (B, 2),
                                 jnp.float32, 0.3, 1.2)
    blobs = GaussianObstacles.from_sigmas(
        centers[:, :1], centers[:, 1:],
        jnp.full((B, 1), 0.3), jnp.full((B, 1), 100.0))
    p = MPCParams().astype(jnp.float32)
    cfg = SolverConfig(n_steps=14, max_sqp_iters=25, ls_iters=5,
                       tol_grad=1e-4, backward="xla", ddp=True)
    r_l = batch_solve_lane(z0s, coeffs, p, cfg, blobs=blobs)
    # vmap path: per-scenario blob pytrees
    import jax as _jax

    r_v = _jax.vmap(
        lambda z, c, bx, by, bg, bw: __import__(
            "mpc_ros_tpu.solver.ilqr", fromlist=["solve"]).solve(
                z, c, p, cfg,
                blobs=GaussianObstacles(cx=bx, cy=by, gamma=bg, w=bw)),
    )(z0s, coeffs, blobs.cx, blobs.cy, blobs.gamma, blobs.w)
    np.testing.assert_array_equal(np.asarray(r_v.n_iters),
                                  np.asarray(r_l.n_iters))
    assert float(jnp.max(jnp.abs(r_v.us - r_l.us))) < 2e-3


def test_ddp_with_horizon_parallel_raises():
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), 4)
    from mpc_ros_tpu.engine.batch import batch_solve

    cfg = SolverConfig(n_steps=10, max_sqp_iters=5, ddp=True,
                       horizon_parallel=True)
    with pytest.raises(ValueError, match="ddp"):
        batch_solve(z0s, coeffs, MPCParams().astype(jnp.float32), cfg)


def test_ddp_warm_endgame_certifies_converged():
    """Round-4 certificate refinement: a tiny-model ACCEPTED step under
    inflated mu keeps iterating (mu decays toward an honest certificate)
    instead of stopping one iteration early with a stalled label. The
    race hit DDP warm endgames at the tracker's high-weight operating
    point (the round-3 'converged iterate labeled stalled' note) — warm
    DDP re-solves must now certify converged, at no more iterations than
    GN, at the same optimum."""
    from mpc_ros_tpu.solver import ilqr

    p = MPCParams(dt=0.1, max_angvel=1.5, w_cte=300.0, w_angvel_d=10.0,
                  w_accel_d=10.0).astype(jnp.float32)
    coeffs = jnp.asarray([0.05, 0.2, 0.25, 0.0], jnp.float32)
    z0 = jnp.asarray([0, 0, 0, 0.4, 0.06, 0.12], jnp.float32)

    def warm_cycles(ddp):
        cfg = SolverConfig(n_steps=30, ddp=ddp)
        r = ilqr.solve(z0, coeffs, p, cfg)
        us_w = jnp.concatenate([r.us[1:], r.us[-1:]])
        iters, convs, costs = [], [], []
        for _ in range(5):
            r2 = ilqr.solve(z0, coeffs, p, cfg, u_init=us_w)
            iters.append(int(r2.n_iters))
            convs.append(bool(r2.converged))
            costs.append(float(r2.cost))
            us_w = jnp.concatenate([r2.us[1:], r2.us[-1:]])
        return iters, convs, costs

    it_d, cv_d, c_d = warm_cycles(True)
    it_g, cv_g, c_g = warm_cycles(False)
    assert all(cv_d), (it_d, cv_d)        # every DDP warm cycle certifies
    assert all(cv_g)
    assert max(it_d) <= max(it_g), (it_d, it_g)
    # same optimum
    assert abs(c_d[-1] - c_g[-1]) < 1e-3 * (1.0 + abs(c_g[-1]))


def _scaled_params(p, c):
    import dataclasses as _dc

    w = {"w_cte", "w_etheta", "w_vel", "w_angvel", "w_accel",
         "w_angvel_d", "w_accel_d"}
    return MPCParams(**{
        f.name: (getattr(p, f.name) * c if f.name in w
                 else getattr(p, f.name))
        for f in _dc.fields(MPCParams)})


def test_weight_scale_equivariance_exact():
    """Round-5 (VERDICT r4 item 5): with scale_adaptive (default), a
    problem whose weights are uniformly up-scaled by a power of two
    solves with bit-identical controls and iteration counts on ~every
    lane (the iLQR update is equivariant under J -> cJ with mu/tol/gate
    -> c*(.), and power-of-two scaling is exact in f32). The ONE
    non-equivariant corner is the box-QP active-set tie-break: its KKT
    violation mixes control-unit (primal) and cost-unit (multiplier)
    terms, so a degenerate boundary tie can pick a different (equally
    optimal) active set under scaling and shift a lane by +-1 iteration
    — tolerated on <=2% of lanes; everything else is exact. This is the
    structural closure of the census gap 'up-scaled weights at long
    horizons degrade ddp to effective GN'."""
    B = 512
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), B)
    p1 = MPCParams().astype(jnp.float32)
    p4 = _scaled_params(p1, 4.0)
    cfg = SolverConfig(n_steps=60, max_sqp_iters=27, ls_iters=4, ddp=True,
                       tol_grad=1e-4, backward="xla")
    r1 = batch_solve_lane(z0s, coeffs, p1, cfg)
    r4 = batch_solve_lane(z0s, coeffs, p4, cfg)
    it1 = np.asarray(r1.n_iters)
    it4 = np.asarray(r4.n_iters)
    same = it1 == it4
    assert same.mean() >= 0.98, same.mean()
    assert np.max(np.abs(it1 - it4)) <= 1
    np.testing.assert_array_equal(np.asarray(r1.us)[same],
                                  np.asarray(r4.us)[same])
    np.testing.assert_allclose(np.asarray(r4.cost),
                               4.0 * np.asarray(r1.cost), rtol=1e-5)
    assert float(np.mean(np.asarray(r4.converged))) >= \
        float(np.mean(np.asarray(r1.converged))) - 2.0 / B
    # without scale_adaptive the up-scaled ensemble genuinely degrades
    # (the census behavior this feature closes)
    import dataclasses

    r4_off = batch_solve_lane(z0s, coeffs, p4,
                              dataclasses.replace(cfg,
                                                  scale_adaptive=False))
    assert float(np.mean(np.asarray(r4_off.n_iters))) > float(
        np.mean(np.asarray(r4.n_iters)))


def test_weight_scale_equivariance_megakernel():
    """The megakernel computes the same per-lane scale from its params
    tile: interpret-mode kernel == XLA lane path on a MIXED-scale batch
    (half c=1, half c=5 lanes)."""
    from mpc_ros_tpu.kernels.backward_pallas import pack_params
    from mpc_ros_tpu.kernels.solve_pallas import solve_pallas
    from mpc_ros_tpu.models.base import get_model

    B = 256
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(1), B)
    p1 = MPCParams().astype(jnp.float32)
    c_lane = jnp.where(jnp.arange(B) < B // 2, 1.0, 5.0).astype(jnp.float32)
    p = _scaled_params(
        MPCParams(**{f: jnp.broadcast_to(getattr(p1, f), (B,))
                     for f in ("dt", "ref_cte", "ref_etheta", "ref_vel",
                               "w_cte", "w_etheta", "w_vel", "w_angvel",
                               "w_accel", "w_angvel_d", "w_accel_d",
                               "max_angvel", "max_throttle", "bound_value",
                               "lf", "max_steer")}), c_lane)
    kw = dict(n_steps=12, max_sqp_iters=10, ls_iters=5, tol_grad=1e-4,
              ddp=True)
    r_x = batch_solve_lane(z0s, coeffs, p, SolverConfig(**kw,
                                                        backward="xla"))
    zT = jnp.swapaxes(z0s, 0, 1)
    cT = jnp.swapaxes(coeffs, 0, 1)
    pp = pack_params(p, B, jnp.float32)
    lb, ub = get_model("diff_drive").control_bounds(p, jnp.float32)
    lb = jnp.broadcast_to(lb if lb.ndim == 2 else lb[:, None], (2, B))
    ub = jnp.broadcast_to(ub if ub.ndim == 2 else ub[:, None], (2, B))
    us0 = jnp.zeros((11, 2, B), jnp.float32)
    out = solve_pallas(zT, cT, pp, lb, ub, us0,
                       SolverConfig(**kw, trig="exact"), interpret=True)
    np.testing.assert_array_equal(np.asarray(out[4]),
                                  np.asarray(r_x.n_iters))
    us_m = out[1]
    us_x = jnp.moveaxis(r_x.us, 0, -1)
    assert float(jnp.max(jnp.abs(us_m - us_x))) < 2e-3


def test_long_horizon_pair_policy():
    """Round-5 coupled long-horizon auto policy: (gate 1.5, mu floor
    1e-2) resolve TOGETHER for f32 DDP at N > 32 with both knobs on
    auto and no blob terms; any explicit knob, GN dtype, obstacles, or
    short horizon reverts BOTH to the conservative resolution."""
    c = SolverConfig(n_steps=60)
    assert c.gate_for(False, jnp.float32) == 1.5
    assert c.mu_init_for(jnp.float32) == 1e-2
    assert c.gate_for(True, jnp.float32) == 0.75       # blobs: pair off
    assert c.mu_init_for(jnp.float32, True) == 1e-6
    assert c.gate_for(False, jnp.float64) == 0.75      # GN dtype
    assert c.mu_init_for(jnp.float64) == 1e-6
    assert c.gate_for(False) == 0.75                   # dtype unknown
    assert SolverConfig(n_steps=60, mu_init=1e-6).gate_for(
        False, jnp.float32) == 0.75                    # explicit mu
    assert SolverConfig(n_steps=60, mu_init=1e-6).mu_init_for(
        jnp.float32) == 1e-6
    assert SolverConfig(n_steps=60, ddp_gate=2.0).mu_init_for(
        jnp.float32) == 1e-6                           # explicit gate
    assert SolverConfig(n_steps=30).gate_for(False, jnp.float32) == 2.5
    assert SolverConfig(n_steps=30).mu_init_for(jnp.float32) == 1e-6
    # grid costmaps exclude the pair too (census: damped early
    # engagement rejected for obstacle fields), without engaging the
    # blobs-only gate cap
    assert c.mu_init_for(jnp.float32, False, True) == 1e-6
    assert c.gate_for(False, jnp.float32, has_omaps=True) == 0.75
    # the backward mode that cannot run DDP keeps the conservative floor
    # even under an explicit ddp=True (which ddp_for honors verbatim); the
    # removed two-kernel backward is refused outright
    assert SolverConfig(n_steps=48, ddp=True,
                        horizon_parallel=True).mu_init_for(
        jnp.float32) == 1e-6
    with pytest.raises(ValueError, match="backward"):
        SolverConfig(n_steps=48, ddp=True, backward="pallas")


def test_long_horizon_pair_beats_conservative():
    """The pair converges in ~28% fewer iterations than the round-4
    (0.75, 1e-6) policy at N=60 on the XLA lane path, conv preserved."""
    B = 512
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), B)
    p = MPCParams().astype(jnp.float32)
    kw = dict(n_steps=60, max_sqp_iters=27, tol_grad=1e-4, backward="xla")
    r_pair = batch_solve_lane(z0s, coeffs, p, SolverConfig(**kw))
    r_cons = batch_solve_lane(z0s, coeffs, p,
                              SolverConfig(**kw, mu_init=1e-6))
    assert float(np.mean(np.asarray(r_pair.converged))) >= 0.996
    assert (float(np.mean(np.asarray(r_pair.n_iters)))
            < 0.85 * float(np.mean(np.asarray(r_cons.n_iters))))
    # same optima on lanes both converged
    both = np.asarray(r_pair.converged) & np.asarray(r_cons.converged)
    rel = np.abs(np.asarray(r_pair.cost) - np.asarray(r_cons.cost)) \
        / (1.0 + np.abs(np.asarray(r_cons.cost)))
    assert float(np.percentile(rel[both], 99.5)) < 1e-3


def test_truthy_nonbool_ddp_still_raises_on_unsupported_backwards():
    """A programmatic SolverConfig(ddp=1) must hit the same unsupported-
    backward raise as ddp=True (an `is True` guard lets 1 slip through
    and silently run GN — the exact silent fallback the raise documents
    against). ddp='auto' keeps resolving to GN without raising. The
    removed two-kernel backward ('pallas') is refused at config time,
    whatever the ddp setting."""
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), 128)
    p = MPCParams().astype(jnp.float32)

    with pytest.raises(ValueError, match="backward"):
        SolverConfig(n_steps=10, ddp=1, backward="pallas")
    from mpc_ros_tpu.solver import ilqr

    with pytest.raises(ValueError, match="horizon_parallel"):
        ilqr.solve(z0s[0], coeffs[0], p,
                   SolverConfig(n_steps=10, ddp=1, horizon_parallel=True))
    # auto still quietly resolves to GN (no raise at config time)
    assert SolverConfig(n_steps=10, horizon_parallel=True).ddp_for(
        jnp.float32) is False
    with pytest.raises(ValueError, match="backward"):
        SolverConfig(n_steps=10, backward="pallas")
