"""Tracking controller: error-state extraction + NMPC solve per cycle.

Re-implements the reference Tracking state's `findBestPath` + `deceleration`
(/root/reference/mpc_ros/src/driving_state.cpp:105-271) around the jitted
solver:

* world->robot transform of the downsampled reference plan,
* cubic polyfit, cte = f(0), etheta via the 30%-lookahead path-direction
  heuristic with the 0->2pi continuity shim,
* optional delay-mode one-step state prediction (actuation latency
  compensation),
* deceleration-based reference-speed scheduling near the goal,
* speed integration `speed = v + throttle*dt` capped at the scheduled
  reference speed.

Host-side float64 numpy for the tiny per-cycle path math (polyfit of ~10
points); the solve itself is the compiled fixed-shape device program, reused
every cycle (the reference re-taped CppAD + recomputed sparsity per solve —
quirk Q9). Warm starting (shift of the previous solution) is on by default.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..config import MPCParams, PlannerConfig, SolverConfig
from ..models.base import get_model
from ..solver import ilqr
from ..solver.types import SolveResult
from .plan_utils import lookahead_heading


@functools.lru_cache(maxsize=None)
def _solve_jit(cfg: SolverConfig, warm: bool, with_omap: bool,
               with_blobs: bool, with_refs: bool = False):
    """Jitted (warm-started) solve, compiled once per SolverConfig and
    optional-input signature. Call as f(z0, coeffs, p, [u_init], [omap],
    [blobs], [refs]) with only the enabled optionals present (`refs` is the
    per-stage setpoint profile of the trajectory-tracking mode)."""

    @jax.jit
    def f(z0, coeffs, p, u_init=None, omap=None, blobs=None, refs=None):
        return ilqr.solve(z0, coeffs, p, cfg, u_init=u_init, omap=omap,
                          blobs=blobs, refs=refs)

    def call(z0, coeffs, p, u_init=None, omap=None, blobs=None, refs=None):
        kw = {}
        if warm:
            kw["u_init"] = u_init
        if with_omap:
            kw["omap"] = omap
        if with_blobs:
            kw["blobs"] = blobs
        if with_refs:
            kw["refs"] = refs
        return f(z0, coeffs, p, **kw)

    return call


@functools.lru_cache(maxsize=None)
def _cycle_jit(cfg: SolverConfig, with_omap: bool, with_blobs: bool):
    """Transfer-lean jitted tracking cycle: ONE packed upload, ONE packed
    fetch, warm start device-resident.

    Every host<->device transfer pays a fixed latency, so the single-robot
    tracker keeps them to one each way: inputs (state, coeffs, scheduled ref_vel) ride one (6+C+1,)
    array, the previous optimum stays ON DEVICE as a carry (the shift
    warm start runs inside the program — the reference re-taped and
    cold-started every cycle, quirk Q9), and every observability output
    (us, zs, cost, converged, iters, grad, reg) is flattened into one
    array so the host pays a single fetch (instead of 4 uploads and 7
    fetches per cycle).

    A zero carry reproduces the cold start exactly (the cold path rolls
    the plant under zero controls; warm with u_init=0 clips to the same
    zeros), so one compiled program serves both."""

    @jax.jit
    def f(inp, prev_us, p, omap=None, blobs=None):
        z0 = inp[: 6]
        coeffs = inp[6: 6 + cfg.n_coeffs]
        p = p.replace(ref_vel=inp[6 + cfg.n_coeffs])
        u_init = jnp.concatenate([prev_us[1:], prev_us[-1:]])
        r = ilqr.solve(z0, coeffs, p, cfg, u_init=u_init, omap=omap,
                       blobs=blobs)
        dtype = inp.dtype
        flat = jnp.concatenate([
            r.us.reshape(-1), r.zs.reshape(-1),
            jnp.stack([r.cost, r.converged.astype(dtype),
                       r.n_iters.astype(dtype), r.grad_norm, r.reg])])
        return flat, r.us

    def call(inp, prev_us, p, omap=None, blobs=None):
        kw = {}
        if with_omap:
            kw["omap"] = omap
        if with_blobs:
            kw["blobs"] = blobs
        return f(inp, prev_us, p, **kw)

    return call


@dataclasses.dataclass
class TrackingDebug:
    """Per-cycle observability record (successor of the reference's
    mpc_reference / mpc_trajectory topics + write-only cost accumulators)."""

    coeffs: np.ndarray
    state: np.ndarray
    ref_vel: float
    solve: Optional[SolveResult]
    cost: float


class TrackingController:
    """Owns solver params + cross-cycle actuation state (_w, _speed,
    _throttle), like the reference's DrivingStateContext
    (/root/reference/mpc_ros/include/driving_state.h:64-98)."""

    def __init__(self, params: MPCParams, solver_cfg: SolverConfig,
                 planner_cfg: PlannerConfig, dtype=jnp.float64):
        self.params = params.astype(dtype)
        self.solver_cfg = solver_cfg
        self.planner_cfg = planner_cfg
        self.dtype = dtype
        # the vehicle family: its yaw_rate maps (v, first control) to the
        # heading rate for the delay-mode prediction (omega for diff-drive,
        # v*delta/lf for the bicycle)
        self.model = get_model(solver_cfg.model)
        # host numpy twin of the device-resident params: per-cycle host
        # reads of device leaves would each cost a device round trip
        self._np_params = self._host_twin(self.params)
        self.w = 0.0
        self.speed = 0.0
        self.throttle = 1.0
        self.ref_vel = float(self._np_params.ref_vel)
        self._warm_us: Optional[np.ndarray] = None
        # device-resident warm-start carry (the previous optimum never
        # leaves the device between cycles — see _cycle_jit)
        self._warm_dev = None
        # optional robot-frame local costmap (models.obstacles.ObstacleMap);
        # set per cycle by the embedder — the obstacle awareness the
        # reference wired up but never used in its NLP (SURVEY.md C1)
        self.obstacle_map = None
        # optional parametric obstacles (models.obstacles.GaussianObstacles,
        # leaves (K,)) — the fast smooth representation; use
        # fit_gaussians_to_map to derive from a costmap snapshot
        self.obstacles = None
        # native (C++) per-cycle path fit; flips off permanently on any
        # build/ABI failure and the numpy path takes over
        self._native_prep = True

    @staticmethod
    def _host_twin(params: MPCParams) -> MPCParams:
        return MPCParams(**{
            f.name: np.asarray(getattr(params, f.name), float)
            for f in dataclasses.fields(MPCParams)})

    def reset(self) -> None:
        self.w = 0.0
        self.speed = 0.0
        self.throttle = 1.0
        self.ref_vel = float(self._np_params.ref_vel)
        self._warm_us = None
        self._warm_dev = None

    def update_params(self, params: MPCParams) -> None:
        """Hot-reload solver weights (no recompilation: params are traced)."""
        self.params = params.astype(self.dtype)
        self._np_params = self._host_twin(self.params)
        self.ref_vel = float(self._np_params.ref_vel)

    def scheduled_ref_vel(self, pose: np.ndarray, goal: np.ndarray,
                          v: float) -> float:
        """Deceleration scheduling
        (/root/reference/mpc_ros/src/driving_state.cpp:121-141): inside the
        braking distance v^2/max_throttle, scale the reference speed with
        distance-to-goal, clamped to [min_speed, max_speed]."""
        dist = float(np.hypot(pose[0] - goal[0], pose[1] - goal[1]))
        max_thr = float(self._np_params.max_throttle)
        if dist <= v * v / max_thr:
            return float(np.clip(max_thr * dist,
                                 self.planner_cfg.min_speed,
                                 self.planner_cfg.max_speed))
        return self.ref_vel

    def curvature_speed_limit(self, ref_plan: np.ndarray) -> float:
        """Curvature-aware speed cap over the local reference window:
        v <= sqrt(max_lat_accel / kappa_max). New relative to the reference
        (which only decelerates near the goal) — at a corner the lateral
        error of any finite-authority vehicle grows with speed, and for
        Ackermann steering the achievable curvature is hard-limited
        (kappa <= max_steer/lf), so the scheduler must slow down BEFORE the
        corner rather than rely on the solver's in-corner recovery."""
        if len(ref_plan) < 3:
            return float("inf")
        d = np.diff(ref_plan[:, :2], axis=0)
        ds = np.hypot(d[:, 0], d[:, 1])
        keep = ds > 1e-9
        if keep.sum() < 2:
            return float("inf")
        h = np.arctan2(d[keep, 1], d[keep, 0])
        dsk = ds[keep]
        dh = (np.diff(h) + np.pi) % (2.0 * np.pi) - np.pi
        seg = np.maximum(0.5 * (dsk[1:] + dsk[:-1]), 1e-6)
        kappa = float(np.max(np.abs(dh) / seg))
        if kappa <= 1e-9:
            return float("inf")
        return float(np.sqrt(self.planner_cfg.max_lat_accel / kappa))

    def compute(self, pose: np.ndarray, goal: np.ndarray,
                feedback_v: float, ref_plan: np.ndarray,
                raw_plan: Optional[np.ndarray] = None):
        """One Tracking cycle. pose: (x, y, yaw); ref_plan: (M, >=2) world
        waypoints (downsampled); `raw_plan`: the pre-downsample local window
        (curvature scheduling measures it — downsampling smooths corners and
        understates kappa). Returns ((v_cmd, w_cmd), TrackingDebug)."""
        if len(ref_plan) == 0:
            # reference quirk Q1 applied the stale command anyway; here the
            # failure is explicit: hold the previous command, flag no solve
            return (self.speed, self.w), TrackingDebug(
                coeffs=np.zeros(self.solver_cfg.n_coeffs),
                state=np.zeros(6), ref_vel=self.ref_vel, solve=None,
                cost=float("nan"))

        px, py, theta = float(pose[0]), float(pose[1]), float(pose[2])
        v = float(feedback_v)
        dt = float(self._np_params.dt)

        ref_vel_eff = self.scheduled_ref_vel(pose, goal, v)
        if self.planner_cfg.curvature_slowdown:
            kplan = ref_plan if raw_plan is None else raw_plan
            ref_vel_eff = float(np.clip(
                min(ref_vel_eff, self.curvature_speed_limit(kplan)),
                self.planner_cfg.min_speed, self.planner_cfg.max_speed))

        # per-cycle path fit: native C++ core when available (transform +
        # Householder-QR polyfit + lookahead heading — runtime.cc plan_fit,
        # like the reference's Eigen path), numpy otherwise. The `order <=
        # n-1` guard of the reference becomes degree reduction.
        order = min(self.solver_cfg.poly_order, len(ref_plan) - 1)
        fit = None
        if self._native_prep:
            try:
                from ..native.runtime import plan_fit

                fit = plan_fit(ref_plan[:, :2], (px, py, theta), order)
            except Exception:
                self._native_prep = False   # build/ABI failure: numpy fallback
        if fit is not None:
            c, cte, traj_deg, valid = fit
            coeffs = np.zeros(self.solver_cfg.n_coeffs)
            coeffs[: len(c)] = c
            etheta = float(np.arctan(coeffs[1]))
        else:
            # world -> robot frame (driving_state.cpp:196-207)
            ct, st = np.cos(theta), np.sin(theta)
            dx = ref_plan[:, 0] - px
            dy = ref_plan[:, 1] - py
            x_veh = dx * ct + dy * st
            y_veh = dy * ct - dx * st
            c = np.polyfit(x_veh, y_veh, order)[::-1]
            coeffs = np.zeros(self.solver_cfg.n_coeffs)
            coeffs[: len(c)] = c
            cte = float(np.polyval(coeffs[::-1], 0.0))
            etheta = float(np.arctan(coeffs[1]))
            # 30%-lookahead path direction (driving_state.cpp:214-235)
            traj_deg, valid = lookahead_heading(ref_plan)
        temp_theta = theta
        if temp_theta <= -np.pi + traj_deg:
            temp_theta += 2.0 * np.pi
        if valid and (temp_theta - traj_deg) < 1.8 * np.pi:
            etheta = temp_theta - traj_deg
        else:
            etheta = 0.0
        # quirk Q13 (fixed by default): the reference's one-sided 0->2pi
        # continuity shim leaves etheta UNWRAPPED when the heading error
        # crosses +-pi (e.g. a left corner approached heading ~pi with the
        # new path direction ~ -pi/2 gives etheta = +4.71 instead of
        # -1.57), so the solver turns the WRONG way — measured as a 270°
        # loop at the square course's top-left corner for both families
        # (0.45-0.84 m excursion). Wrapping to [-pi, pi] commands the short
        # way around; `wrap_etheta=False` reproduces the reference formula.
        if self.planner_cfg.wrap_etheta:
            from .fsm import normalize_angle

            etheta = normalize_angle(etheta)

        # delay-mode one-step prediction (driving_state.cpp:243-253). Under
        # the consistent convention (quirk Q11, cte_vsin_sign=-1) the cte and
        # etheta updates follow the corrected model; with +1 they reproduce
        # the reference formulas bit-for-bit.
        if self.planner_cfg.delay_mode:
            sign = self.solver_cfg.cte_vsin_sign
            px_act = v * dt
            py_act = 0.0
            # self.w holds the previous first control (omega / delta); the
            # model maps it to a heading rate for the one-step prediction
            # (host math via the numpy twin — no device fetch)
            theta_act = float(
                self.model.yaw_rate(v, self.w, self._np_params)) * dt
            v_act = v + self.throttle * dt
            cte_act = cte + sign * v * np.sin(etheta) * dt
            etheta_act = etheta - sign * theta_act
            state = np.array([px_act, py_act, theta_act, v_act, cte_act,
                              etheta_act])
        else:
            state = np.array([0.0, 0.0, 0.0, v, cte, etheta])

        omap = self.obstacle_map
        blobs = self.obstacles
        cfg = self.solver_cfg
        # one packed upload + one packed fetch per cycle, warm start
        # device-resident (see _cycle_jit)
        inp = np.zeros(6 + cfg.n_coeffs + 1)
        inp[:6] = state
        inp[6: 6 + cfg.n_coeffs] = coeffs
        inp[6 + cfg.n_coeffs] = ref_vel_eff
        if self._warm_dev is None:
            self._warm_dev = jnp.zeros((cfg.n_controls, 2), self.dtype)
        cyc = _cycle_jit(cfg, omap is not None, blobs is not None)
        flat, self._warm_dev = cyc(jnp.asarray(inp, self.dtype),
                                   self._warm_dev, self.params,
                                   omap=omap, blobs=blobs)
        flat = np.asarray(jax.device_get(flat), float)
        T, N = cfg.n_controls, cfg.n_steps
        us = flat[: T * 2].reshape(T, 2)
        zs = flat[T * 2: T * 2 + N * 6].reshape(N, 6)
        cost, convf, itersf, gnorm, reg = flat[T * 2 + N * 6:]
        res = SolveResult(
            us=us, zs=zs, cost=cost, converged=bool(convf > 0.5),
            n_iters=int(itersf), grad_norm=gnorm, reg=reg)
        self._warm_us = us

        self.w = float(us[0, 0])
        self.throttle = float(us[0, 1])
        self.speed = min(v + self.throttle * dt, ref_vel_eff)

        dbg = TrackingDebug(coeffs=coeffs, state=state, ref_vel=ref_vel_eff,
                            solve=res, cost=float(res.cost))
        return (self.speed, self.w), dbg
