"""Baseline local planners: Pure Pursuit and DWA.

The reference's only quantitative benchmark is an A/B closed-loop comparison
of NMPC vs DWA vs Pure Pursuit on one course
(/root/reference/assets/{mpc,dwa,pure_pursuit}.csv — SURVEY.md §4.2, C10),
produced by swapping the move_base local-planner plugin. Those controllers
lived outside the reference repo; here they are built in, sharing the full
planner lifecycle (FSM, goal latching, plan pipeline, CSV logging) with
`MPCPlanner` so the three-controller comparison is reproducible with one
command per controller:

    python -m mpc_ros_tpu.sim.run --shape infinity --controller pure_pursuit

Both baselines override only `_make_tracker` / `_tracking_command`; every
other behavior (states, tolerances, deceleration near the goal) is shared,
so differences in the logs measure the control law, not the harness.

The DWA scorer is batch-idiomatic: the whole velocity window rolls out as one
batched closed-form arc evaluation inside a single jitted program (no
per-candidate loop), with optional obstacle clearance from either obstacle
representation (grid costmap or parametric Gaussians).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from ..config import MPCParams, PlannerConfig, SolverConfig
from . import plan_utils
from .planner import MPCPlanner


@dataclasses.dataclass
class _BaselineTracker:
    """Minimal cross-cycle state standing in for TrackingController (the
    lifecycle calls reset/update_params on whatever `_make_tracker` built)."""

    params: MPCParams
    speed: float = 0.0

    def reset(self) -> None:
        self.speed = 0.0
        # DWAPlanner._make_tracker adds `w`; reset it too if present
        if hasattr(self, "w"):
            self.w = 0.0

    def update_params(self, params: MPCParams) -> None:
        self.params = params


def _scheduled_ref_vel(params: MPCParams, planner_cfg: PlannerConfig,
                       pose: np.ndarray, goal: np.ndarray, v: float) -> float:
    """Deceleration scheduling shared with the Tracking state
    (/root/reference/mpc_ros/src/driving_state.cpp:121-141): inside the
    braking distance v^2/max_throttle, scale the reference speed with
    distance-to-goal."""
    dist = float(np.hypot(pose[0] - goal[0], pose[1] - goal[1]))
    max_thr = float(params.max_throttle)
    if dist <= v * v / max_thr:
        return float(np.clip(max_thr * dist, planner_cfg.min_speed,
                             planner_cfg.max_speed))
    return float(params.ref_vel)


# ---------------------------------------------------------------------------
# Pure Pursuit
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PurePursuitConfig:
    """Geometric pure-pursuit parameters (speed-scaled lookahead)."""

    k_dd: float = 1.2           # lookahead time gain [s]: L = k_dd * v
    min_lookahead: float = 0.3  # [m]
    max_lookahead: float = 1.5  # [m]


class PurePursuitPlanner(MPCPlanner):
    """Pure-pursuit tracking inside the shared planner lifecycle.

    Steers along the circular arc through the lookahead point: with the
    lookahead point at (x_l, y_l) in the robot frame at distance d,
    curvature kappa = 2*y_l/d^2 and omega = v*kappa. Speed follows the
    shared deceleration schedule with an accel-limited ramp
    (|dv| <= max_throttle*dt), mirroring the Tracking state's
    `speed = v + throttle*dt` integration."""

    def __init__(self, params: MPCParams = MPCParams(),
                 planner_cfg: PlannerConfig = PlannerConfig(),
                 pp_cfg: PurePursuitConfig = PurePursuitConfig(),
                 **kw):
        super().__init__(params=params, planner_cfg=planner_cfg, **kw)
        self.pp_cfg = pp_cfg

    def _make_tracker(self):
        return _BaselineTracker(self.params)

    def _tracking_command(self, pose, feedback_vel, cut):
        ref_plan = plan_utils.downsample_plan(
            cut, self.planner_cfg.downsample_segments)
        p = self.params
        cfg = self.pp_cfg
        v_fb = float(feedback_vel[0])
        dt = float(p.dt)
        max_thr = float(p.max_throttle)

        ref_v = _scheduled_ref_vel(p, self.planner_cfg, pose, self.goal, v_fb)
        # accel-limited speed ramp toward the scheduled reference speed
        v_cmd = float(np.clip(ref_v, self.tracker.speed - max_thr * dt,
                              self.tracker.speed + max_thr * dt))
        self.tracker.speed = v_cmd

        # lookahead point: first plan point at straight-line distance >= L
        # from the robot (falls back to the last point near the goal)
        L = float(np.clip(cfg.k_dd * max(v_cmd, self.planner_cfg.min_speed),
                          cfg.min_lookahead, cfg.max_lookahead))
        d = np.hypot(cut[:, 0] - pose[0], cut[:, 1] - pose[1])
        ahead = np.nonzero(d >= L)[0]
        target = cut[ahead[0]] if len(ahead) else cut[-1]

        # world -> robot frame
        ct, st = np.cos(pose[2]), np.sin(pose[2])
        dx, dy = target[0] - pose[0], target[1] - pose[1]
        x_l = dx * ct + dy * st
        y_l = dy * ct - dx * st
        d2 = max(x_l * x_l + y_l * y_l, 1e-9)
        w_cmd = float(np.clip(v_cmd * 2.0 * y_l / d2,
                              -float(p.max_angvel), float(p.max_angvel)))
        return (v_cmd, w_cmd), ref_plan, None, None


# ---------------------------------------------------------------------------
# DWA
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DWAConfig:
    """Dynamic-window parameters. The candidate grid and rollout are static
    shapes — one compiled program evaluates the whole window."""

    nv: int = 9                 # linear-velocity samples in the window
    nw: int = 25                # angular-velocity samples
    window_dt: float = 0.2      # accel window horizon [s] (v0 +- a*window_dt)
    sim_time: float = 1.2       # rollout duration [s]
    sim_steps: int = 12         # rollout sample count
    plan_points: int = 32       # static plan-window size (padded/truncated)
    w_path: float = 4.0         # path-proximity score weight
    w_goal: float = 1.5         # end-distance-to-local-goal weight (progress)
    w_vel: float = 0.5          # speed-tracking weight
    # obstacle handling mirrors ROS dwa_local_planner's costmap scoring:
    # rollouts whose peak obstacle cost exceeds `veto_cost` are treated as
    # colliding (hard veto), plus a small graded clearance bias. A purely
    # graded penalty measurably deadlocks: the repulsive gradient beats the
    # goal-progress term several sigma out and the robot stalls
    w_clear: float = 0.1        # graded clearance weight (if obstacles set)
    veto_cost: float = 25.0     # obstacle cost treated as collision
    w_turn: float = 0.02        # angular-effort tiebreak (prevents idle spin)


@functools.lru_cache(maxsize=None)
def _dwa_eval_jit(cfg: DWAConfig, with_omap: bool, with_blobs: bool):
    """Compile the window evaluator once per DWAConfig.

    All candidates (nv*nw constant-twist arcs) are rolled out closed-form —
    x(t) = (v/w)sin(wt), y(t) = (v/w)(1-cos(wt)) — and scored in one fused
    batch; `argmax` picks the winner on device. This is the dynamic-window
    search re-thought as a dense batched evaluation instead of the
    reference-era nested candidate loops."""
    import jax
    import jax.numpy as jnp

    ts = np.linspace(cfg.sim_time / cfg.sim_steps, cfg.sim_time,
                     cfg.sim_steps)

    @jax.jit
    def f(v0, w0, lim, plan_xy, goal_xy, omap=None, blobs=None):
        # lim = [max_accel, max_ang_accel_proxy, max_angvel, ref_v, min_v]
        max_thr, max_ang_acc, max_w, ref_v, min_v = (lim[i] for i in range(5))
        vs = v0 + jnp.linspace(-max_thr * cfg.window_dt,
                               max_thr * cfg.window_dt, cfg.nv)
        vs = jnp.clip(vs, min_v, ref_v)
        ws = w0 + jnp.linspace(-max_ang_acc * cfg.window_dt,
                               max_ang_acc * cfg.window_dt, cfg.nw)
        ws = jnp.clip(ws, -max_w, max_w)
        v = jnp.repeat(vs, cfg.nw)                      # (C,)
        w = jnp.tile(ws, cfg.nv)                        # (C,)

        t = jnp.asarray(ts, v.dtype)                    # (S,)
        wt = w[:, None] * t[None, :]                    # (C, S)
        # w -> 0 limit: straight line
        small = jnp.abs(w)[:, None] < 1e-6
        r = v[:, None] / jnp.where(small, 1.0, w[:, None])
        x = jnp.where(small, v[:, None] * t[None, :], r * jnp.sin(wt))
        y = jnp.where(small, 0.0, r * (1.0 - jnp.cos(wt)))

        # path proximity: mean over rollout samples of min distance to the
        # plan window (robot frame)
        dx = x[:, :, None] - plan_xy[None, None, :, 0]
        dy = y[:, :, None] - plan_xy[None, None, :, 1]
        dist = jnp.sqrt(dx * dx + dy * dy + 1e-12)      # (C, S, P)
        path_pen = jnp.mean(jnp.min(dist, axis=2), axis=1)

        # distance to the local goal at the rollout end — the forward-progress
        # term (ROS dwa_local_planner's goal_distance_bias; a heading-angle
        # term instead rewards spinning in place, a measured failure mode)
        xe, ye = x[:, -1], y[:, -1]
        goal_pen = jnp.hypot(goal_xy[0] - xe, goal_xy[1] - ye)

        vel_pen = jnp.abs(v - ref_v)

        score = -(cfg.w_path * path_pen + cfg.w_goal * goal_pen
                  + cfg.w_vel * vel_pen + cfg.w_turn * jnp.abs(w))
        def apply_clearance(oc, score):
            """oc (C, S) obstacle cost along each rollout: hard-veto
            colliding candidates, bias the rest by mean clearance."""
            colliding = jnp.max(oc, axis=1) > cfg.veto_cost
            return (score - cfg.w_clear * jnp.mean(oc, axis=1)
                    - jnp.where(colliding, 1e6, 0.0))

        if with_omap:
            from ..models.obstacles import bilinear_sample

            oc = omap.weight * bilinear_sample(
                omap.grid, omap.origin, omap.resolution,
                jnp.stack([x, y], -1))                   # (C, S)
            score = apply_clearance(oc, score)
        if with_blobs:
            # per-point blob penalty, summed over blobs only
            bdx = x[:, :, None] - blobs.cx
            bdy = y[:, :, None] - blobs.cy
            bc = jnp.sum(blobs.w * jnp.exp(
                -(bdx * bdx + bdy * bdy) * blobs.gamma), axis=-1)
            score = apply_clearance(bc, score)
        best = jnp.argmax(score)
        return v[best], w[best]

    return f


class DWAPlanner(MPCPlanner):
    """Dynamic Window Approach inside the shared planner lifecycle.

    Like the reference benchmark's `dwa_local_planner`, candidates are
    (v, w) pairs reachable within one acceleration window, each scored on a
    short constant-twist rollout by path proximity, end heading to the local
    goal, speed tracking, and (optionally) obstacle clearance. Unlike the
    ROS implementation's nested loops, the whole window is one batched XLA
    program. Set `self.tracker.obstacle_map` (grid) or `.obstacles`
    (GaussianObstacles, robot frame) for clearance scoring."""

    def __init__(self, params: MPCParams = MPCParams(),
                 planner_cfg: PlannerConfig = PlannerConfig(),
                 dwa_cfg: DWAConfig = DWAConfig(),
                 max_ang_accel: float = 3.0,
                 **kw):
        super().__init__(params=params, planner_cfg=planner_cfg, **kw)
        self.dwa_cfg = dwa_cfg
        self.max_ang_accel = max_ang_accel

    def _make_tracker(self):
        t = _BaselineTracker(self.params)
        t.w = 0.0
        t.obstacle_map = None
        t.obstacles = None
        return t

    def _tracking_command(self, pose, feedback_vel, cut):
        import jax.numpy as jnp

        ref_plan = plan_utils.downsample_plan(
            cut, self.planner_cfg.downsample_segments)
        p = self.params
        cfg = self.dwa_cfg
        v_fb = float(feedback_vel[0])

        ref_v = _scheduled_ref_vel(p, self.planner_cfg, pose, self.goal, v_fb)

        # world -> robot frame plan window, padded to the static size
        ct, st = np.cos(pose[2]), np.sin(pose[2])
        dx = cut[:, 0] - pose[0]
        dy = cut[:, 1] - pose[1]
        pts = np.stack([dx * ct + dy * st, dy * ct - dx * st], -1)
        if len(pts) >= cfg.plan_points:
            idx = np.linspace(0, len(pts) - 1, cfg.plan_points).round()
            pts = pts[idx.astype(int)]
        else:
            pts = np.concatenate(
                [pts, np.repeat(pts[-1:], cfg.plan_points - len(pts), 0)])
        goal_xy = pts[-1]

        # unconditional: set_obstacles(None) must clear the stale snapshot
        self.tracker.obstacles = (
            self.world_obstacles.to_frame(pose)
            if self.world_obstacles is not None else None)
        omap = self.tracker.obstacle_map
        blobs = self.tracker.obstacles
        f = _dwa_eval_jit(cfg, omap is not None, blobs is not None)
        lim = jnp.asarray([float(p.max_throttle), self.max_ang_accel,
                           float(p.max_angvel), ref_v,
                           0.0], jnp.float32)
        kw = {}
        if omap is not None:
            kw["omap"] = omap
        if blobs is not None:
            kw["blobs"] = blobs
        # center the dynamic window on the MEASURED state, not the last
        # command: after an external stop/safety override the commanded
        # speed is stale and the window would span dynamically infeasible
        # candidates (the guarantee DWA is named after)
        v_cmd, w_cmd = f(jnp.float32(v_fb),
                         jnp.float32(float(feedback_vel[1])),
                         lim, jnp.asarray(pts, jnp.float32),
                         jnp.asarray(goal_xy, jnp.float32), **kw)
        v_cmd, w_cmd = float(v_cmd), float(w_cmd)
        self.tracker.speed = v_cmd
        self.tracker.w = w_cmd
        return (v_cmd, w_cmd), ref_plan, None, None
