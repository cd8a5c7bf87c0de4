"""Planner lifecycle API — the nav_core::BaseLocalPlanner successor.

Mirrors the reference plugin surface
(/root/reference/mpc_ros/include/mpc_planner_ros.h:72-75):

    initialize / set_plan / compute_velocity_commands / is_goal_reached

with pluggable observability callbacks in place of ROS topics (SURVEY.md
§7.1-4). Pose and feedback velocity are supplied by the caller (the
transport shim / simulator) instead of tf+costmap; everything else —
latched goal tolerances, plan cutoff & downsampling, FSM dispatch, the
predicted-trajectory record — reproduces the reference behavior, quirk
fixes documented inline.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from ..config import MPCParams, PlannerConfig, SolverConfig
from . import plan_utils
from .fsm import DrivingState, check_transition, normalize_angle, rotate_command, seed_state
from .tracking import TrackingController, TrackingDebug


@dataclasses.dataclass
class CycleInfo:
    """Per-cycle observability record — successor of the 4 ROS Path topics
    (/root/reference/mpc_ros/src/mpc_planner_ros.cpp:73-76) and the
    write-only cost accumulators."""

    state: DrivingState
    cmd: tuple[float, float]
    local_plan: np.ndarray
    ref_plan: np.ndarray
    mpc_trajectory: Optional[np.ndarray]   # (N, 3) x, y, theta in robot frame
    tracking: Optional[TrackingDebug]
    solve_time_s: float


class MPCPlanner:
    """Local planner with the reference's lifecycle semantics."""

    def __init__(self, params: MPCParams = MPCParams(),
                 solver_cfg: SolverConfig = SolverConfig(),
                 planner_cfg: PlannerConfig = PlannerConfig(),
                 dtype=None):
        import jax
        import jax.numpy as jnp

        self._initialized = False
        self.params = params
        self.solver_cfg = solver_cfg
        self.planner_cfg = planner_cfg
        if dtype is None:
            dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        self.dtype = dtype
        self.on_cycle: Optional[Callable[[CycleInfo], None]] = None

    # -- lifecycle ---------------------------------------------------------

    def initialize(self) -> None:
        """Bring-up (reference `initialize`,
        /root/reference/mpc_ros/src/mpc_planner_ros.cpp:38-92): seeds the
        FSM in ReachedAndIdle and builds the tracking controller."""
        self.state = DrivingState.REACHED_AND_IDLE
        self.tracker = self._make_tracker()
        # Ackermann-style families cannot rotate in place: skip the
        # reference's rotate behaviors (Tracking absorbs heading errors)
        # and relax goal completion to position + stopped (see
        # models.base.Model.can_rotate_in_place)
        from ..models.base import get_model

        self._can_rotate = get_model(self.solver_cfg.model).can_rotate_in_place
        self.global_plan: Optional[np.ndarray] = None
        self.latch_xy = False
        self.latch_yaw = False
        self.set_new_goal = False
        # survives re-initialization, like the reference's costmap wiring
        self.world_obstacles = getattr(self, "world_obstacles", None)
        self._initialized = True

    def set_obstacles(self, blobs) -> None:
        """Install WORLD-frame parametric obstacles
        (models.obstacles.GaussianObstacles, leaves (K,)). Each Tracking
        cycle transforms them into the robot frame and feeds them to the
        solver (and to DWA clearance scoring in the baseline planner) —
        the obstacle awareness the reference wired to its costmap but never
        used in the NLP. Pass None to clear."""
        self.world_obstacles = blobs

    def set_costmap(self, omap, n_blobs: int = 4,
                    refine: bool = False) -> None:
        """Convert a WORLD-frame costmap snapshot (models.obstacles.
        ObstacleMap) to parametric obstacles and install them — the
        single-robot production costmap route (the fleet twin is
        FleetPlanner.set_costmaps). Greedy fit ~1.2 ms/map; `refine=True`
        adds the scipy bounded LSQ (~10 s/map — map-update rate only;
        tightens plateau-style maps from ~12% to ~2% mean error). Pass
        None to clear. Closed-loop fidelity of the per-cycle fit pipeline
        vs grid-truth is pinned in tests/test_obstacle_fit.py."""
        if omap is None:
            self.set_obstacles(None)
            return
        from ..models.obstacles import fit_gaussians_to_map

        self.set_obstacles(fit_gaussians_to_map(omap, n_blobs,
                                                refine=refine))

    def _make_tracker(self):
        """Build the Tracking-state controller. Baseline planners
        (planner.baselines) override this together with `_tracking_command`
        to reuse the whole lifecycle (FSM, latching, plan pipeline) with a
        different inner control law — the same substitution the reference's
        A/B benchmark did by swapping the move_base local planner plugin."""
        return TrackingController(self.params, self.solver_cfg,
                                  self.planner_cfg, self.dtype)

    def _tracking_command(self, pose: np.ndarray,
                          feedback_vel: tuple[float, float],
                          cut: np.ndarray):
        """Inner control law of the TRACKING state. Returns
        (cmd, ref_plan, predicted_traj_or_None, TrackingDebug_or_None)."""
        ref_plan = plan_utils.downsample_plan(
            cut, self.planner_cfg.downsample_segments)
        # assign unconditionally: set_obstacles(None) must CLEAR the
        # tracker's snapshot (a stale robot-frame copy would keep repelling
        # from phantom offsets glued to the robot)
        self.tracker.obstacles = (
            self.world_obstacles.to_frame(pose)
            if self.world_obstacles is not None else None)
        (v_cmd, w_cmd), tracking_dbg = self.tracker.compute(
            pose, self.goal, feedback_vel[0], ref_plan, raw_plan=cut)
        mpc_traj = None
        if tracking_dbg.solve is not None:
            zs = np.asarray(tracking_dbg.solve.zs)
            mpc_traj = zs[:, :3]  # x, y, theta in robot base frame
        return (v_cmd, w_cmd), ref_plan, mpc_traj, tracking_dbg

    def reconfigure(self, params: MPCParams = None,
                    planner_cfg: PlannerConfig = None) -> None:
        """Runtime reconfiguration (successor of dynamic_reconfigure,
        /root/reference/mpc_ros/src/mpc_planner_ros.cpp:94-120). Numeric
        solver params hot-reload without recompilation."""
        if params is not None:
            self.params = params
            self.tracker.update_params(params)
        if planner_cfg is not None:
            self.planner_cfg = planner_cfg
            self.tracker.planner_cfg = planner_cfg

    def set_plan(self, plan: np.ndarray, pose: np.ndarray,
                 feedback_vel: tuple[float, float] = (0.0, 0.0)) -> bool:
        """New global plan. plan: (M, 3) world waypoints (x, y, yaw); the
        goal is the final pose (reference `setPlan`,
        /root/reference/mpc_ros/src/mpc_planner_ros.cpp:134-166).

        `feedback_vel` is accepted for interface uniformity but does not
        influence seeding — exactly like the reference, whose setPlan
        fetches the robot velocity via updateInputs and then seeds the FSM
        from position/heading alone (:146-163)."""
        if not self._initialized:
            return False
        plan = np.asarray(plan, float)
        if plan.ndim != 2 or len(plan) == 0:
            return False
        if plan.shape[1] < 3:
            # synthesize tangent headings: downstream goal-yaw logic
            # (orientation latch, StopAndRotate) indexes column 2
            yaw = np.zeros(len(plan))
            if len(plan) >= 2:
                d = np.diff(plan[:, :2], axis=0)
                yaw[:-1] = np.arctan2(d[:, 1], d[:, 0])
                yaw[-1] = yaw[-2]
            plan = np.concatenate([plan[:, :2], yaw[:, None]], axis=1)
        self.global_plan = plan
        self.set_new_goal = True
        self.tracker.reset()

        cut = plan_utils.cutoff_plan(plan, np.asarray(pose[:2]))
        below = (not self._can_rotate) or self._below_heading_error(pose, cut)
        self.state = seed_state(
            position_reached=self._is_position_reached(pose),
            below_heading_error=below,
        )
        return True

    # -- queries -----------------------------------------------------------

    @property
    def goal(self) -> Optional[np.ndarray]:
        if self.global_plan is None or len(self.global_plan) == 0:
            return None
        return self.global_plan[-1]

    def _is_position_reached(self, pose: np.ndarray) -> bool:
        """Latched xy tolerance (reference `isPositionReached`,
        /root/reference/mpc_ros/src/mpc_planner_ros.cpp:181-196)."""
        goal = self.goal
        if goal is None:
            return False
        within = (np.hypot(pose[0] - goal[0], pose[1] - goal[1])
                  <= self.planner_cfg.limits.xy_goal_tolerance)
        if not self.set_new_goal and self.latch_xy:
            return True
        self.set_new_goal = False
        self.latch_xy = bool(within)
        return self.latch_xy

    def _is_orientation_reached(self, pose: np.ndarray,
                                feedback_vel: tuple[float, float]) -> bool:
        """Yaw tolerance + stopped check, latching yaw (reference
        /root/reference/mpc_ros/src/mpc_planner_ros.cpp:229-251)."""
        goal = self.goal
        if goal is None:
            return False
        angle = normalize_angle(pose[2] - goal[2])
        # a family that cannot rotate in place cannot service the yaw
        # tolerance once at the goal position: completion = position +
        # stopped (documented deviation for Ackermann vehicles)
        if not self._can_rotate or (
                abs(angle) <= self.planner_cfg.limits.yaw_goal_tolerance):
            v, w = feedback_vel
            if (abs(v) <= self.planner_cfg.limits.trans_stopped_vel
                    and abs(w) <= self.planner_cfg.limits.theta_stopped_vel):
                self.latch_yaw = True
                return True
        return False

    def _below_heading_error(self, pose: np.ndarray,
                             cutoff: np.ndarray) -> bool:
        """Reference `isBelowErrorTheta`
        (/root/reference/mpc_ros/src/mpc_planner_ros.cpp:253-264)."""
        if len(cutoff) == 0:
            return False
        path_dir = plan_utils.path_heading(cutoff)
        err = normalize_angle(pose[2] - path_dir)
        return abs(err) <= self.planner_cfg.heading_yaw_error_threshold

    def is_goal_reached(self, pose: np.ndarray,
                        feedback_vel: tuple[float, float]) -> bool:
        """Termination query (reference `isGoalReached`,
        /root/reference/mpc_ros/src/mpc_planner_ros.cpp:198-227): both
        latches set -> consume them and force one more cycle."""
        if self.goal is None:
            return False
        if self.latch_xy and self.latch_yaw:
            self.latch_xy = False
            self.latch_yaw = False
            return False
        if self._is_position_reached(pose) and self._is_orientation_reached(
                pose, feedback_vel):
            self.state = DrivingState.REACHED_AND_IDLE
            return True
        return False

    # -- the hot path ------------------------------------------------------

    def compute_velocity_commands(self, pose: np.ndarray,
                                  feedback_vel: tuple[float, float]
                                  ) -> tuple[bool, tuple[float, float], CycleInfo]:
        """One control cycle (reference `computeVelocityCommands`,
        /root/reference/mpc_ros/src/mpc_planner_ros.cpp:397-448).

        Returns (ok, (v, w), info)."""
        t0 = time.perf_counter()
        pose = np.asarray(pose, float)
        if not self._initialized or self.global_plan is None:
            return False, (0.0, 0.0), None

        cut = plan_utils.cutoff_plan(self.global_plan, pose[:2])
        if len(cut) == 0:
            return False, (0.0, 0.0), None
        # keep the pruned plan as the live global plan (reference prunes via
        # LocalPlannerUtil each cycle)
        self.global_plan = cut
        # local lookahead window (the costmap-extent clipping analog)
        cut = plan_utils.truncate_by_length(
            cut, self.planner_cfg.local_plan_length)

        position_reached = self._is_position_reached(pose)
        goal_reached = False
        below = False
        if position_reached:
            goal_reached = self._is_orientation_reached(pose, feedback_vel)
        else:
            below = ((not self._can_rotate)
                     or self._below_heading_error(pose, cut))
        self.state = check_transition(
            self.state, position_reached=position_reached,
            goal_reached=goal_reached, below_heading_error=below)

        mpc_traj = None
        tracking_dbg = None
        ref_plan = np.zeros((0, cut.shape[1]))

        if self.state is DrivingState.REACHED_AND_IDLE:
            cmd = (0.0, 0.0)
        elif self.state is DrivingState.STOP_AND_ROTATE:
            # a non-rotating family just stops here; the stopped check then
            # completes the goal (position + stopped)
            cmd = (rotate_command(pose[2], float(self.goal[2]),
                                  self.planner_cfg.rotate_p_gain)
                   if self._can_rotate else (0.0, 0.0))
        elif self.state is DrivingState.ROTATE_BEFORE_TRACKING:
            cmd = rotate_command(pose[2], plan_utils.path_heading(cut),
                                 self.planner_cfg.rotate_p_gain)
        else:  # TRACKING
            cmd, ref_plan, mpc_traj, tracking_dbg = self._tracking_command(
                pose, feedback_vel, cut)

        info = CycleInfo(
            state=self.state, cmd=tuple(cmd), local_plan=cut, ref_plan=ref_plan,
            mpc_trajectory=mpc_traj, tracking=tracking_dbg,
            solve_time_s=time.perf_counter() - t0,
        )
        if self.on_cycle is not None:
            self.on_cycle(info)
        return True, cmd, info
