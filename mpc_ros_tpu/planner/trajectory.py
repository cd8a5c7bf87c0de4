"""Direct trajectory tracking: a reference point that moves in TIME.

Besides the move_base path-tracking plugin, the reference's upstream parent
ships a trajectory-tracking mode — the robot chases a TIME-parameterized
reference ("tracking the trajectory such as infinity-shaped, epitrochoid,
square", /root/reference/README.md:43-46; the launch file
`ref_trajectory_tracking_gazebo.launch` is claimed but absent from the fork,
SURVEY.md §4.3). Path tracking answers "stay on this curve"; trajectory
tracking answers "be HERE at time t" — it must also recover the schedule
after disturbances, not only the geometry.

Here the mode is built on the solver's per-stage reference profiles
(solver/ilqr.py `refs`): each control cycle,

1. sample the timed reference at the horizon knots t_now + k*dt — the
   lookahead window follows the MOVING point, not the robot's progress;
2. fit the solver's cubic to those future reference positions in the robot
   frame (the same error-state NLP as path tracking — FG_eval semantics,
   /root/reference/mpc_ros/src/mpc_planner.cpp:122-147 — so the whole
   solver stack is reused: the single-robot tracker runs the XLA path via
   the transfer-lean _single_cycle_jit, and the fleet tracker's batched solve runs the
   whole-solve kernel's native per-stage setpoint profiles on a GPU
   (kernels/solve_pallas.py `refs`));
3. build the per-knot speed profile ref_vel[k] = |dr/dt|(t_now + k*dt) plus
   a proportional catch-up on the longitudinal time lag, so the solver
   speeds up when behind schedule and eases off when ahead;
4. solve with `refs` and emit the first control, exactly like Tracking.

Host-side float64 numpy for the per-cycle sampling/fit (tiny), compiled
fixed-shape solve on device — one program, reused every cycle.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import jax.numpy as jnp

from ..config import MPCParams, PlannerConfig, SolverConfig
from ..models.base import get_model
from .fsm import normalize_angle


import functools


@functools.lru_cache(maxsize=None)
def _single_cycle_jit(cfg: SolverConfig, with_blobs: bool = False):
    """Transfer-lean jitted single-robot trajectory cycle — the tracking._cycle_jit
    diet for the refs mode: one packed (6+C+N,) upload (state, coeffs,
    per-knot speed profile; the cte/etheta setpoint columns are zeros and
    are built on device), device-resident warm-start carry, one packed
    observability fetch. Zero carry == the cold start (see _cycle_jit).
    `with_blobs`: robot-frame GaussianObstacles leaves ((K,)) join the
    upload — obstacle-aware trajectory tracking (refs + blobs compose in
    the solver)."""
    import jax

    from ..solver import ilqr

    @jax.jit
    def f(inp, prev_us, p, *blob_leaves):
        z0 = inp[: 6]
        coeffs = inp[6: 6 + cfg.n_coeffs]
        v_ref = inp[6 + cfg.n_coeffs:]
        zero = jnp.zeros((cfg.n_steps,), inp.dtype)
        refs = jnp.stack([zero, zero, v_ref], axis=-1)
        u_init = jnp.concatenate([prev_us[1:], prev_us[-1:]])
        blobs = None
        if with_blobs:
            from ..models.obstacles import GaussianObstacles

            blobs = GaussianObstacles(*blob_leaves)
        r = ilqr.solve(z0, coeffs, p, cfg, u_init=u_init, refs=refs,
                       blobs=blobs)
        dtype = inp.dtype
        flat = jnp.concatenate([
            r.us.reshape(-1), r.zs.reshape(-1),
            jnp.stack([r.cost, r.converged.astype(dtype),
                       r.n_iters.astype(dtype), r.grad_norm, r.reg])])
        return flat, r.us

    return f


@dataclasses.dataclass
class TimedTrajectory:
    """A reference trajectory with explicit timestamps.

    xy: (M, 2) world positions; yaw: (M,) tangents; t: (M,) strictly
    increasing times [s]. Build from a geometric path + speed profile with
    `from_path`.
    """

    xy: np.ndarray
    yaw: np.ndarray
    t: np.ndarray

    def __post_init__(self):
        self.xy = np.asarray(self.xy, float)
        self.yaw = np.asarray(self.yaw, float)
        self.t = np.asarray(self.t, float)
        if not np.all(np.diff(self.t) > 0):
            raise ValueError("timestamps must be strictly increasing")
        # unwrapped yaw so interpolation never crosses the +-pi seam
        self._yaw_unwrapped = np.unwrap(self.yaw)

    @property
    def duration(self) -> float:
        return float(self.t[-1] - self.t[0])

    @staticmethod
    def from_path(plan: np.ndarray, speed) -> "TimedTrajectory":
        """Time-parameterize a geometric plan (M, >=2 [x, y[, yaw]]) by a
        speed profile: scalar (constant speed) or (M,) per-waypoint speeds.
        Timestamps follow from arclength: dt_i = ds_i / v_mid_i."""
        plan = np.asarray(plan, float)
        # planner output frequently repeats waypoints; zero-length segments
        # would produce dt=0 and fail the strictly-increasing check
        seg = np.hypot(*np.diff(plan[:, :2], axis=0).T)
        keep = np.concatenate([[True], seg > 1e-9])
        plan = plan[keep]
        xy = plan[:, :2]
        if plan.shape[1] >= 3:
            yaw = plan[:, 2]
        else:
            d = np.gradient(xy, axis=0)
            yaw = np.arctan2(d[:, 1], d[:, 0])
        ds = np.hypot(*np.diff(xy, axis=0).T)
        v = np.broadcast_to(np.asarray(speed, float), (len(xy),))
        v_mid = np.maximum(0.5 * (v[1:] + v[:-1]), 1e-6)
        t = np.concatenate([[0.0], np.cumsum(ds / v_mid)])
        return TimedTrajectory(xy=xy, yaw=yaw, t=t)

    def sample(self, times: np.ndarray):
        """Reference state at arbitrary times (clamped to [t0, tN]).

        Returns (xy (K, 2), yaw (K,), speed (K,)); speed is 0 beyond the
        end — the reference point stops at the goal, and the tracker's
        speed profile decays with it."""
        times = np.asarray(times, float)
        tc = np.clip(times, self.t[0], self.t[-1])
        x = np.interp(tc, self.t, self.xy[:, 0])
        y = np.interp(tc, self.t, self.xy[:, 1])
        yaw = np.interp(tc, self.t, self._yaw_unwrapped)
        # speed of the moving point: |dr/dt| of the linear interpolant, i.e.
        # segment arclength over segment duration
        ds = np.hypot(*np.diff(self.xy, axis=0).T)
        dt = np.diff(self.t)
        v_seg = ds / dt
        k = np.clip(np.searchsorted(self.t, tc, side="right") - 1,
                    0, len(v_seg) - 1)
        v = v_seg[k]
        v = np.where(times > self.t[-1], 0.0, v)
        v = np.where(times < self.t[0], 0.0, v)
        return np.stack([x, y], axis=-1), yaw, v


@dataclasses.dataclass
class TrajectoryDebug:
    """Per-cycle observability record for the trajectory mode."""

    coeffs: np.ndarray
    state: np.ndarray       # solver z0 (error state)
    refs: np.ndarray        # (N, 3) per-knot setpoint profile
    ref_point: np.ndarray   # (2,) where the reference is NOW
    lag: float              # longitudinal lag behind the reference [m] (>0 = behind)
    solve: object
    cost: float


class TrajectoryTracker:
    """Tracks a `TimedTrajectory` with the per-stage-profile NMPC solve.

    The direct analog of the upstream `ref_trajectory_tracking` node; owns
    the same cross-cycle actuation state as the Tracking driving state
    (/root/reference/mpc_ros/include/driving_state.h:64-98)."""

    def __init__(self, params: MPCParams, solver_cfg: SolverConfig,
                 planner_cfg: PlannerConfig = PlannerConfig(),
                 dtype=None, catchup_gain: float = 0.8):
        if dtype is None:
            import jax

            dtype = (jnp.float64 if jax.config.jax_enable_x64
                     else jnp.float32)
        self.params = params.astype(dtype)
        self.solver_cfg = solver_cfg
        self.planner_cfg = planner_cfg
        self.dtype = dtype
        # proportional speed catch-up on the longitudinal time lag [1/s]:
        # ref_vel[k] += gain * lag. 0 disables schedule recovery (pure
        # feedforward speed profile).
        self.catchup_gain = float(catchup_gain)
        self.model = get_model(solver_cfg.model)
        self.traj: Optional[TimedTrajectory] = None
        self.w = 0.0
        self.speed = 0.0
        self._warm_us: Optional[np.ndarray] = None
        self._warm_dev = None
        self.world_obstacles = None

    def set_obstacles(self, blobs) -> None:
        """World-frame parametric obstacles (GaussianObstacles, leaves
        (K,)) to avoid WHILE tracking the timed reference — transformed
        into the robot frame each cycle like MPCPlanner.set_obstacles
        (call every cycle for moving obstacles; constant leaf shapes ->
        no recompile). None clears."""
        self.world_obstacles = blobs

    def set_trajectory(self, traj: TimedTrajectory) -> None:
        self.traj = traj
        self.w = 0.0
        self.speed = 0.0
        self._warm_us = None
        self._warm_dev = None

    def finished(self, t_now: float, pose: np.ndarray) -> bool:
        """Past the schedule end AND inside the xy goal tolerance of the
        final reference point (latched goal logic belongs to the FSM; the
        trajectory mode's stop rule is explicit)."""
        if self.traj is None:
            return True
        done_t = t_now >= float(self.traj.t[-1])
        d = float(np.hypot(pose[0] - self.traj.xy[-1, 0],
                           pose[1] - self.traj.xy[-1, 1]))
        return done_t and d <= self.planner_cfg.limits.xy_goal_tolerance

    def compute(self, t_now: float, pose: np.ndarray, feedback_v: float):
        """One control cycle at wall/sim time `t_now`.

        pose: (x, y, yaw); returns ((v_cmd, w_cmd), TrajectoryDebug)."""
        assert self.traj is not None, "set_trajectory first"
        cfg = self.solver_cfg
        N = cfg.n_steps
        dt = float(np.asarray(self.params.dt))
        px, py, theta = float(pose[0]), float(pose[1]), float(pose[2])
        v = float(feedback_v)

        times = t_now + dt * np.arange(N)
        pts, yaws, speeds = self.traj.sample(times)

        # world -> robot frame (same rotation as the Tracking state,
        # /root/reference/mpc_ros/src/driving_state.cpp:196-207) of the
        # FUTURE reference positions
        ct, st = np.cos(theta), np.sin(theta)
        dx = pts[:, 0] - px
        dy = pts[:, 1] - py
        x_veh = dx * ct + dy * st
        y_veh = dy * ct - dx * st

        # the cubic needs spatial spread; near the schedule end sample()
        # clamps trailing knots onto the final waypoint, so cap the degree
        # by the number of DISTINCT abscissae (not just the total span) to
        # keep the fit well-conditioned (no RankWarning cubics on 2 points)
        n_distinct = int(np.sum(np.abs(np.diff(np.sort(x_veh))) > 1e-6)) + 1
        order = min(cfg.poly_order, N - 1, max(n_distinct - 1, 0))
        if float(np.ptp(x_veh)) < 1e-3:
            order = 0
        c = np.polyfit(x_veh, y_veh, order)[::-1]
        coeffs = np.zeros(cfg.n_coeffs)
        coeffs[: len(c)] = c
        cte = float(np.polyval(coeffs[::-1], 0.0))
        # heading error vs the reference tangent NOW, wrapped (quirk Q13
        # fixed — the trajectory mode has no legacy formula to preserve)
        etheta = normalize_angle(theta - float(yaws[0]))

        # longitudinal lag: signed projection of (ref_now - robot) onto the
        # reference tangent. >0 = behind schedule -> speed up.
        hx, hy = np.cos(yaws[0]), np.sin(yaws[0])
        lag = float(dx[0] * hx + dy[0] * hy)

        v_ref = speeds + self.catchup_gain * lag
        v_ref = np.clip(v_ref, 0.0, self.planner_cfg.max_speed)
        refs = np.stack(
            [np.zeros(N), np.zeros(N), v_ref], axis=-1)

        state = np.array([0.0, 0.0, 0.0, v, cte, etheta])
        # one packed upload + one packed fetch per cycle, warm start
        # device-resident (same diet as tracking._cycle_jit)
        import jax

        from ..solver.types import SolveResult

        inp = np.zeros(6 + cfg.n_coeffs + N)
        inp[:6] = state
        inp[6: 6 + cfg.n_coeffs] = coeffs
        inp[6 + cfg.n_coeffs:] = v_ref
        if self._warm_dev is None:
            self._warm_dev = jnp.zeros((cfg.n_controls, 2), self.dtype)
        blob_leaves = ()
        if self.world_obstacles is not None:
            loc = self.world_obstacles.to_frame((px, py, theta))
            blob_leaves = (jnp.asarray(loc.cx, self.dtype),
                           jnp.asarray(loc.cy, self.dtype),
                           jnp.asarray(loc.gamma, self.dtype),
                           jnp.asarray(loc.w, self.dtype))
        flat, self._warm_dev = _single_cycle_jit(
            cfg, self.world_obstacles is not None)(
            jnp.asarray(inp, self.dtype), self._warm_dev, self.params,
            *blob_leaves)
        flat = np.asarray(jax.device_get(flat), float)
        T = cfg.n_controls
        us = flat[: T * 2].reshape(T, 2)
        zs = flat[T * 2: T * 2 + N * 6].reshape(N, 6)
        cost, convf, itersf, gnorm, reg = flat[T * 2 + N * 6:]
        res = SolveResult(
            us=us, zs=zs, cost=cost, converged=bool(convf > 0.5),
            n_iters=int(itersf), grad_norm=gnorm, reg=reg)
        self._warm_us = us

        self.w = float(us[0, 0])
        throttle = float(us[0, 1])
        self.speed = float(np.clip(v + throttle * dt, 0.0,
                                   self.planner_cfg.max_speed))

        dbg = TrajectoryDebug(
            coeffs=coeffs, state=state, refs=refs, ref_point=pts[0],
            lag=lag, solve=res, cost=float(res.cost))
        return (self.speed, self.w), dbg


import functools as _ft

# device-resident trajectory constants (set_trajectories uploads once per
# goal change; every leaf is leading-B and shards over the data axis)
_TRAJ_CONST_KEYS = ("t", "xy", "yawu", "vseg", "len", "t_next", "x_next",
                    "y_next", "yaw_next", "vseg_pad")


@_ft.lru_cache(maxsize=None)
def _traj_cycle_jit(solver_cfg: SolverConfig, M: int, max_speed: float,
                    catchup_gain: float, l_scale: float, dtype_name: str,
                    has_blobs: bool = False, mesh=None,
                    sharded_leaves: tuple = ()):
    """Whole fleet-trajectory cycle as ONE jitted device program: timed
    sampling, frame transform, batched fit, speed-profile build, warm
    solve, command extraction. The host uploads (B, 4) world state + a
    scalar time per cycle and fetches a (3, B) tile — every per-cycle
    transfer the old host pipeline paid (the (B, N, 3) refs upload and the
    (B, T, 2) warm-bank fetch) stays on device. The per-knot index search
    runs as N masked count-reductions over the padded timelines (no
    (B, M, N) materialization, no large-output gathers — the rule of the
    fleet device pipeline).

    `mesh`: optional jax.sharding.Mesh — the whole cycle runs under
    shard_map over the mesh's data axis (the fleet_device._cycle_jit
    pattern): every stage is per-robot, so each device tracks B/D robots
    with ZERO control-path collectives (SURVEY.md §5.8 rule); trajectory
    constants and the warm bank live on their shard. `sharded_leaves`:
    names of (B,)-shaped per-robot MPCParams leaves."""
    import jax

    from ..solver.batch_lane import batch_solve_lane
    from .fleet_device import _chol_solve_small

    cfg = solver_cfg
    N = cfg.n_steps
    P = cfg.n_coeffs
    dtype = jnp.dtype(dtype_name)

    def fn(consts, warm, world, tnow, p, *blob_leaves):
        t = consts["t"]                  # (B, M), +inf padded
        xy = consts["xy"]                # (B, M, 2), goal padded
        yawu = consts["yawu"]            # (B, M)
        vseg = consts["vseg"]            # (B, Mv)
        plen = consts["len"]             # (B,) int32
        B = t.shape[0]
        b = jnp.arange(B)
        px, py, pth, v_fb = (world[:, i] for i in range(4))
        # the horizon timeline step is the GLOBAL max over per-robot dt,
        # computed host-side and carried in the replicated tnow vector —
        # a jnp.max(p.dt) here would be a per-SHARD max under shard_map
        # (p's per-lane leaves are sharded), silently breaking the
        # sharded==unsharded command parity for heterogeneous dt fleets
        dt = tnow[1].astype(t.dtype)
        times = tnow[0] + dt * jnp.arange(N, dtype=t.dtype)        # (N,)

        t0 = t[:, 0]
        tN = t[b, jnp.maximum(plen - 1, 0)]
        tc = jnp.clip(times[None, :], t0[:, None], tN[:, None])    # (B, N)
        # Per-knot interpolation WITHOUT gathers: searchsorted(side=
        # "right") == count of t <= tc, and the values at k0 / k0+1 are
        # masked sums against the one-hot of the count (the shifted
        # timelines t_next/x_next/... are uploaded once per
        # set_trajectories, so a[k0+1] is a masked sum of the SHIFTED
        # array at k0): fused compare+select reductions are streaming
        # elementwise passes instead of take_along_axis gathers.
        idxM = jnp.arange(M)
        xs0, xs1 = xy[..., 0], xy[..., 1]
        knots = []
        for j in range(N):
            cmp = t <= tc[:, j:j + 1]                 # (B, M)
            k0j = jnp.clip(jnp.sum(cmp.astype(jnp.int32), axis=1) - 1,
                           0, M - 2)
            sel = idxM[None, :] == k0j[:, None]
            # select-then-sum (never multiply): the timeline pads are +inf
            # and 0 * inf = NaN would poison every masked sum
            ms = lambda a: jnp.sum(jnp.where(sel, a, 0.0), axis=1)
            knots.append((ms(t), ms(consts["t_next"]),
                          ms(xs0), ms(consts["x_next"]),
                          ms(xs1), ms(consts["y_next"]),
                          ms(yawu), ms(consts["yaw_next"]),
                          ms(consts["vseg_pad"])))
        st_ = lambda i: jnp.stack([kn[i] for kn in knots], axis=1)  # (B, N)
        t_lo, t_hi = st_(0), st_(1)
        w = jnp.where(t_hi > t_lo,
                      (tc - t_lo) / jnp.maximum(t_hi - t_lo, 1e-12), 0.0)
        w = jnp.clip(w, 0.0, 1.0)
        x_s = st_(2) * (1 - w) + st_(3) * w
        y_s = st_(4) * (1 - w) + st_(5) * w
        yaw_s = st_(6) * (1 - w) + st_(7) * w
        v_s = st_(8)
        off = (times[None, :] > tN[:, None]) | (times[None, :] < t0[:, None])
        v_s = jnp.where(off, 0.0, v_s)

        # robot-frame transform + batched masked fit (scaled abscissa,
        # unrolled Cholesky — same recipe as fleet_device)
        ct, st = jnp.cos(pth), jnp.sin(pth)
        dx = x_s - px[:, None]
        dy = y_s - py[:, None]
        x_veh = dx * ct[:, None] + dy * st[:, None]
        y_veh = dy * ct[:, None] - dx * st[:, None]
        n_distinct = jnp.sum(
            (jnp.abs(jnp.diff(jnp.sort(x_veh, axis=1), axis=1))
             > 1e-6).astype(jnp.int32), axis=1) + 1
        order = jnp.minimum(jnp.minimum(cfg.poly_order, N - 1),
                            jnp.maximum(n_distinct - 1, 0))
        ptp = jnp.max(x_veh, axis=1) - jnp.min(x_veh, axis=1)
        order = jnp.where(ptp < 1e-3, 0, order)
        xs = x_veh * (1.0 / l_scale)
        cols = [jnp.ones_like(xs)]
        for q in range(1, P):
            cols.append(cols[-1] * xs)
        V = jnp.stack(cols, axis=-1)
        qmask = (jnp.arange(P)[None, :] <= order[:, None]).astype(t.dtype)
        V = V * qmask[:, None, :]
        # HIGHEST: a GPU may run default-precision f32 products in TF32
        # (~3 decimal digits), too coarse for a Gram matrix
        hi = jax.lax.Precision.HIGHEST
        G = jnp.einsum("bni,bnj->bij", V, V, precision=hi)
        G = G + 1e-12 * jnp.eye(P, dtype=t.dtype)
        rhs = jnp.einsum("bni,bn->bi", V, y_veh, precision=hi)
        unscale = (1.0 / l_scale) ** jnp.arange(P, dtype=t.dtype)
        coeffs = _chol_solve_small(G, rhs) * qmask * unscale[None, :]

        cte = coeffs[:, 0]
        etheta = (pth - yaw_s[:, 0] + jnp.pi) % (2.0 * jnp.pi) - jnp.pi
        hx, hy = jnp.cos(yaw_s[:, 0]), jnp.sin(yaw_s[:, 0])
        lag = dx[:, 0] * hx + dy[:, 0] * hy

        v_ref = jnp.clip(v_s + catchup_gain * lag[:, None], 0.0, max_speed)
        zN = jnp.zeros_like(v_ref)
        refs = jnp.stack([zN, zN, v_ref], axis=-1).astype(dtype)
        z = jnp.zeros(B, t.dtype)
        z0s = jnp.stack([z, z, z, v_fb, cte, etheta], axis=1).astype(dtype)
        u_init = jnp.concatenate([warm[:, 1:], warm[:, -1:]],
                                 axis=1).astype(dtype)
        blobs = None
        if has_blobs:
            from ..models.obstacles import GaussianObstacles
            from .fleet import _blobs_to_frames

            wob = GaussianObstacles(*blob_leaves)
            blobs = _blobs_to_frames(wob, world[:, :3], dtype)
        res = batch_solve_lane(z0s, coeffs.astype(dtype), p, cfg,
                               u_init=u_init, refs=refs, blobs=blobs)
        u0 = res.us[:, 0, :].astype(t.dtype)
        v_cmd = jnp.clip(v_fb + u0[:, 1] * dt, 0.0, max_speed)
        out = jnp.stack([v_cmd, u0[:, 0], lag])
        # per-robot observability tile (the DeviceFleetPlanner obs
        # pattern): (6, B) = cte, etheta, ref_v[0], cost, converged,
        # iters — fetched only when the host wants it (obs_every)
        obs = jnp.stack([
            cte.astype(t.dtype), etheta.astype(t.dtype), v_ref[:, 0],
            res.cost.astype(t.dtype),
            res.converged.astype(t.dtype),
            res.n_iters.astype(t.dtype)])
        return res.us, out, obs

    if mesh is not None:
        import dataclasses as _dc

        from jax.sharding import PartitionSpec as Ps

        from ..parallel.mesh import DATA_AXIS

        d = Ps(DATA_AXIS)
        consts_spec = {k: d for k in _TRAJ_CONST_KEYS}
        p_spec = MPCParams(**{
            f.name: (d if f.name in sharded_leaves else Ps())
            for f in _dc.fields(MPCParams)})
        in_specs = [consts_spec, d, d, Ps(), p_spec]
        if has_blobs:
            in_specs += [d] * 4
        fn = jax.shard_map(fn, mesh=mesh, in_specs=tuple(in_specs),
                           out_specs=(d, Ps(None, DATA_AXIS),
                                      Ps(None, DATA_AXIS)),
                           check_vma=False)
    return jax.jit(fn, donate_argnums=(1,))


class FleetTrajectoryTracker:
    """B robots chasing B timed references with ONE batched solve/cycle.

    The fleet twin of `TrajectoryTracker` (same per-cycle math,
    vectorized): trajectories live in padded (B, M) buffers, the horizon
    sampling is one flat searchsorted over all robots, the cubic fits are
    batched normal equations, and the per-stage setpoint profiles go
    through `batch_solve_lane(refs=...)` in a single program (the
    whole-solve kernel on a GPU). Extends
    the upstream ref_trajectory_tracking capability
    (/root/reference/README.md:43-46) to fleet serving.

    `pipeline="device"` runs the WHOLE cycle (sampling, fit, profile
    build, solve) as one jitted device program with a device-resident
    warm bank — one (B, 4) upload and one (3, B) fetch per cycle
    (equivalence with the host pipeline pinned in
    tests/test_trajectory_tracking.py). The default "host" pipeline keeps
    the per-cycle math in float64 numpy.
    """

    def __init__(self, params: MPCParams, solver_cfg: SolverConfig,
                 planner_cfg: PlannerConfig = PlannerConfig(),
                 dtype=None, catchup_gain: float = 0.8,
                 pipeline: str = "host", mesh=None, obs_every: int = 0):
        """`mesh`: optional jax.sharding.Mesh (device pipeline only) —
        the one-jit cycle runs under shard_map over the mesh's data axis,
        B/D robots per device, zero control-path collectives; sharded ==
        unsharded command-for-command (tests/test_trajectory_tracking.py,
        dryrun phase 7).

        `obs_every`: populate `self.last_obs` — a (6, B) per-robot tile
        (cte, etheta, ref_v[0], cost, converged, iters), the
        DeviceFleetPlanner observability pattern — every K cycles
        (0 = never, the transfer-lean default: commands + lag only on
        the wire; on skipped cycles last_obs is None)."""
        if dtype is None:
            import jax

            dtype = (jnp.float64 if jax.config.jax_enable_x64
                     else jnp.float32)
        self.params = params.astype(dtype)
        self.solver_cfg = solver_cfg
        self.planner_cfg = planner_cfg
        self.dtype = dtype
        self.catchup_gain = float(catchup_gain)
        assert pipeline in ("host", "device"), pipeline
        assert mesh is None or pipeline == "device", \
            "mesh sharding requires pipeline='device' (the host pipeline " \
            "already shards its batched solve via parallel.sharded)"
        self.pipeline = pipeline
        self.mesh = mesh
        self.obs_every = int(obs_every)
        self.last_obs: Optional[np.ndarray] = None
        self._cycle_count = 0
        self.model = get_model(solver_cfg.model)
        self.B = 0
        self._warm_us: Optional[np.ndarray] = None
        self.world_obstacles = None

    def _shard(self, a):
        """Shard a leading-B array over the mesh's data axis (identity
        without a mesh)."""
        if self.mesh is None:
            return a
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.mesh import DATA_AXIS

        return jax.device_put(a, NamedSharding(self.mesh, P(DATA_AXIS)))

    def set_obstacles(self, blobs) -> None:
        """World-frame per-robot parametric obstacles (GaussianObstacles,
        leaves (B, K)) to avoid while tracking — the fleet twin of
        TrajectoryTracker.set_obstacles (per-robot frame transform runs
        in the cycle; on the device pipeline the leaves join the per-cycle
        upload). None clears."""
        self.world_obstacles = blobs

    def set_trajectories(self, trajs: list) -> None:
        """Install B `TimedTrajectory` objects (padded internally)."""
        B = len(trajs)
        self.B = B
        M = max(len(tr.t) for tr in trajs)
        self._xy = np.zeros((B, M, 2))
        self._yawu = np.zeros((B, M))
        self._t = np.full((B, M), np.inf)
        self._len = np.zeros(B, np.int64)
        self._vseg = np.zeros((B, max(M - 1, 1)))
        for i, tr in enumerate(trajs):
            n = len(tr.t)
            self._len[i] = n
            self._xy[i, :n] = tr.xy
            # pad with the final waypoint so clamped samples park there
            self._xy[i, n:] = tr.xy[-1]
            self._yawu[i, :n] = tr._yaw_unwrapped
            self._yawu[i, n:] = tr._yaw_unwrapped[-1]
            self._t[i, :n] = tr.t
            ds = np.hypot(*np.diff(tr.xy, axis=0).T)
            dt_ = np.diff(tr.t)
            self._vseg[i, :n - 1] = ds / dt_
        self._t_end = np.array([tr.t[-1] for tr in trajs])
        self._goal = np.stack([tr.xy[-1] for tr in trajs])
        self._warm_us = None
        self.last_obs = None
        self._cycle_count = 0
        if self.pipeline == "device":
            f32 = jnp.float32
            sh = self._shard
            shift = lambda a: np.concatenate([a[:, 1:], a[:, -1:]], axis=1)
            M = self._t.shape[1]
            vseg_pad = np.zeros((B, M))
            vseg_pad[:, : self._vseg.shape[1]] = self._vseg
            self._dev_consts = {
                "t": sh(jnp.asarray(self._t, f32)),
                "xy": sh(jnp.asarray(self._xy, f32)),
                "yawu": sh(jnp.asarray(self._yawu, f32)),
                "vseg": sh(jnp.asarray(self._vseg, f32)),
                "len": sh(jnp.asarray(self._len, jnp.int32)),
                # shifted timelines: a[k0+1] = masked sum of shift(a) at
                # k0 — lets the per-knot interpolation avoid gathers
                "t_next": sh(jnp.asarray(shift(self._t), f32)),
                "x_next": sh(jnp.asarray(shift(self._xy[..., 0]), f32)),
                "y_next": sh(jnp.asarray(shift(self._xy[..., 1]), f32)),
                "yaw_next": sh(jnp.asarray(shift(self._yawu), f32)),
                "vseg_pad": sh(jnp.asarray(vseg_pad, f32)),
            }

    def finished(self, t_now: float, poses: np.ndarray) -> np.ndarray:
        """(B,) flags: past the schedule end AND inside the xy tolerance."""
        d = np.hypot(poses[:, 0] - self._goal[:, 0],
                     poses[:, 1] - self._goal[:, 1])
        return ((t_now >= self._t_end)
                & (d <= self.planner_cfg.limits.xy_goal_tolerance))

    def _sample(self, times: np.ndarray):
        """Vectorized TimedTrajectory.sample over the fleet.
        times (B, K) -> (xy (B, K, 2), yaw (B, K), speed (B, K))."""
        B, M = self._t.shape
        K = times.shape[1]
        t0 = self._t[:, 0]
        tN = np.take_along_axis(self._t, (self._len - 1)[:, None], 1)[:, 0]
        tc = np.clip(times, t0[:, None], tN[:, None])
        # one flat searchsorted across all rows: offset each row's (sorted)
        # timeline by i*C with C above every finite time value
        fin = np.isfinite(self._t)
        tmax = float(self._t[fin].max()) if fin.any() else 1.0
        C = tmax + 2.0
        tpad = np.where(fin, self._t, tmax + 1.0)
        base = np.arange(B)[:, None] * C
        flat = (tpad + base).ravel()
        k = np.searchsorted(flat, (tc + base).ravel(), side="right")
        k = (k - (np.arange(B) * M).repeat(K)).reshape(B, K)
        k0 = np.clip(k - 1, 0, M - 2)
        g = lambda a: np.take_along_axis(a, k0, 1)
        t_lo = g(self._t)
        t_hi = np.take_along_axis(self._t, k0 + 1, 1)
        w = np.where(t_hi > t_lo, (tc - t_lo) / np.maximum(t_hi - t_lo,
                                                           1e-12), 0.0)
        w = np.clip(w, 0.0, 1.0)
        x = g(self._xy[..., 0]) * (1 - w) + np.take_along_axis(
            self._xy[..., 0], k0 + 1, 1) * w
        y = g(self._xy[..., 1]) * (1 - w) + np.take_along_axis(
            self._xy[..., 1], k0 + 1, 1) * w
        yaw = g(self._yawu) * (1 - w) + np.take_along_axis(
            self._yawu, k0 + 1, 1) * w
        v = np.take_along_axis(self._vseg,
                               np.clip(k0, 0, self._vseg.shape[1] - 1), 1)
        v = np.where((times > tN[:, None]) | (times < t0[:, None]), 0.0, v)
        return np.stack([x, y], -1), yaw, v

    def compute(self, t_now: float, poses: np.ndarray,
                feedback_v: np.ndarray):
        """One fleet cycle: poses (B, 3), feedback_v (B,).
        Returns (cmds (B, 2) = (v, w), lags (B,))."""
        assert self.B, "set_trajectories first"
        if self.pipeline == "device":
            return self._compute_device(t_now, poses, feedback_v)
        cfg = self.solver_cfg
        N = cfg.n_steps
        B = self.B
        dt = float(np.max(np.asarray(self.params.dt)))
        times = t_now + dt * np.arange(N)[None, :].repeat(B, 0)
        pts, yaws, speeds = self._sample(times)

        th = poses[:, 2]
        ct, st = np.cos(th), np.sin(th)
        dx = pts[..., 0] - poses[:, 0, None]
        dy = pts[..., 1] - poses[:, 1, None]
        x_veh = dx * ct[:, None] + dy * st[:, None]
        y_veh = dy * ct[:, None] - dx * st[:, None]

        # batched cubic fit (normal equations; degree capped by distinct
        # abscissae like the single-robot tracker)
        n_distinct = (np.abs(np.diff(np.sort(x_veh, axis=1), axis=1))
                      > 1e-6).sum(axis=1) + 1
        order = np.minimum(np.minimum(cfg.poly_order, N - 1),
                           np.maximum(n_distinct - 1, 0))
        order = np.where(np.ptp(x_veh, axis=1) < 1e-3, 0, order)
        # ONE padded batched solve for every polynomial order (the old
        # per-order-group Python loop cost a per-cycle host pass — VERDICT
        # r2 item 5): columns above each robot's order are zeroed, which
        # block-decouples them in the regularized normal equations, so the
        # full-P solve returns exactly the reduced-order coefficients
        P = cfg.n_coeffs
        cols = [np.ones_like(x_veh)]
        for q in range(1, P):
            cols.append(cols[-1] * x_veh)
        V = np.stack(cols, axis=-1)                       # (B, N, P)
        qmask = (np.arange(P)[None, :] <= order[:, None]).astype(float)
        V = V * qmask[:, None, :]
        G = np.einsum("bni,bnj->bij", V, V) + 1e-12 * np.eye(P)
        rhs = np.einsum("bni,bn->bi", V, y_veh)
        coeffs = np.linalg.solve(G, rhs[..., None])[..., 0] * qmask

        cte = coeffs[:, 0]
        etheta = (th - yaws[:, 0] + np.pi) % (2.0 * np.pi) - np.pi
        hx, hy = np.cos(yaws[:, 0]), np.sin(yaws[:, 0])
        lag = dx[:, 0] * hx + dy[:, 0] * hy

        v_ref = np.clip(speeds + self.catchup_gain * lag[:, None], 0.0,
                        self.planner_cfg.max_speed)
        refs = np.stack([np.zeros((B, N)), np.zeros((B, N)), v_ref], -1)
        z0s = np.stack([np.zeros(B), np.zeros(B), np.zeros(B),
                        np.asarray(feedback_v, float), cte, etheta], -1)

        u_init = None
        if self._warm_us is not None:
            # the warm bank is DEVICE-resident (res.us from the previous
            # cycle, never fetched): shift it on device instead of fetching
            # the full (B, T, 2) bank every cycle
            from .fleet import _shift_warm_jit

            u_init = _shift_warm_jit()(
                jnp.asarray(self._warm_us, self.dtype),
                jnp.ones(B, bool)).astype(self.dtype)
        if cfg.model in ("diff_drive", "bicycle"):
            # lane-major path: the whole-solve kernel evaluates the
            # per-stage setpoint profiles natively on a GPU (the vmap path
            # off-kernel)
            from ..solver.batch_lane import batch_solve_lane as _solve
        else:
            from ..engine.batch import batch_solve as _solve
        blobs = None
        if self.world_obstacles is not None:
            from .fleet import _blobs_to_frames

            blobs = _blobs_to_frames(self.world_obstacles, poses,
                                     self.dtype)
        res = _solve(jnp.asarray(z0s, self.dtype),
                     jnp.asarray(coeffs, self.dtype), self.params,
                     cfg, u_init=u_init,
                     refs=jnp.asarray(refs, self.dtype), blobs=blobs)
        import jax

        self._warm_us = res.us            # stays on device for next cycle
        want_obs = self.obs_every > 0 and (
            self._cycle_count % self.obs_every == 0)
        self._cycle_count += 1
        if want_obs:
            cost_h, conv_h, it_h = jax.device_get(
                (res.cost, res.converged, res.n_iters))
            self.last_obs = np.stack([
                np.asarray(cte, float), np.asarray(etheta, float),
                np.asarray(v_ref[:, 0], float),
                np.asarray(cost_h, float), np.asarray(conv_h, float),
                np.asarray(it_h, float)])
        else:
            self.last_obs = None
        u0 = np.asarray(jax.device_get(res.us[:, 0, :]), float)
        v_cmd = np.clip(np.asarray(feedback_v, float) + u0[:, 1] * dt,
                        0.0, self.planner_cfg.max_speed)
        return np.stack([v_cmd, u0[:, 0]], -1), lag

    def _compute_device(self, t_now: float, poses: np.ndarray,
                        feedback_v: np.ndarray):
        """One-program device cycle (see _traj_cycle_jit)."""
        import jax

        B = self.B
        cfg = self.solver_cfg
        world = np.empty((B, 4), np.float32)
        world[:, :3] = poses
        world[:, 3] = feedback_v
        world = self._shard(jnp.asarray(world))
        # [t_now, global max dt] — see the dt note in _traj_cycle_jit
        tnow = jnp.asarray(np.float32([t_now,
                                       float(np.max(self.params.dt))]))
        if self._warm_us is None:
            self._warm_us = self._shard(
                jnp.zeros((B, cfg.n_controls, 2), self.dtype))
        blob_leaves = ()
        if self.world_obstacles is not None:
            ob = self.world_obstacles
            blob_leaves = tuple(self._shard(jnp.asarray(a)) for a in
                                (ob.cx, ob.cy, ob.gamma, ob.w))
        from ..config import per_lane_leaf_names

        sharded_leaves = per_lane_leaf_names(self.params)
        fn = _traj_cycle_jit(cfg, self._t.shape[1],
                             float(self.planner_cfg.max_speed),
                             self.catchup_gain,
                             float(max(self.planner_cfg.local_plan_length,
                                       1e-6)),
                             jnp.dtype(self.dtype).name,
                             self.world_obstacles is not None,
                             mesh=self.mesh, sharded_leaves=sharded_leaves)
        warm, out, obs = fn(self._dev_consts, jnp.asarray(self._warm_us,
                                                          self.dtype),
                            world, tnow, self.params, *blob_leaves)
        self._warm_us = warm
        want_obs = self.obs_every > 0 and (
            self._cycle_count % self.obs_every == 0)
        self._cycle_count += 1
        self.last_obs = (np.asarray(jax.device_get(obs), float)
                         if want_obs else None)
        o = np.asarray(jax.device_get(out), float)
        return np.stack([o[0], o[1]], -1), o[2]
