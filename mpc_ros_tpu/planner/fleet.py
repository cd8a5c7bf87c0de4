"""Fleet serving: the full planner lifecycle for B robots, one device solve.

The single-robot `MPCPlanner` mirrors the reference plugin: host-side path
pipeline + one solve per cycle. Production serving is many robots; the
reference's architecture would run one move_base process per robot. Here a
`FleetPlanner` owns B robots' plans, goal latches and FSM states, runs the
whole per-cycle path pipeline (cutoff, window, downsample, robot-frame
transform, polynomial fit, error-state extraction, speed scheduling,
delay-mode prediction) VECTORIZED on the host over padded plan buffers, and
dispatches ONE batched, warm-started `batch_solve_lane` program per cycle —
the megakernel serves every tracking robot in a single launch (see
`bench.py --serving` for the synthetic-reference upper bound: ~16.5M control
cycles/s/chip).

Semantics match `MPCPlanner` robot-by-robot (asserted in tests): the
cutoff walk, window clipping, downsampling rule, 30%-lookahead heading
heuristic, FSM transitions, latched tolerances, quirk fixes (Q12, Q13) and
the deceleration/curvature schedulers are vectorized transcriptions of the
scalar pipeline (plan_utils.py / tracking.py / planner.py, which carry the
reference parity pointers); the polynomial fit is the same least-squares
problem solved batched (padded, zero-weighted columns) in float64.

Two host-side performance rules shape this file:
  * no per-robot Python loops in the cycle path — plans live in ONE padded
    (B, M, 3) buffer with per-robot start/length cursors, and every
    pipeline stage is a masked numpy expression (the loop version cost
    ~115 ms/cycle at B=1024);
  * no stray host reads of device-resident values — params are mirrored in
    a numpy twin (`_np_params`) and the solve results arrive in ONE
    `jax.device_get` (each stray fetch is a device round trip).

This layer is the real-robot serving surface (plans arrive from the
world); for synthetic / device-resident references use `engine.receding`,
which keeps the whole closed loop on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

import jax.numpy as jnp

from ..config import MPCParams, PlannerConfig, SolverConfig
from ..models.base import get_model

# integer FSM codes for vectorized bookkeeping
_TRACK, _ROT_PRE, _ROT_GOAL, _IDLE = range(4)

from .fsm import DrivingState  # noqa: E402  (enum mapping for info records)

_STATE_OF = {
    _TRACK: DrivingState.TRACKING,
    _ROT_PRE: DrivingState.ROTATE_BEFORE_TRACKING,
    _ROT_GOAL: DrivingState.STOP_AND_ROTATE,
    _IDLE: DrivingState.REACHED_AND_IDLE,
}
_CODE_OF = {v: k for k, v in _STATE_OF.items()}


def _wrap(a):
    return (a + np.pi) % (2.0 * np.pi) - np.pi


def _shift_warm_impl(w, has):
    shifted = jnp.concatenate([w[:, 1:], w[:, -1:]], axis=1)
    return jnp.where(has[:, None, None], shifted, 0.0)


import functools as _ft


@_ft.lru_cache(maxsize=1)
def _shift_warm_jit():
    import jax

    return jax.jit(_shift_warm_impl)


@dataclasses.dataclass
class FleetCycleInfo:
    """Per-cycle fleet observability record.

    On the device planner's LEAN cycles (`DeviceFleetPlanner` with
    `obs_every != 1`: commands only on the wire) every row except `cmds`
    is a stale placeholder — `states` is -1, the float rows are NaN, and
    `converged`/`n_iters` are zeros. Gate any aggregation on `observed`
    (below); a raw mean over `converged` would read a lean cycle as
    all-lane solver failure."""

    states: np.ndarray           # (B,) int FSM codes; -1 = not fetched
    cmds: np.ndarray             # (B, 2) applied (v, u0) commands
    ref_vel: np.ndarray          # (B,) scheduled reference speeds
    cte: np.ndarray              # (B,) extracted cross-track errors
    etheta: np.ndarray           # (B,) extracted heading errors
    cost: np.ndarray             # (B,) solve costs (nan for non-tracking)
    converged: np.ndarray        # (B,) solve convergence (False non-tracking)
    n_iters: np.ndarray          # (B,) SQP iterations

    @property
    def observed(self) -> np.ndarray:
        """(B,) bool — True where the observability rows were actually
        fetched this cycle (False on lean device cycles)."""
        return self.states >= 0

    def state_enum(self, i: int) -> DrivingState:
        return _STATE_OF[int(self.states[i])]


class FleetPlanner:
    """B-robot planner with `MPCPlanner` semantics and one batched solve.

    Usage:
        fp = FleetPlanner(params, solver_cfg, planner_cfg)
        fp.initialize(n_robots)
        fp.set_plans(plans, poses)                  # list of (M_i, 3) arrays
        ok, cmds, info = fp.compute_velocity_commands(poses, feedback)
        done = fp.is_goal_reached(poses, feedback)  # (B,) bool

    Commands are (v, omega) for diff_drive and (v, delta) for the bicycle
    family, per `SolverConfig.model` (shared by the whole fleet; per-robot
    numeric parameters like the wheelbase may still vary via (B,)-shaped
    MPCParams leaves).
    """

    def __init__(self, params: MPCParams = MPCParams(),
                 solver_cfg: SolverConfig = SolverConfig(),
                 planner_cfg: PlannerConfig = PlannerConfig(),
                 dtype=jnp.float32, mesh=None):
        """`mesh`: optional jax.sharding.Mesh — the per-cycle solve shards
        the robot batch over the mesh's data axis (each device runs the
        lane solver on B/D robots; no collectives in the control path).
        Requires B divisible by the data-axis size."""
        self.params = params.astype(dtype)
        self.solver_cfg = solver_cfg
        self.planner_cfg = planner_cfg
        self.dtype = dtype
        self.mesh = mesh
        self.model = get_model(solver_cfg.model)
        self._initialized = False
        self.world_obstacles = None
        self._refresh_host_params()

    def _refresh_host_params(self) -> None:
        # host-side numpy twin of the (device-resident) params: every
        # per-cycle host read of a device leaf would otherwise cost a
        # device round trip
        self._np_params = MPCParams(**{
            f.name: np.asarray(getattr(self.params, f.name), float)
            for f in dataclasses.fields(MPCParams)})

    def reconfigure(self, params: MPCParams) -> None:
        """Hot-reload numeric parameters (traced: no recompilation)."""
        self.params = params.astype(self.dtype)
        self._refresh_host_params()

    def _leaf(self, name: str, idx) -> np.ndarray:
        """Host value of a params leaf for the robot subset `idx`:
        per-robot (B,)-shaped leaves index through, scalars broadcast."""
        a = getattr(self._np_params, name)
        return np.broadcast_to(a[idx] if a.ndim else a, np.shape(idx))

    # -- lifecycle -----------------------------------------------------------

    def initialize(self, n_robots: int) -> None:
        B = int(n_robots)
        self.B = B
        self.plans: list[Optional[np.ndarray]] = [None] * B
        # padded plan buffers: xy padded +inf (distance math saturates),
        # per-robot [start, length) cursors; arclength and per-knot
        # curvature are static per plan and precomputed once
        self._buf = np.full((B, 1, 3), np.inf)
        self._buf[..., 2] = 0.0
        self._len = np.zeros(B, np.int64)
        self._start = np.zeros(B, np.int64)
        self._arc = np.full((B, 1), np.inf)
        self._kappa = np.zeros((B, 1))
        self._span = np.zeros((B, 1), np.int64)
        self.states = np.full(B, _IDLE, np.int64)
        self.latch_xy = np.zeros(B, bool)
        self.latch_yaw = np.zeros(B, bool)
        self.set_new_goal = np.zeros(B, bool)
        T = self.solver_cfg.n_controls
        self._warm = np.zeros((B, T, 2))
        self._has_warm = np.zeros(B, bool)
        # cross-cycle actuation state (TrackingController analogs)
        self.speed = np.zeros(B)
        self.w = np.zeros(B)
        self.throttle = np.ones(B)
        self._initialized = True

    def set_obstacles(self, blobs) -> None:
        """World-frame per-robot parametric obstacles
        (models.obstacles.GaussianObstacles with leaves (B, K))."""
        self.world_obstacles = blobs

    def set_costmaps(self, omaps, n_blobs: int = 4) -> None:
        """WORLD-frame per-robot costmap snapshots -> parametric obstacles
        (the production costmap route: grids are fit ONCE here at map-update
        rate; each cycle then runs the megakernel-fast blob costs).

        `omaps`: models.obstacles.ObstacleMap with batched leaves — grid
        (B, H, W), origin (B, 2) in world coordinates, resolution (B,),
        weight (B,) — or None to clear. The conversion is the batched
        jitted device greedy fit (`fit_gaussians_to_maps`: equal to the
        host greedy fit, closed-loop fidelity vs grid-truth pinned in
        tests/test_obstacle_fit.py)."""
        if omaps is None:
            self.set_obstacles(None)
            return
        from ..models.obstacles import fit_gaussians_to_maps

        self.set_obstacles(fit_gaussians_to_maps(omaps, n_blobs))

    def set_plans(self, plans: Sequence[np.ndarray],
                  poses: np.ndarray) -> np.ndarray:
        """Install per-robot global plans. plans[i]: (M_i, 3) world
        waypoints (x, y, yaw); poses (B, 3). Returns (B,) accept flags.
        2-column plans get tangent headings synthesized."""
        assert self._initialized
        poses = np.asarray(poses, float)
        B = self.B
        ok = np.zeros(B, bool)
        norm: list[Optional[np.ndarray]] = list(self.plans)  # carry-over
        for i, plan in enumerate(plans):
            if plan is None:
                continue                 # keep this robot's existing plan
            plan = np.asarray(plan, float)
            if plan.ndim != 2 or len(plan) == 0:
                continue
            if plan.shape[1] < 3:
                yaw = np.zeros(len(plan))
                if len(plan) >= 2:
                    d = np.diff(plan[:, :2], axis=0)
                    yaw[:-1] = np.arctan2(d[:, 1], d[:, 0])
                    yaw[-1] = yaw[-2]
                plan = np.concatenate([plan[:, :2], yaw[:, None]], axis=1)
            norm[i] = plan
            ok[i] = True
        M = max((len(p) for p in norm if p is not None), default=1)
        old_start = self._start.copy()
        self._buf = np.full((B, M, 3), np.inf)
        self._buf[..., 2] = 0.0
        self._len = np.zeros(B, np.int64)
        self._start = np.zeros(B, np.int64)
        for i, plan in enumerate(norm):
            if plan is None:
                continue
            self.plans[i] = plan
            self._buf[i, :len(plan)] = plan
            self._len[i] = len(plan)
            if not ok[i]:                # carried plan: keep its cursor
                self._start[i] = old_start[i]
        self._recompute_plan_geometry()

        # seeding (reference setPlan): latches re-arm, FSM seeds from
        # position/heading (seed = transition with goal_reached=False)
        self.set_new_goal |= ok
        self._has_warm &= ~ok
        self.speed[ok] = 0.0
        self.w[ok] = 0.0
        self.throttle[ok] = 1.0
        start = self._cutoff(poses)
        pos = self._position_reached(poses, ok)
        below = self._below_heading(poses, start, ok)
        seeded = np.where(pos, _ROT_GOAL,
                          np.where(below, _TRACK, _ROT_PRE))
        self.states = np.where(ok, seeded, self.states)
        return ok

    def _recompute_plan_geometry(self) -> None:
        """Derive the static per-plan geometry from the padded buffer:
        cumulative arclength and per-knot curvature |dheading| / mean
        segment (padding: arc=inf, kappa=0)."""
        B = self.B
        with np.errstate(invalid="ignore"):
            d = np.diff(self._buf[:, :, :2], axis=1)   # inf padding -> nan
            ds = np.hypot(d[:, :, 0], d[:, :, 1])          # (B, M-1)
        ds = np.where(np.isfinite(ds), ds, np.inf)
        self._arc = np.concatenate(
            [np.zeros((B, 1)), np.cumsum(ds, axis=1)], axis=1)
        with np.errstate(invalid="ignore"):
            h = np.arctan2(d[:, :, 1], d[:, :, 0])
            dh = _wrap(np.diff(h, axis=1))
            seg = np.maximum(0.5 * (ds[:, 1:] + ds[:, :-1]), 1e-6)
            kap = np.abs(dh) / seg
        # degenerate (zero-length) segments have no heading: drop their
        # knots' curvature (the scalar twin filters them out; it merges
        # the headings across the gap, which we approximate by ignoring)
        tiny = (ds[:, 1:] <= 1e-9) | (ds[:, :-1] <= 1e-9)
        kap = np.where(tiny, 0.0, kap)
        self._kappa = np.where(np.isfinite(kap), kap, 0.0)  # (B, M-2)

        # per-knot lookahead span: span[i, t] = first index j with
        # arc[i, j] > arc[i, t] + L, clamped to len by the pad sentinel.
        # Precomputed once per set_plans so the per-cycle _window_end is a
        # pure (B,) gather instead of an O(B*M) scan (VERDICT r1 item 4).
        # Vectorized per-row searchsorted: rows are flattened with offsets
        # C*i (C > every within-row value), which keeps the flat array
        # globally sorted with exact float arithmetic (offsets ~1e5).
        L = self.planner_cfg.local_plan_length
        M = self._arc.shape[1]
        finite = np.isfinite(self._arc)
        amax = float(self._arc[finite].max()) if finite.any() else 0.0
        C = amax + L + 2.0
        a = np.where(finite, self._arc, amax + L + 1.0)
        base = np.arange(B)[:, None] * C
        flat = (a + base).ravel()
        tgt = (a + L + base).ravel()
        j = np.searchsorted(flat, tgt, side="right")
        self._span = (j - (np.arange(B) * M).repeat(M)).reshape(B, M)

        # windowed curvature max per knot: kmax_win[i, t] = max kappa over
        # [t, end(t) - 2) where end(t) is exactly what _window_end returns
        # for start=t. Precomputed with a sparse table (O(M log W) build)
        # so the per-cycle curvature scheduler is a pure (B,) gather —
        # the (B, W) gather+max it replaces cost ~7 ms/cycle at B=8192.
        Mk = self._kappa.shape[1]
        if Mk > 0:
            t_idx = np.arange(M)[None, :]
            k_rel = np.maximum(
                np.minimum(self._span, self._len[:, None]) - t_idx, 2)
            e_of_t = np.minimum(t_idx + k_rel,
                                np.maximum(self._len[:, None], t_idx + 1))
            tk = np.arange(Mk)[None, :]
            wlen = np.clip(e_of_t[:, :Mk] - 2 - tk, 0, Mk - tk)
            levels = [self._kappa.astype(np.float32)]
            step = 1
            while 2 * step <= int(wlen.max(initial=1)):
                prev = levels[-1]
                if prev.shape[1] - step <= 0:
                    break
                levels.append(np.maximum(prev[:, : prev.shape[1] - step],
                                         prev[:, step:]))
                step *= 2
            kmax = np.zeros((B, Mk), np.float32)
            pos = wlen >= 1
            lvl = np.zeros(wlen.shape, np.int64)
            lvl[pos] = np.log2(wlen[pos]).astype(np.int64)
            for li, st_arr in enumerate(levels):
                m = pos & (lvl == li)
                if not m.any():
                    continue
                ii, tt = np.nonzero(m)
                off = wlen[m] - (1 << li)
                a1 = st_arr[ii, tt]
                a2 = st_arr[ii, np.minimum(tt + off, st_arr.shape[1] - 1)]
                kmax[ii, tt] = np.maximum(a1, a2)
            self._kmax_win = kmax
        else:
            self._kmax_win = np.zeros((B, 1), np.float32)

    # -- checkpoint / resume ---------------------------------------------------

    _STATE_KEYS = ("states", "latch_xy", "latch_yaw", "set_new_goal",
                   "speed", "w", "throttle")

    def state_dict(self) -> dict:
        """The fleet's full resumable serving state: plan buffers/cursors,
        FSM states, goal latches, the warm-start bank, and the cross-cycle
        actuation state. Persist with `obs.checkpoint.save_checkpoint`; a
        restarted server resumes with warm solves and intact goal latches
        (the reference rebuilt everything every cycle — SURVEY.md §5.4)."""
        sd = {
            "buf": self._buf.copy(), "len": self._len.copy(),
            "start": self._start.copy(),
            "warm": np.asarray(self._warm, float),
            "has_warm": self._has_warm.copy(),
        }
        for k in self._STATE_KEYS:
            sd[k] = getattr(self, k).copy()
        return sd

    def load_state_dict(self, sd: dict) -> None:
        """Restore `state_dict()` output into an `initialize(B)`-ed planner
        of the same fleet size and SolverConfig shape."""
        assert self._initialized
        buf = np.asarray(sd["buf"], float)
        assert buf.shape[0] == self.B, (buf.shape, self.B)
        self._buf = buf
        self._len = np.asarray(sd["len"], np.int64)
        self._start = np.asarray(sd["start"], np.int64)
        self._warm = np.asarray(sd["warm"], float)
        assert self._warm.shape == (self.B, self.solver_cfg.n_controls, 2)
        self._has_warm = np.asarray(sd["has_warm"], bool)
        for k in self._STATE_KEYS:
            dtype = getattr(self, k).dtype
            setattr(self, k, np.asarray(sd[k]).astype(dtype))
        self._recompute_plan_geometry()
        self.plans = [self._buf[i, :self._len[i]].copy()
                      if self._len[i] else None for i in range(self.B)]

    # -- vectorized pipeline stages (scalar twins in plan_utils/planner) ------

    def _has_plan(self) -> np.ndarray:
        return self._len > 0

    def _goals(self) -> np.ndarray:
        """(B, 3) goal poses (undefined rows where there is no plan)."""
        last = np.maximum(self._len - 1, 0)
        return self._buf[np.arange(self.B), last]

    def _goal(self, i: int) -> Optional[np.ndarray]:
        if self._len[i] == 0:
            return None
        return self._buf[i, self._len[i] - 1]

    def _cutoff(self, poses) -> np.ndarray:
        """Advance per-robot start cursors past the walked-off prefix
        (vectorized cutoff_plan: first distance increase ends the walk;
        the nearest waypoint is kept — quirk Q12 fix).

        WINDOWED: the cursor advances only a few knots per control cycle,
        so the walk examines W knots from the cursor and extends (rarely)
        only for rows whose distance keeps decreasing through the whole
        window — O(B*W) per cycle instead of the O(B*M) full-plan scan
        that dominated the B=8192 fleet cycle (232 of 274 ms, VERDICT r1
        item 4). The +inf xy padding makes d2 beyond the plan exactly
        +inf, so the first "increase" at the plan boundary terminates the
        walk identically to the full scan."""
        B, M = self._buf.shape[:2]
        W = min(8, M)
        start = self._start.copy()
        px, py = poses[:, 0], poses[:, 1]
        pending = self._has_plan().copy()
        while pending.any():
            i = np.nonzero(pending)[0]
            j = start[i, None] + np.arange(W)[None, :]
            jc = np.minimum(j, M - 1)
            x = self._buf[i[:, None], jc, 0]
            y = self._buf[i[:, None], jc, 1]
            d2 = (x - px[i, None]) ** 2 + (y - py[i, None]) ** 2
            d2[j >= self._len[i, None]] = np.inf
            inc = d2[:, 1:] > d2[:, :-1]
            has_inc = inc.any(axis=1)
            k = inc.argmax(axis=1)
            end_i = self._len[i] - 1
            start[i] = np.where(has_inc, start[i] + k,
                                np.minimum(start[i] + W - 1, end_i))
            still = ~has_inc & (start[i] < end_i)
            pending[:] = False
            pending[i[still]] = True
        self._start = np.where(self._has_plan(), start, self._start)
        return self._start

    def _window_end(self, start) -> np.ndarray:
        """Vectorized truncate_by_length: first knot beyond the lookahead
        arclength, at least 2 points, clamped to the plan length.

        O(B) per cycle: the first-exceed index is precomputed per knot at
        set_plans time (`_span`, see _recompute_plan_geometry) — the pad
        sentinel there clamps it to the plan length exactly like the old
        full scan's +inf padding did."""
        k = self._span[np.arange(self.B), start]
        k_rel = np.maximum(np.minimum(k, self._len) - start, 2)
        return np.minimum(start + k_rel, np.maximum(self._len, start + 1))

    def _downsample(self, start, end):
        """Vectorized downsample_plan on the [start, end) window: sampling
        stride = path_length / segments / first-segment length; the final
        waypoint is always included. Returns (offsets (B, S), n_tot (B,))
        where offsets index into the buffer (clamped; mask with n_tot)."""
        segs = self.planner_cfg.downsample_segments
        b = np.arange(self.B)
        npts = np.maximum(end - start, 1)
        arc_s = self._arc[b, start]
        arc_e = self._arc[b, np.maximum(end - 1, 0)]
        pl = np.maximum(arc_e - arc_s, 0.0)
        first_seg = self._arc[b, np.minimum(start + 1, self._buf.shape[1] - 1)] - arc_s
        wd = np.where(first_seg > 0.0, first_seg,
                      np.maximum(pl / np.maximum(npts - 1, 1), 1e-9))
        with np.errstate(divide="ignore", invalid="ignore"):
            samp = np.maximum((pl / segs / wd).astype(np.int64), 1)
        n_s = -(-npts // samp)
        need_back = ((npts - 1) % samp) != 0
        n_tot = n_s + need_back
        # <=2-point windows pass through unsampled (scalar short-circuit)
        short = npts <= 2
        samp = np.where(short, 1, samp)
        n_tot = np.where(short, npts, n_tot)
        S = int(n_tot.max())
        off = np.arange(S)[None, :] * samp[:, None]
        off = np.minimum(off, (npts - 1)[:, None])
        return start[:, None] + off, n_tot

    def _position_reached(self, poses, active) -> np.ndarray:
        """Latched xy tolerance (vector twin of MPCPlanner semantics)."""
        has = self._has_plan() & active
        g = self._goals()
        within = (np.hypot(poses[:, 0] - g[:, 0], poses[:, 1] - g[:, 1])
                  <= self.planner_cfg.limits.xy_goal_tolerance)
        shortcut = ~self.set_new_goal & self.latch_xy
        upd = has & ~shortcut
        self.set_new_goal[upd] = False
        self.latch_xy[upd] = within[upd]
        return has & (shortcut | within)

    def _orientation_reached(self, poses, feedback, pos) -> np.ndarray:
        """Yaw tolerance + stopped check (relaxed to stopped-only for
        families that cannot rotate in place); latches yaw."""
        lim = self.planner_cfg.limits
        g = self._goals()
        angle = _wrap(poses[:, 2] - g[:, 2])
        yaw_ok = (np.abs(angle) <= lim.yaw_goal_tolerance
                  if self.model.can_rotate_in_place
                  else np.ones(self.B, bool))
        stopped = ((np.abs(feedback[:, 0]) <= lim.trans_stopped_vel)
                   & (np.abs(feedback[:, 1]) <= lim.theta_stopped_vel))
        reached = pos & yaw_ok & stopped
        self.latch_yaw[reached] = True
        return reached

    def _below_heading(self, poses, start, active) -> np.ndarray:
        """|yaw - leading window heading| <= threshold (True for families
        that cannot rotate in place — Tracking absorbs heading errors)."""
        if not self.model.can_rotate_in_place:
            return active.copy()
        head = self._buf[np.arange(self.B), start, 2]
        err = np.abs(_wrap(poses[:, 2] - head))
        return active & (err <= self.planner_cfg.heading_yaw_error_threshold)

    def is_goal_reached(self, poses: np.ndarray,
                        feedback: np.ndarray) -> np.ndarray:
        """(B,) goal flags with the reference's consume-once latch pair."""
        poses = np.asarray(poses, float)
        feedback = np.asarray(feedback, float)
        has = self._has_plan()
        consume = has & self.latch_xy & self.latch_yaw
        self.latch_xy[consume] = False
        self.latch_yaw[consume] = False
        pos = self._position_reached(poses, has & ~consume)
        reached = self._orientation_reached(poses, feedback, pos)
        self.states = np.where(reached, _IDLE, self.states)
        return reached

    # -- the hot path ----------------------------------------------------------

    def compute_velocity_commands(self, poses: np.ndarray,
                                  feedback: np.ndarray):
        """One fleet control cycle. poses (B, 3); feedback (B, 2) measured
        (v, yaw_rate). Returns (ok (B,), cmds (B, 2), FleetCycleInfo)."""
        return self.finish_cycle(self.begin_cycle(poses, feedback))

    def begin_cycle(self, poses: np.ndarray, feedback: np.ndarray) -> dict:
        """Pipelined serving, phase 1: run the host path pipeline + FSM and
        DISPATCH the batched solve without waiting for it; returns the
        pending-cycle handle for `finish_cycle`.

        The split exists because the only cross-cycle data dependency that
        needs a device->host sync is the fetched first controls — the
        warm-start bank feeds the next solve ON DEVICE (lazy jax value)
        and the host pipeline depends only on world inputs and cursors. A
        serving loop that calls begin(k+1) right after finish(k) overlaps
        cycle k+1's host pipeline with nothing, but a loop structured as

            h = fp.begin_cycle(poses, fb)
            ...                                # robot I/O, logging, etc.
            ok, cmds, info = fp.finish_cycle(h)

        hides the solve + device round trip behind whatever host work runs
        in between. bench.py --fleet --fleet-pipelined interleaves
        begin(k+1) BEFORE finish(k) — cycle k+1's host pipeline runs while
        solve k is in flight — so commands lag one control period and the
        delay-mode actuation state (w, throttle) is one cycle stale;
        `delay_mode`'s one-step actuation prediction is built to
        compensate exactly this kind of latency. Sequential callers (the
        plain compute_velocity_commands) are unaffected."""
        assert self._initialized
        poses = np.asarray(poses, float)
        feedback = np.asarray(feedback, float)
        B = self.B
        cfg = self.planner_cfg
        cmds = np.zeros((B, 2))
        cte_out = np.full(B, np.nan)
        eth_out = np.full(B, np.nan)
        refv_out = np.full(B, np.nan)

        # 1. plan bookkeeping + FSM transition (all vectorized)
        ok = self._has_plan()
        start = self._cutoff(poses)
        end = self._window_end(start)
        pos = self._position_reached(poses, ok)
        goal_reached = self._orientation_reached(poses, feedback, pos)
        below = self._below_heading(poses, start, ok & ~pos)
        st = self.states
        keep = np.isin(st, (_ROT_PRE, _TRACK))
        new_st = np.where(goal_reached, _IDLE,
                          np.where(pos, _ROT_GOAL,
                                   np.where(below, _TRACK,
                                            np.where(keep, st, _ROT_PRE))))
        self.states = np.where(ok, new_st, self.states)
        track = ok & (self.states == _TRACK) & (end > start)

        # 2. rotation commands (P-control; zeros for idle / non-rotating)
        if self.model.can_rotate_in_place:
            g = self._goals()
            rg = ok & (self.states == _ROT_GOAL)
            cmds[rg, 1] = cfg.rotate_p_gain * _wrap(g[rg, 2] - poses[rg, 2])
        head = self._buf[np.arange(B), start, 2]
        rp = ok & (self.states == _ROT_PRE)
        cmds[rp, 1] = cfg.rotate_p_gain * _wrap(head[rp] - poses[rp, 2])

        if not track.any():
            return {"ok": ok, "cmds": cmds, "cte": cte_out, "eth": eth_out,
                    "refv": refv_out, "track": track, "res": None,
                    "states": self.states.copy()}

        # 3. batched fit + error-state extraction for the tracking robots
        idx = np.nonzero(track)[0]
        offs, n_tot = self._downsample(start, end)
        z0s, coeffs, refv = self._batched_prepare(
            idx, poses, feedback, offs[idx], n_tot[idx],
            start[idx], end[idx])
        cte_out[idx] = z0s[:, 4]
        eth_out[idx] = z0s[:, 5]
        refv_out[idx] = refv

        # 4. ONE batched solve for the whole fleet (fixed shape B: robots
        # not tracking get benign zero problems so the jit cache never
        # sees a data-dependent batch size) — DISPATCHED, not fetched: jax
        # async dispatch returns immediately, the chip works in the gap
        res = self._solve_fleet(idx, z0s, coeffs, refv, poses)
        self._warm = res.us                       # device-resident bank
        self._has_warm[:] = False
        self._has_warm[idx] = True
        return {"ok": ok, "cmds": cmds, "cte": cte_out, "eth": eth_out,
                "refv": refv_out, "track": track, "res": res, "idx": idx,
                "refv_sub": refv, "v_meas": feedback[idx, 0],
                "states": self.states.copy()}

    def finish_cycle(self, h: dict):
        """Pipelined serving, phase 2: sync the dispatched solve, fetch the
        first controls + stats (ONE transfer), update the cross-cycle
        actuation state, return (ok, cmds, info)."""
        if h["res"] is None:
            info = self._info(h["cmds"], h["cte"], h["eth"], h["refv"],
                              None, h["track"], states=h["states"])
            return h["ok"], h["cmds"], info

        # ONE device->host transfer for everything the host needs — the
        # warm-start bank itself STAYS ON DEVICE (res.us, (B, T, 2)): only
        # the first controls + per-robot stats come home (65 KB instead of
        # 1.3 MB at B=8192)
        import jax

        res = h["res"]
        idx = h["idx"]
        cmds = h["cmds"]
        u0_all, cost_d, conv_d, iters_d = jax.device_get(
            (res.us[:, 0, :], res.cost, res.converged, res.n_iters))
        dt = self._leaf("dt", idx)
        u0 = np.asarray(u0_all, float)[idx]
        self.w[idx] = u0[:, 0]
        self.throttle[idx] = u0[:, 1]
        self.speed[idx] = np.minimum(h["v_meas"] + u0[:, 1] * dt,
                                     h["refv_sub"])
        cmds[idx, 0] = self.speed[idx]
        cmds[idx, 1] = self.w[idx]

        info = self._info(cmds, h["cte"], h["eth"], h["refv"],
                          (cost_d, conv_d, iters_d), h["track"],
                          states=h["states"])
        return h["ok"], cmds, info

    # -- internals -------------------------------------------------------------

    def _batched_prepare(self, idx, poses, feedback, offs, n_tot, start,
                         end):
        """Vectorized robot-frame transform + weighted LSQ polynomial fit +
        error-state extraction for the tracking subset `idx`.
        offs (n, S): buffer indices of the downsampled window; n_tot (n,):
        valid counts."""
        cfg = self.planner_cfg
        n = len(idx)
        S = offs.shape[1]
        n_coeffs = self.solver_cfg.n_coeffs
        pts = self._buf[idx[:, None], offs, :2]          # (n, S, 2)
        wts = (np.arange(S)[None, :] < n_tot[:, None]).astype(float)

        th = poses[idx, 2]
        ct, st = np.cos(th), np.sin(th)
        dx = (pts[:, :, 0] - poses[idx, 0, None]) * wts
        dy = (pts[:, :, 1] - poses[idx, 1, None]) * wts
        x_veh = dx * ct[:, None] + dy * st[:, None]
        y_veh = dy * ct[:, None] - dx * st[:, None]

        # weighted normal equations per robot: same LSQ solution as the
        # single-robot np.polyfit (QR) to ~1e-10 on these tiny, well-scaled
        # windows; degree reduces when a window has too few points
        coeffs = np.zeros((n, n_coeffs))
        order = np.minimum(self.solver_cfg.poly_order, n_tot - 1)
        for k in np.unique(order):
            sel = order == k
            xs = x_veh[sel]
            # Vandermonde by iterative multiply (pow is ~2x slower) and
            # batched matmul for the normal equations (~5x over c_einsum)
            V = np.empty((xs.shape[0], S, k + 1))
            V[:, :, 0] = 1.0
            for q in range(1, k + 1):
                V[:, :, q] = V[:, :, q - 1] * xs
            Vw = (V * wts[sel][:, :, None]).transpose(0, 2, 1)
            G = np.matmul(Vw, V)
            G += 1e-12 * np.eye(k + 1)     # rank guard (degenerate windows)
            b = np.matmul(Vw, y_veh[sel][:, :, None])
            coeffs[sel, : k + 1] = np.linalg.solve(G, b)[..., 0]

        cte = coeffs[:, 0]
        # 30%-lookahead path direction + continuity shim + Q13 wrap
        # (tracking.py:compute; the lookahead displacement sum telescopes
        # to pts[ns-1] - pts[0])
        ns = (n_tot * 0.3).astype(np.int64)
        j = np.clip(ns - 1, 0, S - 1)
        gx = np.take_along_axis(pts[:, :, 0], j[:, None], 1)[:, 0] - pts[:, 0, 0]
        gy = np.take_along_axis(pts[:, :, 1], j[:, None], 1)[:, 0] - pts[:, 0, 1]
        valid = (gx != 0.0) & (gy != 0.0) & (ns >= 2)
        traj = np.arctan2(gy, gx)
        temp = th.copy()
        bump = temp <= (-np.pi + traj)
        temp[bump] += 2.0 * np.pi
        use = valid & ((temp - traj) < 1.8 * np.pi)
        etheta = np.where(use, temp - traj, 0.0)
        if cfg.wrap_etheta:
            etheta = _wrap(etheta)

        # reference-speed scheduling: goal deceleration + curvature cap
        # (per-robot (B,)-shaped MPCParams leaves supported throughout)
        g = self._goals()[idx]
        dist = np.hypot(poses[idx, 0] - g[:, 0], poses[idx, 1] - g[:, 1])
        v = feedback[idx, 0]
        max_thr = self._leaf("max_throttle", idx)
        ref_vel = self._leaf("ref_vel", idx).copy()
        brake = dist <= v * v / max_thr
        ref_vel[brake] = np.clip((max_thr * dist)[brake], cfg.min_speed,
                                 cfg.max_speed)
        if cfg.curvature_slowdown and self._kappa.shape[1] > 0:
            # per-knot curvature window max is static per plan given the
            # cursor — precomputed at set_plans (_kmax_win), O(n) gather
            Mk = self._kmax_win.shape[1]
            kmax = self._kmax_win[idx, np.minimum(start, Mk - 1)].astype(
                float)
            with np.errstate(divide="ignore"):
                lim = np.where(kmax > 1e-9,
                               np.sqrt(cfg.max_lat_accel / kmax), np.inf)
            ref_vel = np.clip(np.minimum(ref_vel, lim), cfg.min_speed,
                              cfg.max_speed)

        # delay-mode one-step prediction (tracking.py:compute)
        dt = self._leaf("dt", idx)
        if cfg.delay_mode:
            import types

            sign = self.solver_cfg.cte_vsin_sign
            hp = types.SimpleNamespace(
                lf=self._leaf("lf", idx))           # per-robot wheelbases
            yaw_rate = np.asarray(
                self.model.yaw_rate(v, self.w[idx], hp), float)
            theta_act = yaw_rate * dt
            z0s = np.stack([
                v * dt,
                np.zeros(n),
                theta_act,
                v + self.throttle[idx] * dt,
                cte + sign * v * np.sin(etheta) * dt,
                etheta - sign * theta_act,
            ], axis=1)
        else:
            z0s = np.stack([np.zeros(n), np.zeros(n), np.zeros(n), v, cte,
                            etheta], axis=1)
        return z0s, coeffs, ref_vel

    def _solve_fleet(self, idx, z0s_sub, coeffs_sub, refv_sub, poses):
        """Full-width batched solve: tracking robots carry their problems,
        the rest benign zeros (converge in O(1) iterations)."""
        from ..solver.batch_lane import batch_solve_lane

        B = self.B
        n_coeffs = self.solver_cfg.n_coeffs
        z0s = np.zeros((B, 6))
        coeffs = np.zeros((B, n_coeffs))
        refv = np.zeros(B)
        z0s[idx] = z0s_sub
        coeffs[idx] = coeffs_sub
        refv[idx] = refv_sub
        p = self.params.replace(
            ref_vel=jnp.asarray(refv, self.dtype))
        if isinstance(self._warm, np.ndarray):
            # cold start / restored checkpoint: bank still host-side
            warm = jnp.asarray(
                np.where(self._has_warm[:, None, None],
                         np.concatenate([self._warm[:, 1:],
                                         self._warm[:, -1:]], axis=1),
                         0.0), self.dtype)
        else:
            # steady state: shift the DEVICE-resident bank on device
            warm = _shift_warm_jit()(
                self._warm, jnp.asarray(self._has_warm)).astype(self.dtype)
        blobs = None
        if self.world_obstacles is not None:
            blobs = _blobs_to_frames(self.world_obstacles, poses, self.dtype)
        if self.mesh is not None:
            from ..parallel.sharded import sharded_batch_solve

            return sharded_batch_solve(
                self.mesh, jnp.asarray(z0s, self.dtype),
                jnp.asarray(coeffs, self.dtype), p, self.solver_cfg,
                u_init=warm, blobs=blobs)
        return batch_solve_lane(
            jnp.asarray(z0s, self.dtype), jnp.asarray(coeffs, self.dtype),
            p, self.solver_cfg, u_init=warm, blobs=blobs)

    def _info(self, cmds, cte, eth, refv, fetched, track, states=None):
        """`fetched`: host-side (cost, converged, n_iters) arrays or None.
        `states`: FSM snapshot taken at begin_cycle (pipelined serving may
        have advanced self.states for the NEXT cycle already)."""
        B = self.B
        nan = np.full(B, np.nan)
        false = np.zeros(B, bool)
        zero = np.zeros(B, np.int32)
        if fetched is not None:
            cost_d, conv_d, iters_d = fetched
            cost = np.where(track, np.asarray(cost_d, float), np.nan)
            conv = np.asarray(conv_d, bool) & track
            iters = np.where(track, np.asarray(iters_d, np.int32), 0)
        else:
            cost, conv, iters = nan, false, zero
        if states is None:
            states = self.states.copy()
        return FleetCycleInfo(states=states, cmds=cmds.copy(),
                              ref_vel=refv, cte=cte, etheta=eth, cost=cost,
                              converged=conv, n_iters=iters)


def _blobs_to_frames(blobs, poses, dtype):
    """World-frame GaussianObstacles (leaves (B, K)) -> each robot's frame
    (batched twin of GaussianObstacles.to_frame)."""
    from ..models.obstacles import GaussianObstacles

    px = jnp.asarray(poses[:, 0:1], dtype)
    py = jnp.asarray(poses[:, 1:2], dtype)
    yaw = jnp.asarray(poses[:, 2:3], dtype)
    ct, st = jnp.cos(yaw), jnp.sin(yaw)
    dx = jnp.asarray(blobs.cx, dtype) - px
    dy = jnp.asarray(blobs.cy, dtype) - py
    return GaussianObstacles(cx=dx * ct + dy * st, cy=dy * ct - dx * st,
                             gamma=jnp.asarray(blobs.gamma, dtype),
                             w=jnp.asarray(blobs.w, dtype))
