"""Device-resident fleet serving: the whole per-cycle pipeline in ONE jit.

`FleetPlanner` (fleet.py) runs the per-cycle plan pipeline vectorized on the
HOST and dispatches one batched solve, so its cycle scales with the host's
vCPUs (the host-side numpy pipeline dominated it on a 2-vCPU container).
This class moves the ENTIRE cycle on device:

    upload:  poses (B, 3) + feedback (B, 2)          [one small transfer]
    device:  cutoff walk -> lookahead window -> goal latches + FSM ->
             downsample -> robot-frame transform -> batched weighted
             polynomial fit -> cte/etheta extraction -> reference-speed
             scheduling -> delay-mode prediction -> warm-started megakernel
             solve -> command extraction               [ONE jitted program]
    fetch:   one stacked (10, B) f32 result tile      [one small transfer]

All cross-cycle state (plan cursors, FSM codes, goal latches, actuation
state, the warm-start bank) lives on device and is threaded through the
program as a donated carry pytree; the static per-plan geometry (padded
plan buffer, arclength, lookahead spans, windowed curvature maxima) is
computed once per `set_plans` on the host (it is per-goal, not per-cycle)
and uploaded as constants.

Semantics match `FleetPlanner` robot-by-robot (pinned in
tests/test_fleet_device.py): every stage is a jnp transcription of the
numpy stage with the same masking rules; the per-cycle cutoff runs the
full-plan first-distance-increase scan (O(B*M) is trivia on the chip — the
host version had to window it), and the polynomial fit solves the same
weighted normal equations with the abscissa scaled by the lookahead length
so the f32 Gram matrix stays well-conditioned (coefficients are unscaled
exactly; the host fit is float64).

The reference's per-cycle path this replaces at fleet scale:
/root/reference/mpc_ros/src/mpc_planner_ros.cpp:397-448 (one process per
robot there; one device program for B robots here).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..config import MPCParams, PlannerConfig, SolverConfig
from ..models.base import get_model
from .fleet import (FleetPlanner, _IDLE, _ROT_GOAL, _ROT_PRE, _TRACK,
                    _blobs_to_frames, _wrap as _jwrap)

_TWO_PI = 2.0 * np.pi


# observability-tile row indices (fetched at the obs_every cadence)
(OB_CTE, OB_ETH, OB_REFV, OB_COST, OB_CONV, OB_ITERS,
 OB_STATE, OB_TRACK) = range(8)


def _chol_solve_small(G, rhs):
    """Batched SPD solve by fully-unrolled Cholesky: G (B, P, P),
    rhs (B, P) -> (B, P). Pure elementwise ops that fuse with their
    neighbours, where `jnp.linalg.solve` dispatches a batched LU. Pivots are clamped at a tiny floor so rank-deficient Gram
    matrices (degenerate windows; zeroed reduced-order columns carry only
    the 1e-12 ridge) stay finite like LU does."""
    P = G.shape[-1]
    L = [[None] * P for _ in range(P)]
    for j in range(P):
        s = G[:, j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, P):
            s = G[:, i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    y = [None] * P
    for i in range(P):                      # L y = rhs
        s = rhs[:, i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * P
    for i in reversed(range(P)):            # L' x = y
        s = y[i]
        for k in range(i + 1, P):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


_CARRY_KEYS = ("start", "states", "latch_xy", "latch_yaw", "set_new_goal",
               "speed", "w", "throttle", "warm", "has_warm")
_CONST_KEYS = ("buf", "plen", "arc", "span", "kmax", "goals",
               "arc_next", "kmax_pad")


# 16-bit wire codec (DeviceFleetPlanner(wire="i16")): fixed-point scales
# for the (x, y, yaw, v, yaw_rate) upload columns. Poses ride as int16
# DELTAS against an int32 tick mirror kept identically on host and device
# (integer accumulation — bit-exact on both sides, zero codec drift);
# commands return as int16 absolute fixed point. Ranges: +-3.27 m /
# +-0.327 rad / +-3.27 m/s PER CYCLE for deltas (a robot can't outrun
# that at 20 Hz; a teleport/new-fleet jump auto-triggers a float32
# keyframe cycle), +-8.19 in command units at 2.5e-4 resolution.
_WIRE_SCALES = (1e-4, 1e-4, 1e-5, 1e-4, 1e-4)
_WIRE_CMD_SCALE = 2.5e-4


@functools.lru_cache(maxsize=None)
def _cycle_jit(solver_cfg: SolverConfig, planner_cfg: PlannerConfig,
               M: int, Mk: int, has_blobs: bool, dtype_name: str,
               mesh=None, sharded_leaves: tuple = (), wire: str = "f32"):
    """One compiled cycle program per (configs, plan-buffer shape, obstacle
    signature). Recompiles only when set_plans changes the padded length M.

    `mesh`: optional jax.sharding.Mesh — the WHOLE cycle (pipeline + solve)
    runs under shard_map over the mesh's data axis: every stage is
    per-robot, so each device serves B/D robots with zero control-path
    collectives (SURVEY.md §5.8 rule), plan constants and the cross-cycle
    carry resident on their shard. `sharded_leaves`: names of (B,)-shaped
    per-robot MPCParams leaves (they shard with the batch; scalars
    replicate)."""
    from ..solver.batch_lane import batch_solve_lane

    dtype = jnp.dtype(dtype_name)
    cfg = solver_cfg
    pc = planner_cfg
    lim = pc.limits
    model = get_model(cfg.model)
    can_rot = model.can_rotate_in_place
    n_coeffs = cfg.n_coeffs
    sign = cfg.cte_vsin_sign
    L_scale = float(max(pc.local_plan_length, 1e-6))

    def fn(consts, carry, world, p, *blob_leaves):
        # `world` (B, 5): poses (x, y, yaw) ++ feedback (v, yaw_rate) — ONE
        # per-cycle upload (every transfer pays a fixed latency + its size).
        # wire="i16": world is (B, 5) int16 deltas against the int32 tick
        # mirror in the carry; wire="kf" (keyframe): world is f32 and the
        # mirror is (re)seeded from it — same carry structure, so the two
        # programs alternate freely. Integer tick accumulation is bit-exact
        # on host and device; the f32 decode ticks*scale matches the host
        # mirror by construction (same IEEE ops).
        wire_ticks = None
        if wire == "i16":
            wire_ticks = carry["wire_ticks"] + world.astype(jnp.int32)
        elif wire == "kf":
            scl = jnp.asarray(_WIRE_SCALES, jnp.float32)
            wire_ticks = jnp.round(world / scl).astype(jnp.int32)
        if wire_ticks is not None:
            world = wire_ticks.astype(jnp.float32) * jnp.asarray(
                _WIRE_SCALES, jnp.float32)
        buf = consts["buf"]              # (B, M, 3), xy padded +inf
        plen = consts["plen"]            # (B,) int32
        arc = consts["arc"]              # (B, M), +inf padded
        span = consts["span"]            # (B, M) int32
        kmax_w = consts["kmax"]          # (B, Mk)
        B = buf.shape[0]
        b = jnp.arange(B)
        idx = jnp.arange(M)
        poses = world[:, :3]
        feedback = world[:, 3:5]
        px, py, pth = poses[:, 0], poses[:, 1], poses[:, 2]
        v_meas = feedback[:, 0]
        has = plen > 0

        # ---- cutoff: first distance increase from the cursor ends the
        # walk (vector twin of fleet._cutoff; the +inf padding makes the
        # first "increase" at the plan boundary terminate identically) ----
        d2 = ((buf[:, :, 0] - px[:, None]) ** 2
              + (buf[:, :, 1] - py[:, None]) ** 2)
        d2 = jnp.where(idx[None] >= plen[:, None], jnp.inf, d2)
        d2p = jnp.concatenate(
            [d2, jnp.full((B, 1), jnp.inf, d2.dtype)], axis=1)
        inc = (d2p[:, 1:] > d2p[:, :-1]) & (idx[None] >= carry["start"][:, None])
        first = jnp.argmax(inc, axis=1).astype(jnp.int32)
        can_walk = has & (carry["start"] < plen - 1)
        start = jnp.where(can_walk, first, carry["start"])

        # ---- cursor-indexed lookups as masked reductions (one one-hot +
        # select-sum per index is streaming elementwise work instead of a
        # (B, M) row gather — same rule as the fit).
        # select-then-sum, never multiply: arc/buf pads are +inf.
        selS = idx[None, :] == start[:, None]
        ms = lambda a: jnp.sum(jnp.where(selS, a, 0.0), axis=1)
        msi = lambda a: jnp.sum(jnp.where(selS, a, 0), axis=1)

        # ---- lookahead window end (precomputed span lookup) ----
        k = msi(span)
        k_rel = jnp.maximum(jnp.minimum(k, plen) - start, 2)
        end = jnp.minimum(start + k_rel, jnp.maximum(plen, start + 1))

        # ---- goal latches + FSM transition (twin of begin_cycle step 1) --
        goals = consts["goals"]          # (B, 3) — static per set_plans
        latch_xy = carry["latch_xy"]
        latch_yaw = carry["latch_yaw"]
        sng = carry["set_new_goal"]
        within = (jnp.hypot(px - goals[:, 0], py - goals[:, 1])
                  <= lim.xy_goal_tolerance)
        shortcut = (~sng) & latch_xy
        upd_m = has & ~shortcut
        sng = jnp.where(upd_m, False, sng)
        latch_xy = jnp.where(upd_m, within, latch_xy)
        pos = has & (shortcut | within)
        ang = _jwrap(pth - goals[:, 2])
        yaw_ok = (jnp.abs(ang) <= lim.yaw_goal_tolerance if can_rot
                  else jnp.ones(B, bool))
        stopped = ((jnp.abs(feedback[:, 0]) <= lim.trans_stopped_vel)
                   & (jnp.abs(feedback[:, 1]) <= lim.theta_stopped_vel))
        reached = pos & yaw_ok & stopped
        latch_yaw = jnp.where(reached, True, latch_yaw)
        head = ms(buf[:, :, 2])
        if can_rot:
            below = (has & ~pos) & (jnp.abs(_jwrap(pth - head))
                                    <= pc.heading_yaw_error_threshold)
        else:
            below = has & ~pos
        st = carry["states"]
        keep = (st == _ROT_PRE) | (st == _TRACK)
        new_st = jnp.where(
            reached, _IDLE,
            jnp.where(pos, _ROT_GOAL,
                      jnp.where(below, _TRACK,
                                jnp.where(keep, st, _ROT_PRE))))
        states = jnp.where(has, new_st, st).astype(jnp.int32)
        track = has & (states == _TRACK) & (end > start)

        # ---- rotation commands (P-control; states are disjoint) ----
        cmd_w = jnp.zeros(B, buf.dtype)
        if can_rot:
            rg = has & (states == _ROT_GOAL)
            cmd_w = jnp.where(rg, pc.rotate_p_gain * _jwrap(goals[:, 2] - pth),
                              cmd_w)
        rp = has & (states == _ROT_PRE)
        cmd_w = jnp.where(rp, pc.rotate_p_gain * _jwrap(head - pth), cmd_w)

        # ---- downsample (twin of fleet._downsample; S = M static) ----
        npts = jnp.maximum(end - start, 1)
        arc_s = ms(arc)
        selE = idx[None, :] == jnp.maximum(end - 1, 0)[:, None]
        arc_e = jnp.sum(jnp.where(selE, arc, 0.0), axis=1)
        pl_len = jnp.maximum(arc_e - arc_s, 0.0)
        first_seg = ms(consts["arc_next"]) - arc_s
        wd = jnp.where(first_seg > 0.0, first_seg,
                       jnp.maximum(pl_len / jnp.maximum(npts - 1, 1), 1e-9))
        segs = float(pc.downsample_segments)
        ratio = jnp.minimum(pl_len / segs / wd, 1e6)   # int32-safe clamp
        samp = jnp.maximum(ratio.astype(jnp.int32), 1)
        n_s = (npts + samp - 1) // samp
        need_back = (((npts - 1) % samp) != 0).astype(jnp.int32)
        n_tot = n_s + need_back
        short = npts <= 2
        samp = jnp.where(short, 1, samp)
        n_tot = jnp.where(short, npts, n_tot)

        # ---- robot-frame transform + weighted fit (twin of
        # _batched_prepare). The downsampled-knot SET
        # {start + k*samp : k < ceil(npts/samp)} U {start + npts - 1} is
        # computed as a per-knot membership MASK over the full buffer —
        # elementwise work instead of a (B, M) offs gather. Each selected
        # knot appears exactly
        # once, matching the host offset list (whose padding duplicates
        # carry weight 0). The x abscissa is scaled by the lookahead
        # length so the f32 Gram matrix stays well-conditioned; the
        # coefficients are unscaled exactly afterwards. ----
        rel = idx[None] - start[:, None]                  # (B, M)
        in_win = (rel >= 0) & (rel < npts[:, None])
        sel = in_win & (((rel % samp[:, None]) == 0)
                        | (rel == (npts - 1)[:, None]))
        wts = sel.astype(buf.dtype)
        ct, stn = jnp.cos(pth), jnp.sin(pth)
        dx = jnp.where(sel, buf[:, :, 0] - px[:, None], 0.0)
        dy = jnp.where(sel, buf[:, :, 1] - py[:, None], 0.0)
        x_veh = dx * ct[:, None] + dy * stn[:, None]
        y_veh = dy * ct[:, None] - dx * stn[:, None]
        order = jnp.minimum(cfg.poly_order, n_tot - 1)    # (B,)
        xs = x_veh * (1.0 / L_scale)
        cols = [wts]                                      # V0 = 1 on sel
        for q in range(1, n_coeffs):
            cols.append(cols[-1] * xs)
        V = jnp.stack(cols, axis=-1)                      # (B, M, P)
        qmask = (jnp.arange(n_coeffs)[None, :]
                 <= order[:, None]).astype(buf.dtype)     # (B, P)
        V = V * qmask[:, None, :]
        # HIGHEST: a GPU may run default-precision f32 products in TF32
        # (~3 decimal digits), too coarse for a Gram matrix
        hi = jax.lax.Precision.HIGHEST
        G = jnp.einsum("bmi,bmj->bij", V, V,    # 0/1 weights fold into V
                       precision=hi)
        G = G + 1e-12 * jnp.eye(n_coeffs, dtype=buf.dtype)
        rhs = jnp.einsum("bmi,bm->bi", V, y_veh, precision=hi)
        c_s = _chol_solve_small(G, rhs)                   # (B, P)
        unscale = (1.0 / L_scale) ** jnp.arange(n_coeffs, dtype=buf.dtype)
        coeffs = c_s * unscale[None, :]
        cte = coeffs[:, 0]

        # 30%-lookahead path direction + continuity shim + Q13 wrap.
        # Downsampled index ns-1 is buffer knot
        # start + min((ns-1)*samp, npts-1) — a (B,)-sized gather only.
        ns = (n_tot.astype(buf.dtype) * 0.3).astype(jnp.int32)
        j30 = start + jnp.minimum(jnp.maximum(ns - 1, 0) * samp, npts - 1)
        selJ = idx[None, :] == j30[:, None]
        msj = lambda a: jnp.sum(jnp.where(selJ, a, 0.0), axis=1)
        gx = msj(buf[:, :, 0]) - ms(buf[:, :, 0])
        gy = msj(buf[:, :, 1]) - ms(buf[:, :, 1])
        valid = (gx != 0.0) & (gy != 0.0) & (ns >= 2)
        traj = jnp.arctan2(gy, gx)
        temp = jnp.where(pth <= (-np.pi + traj), pth + _TWO_PI, pth)
        use = valid & ((temp - traj) < 1.8 * np.pi)
        etheta = jnp.where(use, temp - traj, 0.0)
        if pc.wrap_etheta:
            etheta = _jwrap(etheta)

        # ---- reference-speed scheduling ----
        bz = lambda leaf: jnp.broadcast_to(
            jnp.asarray(leaf, buf.dtype), (B,))
        dist = jnp.hypot(px - goals[:, 0], py - goals[:, 1])
        max_thr = bz(p.max_throttle)
        ref_vel = bz(p.ref_vel)
        brake = dist <= v_meas * v_meas / max_thr
        ref_vel = jnp.where(
            brake, jnp.clip(max_thr * dist, pc.min_speed, pc.max_speed),
            ref_vel)
        if pc.curvature_slowdown and Mk > 0:
            kmax = ms(consts["kmax_pad"])   # edge-padded to M cols
            vlim = jnp.where(kmax > 1e-9,
                             jnp.sqrt(pc.max_lat_accel / kmax), jnp.inf)
            ref_vel = jnp.clip(jnp.minimum(ref_vel, vlim), pc.min_speed,
                               pc.max_speed)

        # ---- delay-mode one-step prediction ----
        dt = bz(p.dt)
        w_prev = carry["w"]
        thr_prev = carry["throttle"]
        if pc.delay_mode:
            yaw_rate = model.yaw_rate(v_meas, w_prev, p)
            theta_act = yaw_rate * dt
            z0s = jnp.stack([
                v_meas * dt,
                jnp.zeros(B, buf.dtype),
                theta_act,
                v_meas + thr_prev * dt,
                cte + sign * v_meas * jnp.sin(etheta) * dt,
                etheta - sign * theta_act,
            ], axis=1)
        else:
            z = jnp.zeros(B, buf.dtype)
            z0s = jnp.stack([z, z, z, v_meas, cte, etheta], axis=1)

        # ---- ONE batched warm solve (benign zero problems off-track) ----
        z0s = jnp.where(track[:, None], z0s, 0.0).astype(dtype)
        coeffs_s = jnp.where(track[:, None], coeffs, 0.0).astype(dtype)
        refv_s = jnp.where(track, ref_vel, 0.0).astype(dtype)
        p2 = p.replace(ref_vel=refv_s)
        warm = carry["warm"]
        warm = jnp.where(
            carry["has_warm"][:, None, None],
            jnp.concatenate([warm[:, 1:], warm[:, -1:]], axis=1),
            0.0).astype(dtype)
        blobs = None
        if has_blobs:
            from ..models.obstacles import GaussianObstacles

            wob = GaussianObstacles(*blob_leaves)
            blobs = _blobs_to_frames(wob, poses, dtype)
        res = batch_solve_lane(z0s, coeffs_s, p2, cfg, u_init=warm,
                               blobs=blobs)

        # ---- command extraction + cross-cycle actuation state ----
        u0 = res.us[:, 0, :].astype(buf.dtype)
        speed_t = jnp.minimum(v_meas + u0[:, 1] * dt, ref_vel)
        speed = jnp.where(track, speed_t, carry["speed"])
        w_new = jnp.where(track, u0[:, 0], w_prev)
        thr_new = jnp.where(track, u0[:, 1], thr_prev)
        cmd_v = jnp.where(track, speed_t, 0.0)
        cmd_w = jnp.where(track, u0[:, 0], cmd_w)

        nan = jnp.asarray(jnp.nan, buf.dtype)
        # hot tile (fetched every cycle) vs observability tile (fetched at
        # the obs_every cadence): the split is what lets the lean serving
        # loop fetch 8 B/robot instead of 40. The observability rows report the
        # SOLVER-INPUT error state (delay-mode predicted), exactly like
        # the host pipeline's cte_out/eth_out.
        cmds_out = jnp.stack([cmd_v, cmd_w])
        if wire != "f32":
            # 16-bit command wire: absolute fixed point (internal
            # actuation state stays exact f32; only the fetched copy is
            # quantized — 2.5e-4 command units, below actuator resolution)
            cmds_out = jnp.round(
                jnp.clip(cmds_out, -8.19, 8.19) * (1.0 / _WIRE_CMD_SCALE)
            ).astype(jnp.int16)
        obs = jnp.stack([
            jnp.where(track, z0s[:, 4].astype(buf.dtype), nan),
            jnp.where(track, z0s[:, 5].astype(buf.dtype), nan),
            jnp.where(track, ref_vel, nan),
            jnp.where(track, res.cost.astype(buf.dtype), nan),
            (res.converged & track).astype(buf.dtype),
            jnp.where(track, res.n_iters, 0).astype(buf.dtype),
            states.astype(buf.dtype),
            track.astype(buf.dtype),
        ])
        carry2 = {
            "start": start, "states": states,
            "latch_xy": latch_xy, "latch_yaw": latch_yaw,
            "set_new_goal": sng,
            "speed": speed, "w": w_new, "throttle": thr_new,
            "warm": res.us, "has_warm": track,
        }
        if wire_ticks is not None:
            carry2["wire_ticks"] = wire_ticks
        return carry2, cmds_out, obs

    if mesh is not None:
        import dataclasses as _dc

        from jax.sharding import PartitionSpec as P

        from ..parallel.mesh import DATA_AXIS

        d = P(DATA_AXIS)
        consts_spec = {k: d for k in _CONST_KEYS}
        carry_keys = _CARRY_KEYS + (("wire_ticks",) if wire != "f32" else ())
        carry_spec = {k: d for k in carry_keys}
        p_spec = MPCParams(**{
            f.name: (d if f.name in sharded_leaves else P())
            for f in _dc.fields(MPCParams)})
        in_specs = [consts_spec, carry_spec, d, p_spec]
        if has_blobs:
            in_specs += [d] * 4
        fn = jax.shard_map(fn, mesh=mesh, in_specs=tuple(in_specs),
                           out_specs=(carry_spec, P(None, DATA_AXIS),
                                      P(None, DATA_AXIS)),
                           check_vma=False)
    return jax.jit(fn, donate_argnums=(1,))


@functools.lru_cache(maxsize=None)
def _goal_jit(planner_cfg: PlannerConfig, can_rot: bool):
    """Device twin of FleetPlanner.is_goal_reached (consume-once latch
    pair). Off the hot path — one small program + one fetch per call."""
    lim = planner_cfg.limits

    def fn(consts, latch_xy, latch_yaw, sng, poses, feedback):
        buf = consts["buf"]
        plen = consts["plen"]
        B = buf.shape[0]
        b = jnp.arange(B)
        has = plen > 0
        goals = buf[b, jnp.maximum(plen - 1, 0)]
        consume = has & latch_xy & latch_yaw
        latch_xy = jnp.where(consume, False, latch_xy)
        latch_yaw = jnp.where(consume, False, latch_yaw)
        active = has & ~consume
        within = (jnp.hypot(poses[:, 0] - goals[:, 0],
                            poses[:, 1] - goals[:, 1])
                  <= lim.xy_goal_tolerance)
        shortcut = (~sng) & latch_xy
        upd = active & ~shortcut
        sng = jnp.where(upd, False, sng)
        latch_xy = jnp.where(upd, within, latch_xy)
        pos = active & (shortcut | within)
        ang = _jwrap(poses[:, 2] - goals[:, 2])
        yaw_ok = (jnp.abs(ang) <= lim.yaw_goal_tolerance if can_rot
                  else jnp.ones(B, bool))
        stopped = ((jnp.abs(feedback[:, 0]) <= lim.trans_stopped_vel)
                   & (jnp.abs(feedback[:, 1]) <= lim.theta_stopped_vel))
        reached = pos & yaw_ok & stopped
        latch_yaw = jnp.where(reached, True, latch_yaw)
        return latch_xy, latch_yaw, sng, reached

    return jax.jit(fn)


class DeviceFleetPlanner(FleetPlanner):
    """FleetPlanner with the per-cycle pipeline on device (one jitted
    program per cycle, one upload, one fetch). Same public API and
    robot-by-robot semantics (tests/test_fleet_device.py); use this class
    for serving at fleet scale — the cycle time no longer depends on host
    vCPUs. `state_dict`/`load_state_dict` round-trip through the host
    mirrors, so checkpoints interoperate with the host planner."""

    def __init__(self, *args, obs_every: int = 1, wire: str = "f32",
                 **kwargs):
        """`obs_every`: fetch the per-robot observability tile (cte,
        etheta, ref_vel, cost, converged, iters, states) every K cycles
        (1 = every cycle, matching the host planner's fetch; 0 = never on
        the hot path — `FleetCycleInfo` rows carry nan/stale markers on
        skipped cycles). Commands are fetched every cycle regardless. The
        knob exists because the serving transport charges a fixed latency
        plus bandwidth per fetch; a lean 20 Hz loop at large B wants
        8 B/robot on the wire, not 40.

        `wire`: "f32" (default) or "i16" — the 16-bit fixed-point wire
        format for the per-cycle hot path (VERDICT r3 item 6: at 32-64k
        robots the lean cycle is TRANSFER-bound, ~70% wire+RTT). "i16"
        uploads (B, 5) int16 pose/feedback DELTAS against an int32 tick
        mirror kept bit-identically on host and device (integer
        accumulation — zero codec drift; resolution 0.1 mm / 1e-5 rad,
        delta range +-3.27 m per cycle with an automatic float32 keyframe
        cycle on any larger jump) and fetches (2, B) int16 commands
        (2.5e-4 resolution) — 14 B/robot on the wire instead of 28.
        Command quantization only touches the fetched copy; the device
        actuation state stays exact f32."""
        super().__init__(*args, **kwargs)
        self.obs_every = int(obs_every)
        assert wire in ("f32", "i16")
        self.wire = wire
        self._wire_ticks = None    # host int32 tick mirror (wire="i16")
        self._wire_dirty = False   # force keyframe after a non-finite frame
        self._consts = None
        self._carry = None
        self._cycle_count = 0
        # mesh mode: the whole cycle runs under shard_map over the data
        # axis — B/D robots per device, zero control-path collectives

    def _shard(self, a):
        """Shard a leading-B array over the mesh's data axis (identity
        without a mesh)."""
        if self.mesh is None:
            return a
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.mesh import DATA_AXIS

        return jax.device_put(a, NamedSharding(self.mesh, P(DATA_AXIS)))

    # -- device state management ----------------------------------------------

    def _upload(self) -> None:
        """Push plan constants + cross-cycle state to device (called per
        set_plans / load_state_dict — per-goal, not per-cycle)."""
        f32 = jnp.float32
        sh = self._shard
        M = self._buf.shape[1]
        goals = self._buf[np.arange(self.B), np.maximum(self._len - 1, 0)]
        arc_next = np.concatenate([self._arc[:, 1:], self._arc[:, -1:]], 1)
        # curvature window max, edge-padded to M columns (the cursor lookup
        # clamped at Mk-1; edge padding reproduces that clamp mask-free)
        kmax_pad = np.repeat(self._kmax_win[:, -1:], M, axis=1)
        kmax_pad[:, : self._kmax_win.shape[1]] = self._kmax_win
        self._consts = {
            "buf": sh(jnp.asarray(self._buf, f32)),
            "plen": sh(jnp.asarray(self._len, jnp.int32)),
            "arc": sh(jnp.asarray(self._arc, f32)),
            "span": sh(jnp.asarray(self._span, jnp.int32)),
            "kmax": sh(jnp.asarray(self._kmax_win, f32)),
            "goals": sh(jnp.asarray(goals, f32)),
            "arc_next": sh(jnp.asarray(arc_next, f32)),
            "kmax_pad": sh(jnp.asarray(kmax_pad, f32)),
        }
        T = self.solver_cfg.n_controls
        warm = np.asarray(self._warm, np.float32)
        self._carry = {
            "start": sh(jnp.asarray(self._start, jnp.int32)),
            "states": sh(jnp.asarray(self.states, jnp.int32)),
            "latch_xy": sh(jnp.asarray(self.latch_xy)),
            "latch_yaw": sh(jnp.asarray(self.latch_yaw)),
            "set_new_goal": sh(jnp.asarray(self.set_new_goal)),
            "speed": sh(jnp.asarray(self.speed, f32)),
            "w": sh(jnp.asarray(self.w, f32)),
            "throttle": sh(jnp.asarray(self.throttle, f32)),
            "warm": sh(jnp.asarray(warm.reshape(self.B, T, 2), self.dtype)),
            "has_warm": sh(jnp.asarray(self._has_warm)),
        }
        if self.wire == "i16":
            # fresh tick mirrors (host + device, identical zeros); the
            # first begin_cycle sees a > delta-range jump and auto-sends
            # a float32 keyframe that seeds both sides from true poses
            self._wire_ticks = np.zeros((self.B, 5), np.int32)
            self._carry["wire_ticks"] = sh(jnp.asarray(self._wire_ticks))

    def _sync_to_host(self) -> None:
        """Fetch the device carry into the host mirror fields (checkpoint /
        goal-check interop)."""
        if self._carry is None:
            return
        c = jax.device_get(self._carry)
        # np.array (copy): device_get can hand back read-only buffers, and
        # the host seeding logic mutates these in place
        self._start = np.array(c["start"], np.int64)
        self.states = np.array(c["states"], np.int64)
        self.latch_xy = np.array(c["latch_xy"], bool)
        self.latch_yaw = np.array(c["latch_yaw"], bool)
        self.set_new_goal = np.array(c["set_new_goal"], bool)
        self.speed = np.array(c["speed"], float)
        self.w = np.array(c["w"], float)
        self.throttle = np.array(c["throttle"], float)
        self._warm = np.array(c["warm"], float)
        self._has_warm = np.array(c["has_warm"], bool)

    # -- lifecycle ------------------------------------------------------------

    def initialize(self, n_robots: int) -> None:
        # drop any previous fleet's device carry BEFORE the host mirrors
        # reset — set_plans syncs device->host first, and a stale carry
        # would resurrect the old fleet's state (or break on a new B)
        self._consts = None
        self._carry = None
        self._cycle_count = 0
        super().initialize(n_robots)

    def set_plans(self, plans, poses):
        # mid-run goal changes: the live latches / warm bank / actuation
        # state ride the device carry — pull them down before the host
        # seeding logic mutates the mirrors, then push the merged state up
        self._sync_to_host()
        ok = super().set_plans(plans, poses)
        self._upload()
        return ok

    def state_dict(self) -> dict:
        self._sync_to_host()
        return super().state_dict()

    def load_state_dict(self, sd: dict) -> None:
        super().load_state_dict(sd)
        self._upload()

    def is_goal_reached(self, poses, feedback):
        assert self._consts is not None, "set_plans first"
        poses = jnp.asarray(np.asarray(poses, np.float32))
        feedback = jnp.asarray(np.asarray(feedback, np.float32))
        fn = _goal_jit(self.planner_cfg, self.model.can_rotate_in_place)
        lx, ly, sng, reached = fn(
            self._consts, self._carry["latch_xy"], self._carry["latch_yaw"],
            self._carry["set_new_goal"], poses, feedback)
        reached = np.asarray(jax.device_get(reached), bool)
        self._carry = dict(self._carry, latch_xy=lx, latch_yaw=ly,
                           set_new_goal=sng,
                           states=jnp.where(jnp.asarray(reached), _IDLE,
                                            self._carry["states"]))
        return reached

    # -- the hot path ---------------------------------------------------------

    def begin_cycle(self, poses, feedback) -> dict:
        assert self._initialized and self._consts is not None
        # ONE upload: poses ++ feedback as a (B, 5) tile — f32, or int16
        # deltas under the 16-bit wire (see __init__ `wire`)
        world = np.empty((self.B, 5), np.float32)
        world[:, :3] = poses
        world[:, 3:] = feedback
        wire_mode = "f32"
        if self.wire == "i16":
            scl32 = np.asarray(_WIRE_SCALES, np.float32)
            finite = bool(np.isfinite(world).all())
            # Keyframe triggers:
            # * non-finite poses/feedback (NaN comparisons are all-False, so
            #   a plain `dq > 32767` test would cast NaN to int16 and
            #   silently corrupt the tick mirror for a cycle) — and the
            #   cycle AFTER one, because the device casts NaN ticks
            #   implementation-defined, so both mirrors must reseed together
            #   from the first finite frame;
            # * yaw-tick budget: the yaw mirror accumulates UNWRAPPED yaw
            #   (the delta is wrapped, the running sum is not) — ~628k
            #   ticks per lap at 1e-5 rad/tick degrades the f32 decode
            #   (ulp ~8 ticks at 1e8) and overflows int32 after ~3,400
            #   laps; keyframing reseeds from the caller's (wrapped) yaw;
            # * teleport / fresh mirror: a delta beyond int16 range.
            need_kf = (not finite or self._wire_dirty
                       or np.abs(self._wire_ticks[:, 2]).max() > 1e7)
            if not need_kf:
                # decode the mirror exactly like the device does (f32 ops)
                mirror = self._wire_ticks.astype(np.float32) * scl32
                dlt = world.astype(np.float64) - mirror.astype(np.float64)
                # yaw delta wrapped: the mirror tracks yaw modulo 2pi (every
                # in-program use of yaw is 2pi-periodic)
                dlt[:, 2] = (dlt[:, 2] + np.pi) % (2.0 * np.pi) - np.pi
                dq = np.round(dlt / np.asarray(_WIRE_SCALES, np.float64))
                need_kf = not (np.abs(dq).max() <= 32767)
            if need_kf:
                # float32 keyframe cycle: reseeds the tick mirror on both
                # sides from the true poses (nan_to_num keeps the host
                # mirror finite so the wire recovers once the poses do)
                wire_mode = "kf"
                self._wire_ticks = np.round(
                    np.nan_to_num(world) / scl32).astype(np.int32)
                self._wire_dirty = not finite
            else:
                wire_mode = "i16"
                d16 = dq.astype(np.int16)
                self._wire_ticks = self._wire_ticks + d16.astype(np.int32)
                world = d16
        world = jnp.asarray(world)
        Mk = self._kmax_win.shape[1]
        M = self._buf.shape[1]
        blob_leaves = ()
        has_blobs = self.world_obstacles is not None
        if has_blobs:
            ob = self.world_obstacles
            blob_leaves = (jnp.asarray(ob.cx), jnp.asarray(ob.cy),
                           jnp.asarray(ob.gamma), jnp.asarray(ob.w))
        from ..config import per_lane_leaf_names

        sharded_leaves = per_lane_leaf_names(self.params)
        fn = _cycle_jit(self.solver_cfg, self.planner_cfg, M, Mk,
                        has_blobs, jnp.dtype(self.dtype).name,
                        mesh=self.mesh, sharded_leaves=sharded_leaves,
                        wire=wire_mode)
        if self.mesh is not None:
            world = self._shard(world)
            blob_leaves = tuple(self._shard(a) for a in blob_leaves)
        carry2, cmds_out, obs = fn(self._consts, self._carry, world,
                                   self.params, *blob_leaves)
        self._carry = carry2
        want_obs = self.obs_every > 0 and (
            self._cycle_count % self.obs_every == 0)
        self._cycle_count += 1
        return {"cmds": cmds_out, "obs": obs if want_obs else None,
                "ok": self._has_plan()}

    def finish_cycle(self, h: dict):
        from .fleet import FleetCycleInfo

        def decode(cm):
            cmds = np.asarray(cm, np.float64).T.copy()
            if self.wire == "i16":
                cmds *= _WIRE_CMD_SCALE
            return cmds

        if h["obs"] is not None:
            cm, obs = jax.device_get((h["cmds"], h["obs"]))
            obs = np.asarray(obs, np.float64)
            track = obs[OB_TRACK] > 0.5
            cmds = decode(cm)
            info = FleetCycleInfo(
                states=obs[OB_STATE].astype(np.int64),
                cmds=cmds,
                ref_vel=obs[OB_REFV],
                cte=obs[OB_CTE],
                etheta=obs[OB_ETH],
                cost=obs[OB_COST],
                converged=(obs[OB_CONV] > 0.5) & track,
                n_iters=obs[OB_ITERS].astype(np.int32),
            )
        else:
            # lean cycle: commands only on the wire; observability rows
            # carry nan / stale markers (states -1 = not fetched; gate
            # consumers on FleetCycleInfo.observed — converged=False here
            # means "not fetched", not solver failure)
            cm = jax.device_get(h["cmds"])
            cmds = decode(cm)
            B = cmds.shape[0]
            nan = np.full(B, np.nan)
            info = FleetCycleInfo(
                states=np.full(B, -1, np.int64), cmds=cmds, ref_vel=nan,
                cte=nan, etheta=nan, cost=nan,
                converged=np.zeros(B, bool),
                n_iters=np.zeros(B, np.int32),
            )
        # host actuation mirrors stay stale between syncs by design; the
        # live values ride the device carry
        return h["ok"], cmds, info
