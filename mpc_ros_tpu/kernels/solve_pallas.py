"""Whole-solve kernel: the entire batched SQP solve in one GPU program.

One Pallas program (compiled through Triton) per power-of-two block of
scenarios runs the complete control-limited SQP loop: initial rollout,
per-iteration (inline-linearized Riccati backward scan -> per-stage box
QPs -> multi-alpha line search -> masked accept) and per-lane convergence
bookkeeping. Every per-scenario value is a (BLOCK,) vector — about one
scenario per thread — and the small state/control matrices are Python
lists of such vectors, so each 8x8 product is a few dozen FMAs per lane
with structural zeros dropped at trace time.

Why a kernel: XLA cannot fuse a while loop over three scans of T steps
into one program. The plain path (`backward="xla"`) pays every scan step
as separate launches with device-memory round trips of (8, 8, B) stage
arrays, writes all line-search candidates every iteration, and runs the
whole batch to its slowest lane. Here each block exits its while loop
when ITS lanes are done, and the per-lane trajectory, gains and trig
cache stream through buffers the program owns (extra outputs: the Triton
route has no scratch memory), reading and writing only each lane's own
slice — one coalesced (BLOCK,) load or store per row.

The per-stage math is the XLA lane solver's (solver/batch_lane.py):
structured-sparsity Jacobian products, exact 9-combo box QP, FG_eval
cost — agreement is asserted in tests (interpret mode on the CPU).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .backward_pallas import (N_PAR, P_DT, P_LF, P_RCTE, P_RETH, P_RVEL,
                              P_WACC, P_WANG, P_WCTE, P_WDACC, P_WDANG,
                              P_WETH, P_WVEL, _boxqp_tile, _polyder2_tile,
                              _polyder_tile, _polyval_tile)

_N = 8
# rows/cols of A (and of the A' Vss A product) that are not structurally
# zero: nothing depends on cte_t (column 4) and rows 6-7 (previous
# control) are pure control copies
_ALIVE = (0, 1, 2, 3, 5)
# Vss entries carried through the backward scan: row/col 4 is invariantly
# diag(wc2) (A column 4 and K column 4 are zero), so it is not carried
_VLIVE = (0, 1, 2, 3, 5, 6, 7)
# stored feedback-gain columns (K column 4 is structurally zero)
_KCOLS = _VLIVE
_NK = len(_KCOLS)
# rows of the per-lane stats output
STAT_COST, STAT_CONV, STAT_ITERS, STAT_GNORM, STAT_MU, STAT_DONE = range(6)

# lanes per program (one lane per thread: num_warps = BLOCK / 32); 64 was
# the fastest of 64/128/256 at N=30, B=524,288 on an H100 (PERF.md)
BLOCK = 64


def lane_block(B: int, block: int = BLOCK) -> int:
    """Power-of-two lanes per program for a batch of B: `block`, or the
    smallest power of two >= B (at least 16) for small batches."""
    return min(block, max(16, 1 << (max(B, 1) - 1).bit_length()))


def padded_batch(B: int, block: int = BLOCK) -> int:
    """The batch the kernel runs: B rounded up to a whole block."""
    blk = lane_block(B, block)
    return -(-B // blk) * blk


def resolve_schedule(cfg) -> str:
    """The iteration schedule a config runs: "auto" is "compact" above
    n_steps 36 (long horizons have a genuinely slow tail of lanes,
    censused in tools/census_horizon.py; short horizons keep the single
    pass — the DDP endgame collapsed their tail)."""
    if cfg.schedule == "auto":
        return "compact" if cfg.n_steps > 36 else "single"
    return cfg.schedule


def straggler_lanes(B: int, cfg) -> int:
    """Lanes the compact schedule's straggler pass runs for a batch of B
    (block-granular, at least one block); B means one pass only."""
    blk = lane_block(B)
    n_tail = int(-(-B * cfg.compact_tail // blk)) * blk
    return max(blk, min(n_tail, B))


def _kernel(T: int, n_alpha: int, max_iters: int, sign: float,
            tol_grad: float, tol_cost_eff: float, mu_min: float,
            mu_max: float, mu_factor: float, n_coef: int, n_blobs: int,
            block: int, n_done_needed: int, has_resume: bool,
            has_setp: bool, fast_trig: bool, model: str, ddp: bool,
            ddp_gate: float, adaptive: bool, *refs):
    f32 = jnp.float32
    (z0_ref, c_ref, par_ref, lb_ref, ub_ref, u0_ref) = refs[:6]
    i = 6
    if has_setp:
        setp_ref = refs[i]          # (T+1, 3, B) per-knot setpoints
        i += 1
    if has_resume:
        resume_ref = refs[i]        # (4, B): done, conv, mu, gnorm
        i += 1
    if n_blobs:
        bx_ref, by_ref, bg_ref, bw_ref = refs[i:i + 4]
        i += 4
    # trajectory (ss, us) doubles as the output; g/k/K are working buffers
    ss_ref, us_ref, stat_ref, g_ref, k_ref, K_ref = refs[i:i + 6]

    lanes = pl.ds(pl.program_id(0) * block, block)

    def ld(ref, *idx):
        return ref[idx + (lanes,)]

    def st(ref, val, *idx):
        ref[idx + (lanes,)] = val

    par = [ld(par_ref, r) for r in range(N_PAR)]
    cf = [ld(c_ref, r) for r in range(n_coef)]
    lb = [ld(lb_ref, 0), ld(lb_ref, 1)]
    ub = [ld(ub_ref, 0), ld(ub_ref, 1)]
    dt = par[P_DT]
    zeros = jnp.zeros((block,), f32)
    alphas = [0.5 ** j for j in range(n_alpha)]
    if n_blobs:
        bx = [ld(bx_ref, k) for k in range(n_blobs)]
        by = [ld(by_ref, k) for k in range(n_blobs)]
        bg = [ld(bg_ref, k) for k in range(n_blobs)]
        bw = [ld(bw_ref, k) for k in range(n_blobs)]

    def obs_val(x, y):
        """Parametric obstacle penalty sum_k w exp(-|d|^2 g)."""
        tot = zeros
        for k in range(n_blobs):
            dx = x - bx[k]
            dy = y - by[k]
            tot = tot + bw[k] * jnp.exp(-(dx * dx + dy * dy) * bg[k])
        return tot

    def obs_terms(x, y, gate=None):
        """Gradient + curvature (see blob_terms_bl). `gate` (the per-lane
        GN->DDP mask): when given, the blob Hessian's concave -2 g v I
        part is added back scaled by it — exact curvature near
        convergence, convex GN model before the gate (basin stability
        requires the gating, measured)."""
        gx = gy = hxx = hxy = hyy = zeros
        for k in range(n_blobs):
            dx = x - bx[k]
            dy = y - by[k]
            g = bg[k]
            v = bw[k] * jnp.exp(-(dx * dx + dy * dy) * g)
            tg = 2.0 * g
            gx = gx - tg * dx * v
            gy = gy - tg * dy * v
            s = tg * tg * v
            hxx = hxx + s * dx * dx
            hxy = hxy + s * dx * dy
            hyy = hyy + s * dy * dy
            if gate is not None:
                hxx = hxx - gate * tg * v
                hyy = hyy - gate * tg * v
        return gx, gy, hxx, hxy, hyy

    wv2 = 2.0 * par[P_WVEL]
    wc2 = 2.0 * par[P_WCTE]
    we2 = 2.0 * par[P_WETH]
    ww2 = 2.0 * par[P_WANG]
    wa2 = 2.0 * par[P_WACC]

    # one-sided weight-scale equivariance (SolverConfig.scale_adaptive,
    # models/costs.weight_scale): mu floor/ceiling scale per lane with
    # s = max(1, sum(w)/470); the pg MEASUREMENT normalizes by 1/s so the
    # tol_grad / ddp_gate comparisons stay in c=1 units
    if adaptive:
        wscl = jnp.maximum(
            (par[P_WCTE] + par[P_WETH] + par[P_WVEL] + par[P_WANG]
             + par[P_WACC] + par[P_WDANG] + par[P_WDACC]) * (1.0 / 470.0),
            1.0)
        inv_wscl = 1.0 / wscl
        mu_lo = mu_min * wscl
        mu_hi = mu_max * wscl
    else:
        wscl = 1.0
        inv_wscl = 1.0
        mu_lo = jnp.full((block,), mu_min, f32)
        mu_hi = jnp.full((block,), mu_max, f32)

    # per-knot (ref_cte, ref_etheta, ref_vel) setpoints: a time-indexed
    # profile in trajectory-tracking mode (solver/ilqr.py `refs`), the
    # per-lane scalar params otherwise (FG_eval keeps them constant over
    # the horizon)
    if has_setp:
        def ref3(t):
            return (ld(setp_ref, t, 0), ld(setp_ref, t, 1),
                    ld(setp_ref, t, 2))
    else:
        def ref3(t):
            return par[P_RCTE], par[P_RETH], par[P_RVEL]

    # ---------------- model-family heading kinematics --------------------
    # diff_drive: theta/etheta advance by u0*dt (u0 = omega).
    # bicycle:    by (v / lf) * u0 * dt (u0 = delta; models/bicycle.py) —
    # the heading increment gains a state (v) dependence, which is the
    # ONLY structural difference: A[2,3] = A[5,3] = dth/dv and B rows 2/5
    # scale by v/lf instead of 1.
    if model == "bicycle":
        invlf = 1.0 / par[P_LF]

        def dth_of(v, u0):
            return v * invlf * u0 * dt
    else:
        def dth_of(v, u0):
            return u0 * dt

    # ---------------- shared per-stage math (lists of lane vectors) ------

    def dyn_step(s_a, u0, u1, tg):
        x, y, th, v, cte, eth = s_a[:6]
        ct_, st_, se_ = tg
        f0 = _polyval_tile(cf, x)
        dth = dth_of(v, u0)
        return [x + v * ct_ * dt,
                y + v * st_ * dt,
                th + dth,
                v + u1 * dt,
                (f0 - y) + sign * v * se_ * dt,
                eth + dth,
                u0,
                u1]

    def stage_cost(s_rows, u0, u1, rate, t):
        du0 = u0 - s_rows[6]
        du1 = u1 - s_rows[7]
        rc, re, rv = ref3(t)
        c = (par[P_WCTE] * (s_rows[4] - rc) ** 2
             + par[P_WETH] * (s_rows[5] - re) ** 2
             + par[P_WVEL] * (s_rows[3] - rv) ** 2
             + par[P_WANG] * u0 ** 2 + par[P_WACC] * u1 ** 2
             + rate * (par[P_WDANG] * du0 ** 2 + par[P_WDACC] * du1 ** 2))
        if n_blobs:
            c = c + obs_val(s_rows[0], s_rows[1])
        return c

    def term_cost(s_rows):
        rc, re, rv = ref3(T)
        c = (par[P_WCTE] * (s_rows[4] - rc) ** 2
             + par[P_WETH] * (s_rows[5] - re) ** 2
             + par[P_WVEL] * (s_rows[3] - rv) ** 2)
        if n_blobs:
            c = c + obs_val(s_rows[0], s_rows[1])
        return c

    def rate_of(t):
        """Rate-cost switch: 0 at the first stage (no previous control)."""
        return jnp.minimum(t, 1).astype(f32)

    def zadd(*terms):
        """Sum of the non-None terms; None when all are structural zeros."""
        terms = [t for t in terms if t is not None]
        if not terms:
            return None
        acc = terms[0]
        for t in terms[1:]:
            acc = acc + t
        return acc

    def zmul(a, b):
        return None if a is None or b is None else a * b

    # ---------------- buffer access --------------------------------------

    def read_s(t):
        """Full 8-row augmented state at knot t (rows 6-7 = previous
        control; zeros at the pinned start)."""
        return [ld(ss_ref, t, r) for r in range(_N)]

    def write_s(t, s):
        for r in range(_N):
            st(ss_ref, s[r], t, r)

    def read_u(t):
        return [ld(us_ref, t, 0), ld(us_ref, t, 1)]

    def read_g(t):
        return [ld(g_ref, t, r) for r in range(4)]

    def read_gains(t):
        k = [ld(k_ref, t, 0), ld(k_ref, t, 1)]
        K = [{j: ld(K_ref, t, m * _NK + c) for c, j in enumerate(_KCOLS)}
             for m in range(2)]
        return k, K

    def feedback(u_b, kk, K, alpha, s_a, s_b):
        """Clipped u = u_b + alpha k + K (s_a - s_b) (K col 4 is zero)."""
        ds = {j: s_a[j] - s_b[j] for j in _KCOLS}
        out = []
        for m in range(2):
            fb = zadd(*(K[m][j] * ds[j] for j in _KCOLS))
            u = u_b[m] + alpha * kk[m] + fb
            out.append(jnp.clip(u, lb[m], ub[m]))
        return out

    # ---------------- rollout trigonometry -------------------------------
    # Every rollout (initial, the n_alpha line-search candidates, the
    # winner re-roll) starts from the SAME pinned state s0, and theta and
    # etheta advance by the identical increment every step. Hence:
    #   * etheta_t = theta_t + phi with phi = etheta_0 - theta_0 constant
    #     for the WHOLE solve -> sin/cos(etheta) are two FMAs off
    #     sin/cos(theta);
    #   * in fast mode, cos/sin(theta) are carried through the rollout by
    #     rotation composition, the per-step increment's sin/cos coming
    #     from a 9th/8th-order Taylor (|d| <= 1: error < 3e-7) plus
    #     one Newton renormalization step.
    # This removes all per-stage transcendentals from the rollouts.

    s0 = [ld(z0_ref, r) for r in range(6)] + [zeros, zeros]
    ct00 = jnp.cos(s0[2])
    st00 = jnp.sin(s0[2])
    if fast_trig:
        phi = s0[5] - s0[2]
        cphi = jnp.cos(phi)
        sphi = jnp.sin(phi)

        def se_of(ct, st_, s_a):
            return st_ * cphi + ct * sphi

        def ce_of(ct, st_, s_a):
            return ct * cphi - st_ * sphi

        # diff_drive's increment is bounded by max_angvel*dt (<= 1 rad at
        # any documented operating point); the bicycle's v/lf*delta*dt is
        # not config-bounded, so its Taylor runs on the HALF angle and
        # composes the rotation twice — exact-domain |d| <= 2 rad/step
        half = 0.5 if model == "bicycle" else 1.0

        def step_trig(ct, st_, d, s_next):
            d = d * half
            z = d * d
            sd = d * (1.0 + z * (-1.0 / 6.0 + z * (1.0 / 120.0
                      + z * (-1.0 / 5040.0 + z * (1.0 / 362880.0)))))
            cd = 1.0 + z * (-0.5 + z * (1.0 / 24.0
                      + z * (-1.0 / 720.0 + z * (1.0 / 40320.0))))
            if half != 1.0:
                cd, sd = cd * cd - sd * sd, 2.0 * sd * cd   # double angle
            c2 = ct * cd - st_ * sd
            s2 = st_ * cd + ct * sd
            f = 1.5 - 0.5 * (c2 * c2 + s2 * s2)
            return c2 * f, s2 * f
    else:
        def se_of(ct, st_, s_a):
            return jnp.sin(s_a[5])

        def ce_of(ct, st_, s_a):
            return jnp.cos(s_a[5])

        def step_trig(ct, st_, d, s_next):
            return jnp.cos(s_next[2]), jnp.sin(s_next[2])

    # ---------------- initial rollout ------------------------------------

    write_s(0, s0)

    def init_body(t, carry):
        acc, ct, st_ = carry[:3]
        s_a = list(carry[3:])
        u0 = ld(u0_ref, t, 0)
        u1 = ld(u0_ref, t, 1)
        st(us_ref, u0, t, 0)
        st(us_ref, u1, t, 1)
        acc = acc + stage_cost(s_a, u0, u1, rate_of(t), t)
        # cache the stage trig for the backward pass
        se = se_of(ct, st_, s_a)
        for r, val in enumerate((ct, st_, se, ce_of(ct, st_, s_a))):
            st(g_ref, val, t, r)
        s_n = dyn_step(s_a, u0, u1, (ct, st_, se))
        write_s(t + 1, s_n)
        ct, st_ = step_trig(ct, st_, dth_of(s_a[3], u0), s_n)
        return (acc, ct, st_, *s_n)

    out0 = jax.lax.fori_loop(0, T, init_body, (zeros, ct00, st00, *s0))
    cost0 = out0[0] + term_cost(list(out0[3:]))

    # ---------------- SQP loop -------------------------------------------

    vidx = {}
    for a_, i_ in enumerate(_VLIVE):
        for j_ in _VLIVE[a_:]:
            vidx[(i_, j_)] = len(vidx)

    def cond(carry):
        # SolverConfig.done_frac applies PER BLOCK here (each program sees
        # only its own lanes); stragglers keep their current iterate
        it, done = carry[0], carry[4]
        return jnp.logical_and(it < max_iters,
                               jnp.sum(done) < n_done_needed - 0.5)

    def body(carry):
        it, cost, mu, n_small, done, conv, gnorm, iters = carry
        act = 1.0 - done

        # per-lane GN->DDP hybrid gate (SolverConfig.ddp): exact
        # second-order terms (dynamics + the blob concave part) engage
        # once the previous iteration's projected gradient is below
        # ddp_gate (gnorm starts at +inf -> first iteration is pure GN)
        g_ddp = (gnorm < ddp_gate).astype(f32) if ddp else None

        # ---- backward scan with inline linearization ----
        sT = read_s(T)
        if n_blobs:
            ogxT, ogyT, ohxxT, ohxyT, ohyyT = obs_terms(sT[0], sT[1],
                                                        gate=g_ddp)
        else:
            ogxT = ogyT = ohxxT = ohxyT = ohyyT = zeros
        rcT, reT, rvT = ref3(T)
        Vs0 = [ogxT, ogyT, zeros,
               wv2 * (sT[3] - rvT),
               wc2 * (sT[4] - rcT),
               we2 * (sT[5] - reT),
               zeros, zeros]
        diagT = {0: ohxxT, 1: ohyyT, 2: zeros, 3: wv2, 5: we2, 6: zeros,
                 7: zeros}
        Vss0 = [None] * len(vidx)
        for (i2, j2), n in vidx.items():
            if i2 == j2:
                Vss0[n] = diagT[i2]
            elif (i2, j2) == (0, 1) and n_blobs:
                Vss0[n] = ohxyT
            else:
                Vss0[n] = zeros

        def bwd_body(i_, bcarry):
            Vs = list(bcarry[:_N])
            Vflat = bcarry[_N:_N + len(vidx)]
            dv1, dv2, pg = bcarry[_N + len(vidx):]
            t = jnp.asarray(T - 1, jnp.int32) - i_

            def V(i, j):
                if i == 4 or j == 4:
                    return wc2 if i == j else None
                return Vflat[vidx[(i, j) if i <= j else (j, i)]]

            s_t = read_s(t)
            u_t = read_u(t)
            rate = rate_of(t)

            x = s_t[0]
            v = s_t[3]
            eth = s_t[5]
            ct, st_, se, ce = read_g(t)   # cached by the accepting rollout
            fp = _polyder_tile(cf, x)
            a02 = -v * st_ * dt
            a03 = ct * dt
            a12 = v * ct * dt
            a13 = st_ * dt
            a40 = fp
            a43 = sign * se * dt
            a45 = sign * v * ce * dt
            if model == "bicycle":
                # heading rows: dpsi = (v/lf) * delta * dt gives
                # A[2,3] = A[5,3] = delta*dt/lf and B[2,0] = B[5,0] =
                # v*dt/lf (vs 0 and dt for diff_drive)
                a23 = u_t[0] * invlf * dt
                b20 = v * invlf * dt
            else:
                a23 = None
                b20 = dt

            def At_vec(y):
                y3 = y[3] if a23 is None else y[3] + a23 * (y[2] + y[5])
                return [y[0] + a40 * y[4],
                        y[1] - y[4],
                        a02 * y[0] + a12 * y[1] + y[2],
                        a03 * y[0] + a13 * y[1] + y3 + a43 * y[4],
                        None,
                        a45 * y[4] + y[5],
                        None,
                        None]

            def Bt_vec(y):
                return [b20 * (y[2] + y[5]) + y[6], dt * y[3] + y[7]]

            wdw2 = 2.0 * rate * par[P_WDANG]
            wda2 = 2.0 * rate * par[P_WDACC]
            du0 = u_t[0] - s_t[6]
            du1 = u_t[1] - s_t[7]
            if n_blobs:
                ogx, ogy, ohxx, ohxy, ohyy = obs_terms(s_t[0], s_t[1],
                                                       gate=g_ddp)
            else:
                ogx = ogy = ohxx = ohxy = ohyy = None
            rc_t, re_t, rv_t = ref3(t)
            ls = [ogx, ogy, None,
                  wv2 * (v - rv_t),
                  wc2 * (s_t[4] - rc_t),
                  we2 * (eth - re_t),
                  -wdw2 * du0,
                  -wda2 * du1]
            lu = [ww2 * u_t[0] + wdw2 * du0,
                  wa2 * u_t[1] + wda2 * du1]
            lss_diag = [None, None, None, wv2, wc2, we2, wdw2, wda2]

            Qs = [zadd(a, b) for a, b in zip(ls, At_vec(Vs))]
            Qu = [a + b for a, b in zip(lu, Bt_vec(Vs))]

            # Structured VA = Vss @ A, per entry (column j of VA as a
            # list over rows i); None marks structural zeros
            va0 = [V(i, 0) for i in range(_N)]
            va0[4] = a40 * wc2
            va1 = [V(i, 1) for i in range(_N)]
            va1[4] = -wc2
            va2 = [zadd(a02 * V(i, 0), a12 * V(i, 1), V(i, 2))
                   if i != 4 else None for i in range(_N)]
            va3 = [zadd(a03 * V(i, 0), a13 * V(i, 1), V(i, 3),
                        None if a23 is None else a23 * (V(i, 2) + V(i, 5)))
                   if i != 4 else None for i in range(_N)]
            # row 4's (4,2)/(4,5) entries are structurally zero, so the
            # bicycle a23 term drops out of the row-4 invariant too
            va3[4] = a43 * wc2
            va5 = [V(i, 5) for i in range(_N)]
            va5[4] = a45 * wc2
            va = {0: va0, 1: va1, 2: va2, 3: va3, 5: va5}

            def atva(i, j):
                """(A' Vss A)[i, j] for live i, j; rows/cols 4, 6, 7 zero."""
                y = va[j]
                y4 = y[4]
                if i == 0:
                    return zadd(y[0], zmul(a40, y4))
                if i == 1:
                    return zadd(y[1], None if y4 is None else -y4)
                if i == 2:
                    return zadd(a02 * y[0], a12 * y[1], y[2])
                if i == 3:
                    return zadd(a03 * y[0], a13 * y[1], y[3], zmul(a43, y4),
                                None if a23 is None
                                else a23 * (y[2] + y[5]))
                return zadd(zmul(a45, y4), y[5])           # i == 5

            if ddp:
                # exact d2f/ds2 contractions with Vs (rows 0/1: v cos/sin
                # theta; row 4: f(x) and v sin(etheta)); all entries avoid
                # the structural row/col 4, so the invariants hold
                fpp = _polyder2_tile(cf, x)
                dmap = {
                    (0, 0): Vs[4] * fpp * g_ddp,
                    (2, 2): -v * dt * (Vs[0] * ct + Vs[1] * st_) * g_ddp,
                    (2, 3): dt * (Vs[1] * ct - Vs[0] * st_) * g_ddp,
                    (3, 5): sign * dt * ce * Vs[4] * g_ddp,
                    (5, 5): -sign * dt * v * se * Vs[4] * g_ddp,
                }

            def qss_entry(i, j):
                e = atva(i, j) if (i in _ALIVE and j in _ALIVE) else None
                if i == j:
                    e = zadd(e, lss_diag[i])
                if n_blobs:
                    if i == 0 and j == 0:
                        e = zadd(e, ohxx)
                    elif i == 1 and j == 1:
                        e = zadd(e, ohyy)
                    elif {i, j} == {0, 1}:
                        e = zadd(e, ohxy)
                if ddp:
                    e = zadd(e, dmap.get((i, j) if i <= j else (j, i)))
                return e

            # Qus = B' Vss A + l_us per entry (col 4 zero; cols 6/7 are the
            # rate-coupling constants)
            qus0 = {j: zadd(b20 * zadd(va[j][2], va[j][5]), va[j][6])
                    for j in _ALIVE}
            qus1 = {j: zadd(dt * va[j][3], va[j][7]) for j in _ALIVE}
            qus0[4] = qus1[4] = None
            qus0[6], qus1[6] = -wdw2, None
            qus0[7], qus1[7] = None, -wda2
            if ddp and model == "bicycle":
                # theta rows 2/5: d2((v/lf) delta dt)/dv ddelta -> Qus[0,3]
                qus0[3] = zadd(qus0[3],
                               (Vs[2] + Vs[5]) * (invlf * dt) * g_ddp)
            # B' Vss B: VB columns over the rows Bt_vec reads
            VB0 = {i: b20 * (V(i, 2) + V(i, 5)) + V(i, 6)
                   for i in (2, 3, 5, 6, 7)}
            VB1 = {i: dt * V(i, 3) + V(i, 7) for i in (2, 3, 5, 6, 7)}
            BtVB = [Bt_vec(VB0), Bt_vec(VB1)]           # [col][row]
            offd = 0.5 * (BtVB[1][0] + BtVB[0][1])
            q00 = BtVB[0][0] + ww2 + wdw2
            q11 = BtVB[1][1] + wa2 + wda2
            Quu = ((q00, offd), (offd, q11))

            (k0, k1), (j00, j01, j10, j11) = _boxqp_tile(
                ((q00 + mu, offd), (offd, q11 + mu)), Qu,
                (lb[0] - u_t[0], lb[1] - u_t[1]),
                (ub[0] - u_t[0], ub[1] - u_t[1]))
            K = [{j: -zadd(zmul(j00, qus0[j]), zmul(j01, qus1[j]))
                  for j in _KCOLS},
                 {j: -zadd(zmul(j10, qus0[j]), zmul(j11, qus1[j]))
                  for j in _KCOLS}]

            Quu_k = [Quu[0][0] * k0 + Quu[0][1] * k1,
                     Quu[1][0] * k0 + Quu[1][1] * k1]
            # Vs_n = Qs + K'(Quu k + Qu) + Qus' k (one folded matvec)
            ku = [Quu_k[0] + Qu[0], Quu_k[1] + Qu[1]]
            Vs_n = []
            for i in range(_N):
                Kc = [None if i == 4 else K[m][i] for m in range(2)]
                e = zadd(Qs[i], zadd(zmul(Kc[0], ku[0]), zmul(Kc[1], ku[1])),
                         zadd(zmul(qus0[i], k0), zmul(qus1[i], k1)))
                Vs_n.append(zeros if e is None else e)
            KtQuu = {i: (K[0][i] * Quu[0][0] + K[1][i] * Quu[1][0],
                         K[0][i] * Quu[0][1] + K[1][i] * Quu[1][1])
                     for i in _KCOLS}

            def cross(i, j):
                """(K' Qus)[i, j] with structural-zero Qus columns dropped."""
                return zadd(zmul(K[0][i], qus0[j]), zmul(K[1][i], qus1[j]))

            # Vss_n = Qss + K'Quu K + K'Qus + (K'Qus)' is symmetric by
            # construction (Quu is); build only the upper triangle over
            # the carried indices
            Vss_n = [None] * len(vidx)
            for (i2, j2), n in vidx.items():
                e = zadd(qss_entry(i2, j2),
                         KtQuu[i2][0] * K[0][j2] + KtQuu[i2][1] * K[1][j2],
                         cross(i2, j2), cross(j2, i2))
                Vss_n[n] = zeros if e is None else e

            st(k_ref, k0, t, 0)
            st(k_ref, k1, t, 1)
            for m in range(2):
                for c, j in enumerate(_KCOLS):
                    st(K_ref, K[m][j], t, m * _NK + c)
            dv1 = dv1 + k0 * Qu[0] + k1 * Qu[1]
            dv2 = dv2 + 0.5 * (k0 * Quu_k[0] + k1 * Quu_k[1])
            # pg on the weight-scale-NORMALIZED gradient (inv_wscl == 1/s;
            # equals the c=1 problem's pg for uniform weight scalings)
            pg_t = jnp.maximum(
                jnp.abs(u_t[0] - jnp.clip(u_t[0] - Qu[0] * inv_wscl,
                                          lb[0], ub[0])),
                jnp.abs(u_t[1] - jnp.clip(u_t[1] - Qu[1] * inv_wscl,
                                          lb[1], ub[1])))
            return (*Vs_n, *Vss_n, dv1, dv2, jnp.maximum(pg, pg_t))

        bout = jax.lax.fori_loop(0, T, bwd_body,
                                 (*Vs0, *Vss0, zeros, zeros, zeros))
        dv1, dv2, pg = bout[-3:]

        pred_decrease = -(dv1 + dv2)
        # wscl floor: tol*(s+|J|) keeps the relative-cost guards exactly
        # equivariant under uniform weight scaling (matches ilqr/batch_lane)
        tiny_model = (pred_decrease
                      <= tol_cost_eff * (wscl + jnp.abs(cost))).astype(f32)

        # ---- multi-alpha line search (candidates held in registers) ----
        s0_t = read_s(0)

        def roll_body(t, carry):
            accs = carry[:n_alpha]
            cts = carry[n_alpha:2 * n_alpha]
            sts = carry[2 * n_alpha:3 * n_alpha]
            s_all = carry[3 * n_alpha:]
            s_b = read_s(t)
            u_b = read_u(t)
            kk, K = read_gains(t)
            rate = rate_of(t)
            new_accs, new_cts, new_sts, new_s = [], [], [], []
            for a in range(n_alpha):
                s_a = list(s_all[a * _N:(a + 1) * _N])
                u0, u1 = feedback(u_b, kk, K, alphas[a], s_a, s_b)
                new_accs.append(accs[a] + stage_cost(s_a, u0, u1, rate, t))
                se = se_of(cts[a], sts[a], s_a)
                s_n = dyn_step(s_a, u0, u1, (cts[a], sts[a], se))
                nct, nst = step_trig(cts[a], sts[a], dth_of(s_a[3], u0), s_n)
                new_cts.append(nct)
                new_sts.append(nst)
                new_s.extend(s_n)
            return (*new_accs, *new_cts, *new_sts, *new_s)

        rout = jax.lax.fori_loop(
            0, T, roll_body,
            (*([zeros] * n_alpha), *([ct00] * n_alpha),
             *([st00] * n_alpha), *(s0_t * n_alpha)))
        s_fin = rout[3 * n_alpha:]
        costs = [rout[a] + term_cost(list(s_fin[a * _N:(a + 1) * _N]))
                 for a in range(n_alpha)]

        picked = zeros
        alpha_sel = zeros
        cost_sel = cost
        for a in range(n_alpha):
            improved = (costs[a] < cost).astype(f32)
            take = improved * (1.0 - jnp.minimum(picked, 1.0))
            picked = picked + take
            alpha_sel = alpha_sel + take * alphas[a]
            cost_sel = jnp.where(take > 0.5, costs[a], cost_sel)
        accepted = jnp.minimum(picked, 1.0)
        upd = accepted * act
        take_new = upd > 0.5

        # ---- winner re-roll, written in place (masked) ----
        # step t reads the OLD knot t+1 before overwriting it and carries
        # it as the next step's reference state
        def sel_body(t, carry):
            ct, st_ = carry[:2]
            s_a = list(carry[2:2 + _N])
            s_b = list(carry[2 + _N:])
            u_b = read_u(t)
            kk, K = read_gains(t)
            u0, u1 = feedback(u_b, kk, K, alpha_sel, s_a, s_b)
            se = se_of(ct, st_, s_a)
            g_new = (ct, st_, se, ce_of(ct, st_, s_a))
            for r, (gn, go) in enumerate(zip(g_new, read_g(t))):
                st(g_ref, jnp.where(take_new, gn, go), t, r)
            s_n = dyn_step(s_a, u0, u1, (ct, st_, se))
            s_old = read_s(t + 1)
            st(us_ref, jnp.where(take_new, u0, u_b[0]), t, 0)
            st(us_ref, jnp.where(take_new, u1, u_b[1]), t, 1)
            write_s(t + 1, [jnp.where(take_new, a, b)
                            for a, b in zip(s_n, s_old)])
            ct, st_ = step_trig(ct, st_, dth_of(s_a[3], u0), s_n)
            return (ct, st_, *s_n, *s_old)

        jax.lax.fori_loop(0, T, sel_body, (ct00, st00, *s0_t, *s0_t))
        cost2 = jnp.where(take_new, cost_sel, cost)

        # ---- per-lane bookkeeping (matches batch_lane) ----
        mu2 = jnp.where(
            take_new, jnp.maximum(mu / mu_factor, mu_lo),
            jnp.where(act > 0.5, jnp.minimum(mu * mu_factor, mu_hi), mu))
        small_step = accepted * (
            jnp.abs(cost - cost2)
            <= tol_cost_eff * (wscl + jnp.abs(cost))).astype(f32)
        n_small2 = jnp.where(act > 0.5,
                             jnp.where(small_step > 0.5, n_small + 1.0, 0.0),
                             n_small)
        # tiny predicted decrease = optimum only with the trust region
        # open; under inflated mu it is a stall only if the step was ALSO
        # rejected — accepted tiny steps keep iterating while mu decays
        # toward an honest certificate (see ilqr.py) — per lane
        mu_open = (mu <= mu_lo * mu_factor).astype(f32)
        converged_now = jnp.maximum(
            jnp.maximum((pg < tol_grad).astype(f32),
                        (n_small2 >= 2.0).astype(f32)),
            tiny_model * mu_open)
        stalled = jnp.maximum(
            (1.0 - accepted) * (mu2 >= mu_hi).astype(f32),
            tiny_model * (1.0 - mu_open) * (1.0 - accepted))
        done2 = jnp.where(act > 0.5,
                          jnp.maximum(converged_now, stalled), done)
        conv2 = jnp.where(act > 0.5, converged_now, conv)
        gnorm2 = jnp.where(act > 0.5, pg, gnorm)
        iters2 = iters + act
        return (it + 1, cost2, mu2, n_small2, done2, conv2, gnorm2, iters2)

    if has_resume:
        # warm restart: (done, conv, mu, gnorm) carried from a previous
        # pass. Done lanes never enter the body (act = 0), and a block
        # whose lanes are ALL done exits the while loop before its first
        # iteration — it pays only the initial rollout.
        carry0 = (cost0, ld(resume_ref, 2), zeros, ld(resume_ref, 0),
                  ld(resume_ref, 1), ld(resume_ref, 3), zeros)
    else:
        carry0 = (cost0, jnp.broadcast_to(mu_lo, (block,)).astype(f32),
                  zeros, zeros, zeros, jnp.full((block,), jnp.inf, f32),
                  zeros)
    (_, cost_f, mu_f, _, done_f, conv_f, gnorm_f, iters_f) = (
        jax.lax.while_loop(cond, body,
                           (jnp.asarray(0, jnp.int32), *carry0)))

    for row, val in ((STAT_COST, cost_f), (STAT_CONV, conv_f),
                     (STAT_ITERS, iters_f), (STAT_GNORM, gnorm_f),
                     (STAT_MU, mu_f), (STAT_DONE, done_f)):
        st(stat_ref, val, row)


def solve_pallas(zT, cT, params_pack, lb, ub, u0, cfg, *, dtype=jnp.float32,
                 interpret: bool = False, blobs=None, resume=None,
                 refs=None, block: int = BLOCK, num_warps: int | None = None):
    """Whole-solve kernel. Batch-last inputs: zT (6,B), cT (P,B),
    params_pack (N_PAR,B) from `pack_params`, lb/ub (2,B), u0 (T,2,B)
    initial controls.

    `refs`: optional lane-major (T+1, 3, B) per-knot
    (ref_cte, ref_etheta, ref_vel) setpoint profiles — the time-indexed
    objective behind trajectory tracking (solver/ilqr.py `refs`). None =
    the scalar FG_eval setpoints from params_pack, bit-for-bit.

    `cfg.model` selects the vehicle family ("diff_drive" or "bicycle") —
    a static specialization: the bicycle's heading rows read the traced
    per-lane wheelbase from params_pack[P_LF] (models/bicycle.py).

    `blobs`: optional lane-major parametric obstacles — a tuple of four
    (K, B) arrays (cx, cy, gamma, w) from `GaussianObstacles.lane()`. The
    penalty, its gradient and its PSD Gauss-Newton curvature are evaluated
    inline per stage.

    `resume`: optional warm-restart state — a tuple of four (B,) arrays
    (done, conv, mu, gnorm) from a previous pass (see the two-pass
    schedules below). Done lanes pass through untouched; a block of only
    done lanes exits before its first iteration.

    The batch is padded up to a whole number of `block`-lane programs by
    repeating the last lane; each lane's result does not depend on the
    blocking (done lanes stop changing), except through `cfg.done_frac`,
    which applies per block.

    The kernel runs compiled on a GPU only; `interpret=True` runs it on
    the CPU through the Pallas interpreter (tests). Anything else raises.

    Returns (ss (T+1,8,B), us (T,2,B), cost (B,), conv (B,), iters (B,),
    gnorm (B,), mu (B,), done (B,)).
    """
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the whole-solve kernel is compiled for the GPU only (found "
            f"{jax.default_backend()!r}); use SolverConfig(backward='xla') "
            "or interpret=True")
    if dtype != jnp.float32:
        raise ValueError(f"the whole-solve kernel is float32-only, got "
                         f"{jnp.dtype(dtype)}")
    T = cfg.n_controls
    B = zT.shape[-1]
    blk = lane_block(B, block)
    Bp = padded_batch(B, block)
    tol_cost_eff = max(cfg.tol_cost, 10.0 * float(jnp.finfo(dtype).eps))
    n_blobs = 0 if blobs is None else blobs[0].shape[0]
    n_ls = cfg.ls_for(dtype)

    def prep(a):
        a = jnp.asarray(a, dtype)
        if Bp == B:
            return a
        pad = [(0, 0)] * (a.ndim - 1) + [(0, Bp - B)]
        return jnp.pad(a, pad, mode="edge")

    n_done_needed = (blk if cfg.done_frac >= 1.0
                     else min(blk, int(math.ceil(cfg.done_frac * blk))))
    kernel = functools.partial(
        _kernel, T, n_ls, cfg.max_sqp_iters, float(cfg.cte_vsin_sign),
        float(cfg.tol_grad_for(dtype)), float(tol_cost_eff),
        float(cfg.mu_init_for(dtype, n_blobs > 0)),
        float(cfg.mu_max), float(cfg.mu_factor), cT.shape[0], n_blobs, blk,
        n_done_needed, resume is not None, refs is not None,
        cfg.trig == "fast", cfg.model, cfg.ddp_for(dtype),
        # blob ensembles cap the auto gate at 0.75 (basin stability with
        # the exact blob curvature — policy in SolverConfig.gate_for)
        float(cfg.gate_for(n_blobs > 0, dtype)), cfg.scale_adaptive)
    inputs = [zT, cT, params_pack, lb, ub, u0]
    if refs is not None:
        inputs.append(refs)
    if resume is not None:
        inputs.append(jnp.stack(resume))
    if n_blobs:
        inputs.extend(blobs)
    sds = lambda *shape: jax.ShapeDtypeStruct(shape + (Bp,), dtype)
    ss, us, stats, *_ = pl.pallas_call(
        kernel,
        grid=(Bp // blk,),
        out_shape=[
            sds(T + 1, _N),      # trajectory (also the working copy)
            sds(T, 2),           # controls (also the working copy)
            sds(6),              # per-lane stats (STAT_* rows)
            sds(T, 4),           # trig cache of the accepted rollout
            sds(T, 2),           # feedforward steps k
            sds(T, 2 * _NK),     # feedback gains K (col 4 dropped)
        ],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=num_warps or max(1, blk // 32), num_stages=1),
        interpret=interpret,
        name="nmpc_whole_solve",
    )(*[prep(a) for a in inputs])
    ss, us, stats = ss[..., :B], us[..., :B], stats[..., :B]
    return (ss, us, stats[STAT_COST], stats[STAT_CONV], stats[STAT_ITERS],
            stats[STAT_GNORM], stats[STAT_MU], stats[STAT_DONE])


def solve_pallas_scheduled(zT, cT, params_pack, lb, ub, u0, cfg, *,
                           dtype=jnp.float32, interpret: bool = False,
                           blobs=None, refs=None):
    """Whole-solve kernel under the SolverConfig iteration schedule.

    The kernel's per-block adaptive while loop pays the MAX iteration
    count over each block of lanes. Schedules:

      "single": one pass.
      "sorted": pass 1 runs `presolve_iters` iterations for every lane;
              lanes are then sorted (done first, the rest by projected-
              gradient norm ascending) and pass 2 continues warm-started
              on the PERMUTED batch — blocks made entirely of done lanes
              exit before their first iteration — and the outputs are
              scattered back to the caller's lane order.
      "compact": see `_solve_compact`.
      "auto": "compact" above n_steps 36, else "single".

    The passes run the identical kernel; the only semantic difference
    from one long pass is that the line-search/trust-region state (mu,
    small-step counter) restarts at the boundary for lanes still active —
    convergence criteria and solution quality are unchanged (asserted in
    tests against the single-pass and XLA paths).
    """
    total = cfg.max_sqp_iters
    schedule = resolve_schedule(cfg)
    if schedule == "compact":
        return _solve_compact(zT, cT, params_pack, lb, ub, u0, cfg,
                              dtype=dtype, interpret=interpret, blobs=blobs,
                              refs=refs)
    k1 = cfg.presolve_iters
    # a second pass needs at least one iteration of budget left after the
    # presolve
    two_pass = schedule == "sorted" and 1 <= k1 < total
    if not two_pass:
        return solve_pallas(zT, cT, params_pack, lb, ub, u0, cfg,
                            dtype=dtype, interpret=interpret, blobs=blobs,
                            refs=refs)

    cfg1 = dataclasses.replace(cfg, max_sqp_iters=k1)
    cfg2 = dataclasses.replace(cfg, max_sqp_iters=total - k1)
    ss1, us1, cost1, conv1, it1, gn1, mu1, done1 = solve_pallas(
        zT, cT, params_pack, lb, ub, u0, cfg1, dtype=dtype,
        interpret=interpret, blobs=blobs, refs=refs)
    key = jnp.where(done1 > 0.5, jnp.asarray(-1.0, dtype), gn1)
    perm = jnp.argsort(key)
    inv_perm = jnp.argsort(perm)
    tk = lambda a: jnp.take(a, perm, axis=-1)
    blobs2 = None if blobs is None else tuple(tk(a) for a in blobs)
    refs2 = None if refs is None else tk(refs)
    outs = solve_pallas(
        tk(zT), tk(cT), tk(params_pack), tk(lb), tk(ub), tk(us1), cfg2,
        dtype=dtype, interpret=interpret, blobs=blobs2, refs=refs2,
        resume=(tk(done1), tk(conv1), tk(mu1), tk(gn1)))
    ss, us, cost, conv, it2, gnorm, mu, done = (
        jnp.take(a, inv_perm, axis=-1) for a in outs)
    return ss, us, cost, conv, it1 + it2, gnorm, mu, done


def _solve_compact(zT, cT, params_pack, lb, ub, u0, cfg, *, dtype,
                   interpret, blobs, refs=None):
    """Compact straggler schedule: close the block-max iteration waste
    without the sorted schedule's full-batch gathers.

      pass 1: whole batch, per-block early exit once `compact_frac` of the
              block's lanes are done (blocks stop at ~the p97 lane, not
              the max);
      gather: the not-done lanes (argsort of the done flag — stable),
              padded with done lanes to a static `compact_tail * B`
              block-granular batch;
      pass 2: resume-solve the small compact batch to completion (fresh
              iteration budget — these are exactly the lanes that need
              it); done pad lanes exit before their first iteration;
      scatter: results back into the pass-1 outputs.

    Only ~compact_tail of the lanes pay gather/scatter traffic. Stragglers
    beyond the tail budget keep their pass-1 iterate and report
    unconverged — conv accounting stays honest. Line-search/trust-region
    state (mu, small-step counter) restarts at the boundary exactly like
    the sorted schedule (tested equivalence)."""
    B = zT.shape[-1]
    n_tail = straggler_lanes(B, cfg)
    if n_tail >= B:
        # batch too small for a compaction win — single pass
        return solve_pallas(zT, cT, params_pack, lb, ub, u0, cfg,
                            dtype=dtype, interpret=interpret, blobs=blobs,
                            refs=refs)
    cfg1 = dataclasses.replace(cfg, done_frac=cfg.compact_frac)
    ss1, us1, cost1, conv1, it1, gn1, mu1, done1 = solve_pallas(
        zT, cT, params_pack, lb, ub, u0, cfg1, dtype=dtype,
        interpret=interpret, blobs=blobs, refs=refs)
    pair = cfg._long_horizon_pair(dtype, blobs is not None)
    # stable argsort: lanes needing rescue first, original order
    # otherwise. Under the long-horizon pair, "needs rescue" includes
    # pass-1 lanes that STALLED (done but unconverged): the early-gate
    # policy occasionally stalls a lane the conservative policy solves,
    # and a stalled lane is marked done so the plain key would skip it.
    need = (jnp.logical_or(done1 < 0.5, conv1 < 0.5) if pair
            else done1 < 0.5)
    sel = jnp.argsort(jnp.logical_not(need), stable=True)[:n_tail]
    tk = lambda a: jnp.take(a, sel, axis=-1)
    blobs2 = None if blobs is None else tuple(tk(a) for a in blobs)
    refs2 = None if refs is None else tk(refs)
    cfg2 = dataclasses.replace(cfg, done_frac=1.0)
    if pair:
        # two-policy compaction: pass 1 runs the fast coupled (gate 1.5,
        # mu floor 1e-2) policy for the bulk; the straggler pass keeps the
        # SAME mu floor (the resume carries pass-1 mu — a lower pass-2
        # floor makes carried floor-level mu read as "inflated" and
        # mislabels near-converged lanes stalled) but reverts the GATE to
        # the conservative 0.75 — the genuinely-hard tail is the class the
        # early gate trades away, and it is ~compact_tail of the batch, so
        # the conservative rescue costs tail-sized work only. The rescue
        # budget doubles (stragglers get 3x cap total vs the plain
        # compact's 2x).
        cfg2 = dataclasses.replace(cfg2, ddp_gate=0.75, mu_init=1e-2,
                                   max_sqp_iters=2 * cfg.max_sqp_iters)
    d1s, c1s, m1s, g1s = tk(done1), tk(conv1), tk(mu1), tk(gn1)
    if pair:
        # stalled pass-1 lanes re-enter the conservative pass warm from
        # their iterate, with done cleared, mu reset to the floor (their
        # carried mu sits at the rejection ramp's top — carrying it in
        # would re-stall immediately) and gnorm re-armed
        stalled1 = jnp.logical_and(d1s > 0.5, c1s < 0.5)
        floor2 = jnp.asarray(cfg2.mu_init_for(dtype, blobs is not None),
                             d1s.dtype)
        if cfg.scale_adaptive:
            # the in-kernel mu floor is weight-scaled per lane
            # (scale_adaptive: s = max(1, sum(w)/470)); the rescue reset
            # must carry the same scale or an up-scaled lane resumes
            # under-damped by s, breaking the c=1 iterate equivariance
            # on the rescue path
            pt = tk(params_pack)
            floor2 = floor2 * jnp.maximum(
                (pt[P_WCTE] + pt[P_WETH] + pt[P_WVEL] + pt[P_WANG]
                 + pt[P_WACC] + pt[P_WDANG] + pt[P_WDACC])
                * jnp.asarray(1.0 / 470.0, d1s.dtype),
                jnp.asarray(1.0, d1s.dtype)).astype(d1s.dtype)
        d1s = jnp.where(stalled1, 0.0, d1s)
        m1s = jnp.where(stalled1, floor2, m1s)
        g1s = jnp.where(stalled1, jnp.inf, g1s)
    (ss2, us2, cost2, conv2, it2, gn2, mu2, done2) = solve_pallas(
        tk(zT), tk(cT), tk(params_pack), tk(lb), tk(ub), tk(us1), cfg2,
        dtype=dtype, interpret=interpret, blobs=blobs2, refs=refs2,
        resume=(d1s, c1s, m1s, g1s))
    scat = lambda full, tail: full.at[..., sel].set(tail)
    return (scat(ss1, ss2), scat(us1, us2), scat(cost1, cost2),
            scat(conv1, conv2), it1.at[sel].add(it2), scat(gn1, gn2),
            scat(mu1, mu2), scat(done1, done2))
