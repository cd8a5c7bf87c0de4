"""Typed configuration for the batched NMPC framework.

Replaces the reference's three-tier string-keyed config relay
(`dynamic_reconfigure` cfg -> map<string,double> -> MPC::LoadParams, see
/root/reference/mpc_ros/src/driving_state.cpp:45-103 and
/root/reference/mpc_ros/src/mpc_planner.cpp:243-262) with two typed layers:

* `MPCParams` — every *numeric* solver parameter as a JAX pytree so it can be
  traced, vmapped over (per-scenario weights in Monte-Carlo sweeps), and
  updated at runtime WITHOUT recompilation (the reference re-issued
  `LoadParams` on every reconfigure; here new values are just new leaves).
* `SolverConfig` — static shape/iteration knobs (horizon, iteration caps)
  that participate in jit specialization.

Defaults follow the STRUCTURE of the reference's live config path (the
dynamic_reconfigure schema /root/reference/mpc_ros/cfg/MPCPlanner.cfg; the
yaml file is dead code in that fork, SURVEY.md §5.6) but several VALUES
deviate deliberately — softer error weights (w_cte/w_etheta 100 vs the
cfg's 1000), ref_vel 0.5 vs 1.0, and nonzero rate costs — tuned for the
built-in courses and the conservative diff-drive class. For a bit-exact
A/B against the reference's own defaults use
`MPCParams.reference_defaults()`.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp

from .pytree import dataclass as pytree_dataclass

Array = Any  # jax scalar or array


@pytree_dataclass
class MPCParams:
    """Numeric NMPC parameters (a pytree: every field is traced).

    Mirrors the 15-key `mpc_params_` map of the reference
    (/root/reference/mpc_ros/src/driving_state.cpp:65-79) minus STEPS,
    which is static shape information and lives in `SolverConfig`.
    """

    dt: Array = 0.1            # control period [s]
    ref_cte: Array = 0.0       # cross-track error setpoint
    ref_etheta: Array = 0.0    # heading error setpoint
    ref_vel: Array = 0.5       # reference speed [m/s] ("REF_V")
    w_cte: Array = 100.0       # cross-track error weight
    w_etheta: Array = 100.0    # heading error weight ("W_EPSI")
    w_vel: Array = 100.0       # speed tracking weight
    w_angvel: Array = 100.0    # angular-velocity magnitude weight
    w_accel: Array = 50.0      # acceleration magnitude weight
    w_angvel_d: Array = 10.0   # angular-velocity rate weight
    w_accel_d: Array = 10.0    # acceleration rate weight
    max_angvel: Array = 1.0    # |omega| bound [rad/s] ("ANGVEL")
    max_throttle: Array = 1.0  # |accel| bound [m/s^2] ("MAXTHR")
    bound_value: Array = 1.0e3  # box bound for non-actuator vars ("BOUND")
    # --- model-family parameters beyond the reference (traced, sweepable;
    # read only by the models that use them — see models/base.py) ---
    lf: Array = 0.5            # bicycle: CoG -> front-axle distance [m]
    max_steer: Array = 0.6     # bicycle: |delta| steering bound [rad]

    def astype(self, dtype) -> "MPCParams":
        return MPCParams(
            **{
                f.name: jnp.asarray(getattr(self, f.name), dtype)
                for f in dataclasses.fields(self)
            }
        )

    @staticmethod
    def reference_defaults() -> "MPCParams":
        """The reference's own live defaults, bit-exact: the
        dynamic_reconfigure values of
        /root/reference/mpc_ros/cfg/MPCPlanner.cfg:23-37 (the only config
        path that ever takes effect there — SURVEY.md §5.6). Use for
        default-vs-default A/B runs against the reference."""
        return MPCParams(
            dt=0.1, ref_cte=0.0, ref_etheta=0.0, ref_vel=1.0,
            w_cte=1000.0, w_etheta=1000.0, w_vel=100.0, w_angvel=100.0,
            w_accel=50.0, w_angvel_d=0.0, w_accel_d=10.0,
            max_angvel=1.0, max_throttle=1.0, bound_value=1.0e3)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration — participates in jit specialization."""

    n_steps: int = 20          # horizon knots N (reference `mpc_steps`)
    poly_order: int = 3        # reference-path polynomial order (cubic)
    # vehicle-dynamics family (models/base.py registry): "diff_drive"
    # (the reference robot class) or "bicycle" (Ackermann steering). Static
    # so jit specializes per model; the hand-tuned Pallas megakernel serves
    # diff_drive, other models run the XLA lane / vmap paths.
    model: str = "diff_drive"
    max_sqp_iters: int = 60    # outer SQP/iLQR iteration cap
    # parallel line-search step sizes (0.5^j). None (default) resolves at
    # solve time with the ddp profile: 4 candidates when the hybrid GN->DDP
    # backward is engaged (DDP's Newton steps accept at alpha=1 — deeper
    # backtracking only pads the rollout scan), 8 for pure Gauss-Newton
    # (whose large-residual tail lanes need the deeper ladder). An explicit
    # value is used verbatim.
    ls_iters: "int | None" = None

    def ls_for(self, dtype) -> int:
        """Effective line-search candidate count for a compute dtype."""
        if self.ls_iters is not None:
            return int(self.ls_iters)
        return 4 if self.ddp_for(dtype) else 8
    # projected-gradient convergence threshold. None (default) resolves
    # per dtype at solve time — 1e-7 in f64 (oracle-grade), 1e-4 in f32:
    # the pg certificate cannot resolve below the f32 rounding noise of
    # the cost expansion, so a 1e-7 threshold in f32 never fires and the
    # solve grinds 30-45 extra GN-tail iterations against the
    # cost-stagnation stop instead (measured on the production tracker:
    # warm solves at 45 iterations; 1e-4 converges in 2-5 at the same
    # optimum — the f32 control accuracy spec (max 6.7e-4 vs the f64
    # optimum) was measured AT 1e-4). An explicit value is used verbatim.
    tol_grad: "float | None" = None

    def tol_grad_for(self, dtype) -> float:
        """Effective projected-gradient threshold for a compute dtype."""
        if self.tol_grad is not None:
            return float(self.tol_grad)
        return 1e-4 if jnp.finfo(dtype).eps > 1e-10 else 1e-7
    tol_cost: float = 1e-12    # relative cost-decrease threshold
    # initial Levenberg regularization. "auto" (default since round 5)
    # resolves with the horizon-aware DDP gate as a COUPLED pair (see
    # _long_horizon_pair): 1e-6 everywhere except the long-horizon
    # damped-early-engagement configuration, where the floor rises to
    # 1e-2 so the DDP terms can engage at gate 1.5 while mu still damps
    # the transiently indefinite model (engaging early UNdamped loses:
    # N=100 @ mu 1e-4 conv 0.83). An explicit float is used verbatim —
    # and an explicit mu_init also reverts the auto gate to the
    # conservative 0.75 (the pair ships together or not at all).
    mu_init: "float | str" = "auto"
    mu_factor: float = 10.0    # regularization update factor
    mu_max: float = 1e8        # regularization ceiling

    def _long_horizon_pair(self, dtype, has_obstacles: bool,
                           has_omaps: bool = False) -> bool:
        """True when the long-horizon (gate 1.5, mu floor 1e-2) coupled
        auto policy applies: DDP active in this dtype, N > 32, both knobs
        on auto, no parametric blob terms (`has_obstacles` carries the
        SAME blobs-presence flag as the gate's basin-stability cap, so
        gate and mu always resolve the pair identically — a 1.5 gate
        with an unraised mu floor is the measured-bad combination).
        The mu floor is what makes the early gate safe: the rescue
        mechanism the weight-scale census identified, applied
        deliberately. CPU lane path (B=1024): N=36 it 5.67 -> 4.07 @
        conv 1.000; N=60 7.53 -> 5.34 @ 1.000. Under the compact
        schedule the pair additionally switches the straggler pass to
        the conservative policy and re-enters pass-1 STALLED lanes
        (see _solve_compact); against the (0.75, 1e-6) policy it left
        fewer lanes unconverged at N=48/60/100 (8/0/61 vs 290/300/400
        ppm)."""
        # `has_omaps` (grid costmaps) also excludes the pair: the census
        # rejected damped early engagement for obstacle fields (asymmetric
        # basin loss), and grids are the worse-conditioned kink class —
        # while the GATE's basin-stability cap stays keyed on blobs only
        # (the grid gate numbers were measured at the horizon-aware auto).
        # horizon_parallel cannot run DDP at all (even under an explicit
        # ddp=True, which ddp_for honors verbatim) — the raised mu floor
        # was never measured on pure GN, so that mode keeps the
        # conservative floor too.
        return (self.n_steps > 32 and not has_obstacles and not has_omaps
                and not self.horizon_parallel
                and self.ddp_gate is None and self.mu_init == "auto"
                and dtype is not None and self.ddp_for(dtype))

    def mu_init_for(self, dtype=None, has_obstacles: bool = False,
                    has_omaps: bool = False) -> float:
        """Effective initial/floor regularization (see mu_init)."""
        if self.mu_init != "auto":
            return float(self.mu_init)
        return 1e-2 if self._long_horizon_pair(dtype, has_obstacles,
                                               has_omaps) else 1e-6
    # batched-solve early exit: stop iterating once this fraction of lanes
    # has converged (stragglers keep their current iterate and report
    # converged=False). 1.0 = run until every lane is done — the whole
    # batch pays the slowest lane's iteration count.
    done_frac: float = 1.0
    # engine of the lane-major batched solver (solver/batch_lane.py
    # `_use_kernel` is the one place it is resolved):
    #   "auto" -> the whole-solve kernel (kernels/solve_pallas.py: per-block
    #             adaptive iteration, one program for the entire solve) on
    #             a GPU for float32 problems without grid costmaps, the
    #             XLA lane path otherwise
    #   "mega" -> the kernel or a ValueError (never the interpreter)
    #   "xla"  -> pure XLA lax.scan paths
    backward: str = "auto"
    # horizon-parallel backward pass: O(log N) associative-scan Riccati
    # (solver/riccati.py) instead of the O(N) sequential scan (exact incl.
    # control limits via the boxed fixed point). Leave this False on one
    # device: the log-depth scan builds (T, 8, 8) composition elements and
    # runs scenario-major under vmap, far more work than the sequential
    # scan; the pass pays off only when the time axis maps to additional
    # devices (parallel.sharded.sharded_horizon_solve over a (data x time)
    # mesh).
    horizon_parallel: bool = False
    # full-DDP second-order dynamics terms in the backward pass: add
    # sum_k Vs_k * d2f_k/ds2 to Qss (and the bicycle's v-delta coupling to
    # Qus). The Gauss-Newton (iLQR) pass drops these and converges only
    # LINEARLY on large-residual scenarios (high heading error at speed on
    # curved references — the census class behind the iteration-count tail,
    # PERF.md); the exact Hessian restores local quadratic convergence
    # for a handful of extra FMAs per stage. Same fixed point either way.
    # The terms engage PER LANE once the projected gradient falls below
    # `ddp_gate` (hybrid GN->DDP): applied from a cold start they make the
    # early quadratic model indefinite and burn ~6 rejected-step
    # iterations per hard lane while mu ramps (measured on the census
    # lanes); gated, they only accelerate the endgame.
    # Gate calibration (None = horizon-aware auto). pg (max projected
    # gradient over controls) SATURATES at ~the control-bound width while
    # steps clip, so an "engage early" gate must sit just above that
    # plateau: 2.5 (> 2*max_angvel default) engages DDP from the second
    # iteration and measured conv 1.000 / max 6 iters at N<=30. LONG
    # horizons invert the calculus — the second-order terms compound over
    # T backward stages and an early-engaged DDP model goes indefinite
    # (N=100 @ gate 2.5: conv 0.68); a conservative 0.75 engages only
    # once real progress exists and BEATS GN convergence there (N=60:
    # 0.9984, N=100: 0.9984 vs GN 0.9968). Auto picks 2.5 for
    # n_steps <= 32, 0.75 above — measured best at every probed horizon.
    # "auto" (the default since round 5) resolves per compute dtype at
    # solve time: f32 — every production path (tracker, fleet, serving,
    # bench) — engages the hybrid; f64 (oracle/regression work) keeps pure
    # GN, whose iterates the f64 parity suite was calibrated against.
    # Rationale: at the production tracker's operating point warm GN burns
    # 33-45 iterations against the cost-stagnation stop where the gated
    # hybrid certifies in ~4 at the same optimum (cost parity <0.1%).
    # "auto" also resolves False for the backward mode that cannot carry
    # the second-order terms (horizon_parallel) — an EXPLICIT ddp=True
    # with it still raises.
    ddp: "bool | str" = "auto"
    ddp_gate: "float | None" = None

    def ddp_for(self, dtype) -> bool:
        """Effective hybrid GN->DDP switch for a compute dtype (the one
        place the production-vs-oracle solver profile lives)."""
        if self.ddp != "auto":
            return bool(self.ddp)
        if self.horizon_parallel:
            return False   # the backward mode without second-order terms
        return bool(jnp.finfo(dtype).eps > 1e-10)   # f32 prod / f64 oracle

    def gate_for(self, has_obstacles: bool = False, dtype=None,
                 has_omaps: bool = False) -> float:
        """Effective DDP gate — the ONE place the gate policy lives (the
        lane, vmap, and megakernel paths all call this, so the obstacle
        cap cannot drift between engines).

        An explicitly-set `ddp_gate` is honored verbatim, obstacles or
        not (the user overrode the policy; silently clamping it made the
        knob a lie). The auto gate is horizon-aware (2.5 engages DDP from
        the second iteration at N<=32; above 32, 1.5 WHEN COUPLED with
        the auto-raised mu floor — see _long_horizon_pair — else the
        conservative 0.75, where the second-order terms compounding over
        T backward stages would otherwise go indefinite) and caps at
        0.75 when obstacle terms are present: with the exact blob
        curvature an early-engaged gate lets ~1% of lanes jump homotopy
        basins (conv 0.989 vs 1.000 — measured, PERF.md gate
        table)."""
        if self.ddp_gate is not None:
            return float(self.ddp_gate)
        if self.n_steps <= 32:
            gate = 2.5
        else:
            gate = 1.5 if self._long_horizon_pair(dtype, has_obstacles,
                                                  has_omaps) else 0.75
        return min(gate, 0.75) if has_obstacles else gate

    @property
    def ddp_gate_eff(self) -> float:
        """Obstacle-free, dtype-agnostic gate resolution — the
        CONSERVATIVE reading (without a compute dtype the long-horizon
        pair cannot be confirmed, so N > 32 reports 0.75 even though an
        f32 auto solve runs 1.5). For the gate a solve actually uses,
        call `gate_for(has_obstacles, dtype)`."""
        return self.gate_for(False)
    # one-sided weight-scale equivariance.
    # The solver's absolute knobs — mu floor/ceiling, projected-gradient
    # tolerance, DDP gate — are in COST units, so a problem with weights
    # uniformly scaled by c > 1 behaves like the unscaled problem with
    # mu/tol/gate ÷ c: relatively weaker damping, a relatively tighter
    # certificate, and a DDP gate the endgame gradient never falls below
    # (the round-4 census's one real gap: N=60 c=5 degraded ddp to
    # effective GN at conv 0.9961). When True, each lane scales those
    # knobs by s = max(1, sum(weights)/470) (470 = the default weight
    # sum), which restores EXACT c=1 iterates for uniformly up-scaled
    # problems (bit-identical at power-of-two scales up to degenerate
    # box-QP active-set ties, whose KKT tie-break mixes primal and
    # multiplier units — pinned in tests/test_ddp.py). One-sided
    # because DOWN-scaled weights are
    # measurably rescued by the absolute mu floor (census: N=60 c=0.05
    # fixed it=5.52/conv 1.000 vs scaled it=7.52) — s < 1 is clamped.
    scale_adaptive: bool = True
    # cte/etheta coupling sign: +1.0 = reference-exact (default, FG_eval
    # parity); -1.0 = the internally-consistent yaw-minus-path convention
    # (reference quirk Q11 — see models/diff_drive.py docstring; closed-loop
    # quality is weight-dominated, so parity wins the default)
    cte_vsin_sign: float = 1.0
    # whole-solve kernel iteration schedule. The kernel's per-block
    # adaptive loop pays the MAX iteration count over each block of lanes.
    # "sorted" runs a two-pass schedule: presolve_iters iterations for
    # everyone, sort lanes by convergence state (done first, then by
    # projected-gradient norm), and continue warm-started — converged
    # blocks exit before their first iteration, and slow lanes cluster
    # into few blocks; the sort's gathers and scatters move every operand,
    # and pass 2 re-pays the initial rollout. Opt-in only.
    # "compact" runs one pass with per-block early exit at `compact_frac`
    # done, then gathers ONLY the straggler lanes (padded to block
    # granularity, <= compact_tail of the batch) into a small resume pass
    # and scatters back — the sorted schedule's iteration savings without
    # its full-batch permutation gathers. Stragglers past the tail budget
    # keep pass-1 results and report unconverged (honest conv accounting).
    # "auto" = "compact" above n_steps 36, "single" otherwise.
    schedule: str = "auto"
    presolve_iters: int = 3
    compact_frac: float = 0.97   # pass-1 per-tile done fraction
    compact_tail: float = 0.06   # straggler-pass size as a fraction of B
    # megakernel rollout trigonometry:
    #   "fast"  -> transcendental-free rollouts. Exploits two identities:
    #              (1) theta and etheta advance by the SAME u0*dt each step
    #              (FG_eval rows 3/6), so etheta_t = theta_t + phi with phi
    #              fixed per solve — sin/cos(etheta) are two FMAs off
    #              sin/cos(theta); (2) cos/sin(theta) evolve by rotation
    #              composition, with the per-step increment's sin/cos from
    #              a 9th/8th-order Taylor + one Newton renormalization.
    #              Exactness domain: |omega * dt| <= 1 rad/step (any
    #              diff-drive operating point; error < 3e-7 per step,
    #              ~1e-6 per rollout — below f32 solve noise).
    #   "exact" -> jnp.sin/cos per stage (bit-matches the XLA lane path).
    trig: str = "fast"

    def __post_init__(self):
        if self.backward not in ("auto", "mega", "xla"):
            raise ValueError(
                f"SolverConfig.backward must be 'auto', 'mega' or 'xla', "
                f"got {self.backward!r}")

    @property
    def n_controls(self) -> int:
        """Number of control steps T = N - 1."""
        return self.n_steps - 1

    @property
    def n_coeffs(self) -> int:
        return self.poly_order + 1

    @property
    def n_vars(self) -> int:
        """Reference NLP decision-vector size: 6N + 2(N-1)
        (/root/reference/mpc_ros/src/mpc_planner.cpp:281)."""
        return 6 * self.n_steps + 2 * (self.n_steps - 1)

    @property
    def n_constraints(self) -> int:
        """Reference NLP constraint count: 6N
        (/root/reference/mpc_ros/src/mpc_planner.cpp:284)."""
        return 6 * self.n_steps


def per_lane_leaf_names(params: MPCParams) -> tuple:
    """Sorted names of the (B,)-shaped per-robot/per-scenario MPCParams
    leaves — the shard_map partition-spec signature shared by the device
    fleet planner and the fleet trajectory tracker (one definition so
    their sharded==unsharded parity cannot drift)."""
    import numpy as np

    return tuple(sorted(
        f.name for f in dataclasses.fields(MPCParams)
        if np.ndim(getattr(params, f.name)) >= 1))


@dataclasses.dataclass(frozen=True)
class PlannerLimits:
    """Generic local-planner limits (successor of
    base_local_planner::LocalPlannerLimits consumed in
    /root/reference/mpc_ros/src/mpc_planner_ros.cpp:96-113)."""

    xy_goal_tolerance: float = 0.2
    yaw_goal_tolerance: float = 0.1
    trans_stopped_vel: float = 0.1
    theta_stopped_vel: float = 0.1


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Planner-level configuration (successor of the reference's
    dynamic_reconfigure schema /root/reference/mpc_ros/cfg/MPCPlanner.cfg
    plus hard-coded values it never wired up)."""

    limits: PlannerLimits = dataclasses.field(default_factory=PlannerLimits)
    # heading error below which Tracking engages (hard-coded 0.1 in the
    # reference, /root/reference/mpc_ros/src/mpc_planner_ros.cpp:81)
    heading_yaw_error_threshold: float = 0.1
    # FSM speed policy defaults (/root/reference/mpc_ros/src/driving_state.cpp:24-29)
    max_speed: float = 0.7
    min_speed: float = 0.05
    # P-gain for the two rotation states
    # (`theta_ref` in /root/reference/mpc_ros/src/driving_state.cpp:155,170)
    rotate_p_gain: float = 0.5
    # one-control-period latency compensation
    # (/root/reference/mpc_ros/src/driving_state.cpp:243-253)
    delay_mode: bool = True
    # lookahead window [m]: the plan is clipped to this arclength before
    # fitting (successor of the local-costmap clipping in the reference's
    # getLocalPlan; a cubic over an unbounded looping course is ill-posed)
    local_plan_length: float = 4.0
    # plan downsampling: target number of reference segments
    # (the reference divides the path into ~10 segments,
    #  /root/reference/mpc_ros/src/mpc_planner_ros.cpp:374 — with the
    #  uninitialized-variable bug Q6 fixed here)
    downsample_segments: int = 10
    # curvature-aware reference-speed scheduling (new; the reference only
    # decelerates near the goal): cap ref_vel at sqrt(max_lat_accel/kappa)
    # over the local reference window. Essential for Ackermann vehicles on
    # sharp courses (at the steering limit, tracking error at corners
    # shrinks with speed); off by default to preserve reference behavior.
    curvature_slowdown: bool = False
    max_lat_accel: float = 1.0   # [m/s^2] lateral-acceleration comfort cap
    # quirk Q13 fix (default on): wrap the extracted heading error to
    # [-pi, pi]. The reference's one-sided continuity shim
    # (/root/reference/mpc_ros/src/driving_state.cpp:214-235) leaves etheta
    # unwrapped across +-pi, steering the long way around at sharp left
    # corners; False reproduces the reference formula bit-for-bit.
    wrap_etheta: bool = True
    debug_info: bool = False
