"""Solver result types."""

from __future__ import annotations

from typing import Any

from .. import pytree

Array = Any


@pytree.dataclass
class SolveResult:
    """Result of one NMPC solve.

    Successor of the reference's `CppAD::ipopt::solve_result` + the
    `mpc_x/mpc_y/mpc_theta` side-channel
    (/root/reference/mpc_ros/src/mpc_planner.cpp:370-401), as one struct:

    * `us`: (T, 2) optimal controls (omega, accel); `us[0]` is the pair the
      reference returns from MPC::Solve.
    * `zs`: (N, 6) predicted state horizon (x, y, theta, v, cte, etheta) —
      the reference's mpc_x/y/theta plus the error states.
    * `cost`: objective value (reference `solution.obj_value`).
    * `converged`: whether the projected-gradient tolerance was met — and
      unlike the reference (which computes `ok` and ignores it, quirk Q2),
      this is surfaced to the caller.
    * `n_iters`: SQP iterations taken.
    * `grad_norm`: final projected-gradient max-norm.
    * `reg`: final Levenberg regularization (diagnostic).
    """

    us: Array
    zs: Array
    cost: Array
    converged: Array
    n_iters: Array
    grad_norm: Array
    reg: Array

    @property
    def control(self) -> Array:
        """First control (omega0, accel0) — what MPC::Solve returns."""
        return self.us[..., 0, :]
