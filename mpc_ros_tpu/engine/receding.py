"""Batched receding-horizon serving: closed-loop MPC for B robots on-device.

The reference runs ONE robot's control loop at 10-20 Hz with the solver cold
-started every cycle. This engine steps THOUSANDS of simulated robots in
lockstep entirely inside one jitted program: per cycle it (a) solves every
robot's NMPC problem warm-started from its previous solution (shift), (b)
applies the first control, and (c) advances each plant one period with the
same error-state kinematics the solver optimizes (the kinematic model IS
the simulator — SURVEY.md §4). No host round-trips inside the loop.

This is the production-serving counterpart of the throughput bench: the
metric is control cycles/s (robots x cycles / wall time), and the warm-start
benefit the reference never had (quirk Q9) shows up directly as a lower
per-cycle iteration count.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp

from .. import pytree
from ..config import MPCParams, SolverConfig
from ..models.base import get_model
from ..solver.batch_lane import batch_solve_lane

Array = Any


@pytree.dataclass
class RecedingTrace:
    zs: Array        # (n_cycles, B, 6) plant states per cycle
    us: Array        # (n_cycles, B, 2) applied controls
    costs: Array     # (n_cycles, B) solve costs
    iters: Array     # (n_cycles, B) SQP iterations (warm-start signal)


@functools.partial(jax.jit, static_argnames=("cfg", "n_cycles"))
def receding_horizon_rollout(z0s: jnp.ndarray, coeffs: jnp.ndarray,
                             p: MPCParams, cfg: SolverConfig,
                             n_cycles: int = 20,
                             blobs=None) -> RecedingTrace:
    """Run `n_cycles` closed-loop control cycles for B robots.

    z0s (B, 6): initial error states; coeffs (B, P): each robot's reference
    polynomial (robot-frame, fixed over the run — the on-device analog of
    the per-cycle refit pipeline, which is host-side in planner/).
    `blobs` (GaussianObstacles, leaves (B, K)): per-robot parametric
    obstacle fields, solved inside the megakernel every cycle.
    """
    B = z0s.shape[0]
    T = cfg.n_controls
    dtype = z0s.dtype
    dt = jnp.asarray(p.dt, dtype)
    sign = cfg.cte_vsin_sign
    mdl = get_model(cfg.model)

    def cycle(carry, _):
        zs, warm = carry
        res = batch_solve_lane(zs, coeffs, p, cfg, u_init=warm, blobs=blobs)
        u0 = res.us[:, 0, :]                       # (B, 2)
        # plant step with the applied control
        zs_next = jax.vmap(lambda z, u, c: mdl.step(z, u, c, dt, sign, p))(
            zs, u0, coeffs)
        # shift warm start
        warm_next = jnp.concatenate([res.us[:, 1:], res.us[:, -1:]], axis=1)
        return (zs_next, warm_next), (zs, u0, res.cost,
                                      res.n_iters.astype(jnp.int32))

    warm0 = jnp.zeros((B, T, 2), dtype)
    (_, _), (zs_t, us_t, costs_t, iters_t) = jax.lax.scan(
        cycle, (z0s, warm0), None, length=n_cycles)
    return RecedingTrace(zs=zs_t, us=us_t, costs=costs_t, iters=iters_t)
