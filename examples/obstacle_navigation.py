"""Closed-loop obstacle avoidance with world-frame parametric obstacles.

Drops a Gaussian obstacle directly ON the global plan and runs the NMPC
planner closed-loop: each Tracking cycle transforms the world-frame blobs
into the robot frame (`MPCPlanner.set_obstacles`) and the solver's
trajectory optimization swerves around them while still tracking the path —
local obstacle resolution the reference stack delegated to move_base's
global replanning.

Run (CPU works fine for this size):

    JAX_PLATFORMS=cpu python examples/obstacle_navigation.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

import jax.numpy as jnp
import numpy as np

from mpc_ros_tpu.config import MPCParams, PlannerConfig, SolverConfig
from mpc_ros_tpu.models.obstacles import GaussianObstacles
from mpc_ros_tpu.planner import MPCPlanner
from mpc_ros_tpu.sim import run_closed_loop


def main():
    # straight 6 m course; two blobs sitting on/near it
    x = np.linspace(0.0, 6.0, 120)
    plan = np.stack([x, np.zeros_like(x), np.zeros_like(x)], -1)
    blobs = GaussianObstacles.from_sigmas(
        cx=jnp.asarray([2.0, 4.0]), cy=jnp.asarray([0.05, -0.1]),
        sigma=jnp.asarray([0.3, 0.25]), w=jnp.asarray([50.0, 50.0]))

    p = MPCParams(dt=0.1, ref_vel=0.5, max_angvel=1.5,
                  w_angvel_d=10.0, w_accel_d=10.0)
    planner = MPCPlanner(params=p, solver_cfg=SolverConfig(n_steps=20),
                         planner_cfg=PlannerConfig(local_plan_length=2.5))
    planner.initialize()
    planner.set_obstacles(blobs)

    res = run_closed_loop(planner, plan, max_cycles=900)
    assert res.reached, "goal not reached"

    cx = np.asarray(blobs.cx)
    cy = np.asarray(blobs.cy)
    for k in range(len(cx)):
        d = np.hypot(res.poses[:, 0] - cx[k], res.poses[:, 1] - cy[k])
        print(f"blob {k} at ({cx[k]:.1f}, {cy[k]:+.2f}): "
              f"closest approach {d.min():.3f} m")
    dev = np.abs(res.poses[:, 1])
    print(f"course done in {res.n_cycles} cycles "
          f"({res.course_time_s:.1f} s); max lateral excursion "
          f"{dev.max():.3f} m; mean |cte| {res.mean_abs_cte:.4f}")


if __name__ == "__main__":
    main()
