"""The production costmap pipeline: grid snapshot -> Gaussian blobs -> solve.

The reference wires a costmap_2d into its planner but never uses it in the
NLP (/root/reference/mpc_ros/src/mpc_planner_ros.cpp:47). Here the costmap
is a first-class obstacle source with three routes (round 4):

  1. `MPCPlanner.set_costmap(omap)` — single robot: host greedy blob fit
     (~1.2 ms/map) installs parametric obstacles; each cycle transforms
     them into the robot frame and solves them as smooth parametric terms.
  2. `FleetPlanner.set_costmaps(omaps)` — fleet: the batched jitted
     DEVICE fit (`fit_gaussians_to_maps`) converts every robot's map in
     one program.
  3. `ObstacleMap(sampling="spline").with_spline_coeffs()` — stay on the
     grid directly with the C1 quadratic-B-spline reconstruction
     evaluated from precomputed per-cell coefficient planes (conv 0.998
     at B=4096; re-derive planes on grid updates via `with_grid`). Plain
     "spline" keeps the stencil; "bilinear" is the costmap_2d-exact C0
     mode (conv ~0.94).

Run (CPU works fine for this size):

    JAX_PLATFORMS=cpu python examples/costmap_pipeline.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

import jax.numpy as jnp
import numpy as np

from mpc_ros_tpu.config import MPCParams, PlannerConfig, SolverConfig
from mpc_ros_tpu.models.obstacles import (ObstacleMap,
                                          fit_gaussians_to_maps,
                                          gaussian_blob_map)
from mpc_ros_tpu.planner import FleetPlanner, MPCPlanner
from mpc_ros_tpu.sim import run_closed_loop


def main():
    n = 120
    plan = np.stack([np.linspace(0, 6, n), np.zeros(n), np.zeros(n)], -1)
    p = MPCParams(dt=0.1, ref_vel=0.5, max_angvel=1.5,
                  w_angvel_d=10.0, w_accel_d=10.0)

    # a world-frame costmap snapshot with an obstacle near the plan
    omap = gaussian_blob_map((3.0, 0.2), sigma=0.3, extent=8.0, weight=50.0)

    # route 1: single robot through the costmap door
    planner = MPCPlanner(params=p, solver_cfg=SolverConfig(n_steps=20),
                         planner_cfg=PlannerConfig(local_plan_length=2.5))
    planner.initialize()
    planner.set_costmap(omap)           # greedy fit + install
    res = run_closed_loop(planner, plan, max_cycles=600)
    d = np.min(np.hypot(res.poses[:, 0] - 3.0, res.poses[:, 1] - 0.2))
    print(f"single robot: reached={res.reached} "
          f"min clearance to obstacle {d:.2f} m")

    # route 2: fleet-scale batched device fit
    B = 4
    omaps = jax.tree.map(lambda a: jnp.broadcast_to(a[None],
                                                    (B,) + a.shape), omap)
    blobs = fit_gaussians_to_maps(omaps, n_blobs=4)
    print(f"fleet fit: {B} maps -> blob weights "
          f"{np.round(np.asarray(blobs.w[0]), 1)} (one jitted program)")
    fleet = FleetPlanner(params=p, solver_cfg=SolverConfig(n_steps=20),
                         planner_cfg=PlannerConfig(local_plan_length=2.5))
    fleet.initialize(B)
    poses = np.stack([plan[0]] * B)
    fleet.set_plans([plan] * B, poses)
    fleet.set_costmaps(omaps)           # the fleet costmap door
    ok, cmds, info = fleet.compute_velocity_commands(poses,
                                                     np.zeros((B, 2)))
    print(f"fleet cycle: commands {np.round(cmds[0], 3)} x{B} robots")

    # route 3: solve against the C1 spline grid directly — coefficient
    # planes precomputed once per costmap update (the fast grid mode)
    spline = ObstacleMap(grid=omap.grid, origin=omap.origin,
                         resolution=omap.resolution, weight=omap.weight,
                         sampling="spline").with_spline_coeffs()
    planner2 = MPCPlanner(params=p, solver_cfg=SolverConfig(n_steps=20),
                          planner_cfg=PlannerConfig(local_plan_length=2.5))
    planner2.initialize()
    planner2.set_plan(plan, plan[0].copy())
    planner2.tracker.obstacle_map = spline   # robot-frame grid per cycle
    ok, (v, w), _ = planner2.compute_velocity_commands(
        plan[0].copy(), (0.2, 0.0))
    print(f"spline-grid cycle: cmd=({v:.3f}, {w:.3f})")


if __name__ == "__main__":
    main()
