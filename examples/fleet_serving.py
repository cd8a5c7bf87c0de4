"""Serve a robot fleet from one device program per control cycle.

Demonstrates the round-3 serving stack: `DeviceFleetPlanner` runs the
ENTIRE per-cycle planner pipeline (plan cutoff, lookahead window, goal
latches + driving FSM, downsampling, robot-frame polynomial fit,
error-state extraction, reference-speed scheduling, delay-mode
prediction, warm-started megakernel solve, command extraction) as ONE
jitted program; the host uploads the fleet's world state and fetches
commands.

Run on the CPU:  JAX_PLATFORMS=cpu python examples/fleet_serving.py
(the same code runs on the GPU without the variable).

Reference analog: one move_base process per robot, each re-taping its NLP
every cycle (/root/reference/mpc_ros/src/mpc_planner_ros.cpp:397-448).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

import numpy as np

from mpc_ros_tpu.config import MPCParams, PlannerConfig, SolverConfig
from mpc_ros_tpu.planner import DeviceFleetPlanner
from mpc_ros_tpu.sim import get_shape


def main():
    B = 32                           # fleet size (bench: 8192-32768)
    base = get_shape("infinity")
    plans = []
    for i in range(B):
        pl = base.copy()
        pl[:, :2] += 5.0 * (i % 8), 5.0 * (i // 8)
        plans.append(pl)

    fp = DeviceFleetPlanner(
        params=MPCParams(max_angvel=1.5, w_cte=300.0,
                         w_angvel_d=10.0, w_accel_d=10.0),
        solver_cfg=SolverConfig(n_steps=20, ls_iters=4, ddp=True),
        planner_cfg=PlannerConfig(local_plan_length=2.5),
        obs_every=5,                 # full observability every 5th cycle
    )
    fp.initialize(B)
    poses = np.stack([pl[0] for pl in plans]).astype(float)
    feedback = np.zeros((B, 2))
    assert fp.set_plans(plans, poses).all()

    dt = 0.1
    for cycle in range(40):
        ok, cmds, info = fp.compute_velocity_commands(poses, feedback)
        # integrate a toy plant (a real deployment feeds robot odometry)
        v, w = cmds[:, 0], cmds[:, 1]
        poses[:, 0] += dt * v * np.cos(poses[:, 2])
        poses[:, 1] += dt * v * np.sin(poses[:, 2])
        poses[:, 2] += dt * w
        feedback = cmds.copy()
        if cycle % 5 == 0:           # an observability cycle
            tracking = (info.states == 0).sum()
            print(f"cycle {cycle:3d}: tracking {tracking}/{B}, "
                  f"mean|cte| {np.nanmean(np.abs(info.cte)):.3f} m, "
                  f"conv {info.converged.mean():.2f}")
    done = fp.is_goal_reached(poses, feedback)
    print(f"after 40 cycles: {done.sum()}/{B} at goal (long course — "
          f"expected 0), mean speed {feedback[:, 0].mean():.2f} m/s")


if __name__ == "__main__":
    main()
