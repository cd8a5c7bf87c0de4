"""Fleet planning: B robots with real world plans, one batched solve/cycle.

Unlike examples/fleet_serving.py (synthetic device-resident references via
`engine.receding`), this drives the FULL planner lifecycle for every robot:
per-robot global plans, goal latching, FSM, the host path pipeline, and a
single warm-started batched solve per control cycle.

    JAX_PLATFORMS=cpu python examples/fleet_planner.py --fleet 64
    python examples/fleet_planner.py --fleet 1024      # on the GPU
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import time

import numpy as np

from mpc_ros_tpu import MPCParams, PlannerConfig, SolverConfig
from mpc_ros_tpu.planner import FleetPlanner
from mpc_ros_tpu.sim import get_shape

ap = argparse.ArgumentParser()
ap.add_argument("--fleet", type=int, default=64)
ap.add_argument("--cycles", type=int, default=200)
args = ap.parse_args()

B = args.fleet
shapes = ["infinity", "epitrochoid", "square"]
plans = []
for i in range(B):
    plan = get_shape(shapes[i % 3]).copy()
    plan[:, :2] += 12.0 * i                       # disjoint worlds
    plans.append(plan)

p = MPCParams(max_angvel=1.5, w_cte=300.0, w_angvel_d=10.0, w_accel_d=10.0)
fleet = FleetPlanner(params=p, solver_cfg=SolverConfig(n_steps=20),
                     planner_cfg=PlannerConfig(local_plan_length=2.5))
fleet.initialize(B)
poses = np.stack([pl[0] for pl in plans])
assert fleet.set_plans(plans, poses).all()

vw = np.zeros((B, 2))
dt = float(np.max(np.asarray(p.dt)))
done = np.zeros(B, bool)
t0 = time.time()
for cycle in range(args.cycles):
    done |= fleet.is_goal_reached(poses, vw)
    if done.all():
        break
    ok, cmds, info = fleet.compute_velocity_commands(poses, vw)
    act = ok & ~done
    v, w = cmds[:, 0], cmds[:, 1]
    poses[act, 0] += v[act] * np.cos(poses[act, 2]) * dt
    poses[act, 1] += v[act] * np.sin(poses[act, 2]) * dt
    poses[act, 2] += w[act] * dt
    vw[act, 0] = v[act]
    vw[act, 1] = w[act]
    vw[~act] = 0.0
    if cycle % 50 == 0:
        d = np.array([np.min(np.hypot(plans[i][:, 0] - poses[i, 0],
                                      plans[i][:, 1] - poses[i, 1]))
                      for i in range(B)])
        print(f"cycle {cycle:4d}: reached {int(done.sum())}/{B}, "
              f"tracking err mean {d.mean():.3f} m, "
              f"conv {float(np.mean(info.converged)):.2f}")

wall = time.time() - t0
print(f"{B} robots x {cycle + 1} cycles in {wall:.1f} s "
      f"({B * (cycle + 1) / wall:,.0f} robot-cycles/s), "
      f"{int(done.sum())}/{B} goals reached")
