"""Quickstart: one NMPC solve + a closed-loop course.

    python examples/quickstart.py          # uses the GPU if JAX finds one
    JAX_PLATFORMS=cpu python examples/quickstart.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax.numpy as jnp

from mpc_ros_tpu import MPCParams, SolverConfig, PlannerConfig
from mpc_ros_tpu.planner import MPCPlanner
from mpc_ros_tpu.sim import infinity, run_closed_loop
from mpc_ros_tpu.solver import solve_jit


def single_solve():
    # robot 5 cm left of a curved path, moving at 0.3 m/s
    coeffs = jnp.asarray([0.05, -0.1, 0.2, -0.02], jnp.float32)
    z0 = jnp.asarray([0, 0, 0, 0.3, 0.05, float(np.arctan(-0.1))], jnp.float32)
    p = MPCParams(ref_vel=0.5).astype(jnp.float32)
    res = solve_jit(z0, coeffs, p, SolverConfig(n_steps=30))
    omega, accel = np.asarray(res.control)
    print(f"single solve: omega={omega:.4f} rad/s accel={accel:.4f} m/s^2 "
          f"cost={float(res.cost):.3f} iters={int(res.n_iters)}")


def solve_around_obstacle():
    # straight reference with a Gaussian obstacle sitting just off-path:
    # the optimal trajectory bends around it (parametric obstacles also
    # run inside the batched whole-solve kernel — see models/obstacles.py)
    from mpc_ros_tpu.models.obstacles import GaussianObstacles
    from mpc_ros_tpu.solver.ilqr import solve

    z0 = jnp.asarray([0, 0, 0, 0.5, 0, 0], jnp.float32)
    coeffs = jnp.zeros((4,), jnp.float32)
    p = MPCParams(ref_vel=0.5, w_cte=50.0).astype(jnp.float32)
    blobs = GaussianObstacles.from_sigmas(
        jnp.asarray([0.6]), jnp.asarray([0.05]),
        jnp.asarray([0.25]), jnp.asarray([200.0]))
    res = solve(z0, coeffs, p, SolverConfig(n_steps=20), blobs=blobs)
    ys = np.asarray(res.zs[:, 1])
    print(f"obstacle solve: max lateral deviation {ys.min():.3f} m "
          f"(steers around the blob at (0.6, 0.05))")


def closed_loop():
    p = MPCParams(dt=0.1, ref_vel=0.5, max_angvel=1.5, w_cte=300.0,
                  w_angvel_d=10.0, w_accel_d=10.0)
    planner = MPCPlanner(params=p, solver_cfg=SolverConfig(n_steps=20),
                         planner_cfg=PlannerConfig(local_plan_length=2.5))
    res = run_closed_loop(planner, infinity(), max_cycles=1200)
    print(f"infinity course: reached={res.reached} in {res.course_time_s:.1f} s"
          f" (sim), mean|cte|={res.mean_abs_cte:.4f} m")


if __name__ == "__main__":
    single_solve()
    solve_around_obstacle()
    closed_loop()
