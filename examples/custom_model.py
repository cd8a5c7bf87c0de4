"""Custom vehicle family with autodiff-only dynamics (no hand math).

The reference's CppAD workflow: write the dynamics on `AD<double>`, the
vendored engine differentiates them (SURVEY.md §2.2). The equivalent here
is `models.model_from_step`: write ONE step function with jnp ops and the
framework derives the Jacobians (jax.jacfwd), builds the rate-cost
augmentation, and registers the family with the whole solver stack —
single solves, vmapped batches, the oracle, the planner.

This example adds a "skid_drive" family: a differential drive whose
commanded angular velocity is attenuated by track slip growing with
forward speed (omega_eff = omega / (1 + k_slip * v^2)), a common tracked-
vehicle kinematics correction. No Jacobians are written anywhere.

    JAX_PLATFORMS=cpu python examples/custom_model.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from mpc_ros_tpu import MPCParams, SolverConfig
from mpc_ros_tpu.engine import batch_solve, make_random_scenarios
from mpc_ros_tpu.models import diff_drive, get_model, model_from_step
from mpc_ros_tpu.ops.poly import polyeval
from mpc_ros_tpu.solver import solve_jit

K_SLIP = 0.8  # track-slip coefficient [s^2/m^2]


def skid_step(z, u, coeffs, dt, sign, p):
    """One ZOH-Euler step; same 6-state error-state layout as diff_drive."""
    x, y, theta, v, cte, etheta = (z[..., i] for i in range(6))
    omega, accel = u[..., 0], u[..., 1]
    dtype = z.dtype
    dt = jnp.asarray(dt, dtype)
    omega_eff = omega / (1.0 + K_SLIP * v * v)   # slip attenuation
    f0 = polyeval(coeffs, x)
    return jnp.stack(
        [
            x + v * jnp.cos(theta) * dt,
            y + v * jnp.sin(theta) * dt,
            theta + omega_eff * dt,
            v + accel * dt,
            (f0 - y) + sign * v * jnp.sin(etheta) * dt,
            etheta + omega_eff * dt,
        ],
        axis=-1,
    )


def main():
    # one call: Jacobians via jacfwd, rate-cost augmentation, registration
    model_from_step("skid_drive", skid_step,
                    get_model("diff_drive").control_bounds)

    dtype = jnp.float32
    p = MPCParams(ref_vel=0.5).astype(dtype)
    cfg = SolverConfig(n_steps=30, model="skid_drive", backward="xla")

    # single solve: robot offset from a curved path
    coeffs = jnp.asarray([0.05, -0.1, 0.2, -0.02], dtype)
    z0 = jnp.asarray([0, 0, 0, 0.3, 0.05, float(np.arctan(-0.1))], dtype)
    res = solve_jit(z0, coeffs, p, cfg)
    omega, accel = np.asarray(res.us[0])
    print(f"skid_drive solve: omega={omega:.4f} rad/s accel={accel:.4f} "
          f"m/s^2 cost={float(res.cost):.3f} iters={int(res.n_iters)} "
          f"converged={bool(res.converged)}")

    # the slip correction matters: at v=0.5 the effective turn rate is
    # omega / 1.2, so the solver commands harder omega than plain diff_drive
    res_dd = solve_jit(z0, coeffs, p,
                       SolverConfig(n_steps=30, backward="xla"))
    print(f"  vs diff_drive omega={float(res_dd.us[0, 0]):.4f} "
          f"(skid commands {abs(float(res.us[0, 0]) / float(res_dd.us[0, 0])):.2f}x)")

    # vmapped batch — the custom family rides the same scale axis
    z0s, cs = make_random_scenarios(jax.random.PRNGKey(0), 256, dtype)
    bres = batch_solve(z0s, cs, p, cfg)
    conv = float(jnp.mean(bres.converged.astype(jnp.float32)))
    print(f"batched 256 scenarios: converged={conv:.2%} "
          f"mean cost={float(jnp.mean(bres.cost)):.3f}")


if __name__ == "__main__":
    main()
