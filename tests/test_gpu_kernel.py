"""The whole-solve kernel as compiled for the card (marker `gpu`).

These skip on a machine without a GPU; chip_smoke.py runs them on the
card. Their CPU counterparts (interpret mode, lowering, wrapper) live in
test_pallas_kernels.py and test_kernel_wrapper.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_ros_tpu.config import MPCParams, SolverConfig
from mpc_ros_tpu.engine import make_random_scenarios
from mpc_ros_tpu.kernels.backward_pallas import pack_params
from mpc_ros_tpu.kernels.solve_pallas import solve_pallas
from mpc_ros_tpu.solver.batch_lane import _use_kernel, batch_solve_lane

pytestmark = pytest.mark.gpu

F32 = jnp.float32


def _problem(B, cfg, seed=0):
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(seed), B, F32)
    p = MPCParams().astype(F32)
    args = (jnp.swapaxes(z0s, 0, 1), jnp.swapaxes(coeffs, 0, 1),
            pack_params(p, B, F32),
            jnp.full((2, B), -1.0, F32), jnp.full((2, B), 1.0, F32),
            jnp.zeros((cfg.n_controls, 2, B), F32))
    return z0s, coeffs, p, args


def test_auto_picks_the_kernel_on_gpu(gpu):
    assert _use_kernel(SolverConfig(), F32, False)
    assert not _use_kernel(SolverConfig(), F32, True)
    assert not _use_kernel(SolverConfig(backward="xla"), F32, False)


@pytest.mark.parametrize("model", ["diff_drive", "bicycle"])
def test_compiled_kernel_matches_interpreter(gpu, model):
    """The Triton-compiled kernel and the Pallas interpreter run the same
    program: controls to f32 rounding, the same convergence flags."""
    cfg = SolverConfig(n_steps=12, max_sqp_iters=8, tol_grad=1e-3,
                       model=model)
    B = 300                        # not a whole block: exercises padding
    _, _, _, args = _problem(B, cfg)
    out_c = solve_pallas(*args, cfg)
    out_i = solve_pallas(*args, cfg, interpret=True)
    du = float(jnp.max(jnp.abs(out_c[1] - out_i[1])))
    assert du < 1e-3, du
    assert float(jnp.mean((out_c[3] == out_i[3]).astype(F32))) >= 0.99


def test_mega_matches_xla_highest_on_gpu(gpu):
    """batch_solve_lane(backward='mega') against the XLA lane path at
    HIGHEST precision, with the repo's parity thresholds."""
    from bench import solve_parity

    cfg = SolverConfig(n_steps=30, max_sqp_iters=12, tol_grad=1e-4,
                       ddp=True, ls_iters=4, backward="mega")
    z0s, coeffs, p, _ = _problem(5000, cfg, seed=3)
    r_m = batch_solve_lane(z0s, coeffs, p, cfg)
    with jax.default_matmul_precision("highest"):
        r_x = batch_solve_lane(z0s, coeffs, p,
                               dataclasses.replace(cfg, backward="xla"))
    par = solve_parity(r_m, r_x, cfg)
    assert par["ok"], par
    assert np.isfinite(np.asarray(r_m.us)).all()
