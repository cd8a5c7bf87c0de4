"""Monte-Carlo weight tuning: evaluate candidate cost weights in one program.

    python examples/weight_tuning.py --candidates 8 --scenarios 512
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import jax
import jax.numpy as jnp

from mpc_ros_tpu import MPCParams, SolverConfig
from mpc_ros_tpu.engine.sweep import sample_weight_candidates, tuning_sweep

ap = argparse.ArgumentParser()
ap.add_argument("--candidates", type=int, default=8)
ap.add_argument("--scenarios", type=int, default=512)
args = ap.parse_args()

dtype = jnp.float32
cands = sample_weight_candidates(jax.random.PRNGKey(0), args.candidates,
                                 MPCParams(), dtype=dtype)
res = tuning_sweep(jax.random.PRNGKey(1), cands, args.scenarios,
                   SolverConfig(n_steps=30, max_sqp_iters=12, tol_grad=1e-4),
                   dtype=dtype)
best = res.best_params()
print(f"evaluated {args.candidates} x {args.scenarios} solves; "
      f"best candidate #{res.best_index}: "
      f"w_cte={float(best.w_cte):.1f} w_etheta={float(best.w_etheta):.1f} "
      f"mean terminal |cte|={float(res.mean_terminal_cte[res.best_index]):.4f}")
