"""Monte-Carlo weight-tuning sweeps (BASELINE.md config #5).

The reference exposes its 7 cost weights through dynamic_reconfigure and
leaves tuning to the operator. Here tuning is a batched compute problem:
sample candidate weight vectors, evaluate each on a common scenario set by
solving (n_weights x n_scenarios) NMPC problems in one sharded batch, and
rank candidates by closed-loop-relevant statistics. Because `MPCParams` is
a traced pytree, per-scenario weights need no recompilation — the sweep is
one XLA program regardless of the candidate set.
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp

from ..config import MPCParams, SolverConfig
from .batch import batch_solve_swept, make_random_scenarios


@dataclasses.dataclass
class SweepResult:
    weights: MPCParams          # candidate weight sets (leaves (n_weights,))
    mean_cost: jnp.ndarray      # (n_weights,) mean solve cost over scenarios
    mean_terminal_cte: jnp.ndarray   # (n_weights,)
    converged_frac: jnp.ndarray      # (n_weights,)
    mean_iters: jnp.ndarray          # (n_weights,) mean SQP iterations —
    # extreme candidates dominate sweep wall time (each batch tile pays its
    # slowest lane), so this is the knob to watch when a sweep runs long
    best_index: int

    def best_params(self) -> MPCParams:
        i = self.best_index
        return jax.tree.map(lambda leaf: leaf[i], self.weights)


def sample_weight_candidates(key, n: int, base: MPCParams,
                             scale: float = 3.0,
                             dtype=jnp.float32) -> MPCParams:
    """Log-uniform perturbations of the tracking weights around `base`."""
    names = ["w_cte", "w_etheta", "w_vel", "w_angvel", "w_accel",
             "w_angvel_d", "w_accel_d"]
    keys = jax.random.split(key, len(names))
    out = base.astype(dtype)
    out = jax.tree.map(lambda leaf: jnp.broadcast_to(leaf, (n,)), out)
    for name, k in zip(names, keys):
        factor = jnp.exp(jax.random.uniform(
            k, (n,), dtype, -jnp.log(scale), jnp.log(scale)))
        out = out.replace(**{name: jnp.asarray(getattr(base, name), dtype)
                             * factor})
    return out


def tuning_sweep(key, candidates: MPCParams, n_scenarios: int,
                 cfg: SolverConfig, dtype=jnp.float32,
                 score_cte_weight: float = 1.0,
                 presort: bool = False) -> SweepResult:
    """Evaluate `n_weights` candidates on a shared random scenario set.

    Total batch = n_weights * n_scenarios solves in ONE program. Scoring
    uses a fixed evaluation metric (terminal |cte| + convergence), NOT each
    candidate's own cost (costs with different weights are incomparable).

    `presort`: order the shared scenario set by predicted solve difficulty
    before tiling, so similar-iteration lanes share the kernel's blocks
    (see engine/presort.py). SEMANTICS-FREE here — the sweep consumes only
    per-candidate reductions (means, fractions, argmin), permutation-
    invariant within each candidate's contiguous block; ranking
    invariance is pinned in tests/test_batch_parallel.py. Off by default:
    it adds a calibration solve and host fetches of the scenario set to a
    one-shot program, and whether the block-max saving pays for them on
    the GPU is not measured. The ridge model is fit on a <=2048-scenario
    calibration subsample under the first candidate's weights, then
    predicts keys with one matvec."""
    n_weights = jax.tree.leaves(candidates)[0].shape[0]
    kz, _ = jax.random.split(key)
    z0s, coeffs = make_random_scenarios(kz, n_scenarios, dtype)

    if (presort and n_scenarios >= 256 and n_scenarios % 128 == 0
            and cfg.model in ("diff_drive", "bicycle")):
        import numpy as np

        from ..solver.batch_lane import batch_solve_lane
        from .presort import fit_difficulty_model, predict_difficulty

        n_cal = min(n_scenarios, 2048)
        p0 = jax.tree.map(lambda leaf: leaf[0], candidates)
        calib = batch_solve_lane(z0s[:n_cal], coeffs[:n_cal], p0, cfg)
        z0s_h = np.asarray(z0s)
        coeffs_h = np.asarray(coeffs)
        dmodel = fit_difficulty_model(z0s_h[:n_cal], coeffs_h[:n_cal],
                                      np.asarray(calib.n_iters))
        order = np.argsort(predict_difficulty(dmodel, z0s_h, coeffs_h),
                           kind="stable")
        z0s = z0s[order]
        coeffs = coeffs[order]

    # tile: scenario-major blocks per candidate
    z0s_t = jnp.tile(z0s, (n_weights, 1))
    coeffs_t = jnp.tile(coeffs, (n_weights, 1))
    ps = jax.tree.map(
        lambda leaf: jnp.repeat(leaf, n_scenarios, axis=0), candidates)

    # lane-major engine: per-scenario params ride the lanes (incl. through
    # the kernel's packed-parameter rows); batches that are not a multiple
    # of 128 keep the vmapped engine
    from ..solver.batch_lane import batch_solve_lane

    total = n_weights * n_scenarios
    if total % 128 == 0 and cfg.model in ("diff_drive", "bicycle"):
        res = batch_solve_lane(z0s_t, coeffs_t, ps, cfg)
    else:
        # registry-defined custom families (and ragged batches) run the
        # model-generic vmapped engine
        res = batch_solve_swept(z0s_t, coeffs_t, ps, cfg)
    costs = res.cost.reshape(n_weights, n_scenarios)
    term_cte = jnp.abs(res.zs[:, -1, 4]).reshape(n_weights, n_scenarios)
    conv = res.converged.reshape(n_weights, n_scenarios)

    mean_cost = jnp.mean(costs, axis=1)
    mean_cte = jnp.mean(term_cte, axis=1)
    conv_frac = jnp.mean(conv.astype(dtype), axis=1)
    mean_iters = jnp.mean(
        res.n_iters.astype(dtype).reshape(n_weights, n_scenarios), axis=1)
    score = score_cte_weight * mean_cte + jnp.where(conv_frac < 0.99,
                                                   jnp.inf, 0.0)
    if not bool(jnp.any(jnp.isfinite(score))):
        # no candidate reached the convergence bar: argmin over +inf would
        # silently crown index 0 — fall back to the most-converged
        # candidate so best_params is at least the least-bad choice
        score = -conv_frac
    best = int(jnp.argmin(score))
    return SweepResult(
        weights=candidates, mean_cost=mean_cost, mean_terminal_cte=mean_cte,
        converged_frac=conv_frac, mean_iters=mean_iters, best_index=best,
    )
