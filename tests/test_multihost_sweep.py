"""Multi-host scaffolding + Monte-Carlo tuning sweep tests (virtual mesh)."""

import jax
import jax.numpy as jnp
import numpy as np

from mpc_ros_tpu.config import MPCParams, SolverConfig
from mpc_ros_tpu.engine.sweep import (sample_weight_candidates, tuning_sweep)
from mpc_ros_tpu.parallel.multihost import (host_local_scenarios,
                                            init_multihost, measure_scaling)


def test_init_multihost_single_process():
    topo = init_multihost()
    assert topo["processes"] == 1
    assert topo["global_devices"] == 8  # virtual CPU mesh


def test_host_local_scenarios_sharded():
    mesh, z0s, coeffs = host_local_scenarios(jax.random.PRNGKey(0), 64,
                                             jnp.float64)
    assert z0s.shape == (64, 6)
    # sharded over the data axis of the 8-device mesh
    assert len(z0s.sharding.device_set) == 8


def test_measure_scaling_runs_and_reports():
    rows = measure_scaling([1, 2, 4], global_batch_per_device=8,
                           n_steps=10, dtype=jnp.float64, repeats=1)
    assert [r["n_devices"] for r in rows] == [1, 2, 4]
    for r in rows:
        assert r["solves_per_s"] > 0
        # efficiency is REPORTED, not asserted: on a virtual CPU mesh the
        # quantity measures host-core oversubscription plus whatever else
        # is running on the box (observed 0.22 idle, 3.86 under load —
        # PERF.md "Tried and rejected"), so any bound here fails on
        # machine load, not on code. Real efficiency needs a real slice.
        assert np.isfinite(r["efficiency"]) and r["efficiency"] > 0


def test_weight_candidates_shape_and_positivity():
    base = MPCParams()
    cands = sample_weight_candidates(jax.random.PRNGKey(1), 5, base,
                                     dtype=jnp.float64)
    assert cands.w_cte.shape == (5,)
    assert bool(jnp.all(cands.w_cte > 0))
    # non-weight leaves broadcast unchanged
    np.testing.assert_allclose(np.asarray(cands.dt), np.full(5, 0.1))


def test_tuning_sweep_picks_sane_candidate():
    base = MPCParams()
    key = jax.random.PRNGKey(2)
    cands = sample_weight_candidates(key, 6, base, dtype=jnp.float64)
    res = tuning_sweep(key, cands, n_scenarios=8,
                       cfg=SolverConfig(n_steps=10), dtype=jnp.float64)
    assert res.mean_cost.shape == (6,)
    assert 0 <= res.best_index < 6
    best = res.best_params()
    assert best.w_cte.shape == ()
    # the winner must be among the most-converged candidates
    assert float(res.converged_frac[res.best_index]) >= 0.99


def test_two_process_dcn_sweep():
    """REAL multi-process run of the DCN path: two OS processes, each with
    2 virtual CPU devices, form one 4-device global mesh and execute
    init_multihost -> host_local_scenarios -> sharded_sweep; the psum
    reductions cross the inter-process transport (Gloo, standing in for
    DCN). Both processes must report identical global statistics."""
    import json
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(__file__), "_mh_worker.py")
    repo = os.path.dirname(os.path.dirname(worker))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        cwd=os.path.dirname(os.path.dirname(worker)))
        for i in range(2)]
    outs = []
    for pr in procs:
        out, err = pr.communicate(timeout=300)
        assert pr.returncode == 0, err.decode()[-2000:]
        line = [l for l in out.decode().splitlines() if l.startswith("{")][-1]
        outs.append(json.loads(line))
    assert outs[0]["mean_cost"] == outs[1]["mean_cost"]
    assert outs[0]["converged_frac"] == outs[1]["converged_frac"]
    assert outs[0]["converged_frac"] > 0.9
