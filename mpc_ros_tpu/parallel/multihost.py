"""Multi-host launch scaffolding and scaling-efficiency measurement.

The reference is strictly single-process (SURVEY.md §2.4). The north-star
configs require a >=2-host Monte-Carlo sweep with scaling efficiency
measured at 1 device / 1 host / N hosts (BASELINE.md).

Design: one SPMD program over the global mesh. Each host builds its local
scenario shard (`host_local_scenarios`) and assembles a global array; the
sweep itself is the same `sharded_sweep` program — `psum` reductions run
across the devices of a host and over the network across hosts, and the
per-cycle control path never participates (SURVEY.md §5.8 constraint).

The same code runs on the virtual CPU mesh (tests) and on one device;
`init_multihost` is the only piece that needs real multi-process
infrastructure.
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MPCParams, SolverConfig
from ..engine.batch import make_random_scenarios
from .mesh import make_mesh, batch_sharding
from .sharded import sharded_sweep


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> dict:
    """Initialize jax.distributed for a multi-host run (no-op if single
    process). Call once per process before any backend use.

    Returns a topology summary {processes, process_index, local_devices,
    global_devices}.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return {
        "processes": jax.process_count(),
        "process_index": jax.process_index(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def host_local_scenarios(key, global_batch: int, dtype=jnp.float32):
    """Each process generates only ITS shard of the global scenario batch
    (per-host independent keys), then assembles the global sharded arrays —
    the data-loading pattern for DCN-scale sweeps."""
    n_proc = jax.process_count()
    if global_batch % n_proc:
        raise ValueError(
            f"global_batch={global_batch} must divide evenly over "
            f"{n_proc} processes (local shards must tile the global shape)")
    per_host = global_batch // n_proc
    host_key = jax.random.fold_in(key, jax.process_index())
    z0s_local, coeffs_local = make_random_scenarios(host_key, per_host, dtype)

    mesh = make_mesh()
    sharding = batch_sharding(mesh)
    if n_proc == 1:
        z0s = jax.device_put(z0s_local, sharding)
        coeffs = jax.device_put(coeffs_local, sharding)
    else:
        z0s = jax.make_array_from_process_local_data(
            sharding, np.asarray(z0s_local), (global_batch, 6))
        coeffs = jax.make_array_from_process_local_data(
            sharding, np.asarray(coeffs_local),
            (global_batch, coeffs_local.shape[-1]))
    return mesh, z0s, coeffs


def measure_scaling(n_devices_list, global_batch_per_device: int = 512,
                    n_steps: int = 30, dtype=jnp.float32,
                    repeats: int = 3) -> list[dict]:
    """Scaling-efficiency measurement: solves/s on meshes of increasing
    size (same per-device load — weak scaling). Runs on whatever devices
    are visible (virtual CPU mesh in tests, real slice in production)."""
    cfg = SolverConfig(n_steps=n_steps, max_sqp_iters=12,
                       tol_grad=1e-4 if dtype == jnp.float32 else 1e-7)
    p = MPCParams().astype(dtype)
    results = []
    base_rate = None
    for nd in n_devices_list:
        if nd > len(jax.devices()):
            continue
        mesh = make_mesh(n_data=nd, devices=jax.devices()[:nd])
        batch = global_batch_per_device * nd
        z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), batch,
                                            dtype)
        sh = batch_sharding(mesh)
        z0s = jax.device_put(z0s, sh)
        coeffs = jax.device_put(coeffs, sh)
        res, stats = sharded_sweep(mesh, z0s, coeffs, p, cfg)
        float(stats.mean_cost)  # sync
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            res, stats = sharded_sweep(mesh, z0s, coeffs, p, cfg)
            float(stats.mean_cost)
            times.append(time.perf_counter() - t0)
        rate = batch / min(times)
        if base_rate is None:
            base_rate = rate / nd
        results.append({
            "n_devices": nd,
            "batch": batch,
            "solves_per_s": round(rate, 1),
            "per_device": round(rate / nd, 1),
            "efficiency": round(rate / nd / base_rate, 3),
            "converged_frac": round(float(stats.converged_frac), 4),
        })
    return results
