#!/usr/bin/env python
"""Smoke test of the system on one GPU: the main path at full width.

    python chip_smoke.py                # one GPU: every phase below
    python chip_smoke.py --devices 4    # four GPUs: the multi-device paths

One process drives the card. Phases (one GPU):

  main     batch_solve_lane at N=30, B=524,288 with the production config
           (ddp, 4 line-search candidates, cap 12): the whole-solve kernel
           against backward="xla" — compile time, median of 5 timed runs,
           parity with the XLA path at HIGHEST matmul precision, the XLA
           path at default precision against HIGHEST (TF32), and a 64-lane
           sample against the float64 scipy oracle;
  n48      N=48 under schedule="auto" (the compact straggler schedule),
           B=131,072, against the XLA path;
  blobs, bicycle, refs
           parametric obstacles (single pass, cap 30) and the bicycle
           family at B=32,768 and per-stage setpoint profiles at
           B=16,384, exact trig, each against its plain reference;
  fleet    DeviceFleetPlanner at 8,192 robots: warm-up, 20 timed cycles
           (p50/p99 ms), and its commands against the host FleetPlanner on
           the same plans;
  planner  one MPCPlanner cycle loop (p50/p99 ms);
  tests    the tests marked `gpu`, in this process.

With --devices 4 only the multi-device paths run, each against the same
work on one card: DeviceFleetPlanner over a 4-device mesh at 4 x 8,192
robots, and parallel.sharded_sweep against the unsharded sweep.

Prints the card's name and power limit, which solve path ran, timings,
parity numbers and peak device memory; the last line is one JSON object
{"ok": true, "device": {...}}. Any failed phase exits nonzero. Exits at once,
printing no result, when JAX's first device is not a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from mpc_ros_tpu.device import (card_info, device_record,
                                enable_compile_cache, require_gpu)

F32 = jnp.float32


def log(*args) -> None:
    print(*args, flush=True)


def run_timed(fn, args, repeats: int = 5, precision=None):
    """Compile `fn` for `args`, warm it up, then time `repeats` runs that
    each end in block_until_ready. Returns (output, compile s, median s)."""
    jf = jax.jit(fn)
    t0 = time.perf_counter()
    if precision is None:
        compiled = jf.lower(*args).compile()
    else:
        with jax.default_matmul_precision(precision):
            compiled = jf.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    return out, compile_s, statistics.median(times)


def _oracle_lane(job):
    """One float64 scipy oracle solve (runs in a CPU-only worker)."""
    z0, coeffs, cfg = job
    jax.config.update("jax_enable_x64", True)
    from mpc_ros_tpu.config import MPCParams
    from mpc_ros_tpu.solver.oracle import solve_oracle

    res = solve_oracle(z0, coeffs, MPCParams(), cfg)
    return res.success, res.us


# environment of the oracle workers: host CPU only (they never open the
# card), no persistent compile cache, and one thread per worker for XLA
# and BLAS — a pool of workers that each spawn a thread per host core
# oversubscribes a container and runs orders of magnitude slower
_ORACLE_ENV = {"JAX_PLATFORMS": "cpu", "JAX_ENABLE_COMPILATION_CACHE": "false",
               "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false",
               "OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
               "MKL_NUM_THREADS": "1"}


def oracle_solves(z0s, coeffs, cfg, workers: int | None = None):
    """Solve each lane's NLP with the float64 oracle in a pool of worker
    processes (see _ORACLE_ENV); the pool is shut down before this
    returns."""
    import multiprocessing

    workers = workers or min(len(z0s), 16, len(os.sched_getaffinity(0)))
    old = {k: os.environ.get(k) for k in _ORACLE_ENV}
    os.environ.update(_ORACLE_ENV)            # inherited by the workers
    try:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(workers) as pool:
            return pool.map(_oracle_lane, [(z0s[i], coeffs[i], cfg)
                                           for i in range(len(z0s))])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def production_cfg(**kw):
    from mpc_ros_tpu.config import SolverConfig

    base = dict(n_steps=30, max_sqp_iters=12, tol_grad=1e-4, ddp=True,
                ls_iters=4)
    base.update(kw)
    return SolverConfig(**base)


def report_path(cfg, B: int) -> str:
    from mpc_ros_tpu.kernels.solve_pallas import (BLOCK, lane_block,
                                                  padded_batch)
    from mpc_ros_tpu.solver.batch_lane import _use_kernel

    if _use_kernel(cfg, F32, False):
        return (f"whole-solve kernel (Pallas/Triton, {lane_block(B, BLOCK)}"
                f" lanes per program, batch padded to {padded_batch(B)})")
    return "XLA lane path"


def parity_line(name: str, par: dict) -> None:
    log(f"parity {name}: " + json.dumps(par))
    if not par["ok"]:
        raise AssertionError(f"{name}: kernel deviates from its reference")


def phase_main(batch: int = 524288, repeats: int = 5,
               oracle_lanes: int = 64) -> None:
    from bench import solve_parity
    from mpc_ros_tpu.config import MPCParams
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.solver.batch_lane import batch_solve_lane

    cfg = production_cfg()
    cfg_x = dataclasses.replace(cfg, backward="xla")
    p = MPCParams().astype(F32)
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), batch, F32)
    path = report_path(cfg, batch)
    log(f"main: N={cfg.n_steps} B={batch} backward='auto' runs: {path}")
    assert path.startswith("whole-solve"), "auto did not pick the kernel"

    def solve(c):
        return lambda z, q: batch_solve_lane(z, q, p, c)

    r_k, comp_k, t_k = run_timed(solve(cfg), (z0s, coeffs), repeats)
    log(f"main kernel: compile {comp_k:.2f} s, median {t_k * 1e3:.2f} ms, "
        f"{batch / t_k:.1f} solves/s")
    r_xh, comp_xh, t_xh = run_timed(solve(cfg_x), (z0s, coeffs), repeats,
                                    precision="highest")
    log(f"main xla(highest): compile {comp_xh:.2f} s, median "
        f"{t_xh * 1e3:.2f} ms, {batch / t_xh:.1f} solves/s")
    r_xd, comp_xd, t_xd = run_timed(solve(cfg_x), (z0s, coeffs), repeats)
    log(f"main xla(default): compile {comp_xd:.2f} s, median "
        f"{t_xd * 1e3:.2f} ms, {batch / t_xd:.1f} solves/s")
    log(f"main kernel speedup vs xla(default): {t_xd / t_k:.3f}x, "
        f"vs xla(highest): {t_xh / t_k:.3f}x")
    parity_line("main kernel vs xla(highest)",
                solve_parity(r_k, r_xh, cfg))
    # TF32: the plain path at default precision against HIGHEST
    tf = solve_parity(r_xd, r_xh, cfg)
    log("tf32 xla(default) vs xla(highest): " + json.dumps(
        {k: tf[k] for k in ("max_du", "conv_frac_kernel_xla",
                            "conv_match_frac", "iters_match_frac", "ok")}))

    idx = np.linspace(0, batch - 1, oracle_lanes).astype(int)
    us_k = np.asarray(r_k.us)[idx]
    conv_k = np.asarray(r_k.converged)[idx]
    t0 = time.perf_counter()
    orcs = oracle_solves(np.asarray(z0s)[idx], np.asarray(coeffs)[idx], cfg)
    dus = [float(np.max(np.abs(us_o - us_k[i])))
           for i, (ok, us_o) in enumerate(orcs) if ok and conv_k[i]]
    n_ok = len(dus)
    du_orc = max(dus) if dus else float("inf")
    log(f"oracle: {n_ok}/{oracle_lanes} lanes compared (oracle success and "
        f"kernel converged), max |du| {du_orc:.3e} (limit 1e-3), "
        f"{time.perf_counter() - t0:.1f} s on the host")
    if not (du_orc <= 1e-3 and n_ok >= oracle_lanes - 2):
        raise AssertionError("kernel vs float64 oracle outside 1e-3")


def phase_variants(batch: int = 131072, small_batch: int = 32768,
                   refs_batch: int = 16384, repeats: int = 3) -> None:
    from bench import bench_blobs, compact_runs, solve_parity
    from mpc_ros_tpu.config import MPCParams
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.solver.batch_lane import batch_solve_lane

    p = MPCParams().astype(F32)

    def check(name, cfg, B, blobs_on=False, refs_on=False,
              expect_compact=False):
        z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), B, F32)
        extra = []
        if blobs_on:
            extra.append(bench_blobs(B, F32))
        if refs_on:
            N = cfg.n_steps
            tgrid = jnp.linspace(0.0, 1.0, N, dtype=F32)
            v_prof = 0.2 + 0.6 * tgrid[None, :] * jnp.linspace(
                0.5, 1.0, B, dtype=F32)[:, None]
            cte_prof = 0.1 * jnp.sin(3.0 * tgrid)[None, :] * jnp.ones((B, 1),
                                                                     F32)
            extra.append(jnp.stack([cte_prof, jnp.zeros((B, N), F32),
                                    v_prof], axis=-1))

        def solve(c):
            def fn(z, q, *ex):
                kw = {}
                ex = list(ex)
                if blobs_on:
                    kw["blobs"] = ex.pop(0)
                if refs_on:
                    kw["refs"] = ex.pop(0)
                return batch_solve_lane(z, q, p, c, **kw)
            return fn

        log(f"{name}: N={cfg.n_steps} B={B} trig={cfg.trig} runs: "
            f"{report_path(cfg, B)}")
        args = (z0s, coeffs, *extra)
        r_k, comp, t = run_timed(solve(cfg), args, repeats)
        log(f"{name} kernel: compile {comp:.2f} s, median {t * 1e3:.2f} ms, "
            f"{B / t:.1f} solves/s")
        # the refs reference is the per-scenario vmap engine (the XLA lane
        # stages keep scalar setpoints, so backward="xla" delegates to it)
        cfg_x = dataclasses.replace(cfg, backward="xla")
        with jax.default_matmul_precision("highest"):
            r_x = jax.jit(solve(cfg_x))(*args)
        engaged = compact_runs(B, cfg)
        par = solve_parity(r_k, r_x, cfg, engaged)
        if expect_compact:
            par["ok"] = bool(par["ok"] and engaged)
        parity_line(name, par)

    check("n48", production_cfg(n_steps=48, max_sqp_iters=22, ls_iters=None,
                                ddp="auto"), batch, expect_compact=True)
    # the family/feature checks run exact trig (bench.kernel_verify's
    # convention: rollout transcendentals bit-comparable with the XLA
    # path, so a failure is the kernel's, not the Taylor rotation's); the
    # blobs check runs the single pass, like the XLA loop it is compared
    # with (a compact run legitimately converges stragglers the single
    # loop leaves at its cap; n48 checks the compact machinery)
    check("blobs", production_cfg(max_sqp_iters=30, schedule="single",
                                  trig="exact"), small_batch, blobs_on=True)
    check("bicycle", production_cfg(model="bicycle", trig="exact"),
          small_batch)
    check("refs", production_cfg(n_steps=20, max_sqp_iters=20, trig="exact"),
          refs_batch, refs_on=True)


def fleet_plans(B: int):
    from mpc_ros_tpu.sim import get_shape

    base = get_shape("infinity")
    plans = []
    for i in range(B):
        pl = base.copy()
        pl[:, :2] += 10.0 * (i % 64)
        plans.append(pl)
    return plans


def fleet_params():
    from mpc_ros_tpu.config import MPCParams

    return MPCParams(max_angvel=1.5, w_cte=300.0, w_angvel_d=10.0,
                     w_accel_d=10.0)


def drive_fleet(planner, plans, n_warm: int, n_cycles: int):
    """Run a fleet planner on `plans`, advancing the plant with its own
    commands. Returns (first-cycle commands, cycle seconds, info)."""
    B = len(plans)
    poses = np.stack([pl[0] for pl in plans]).astype(float)
    fb = np.zeros((B, 2))
    planner.initialize(B)
    assert planner.set_plans(plans, poses).all()
    laps, first = [], None
    for cyc in range(n_warm + n_cycles):
        t0 = time.perf_counter()
        ok, cmds, info = planner.compute_velocity_commands(poses, fb)
        if cyc >= n_warm:
            laps.append(time.perf_counter() - t0)
        if first is None:
            first = cmds.copy()
        v, w = cmds[:, 0], cmds[:, 1]
        poses[:, 0] += 0.1 * v * np.cos(poses[:, 2])
        poses[:, 1] += 0.1 * v * np.sin(poses[:, 2])
        poses[:, 2] += 0.1 * w
        fb = cmds.copy()
    return first, np.asarray(laps), info


def phase_fleet(robots: int = 8192, cycles: int = 20,
                compare_robots: int = 1024) -> None:
    from mpc_ros_tpu.config import PlannerConfig, SolverConfig
    from mpc_ros_tpu.planner import FleetPlanner
    from mpc_ros_tpu.planner.fleet_device import DeviceFleetPlanner

    cfg = SolverConfig(n_steps=20, ls_iters=4)
    kw = dict(params=fleet_params(), solver_cfg=cfg,
              planner_cfg=PlannerConfig(local_plan_length=2.5))
    log(f"fleet: DeviceFleetPlanner, {robots} robots, N=20, solve runs: "
        f"{report_path(cfg, robots)}")
    _, laps, info = drive_fleet(DeviceFleetPlanner(**kw), fleet_plans(robots),
                                n_warm=2, n_cycles=cycles)
    log(f"fleet cycle ms: p50 {np.percentile(laps, 50) * 1e3:.3f}, "
        f"p99 {np.percentile(laps, 99) * 1e3:.3f} over {len(laps)} cycles, "
        f"conv {float(np.mean(info.converged)):.4f}")
    # the device pipeline (f32 fit on the card) against the host pipeline
    # (numpy f64 fit), same plans: commands agree to solver noise
    plans = fleet_plans(compare_robots)
    cmd_d, _, _ = drive_fleet(DeviceFleetPlanner(**kw), plans, 0, 1)
    cmd_h, _, _ = drive_fleet(FleetPlanner(**kw), plans, 0, 1)
    dcmd = float(np.max(np.abs(cmd_d - cmd_h)))
    log(f"fleet device vs host planner ({compare_robots} robots): max "
        f"|dcmd| {dcmd:.3e} (limit 2e-3)")
    if not dcmd < 2e-3:
        raise AssertionError("device fleet commands deviate from host")


def phase_planner(cycles: int = 100) -> None:
    from mpc_ros_tpu.config import PlannerConfig, SolverConfig
    from mpc_ros_tpu.planner.planner import MPCPlanner
    from mpc_ros_tpu.sim import get_shape

    pl = MPCPlanner(params=fleet_params(), solver_cfg=SolverConfig(n_steps=20),
                    planner_cfg=PlannerConfig(local_plan_length=2.5))
    pl.initialize()
    plan = get_shape("infinity")
    pose = np.array([plan[40, 0], plan[40, 1], plan[40, 2]])
    pl.set_plan(plan, pose)
    vw = np.zeros(2)
    laps = []
    for i in range(cycles + 2):
        t0 = time.perf_counter()
        ok, cmd, _ = pl.compute_velocity_commands(pose, vw)
        if i >= 2:
            laps.append(time.perf_counter() - t0)
        v, w = float(cmd[0]), float(cmd[1])
        pose = pose + 0.1 * np.array([v * np.cos(pose[2]),
                                      v * np.sin(pose[2]), w])
        vw = np.array([v, w])
    laps = np.asarray(laps)
    log(f"planner cycle ms (MPCPlanner, N=20): p50 "
        f"{np.percentile(laps, 50) * 1e3:.3f}, p99 "
        f"{np.percentile(laps, 99) * 1e3:.3f} over {cycles} cycles")


def phase_tests() -> None:
    import pytest

    os.environ["MPC_ROS_TESTS_ON_DEVICE"] = "1"
    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(here, "tests", "test_gpu_kernel.py")])
    log(f"gpu tests: pytest exit code {int(rc)}")
    if rc != 0:
        raise AssertionError("gpu-marked tests failed")


def _mesh_of(n_dev: int):
    from mpc_ros_tpu.parallel import make_mesh

    if len(jax.devices()) < n_dev:
        raise AssertionError(f"need {n_dev} devices, JAX found "
                             f"{len(jax.devices())}")
    return make_mesh(n_data=n_dev, devices=jax.devices()[:n_dev])


def phase_multi_fleet(n_dev: int = 4, robots_per_dev: int = 8192,
                      cycles: int = 20) -> None:
    """DeviceFleetPlanner over an n_dev mesh against one device."""
    from mpc_ros_tpu.config import PlannerConfig, SolverConfig
    from mpc_ros_tpu.planner.fleet_device import DeviceFleetPlanner

    mesh = _mesh_of(n_dev)
    cfg = SolverConfig(n_steps=20, ls_iters=4)
    kw = dict(params=fleet_params(), solver_cfg=cfg,
              planner_cfg=PlannerConfig(local_plan_length=2.5))
    B = n_dev * robots_per_dev
    plans = fleet_plans(B)
    cmd4, laps4, info4 = drive_fleet(DeviceFleetPlanner(**kw, mesh=mesh),
                                     plans, 2, cycles)
    cmd1, laps1, _ = drive_fleet(DeviceFleetPlanner(**kw), plans, 2, cycles)
    dev = float(np.max(np.abs(cmd4 - cmd1)))
    log(f"multi fleet: {B} robots, {n_dev}-device mesh p50 "
        f"{np.percentile(laps4, 50) * 1e3:.3f} ms p99 "
        f"{np.percentile(laps4, 99) * 1e3:.3f} ms; one device p50 "
        f"{np.percentile(laps1, 50) * 1e3:.3f} ms p99 "
        f"{np.percentile(laps1, 99) * 1e3:.3f} ms; first-cycle max |dcmd| "
        f"{dev:.3e} (limit 1e-5), conv {float(np.mean(info4.converged)):.4f}")
    if not dev <= 1e-5:
        raise AssertionError("sharded fleet deviates from one device")


def phase_multi_sweep(n_dev: int = 4, sweep_per_dev: int = 4096) -> None:
    """parallel.sharded_sweep against the unsharded sweep on one device.

    Both run at HIGHEST matmul precision: the sweep's per-scenario solver
    contracts with einsums, and at default precision a GPU may run them in
    TF32, whose rounding then differs between the two batch shapes."""
    from mpc_ros_tpu.config import MPCParams, SolverConfig
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.engine.batch import batch_solve
    from mpc_ros_tpu.parallel import batch_sharding, sharded_sweep

    mesh = _mesh_of(n_dev)
    p = MPCParams().astype(F32)
    scfg = SolverConfig(n_steps=30, max_sqp_iters=12, tol_grad=1e-4)
    Bs = n_dev * sweep_per_dev
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), Bs, F32)
    sh = batch_sharding(mesh)
    with jax.default_matmul_precision("highest"):
        t0 = time.perf_counter()
        res, stats = sharded_sweep(mesh, jax.device_put(z0s, sh),
                                   jax.device_put(coeffs, sh), p, scfg)
        jax.block_until_ready(res.us)
        t4 = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = jax.block_until_ready(batch_solve(z0s, coeffs, p, scfg))
        t1 = time.perf_counter() - t0
    dus = np.max(np.abs(np.asarray(res.us) - np.asarray(ref.us)), axis=(1, 2))
    du = float(dus.max())
    log(f"multi sweep: {Bs} scenarios, sharded {t4:.2f} s vs one device "
        f"{t1:.2f} s (first calls, compile included); max |du| {du:.3e} "
        f"(limit 1e-6), lanes above 1e-6: {int(np.sum(dus > 1e-6))}, "
        f"converged {float(stats.converged_frac):.4f}")
    if not du <= 1e-6:
        raise AssertionError("sharded sweep deviates from one device")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="1: the one-GPU phases; 4: the multi-device paths")
    args = ap.parse_args()
    cache = enable_compile_cache()
    dev = require_gpu("chip_smoke.py")
    log(f"card: {card_info()}")
    log(f"jax {jax.__version__}, devices: {json.dumps(device_record())}, "
        f"compile cache: {cache}")
    if args.devices == 4:
        phases = [("multi fleet", phase_multi_fleet),
                  ("multi sweep", phase_multi_sweep)]
    else:
        phases = [("main", phase_main), ("variants", phase_variants),
                  ("fleet", phase_fleet), ("planner", phase_planner),
                  ("tests", phase_tests)]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"== phase {name}")
        try:
            fn()
        except Exception as e:  # report every phase, then fail the run
            failed.append(name)
            log(f"phase {name} FAILED: {type(e).__name__}: {e}")
        log(f"== phase {name} took {time.perf_counter() - t0:.1f} s")
    peak = dev.memory_stats().get("peak_bytes_in_use", 0)
    log(f"peak device memory: {peak / 2**30:.2f} GiB (peak_bytes_in_use)")
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    print(json.dumps({"ok": True, "device": device_record()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
