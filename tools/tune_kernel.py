"""Time the whole-solve kernel over block sizes and warp counts on the GPU.

    python tools/tune_kernel.py --batch 524288 --blocks 64,128,256 \
        --warps 0 --repeats 5

`--warps 0` means one warp per 32 lanes. For each setting: compile time,
median of `--repeats` timed runs (each ending in block_until_ready),
solves/s and the compiled program's memory analysis. Then the XLA lane
path on the same batch, for comparison. Exits without a GPU.
"""

import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mpc_ros_tpu.device import (card_info, enable_compile_cache,  # noqa: E402
                                require_gpu)


def timed(compiled, args, repeats):
    jax.block_until_ready(compiled(*args))
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=524288)
    ap.add_argument("--n-steps", type=int, default=30)
    ap.add_argument("--blocks", default="64,128,256")
    ap.add_argument("--warps", default="0")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--xla", action="store_true",
                    help="also time the XLA lane path")
    args = ap.parse_args()
    enable_compile_cache()
    require_gpu("tools/tune_kernel.py")
    print("card:", card_info(), "| jax device_kind:",
          jax.devices()[0].device_kind, flush=True)

    from mpc_ros_tpu.config import MPCParams, SolverConfig
    from mpc_ros_tpu.engine import make_random_scenarios
    from mpc_ros_tpu.kernels.backward_pallas import pack_params
    from mpc_ros_tpu.kernels.solve_pallas import solve_pallas
    from mpc_ros_tpu.solver.batch_lane import batch_solve_lane

    f32 = jnp.float32
    B = args.batch
    cfg = SolverConfig(n_steps=args.n_steps, max_sqp_iters=12,
                       tol_grad=1e-4, ddp=True, ls_iters=4)
    p = MPCParams().astype(f32)
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), B, f32)
    lane = (jnp.swapaxes(z0s, 0, 1), jnp.swapaxes(coeffs, 0, 1),
            pack_params(p, B, f32), jnp.full((2, B), -1.0, f32),
            jnp.full((2, B), 1.0, f32), jnp.zeros((cfg.n_controls, 2, B), f32))
    for blk in [int(b) for b in args.blocks.split(",")]:
        for w in [int(x) for x in args.warps.split(",")]:
            fn = jax.jit(lambda *a, blk=blk, w=w: solve_pallas(
                *a, cfg, block=blk, num_warps=w or None))
            t0 = time.perf_counter()
            try:
                compiled = fn.lower(*lane).compile()
            except Exception as e:  # report and go on to the next setting
                print(f"block {blk} warps {w}: compile FAILED "
                      f"{type(e).__name__}: {str(e)[:400]}", flush=True)
                continue
            comp = time.perf_counter() - t0
            t = timed(compiled, lane, args.repeats)
            out = compiled(*lane)
            print(f"block {blk} warps {w or blk // 32}: compile {comp:.2f} s,"
                  f" median {t * 1e3:.3f} ms, {B / t:.1f} solves/s, mean "
                  f"iters {float(jnp.mean(out[4])):.3f}, conv "
                  f"{float(jnp.mean(out[3])):.5f}; memory "
                  f"{compiled.memory_analysis()}", flush=True)
    if args.xla:
        import dataclasses

        cx = dataclasses.replace(cfg, backward="xla")
        fn = jax.jit(lambda z, c: batch_solve_lane(z, c, p, cx))
        t0 = time.perf_counter()
        compiled = fn.lower(z0s, coeffs).compile()
        comp = time.perf_counter() - t0
        t = timed(compiled, (z0s, coeffs), args.repeats)
        print(f"xla lane path: compile {comp:.2f} s, median {t * 1e3:.3f} ms"
              f", {B / t:.1f} solves/s", flush=True)


if __name__ == "__main__":
    main()
