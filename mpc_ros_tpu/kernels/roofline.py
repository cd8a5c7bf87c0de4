"""Speed-of-light accounting for the solver's hot stages.

Analytic FLOP and device-memory byte counts per stage of the lane-major
batched solve (solver/batch_lane.py) and of the whole-solve kernel
(kernels/solve_pallas.py), a roofline bound from the device's published
peaks, and efficiency = bound / measured.

Counts are per SQP iteration for a batch B, horizon T, state n=8, control
m=2, n_alpha line-search candidates, f32. The XLA lane path is strongly
MEMORY-bound (arithmetic intensity ~2-3 flop/byte against the H100's f32
knee of ~20), so its roofline is the memory bound.
"""

from __future__ import annotations

import dataclasses

_N = 8     # augmented state dim
_M = 2     # control dim
_F32 = 4   # bytes


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Published peaks of one device for the roofline: float32 FLOP/s
    outside any matrix unit (every per-lane product here is elementwise)
    and device-memory bytes/s."""

    name: str
    peak_flops_f32: float
    hbm_bytes_per_s: float


# keyed by jax.Device.device_kind. Source: NVIDIA H100 Tensor Core GPU
# data sheet, SXM5 part — 67 TFLOP/s FP32 (non-tensor), 3.35 TB/s HBM3.
# Those peaks assume the card's full 700 W power limit.
DEVICE_SPECS = {
    "NVIDIA H100 80GB HBM3": DeviceSpec("NVIDIA H100 SXM", 67e12, 3.35e12),
}


def device_spec(kind: str) -> DeviceSpec:
    """The peaks for a `device_kind`; an unknown device is an error (a
    roofline against some other card's peaks would be meaningless)."""
    try:
        return DEVICE_SPECS[kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {kind!r}; add it to "
            f"kernels/roofline.DEVICE_SPECS with its source") from None


@dataclasses.dataclass
class StageAccount:
    name: str
    flops: float
    bytes: float

    def roofline_s(self, dev: DeviceSpec) -> float:
        return max(self.flops / dev.peak_flops_f32,
                   self.bytes / dev.hbm_bytes_per_s)

    @property
    def intensity(self) -> float:
        return self.flops / self.bytes


# bytes of one stage's linearization outputs per scenario:
# A(n*n) + B(n*m) + l_s(n) + l_u(m) + l_ss(n*n) + l_uu(m*m) + l_us(m*n)
_STAGE_LIN = (_N * _N + _N * _M + _N + _M + _N * _N + _M * _M + _M * _N)


def account_linearize(B: int, T: int) -> StageAccount:
    """Per-iteration linearize+expand: elementwise over (T, B); reads the
    trajectory slice, writes all stage quadratics."""
    flops = B * T * 80.0                      # trig, polynomial, products
    bytes_ = B * T * ((_N + _M) + _STAGE_LIN) * _F32
    return StageAccount("linearize+expand", flops, bytes_)


def account_backward(B: int, T: int) -> StageAccount:
    """Per-iteration control-limited Riccati scan: per stage ~6 batched
    (8x8)-class matmuls + the 9-combo box QP; reads stage quadratics,
    writes (k, K). The (Vs, Vss) carry stays on chip."""
    matmul_flops = 2 * (_N**3 + 2 * _N * _N * _M + _N * _M * _M
                        + 2 * _M * _M * _N)          # Q-expansion + V update
    boxqp_flops = 9 * 40 + 60                         # enumeration + select
    flops = B * T * float(matmul_flops + boxqp_flops)
    bytes_ = B * T * (_STAGE_LIN + (_M + _M * _N)) * _F32
    return StageAccount("riccati backward", flops, bytes_)


def account_forward(B: int, T: int, n_alpha: int) -> StageAccount:
    """Per-iteration multi-alpha forward rollouts: per stage and alpha a
    feedback matvec + dynamics step + stage cost; writes the candidate
    trajectories (gathered once per iteration)."""
    flops = B * T * n_alpha * (2 * _M * _N + 60.0)
    bytes_ = B * T * ((_N + _M + _M + _M * _N) * _F32          # read bar/k/K
                      + n_alpha * (_N + _M) * _F32 * 2)        # write + gather
    return StageAccount("forward line-search", flops, bytes_)


def account_rollout(B: int, T: int) -> StageAccount:
    """Initial cold/warm-start rollout (once per solve)."""
    flops = B * T * 60.0
    bytes_ = B * T * (_N + _M) * 2 * _F32
    return StageAccount("rollout", flops, bytes_)


def solve_accounting(B: int, T: int, dev: DeviceSpec, n_alpha: int = 8,
                     n_iters: float = 5.0) -> dict:
    """Full-solve accounting: per-iteration stages x n_iters + rollout."""
    stages = [account_linearize(B, T), account_backward(B, T),
              account_forward(B, T, n_alpha)]
    per_iter_flops = sum(s.flops for s in stages)
    per_iter_bytes = sum(s.bytes for s in stages)
    roll = account_rollout(B, T)
    total_flops = per_iter_flops * n_iters + roll.flops
    total_bytes = per_iter_bytes * n_iters + roll.bytes
    total = StageAccount("solve", total_flops, total_bytes)
    return {
        "device": dev.name,
        "B": B,
        "T": T,
        "n_iters": n_iters,
        "stages": {
            s.name: {
                "gflops": s.flops / 1e9,
                "mbytes": s.bytes / 1e6,
                "intensity_flop_per_byte": round(s.intensity, 2),
                "roofline_us": s.roofline_s(dev) * 1e6,
            }
            for s in stages + [roll]
        },
        "solve_roofline_ms": total.roofline_s(dev) * 1e3,
        "solve_gflops": total.flops / 1e9,
        "solve_mbytes": total.bytes / 1e6,
        "bound": ("memory" if total.bytes / dev.hbm_bytes_per_s
                  > total.flops / dev.peak_flops_f32 else "compute"),
    }


def megakernel_accounting(B: int, T: int, dev: DeviceSpec, n_alpha: int = 8,
                          n_iters: float = 5.0, ddp: bool = False) -> dict:
    """Speed-of-light accounting for the whole-solve kernel.

    FLOPs reuse the per-iteration stage counts (linearization is inlined
    into the backward scan; the winner re-roll adds one more alpha-like
    rollout). Memory traffic is the kernel's own per-lane streaming: each
    backward stage reads the knot (8 state rows, 2 controls, 4 cached trig
    values) and writes the gains (2 + 14); the line search reads the knot
    and gains (26 values) for all candidates at once; the winner re-roll
    reads 30 and writes 14. No (8, 8, B) stage array ever reaches device
    memory."""
    per_iter = (account_linearize(B, T).flops
                + account_backward(B, T).flops
                + account_forward(B, T, n_alpha + 1).flops)
    if ddp:
        # gated second-order terms (SolverConfig.ddp): per backward stage,
        # the f''(x) Horner (~2P-3), the five dmap entry products (~22
        # FMAs+mults incl. the gate scale) and their Qss additions (~7)
        per_iter += 35.0 * B * T
    flops = per_iter * n_iters + account_rollout(B, T).flops
    per_stage_iter = (14 + 16) + 26 + (30 + 14)
    in_bytes = B * (6 + 4 + 12 + 2 + 2 + 2 * T) * _F32
    roll_bytes = B * T * (2 + 2 + 4 + _N) * _F32
    bytes_ = float(in_bytes + roll_bytes
                   + B * T * per_stage_iter * _F32 * n_iters)
    t_compute = flops / dev.peak_flops_f32
    t_hbm = bytes_ / dev.hbm_bytes_per_s
    return {
        "device": dev.name,
        "kernel": "whole-solve",
        "B": B,
        "T": T,
        "n_iters": n_iters,
        "solve_gflops": flops / 1e9,
        "solve_mbytes": bytes_ / 1e6,
        "intensity_flop_per_byte": round(flops / bytes_, 1),
        "solve_roofline_ms": max(t_compute, t_hbm) * 1e3,
        "bound": "compute" if t_compute > t_hbm else "memory",
    }


def efficiency(measured_s: float, accounting: dict) -> float:
    """Fraction of speed-of-light achieved by a measured batch-solve time."""
    return accounting["solve_roofline_ms"] / 1e3 / measured_s
