"""Roofline accounting sanity tests."""

import pytest

from mpc_ros_tpu.kernels import (DeviceSpec, account_backward,
                                 account_linearize, device_spec, efficiency,
                                 solve_accounting)

H100 = device_spec("NVIDIA H100 80GB HBM3")


def test_accounting_scales_linearly():
    a1 = solve_accounting(1024, 29, H100)
    a2 = solve_accounting(2048, 29, H100)
    assert abs(a2["solve_gflops"] / a1["solve_gflops"] - 2.0) < 1e-9
    assert abs(a2["solve_mbytes"] / a1["solve_mbytes"] - 2.0) < 1e-9


def test_memory_bound_regime():
    acct = solve_accounting(4096, 29, H100)
    assert acct["bound"] == "memory"
    # arithmetic intensity far below the H100's f32 knee (~20 flop/byte)
    assert acct["stages"]["riccati backward"]["intensity_flop_per_byte"] < 10


def test_roofline_is_max_of_bounds():
    dev = DeviceSpec("slow memory", peak_flops_f32=1e12,
                     hbm_bytes_per_s=1e9)
    s = account_backward(1024, 29)
    assert abs(s.roofline_s(dev) - s.bytes / 1e9) < 1e-12


def test_efficiency_fraction():
    acct = solve_accounting(4096, 29, H100, n_iters=5.0)
    e = efficiency(acct["solve_roofline_ms"] / 1e3, acct)
    assert abs(e - 1.0) < 1e-9
    assert efficiency(1.0, acct) < 0.01


def test_linearize_dominated_by_output_bytes():
    s = account_linearize(4096, 29)
    assert s.intensity < 1.0


def test_megakernel_accounting_compute_bound():
    """The whole-solve kernel streams only each lane's knots and gains:
    far fewer device-memory bytes than the lane path's (8, 8, B) stage
    arrays, the same order of FLOPs, hence a much higher arithmetic
    intensity (closer to the compute bound)."""
    from mpc_ros_tpu.kernels import megakernel_accounting, solve_accounting

    B, T = 16384, 29
    mk = megakernel_accounting(B, T, H100, n_alpha=8, n_iters=6.0)
    ln = solve_accounting(B, T, H100, n_alpha=8, n_iters=6.0)
    assert mk["solve_mbytes"] < 0.25 * ln["solve_mbytes"]
    assert 0.5 < mk["solve_gflops"] / ln["solve_gflops"] < 2.5
    ln_intensity = ln["solve_gflops"] / ln["solve_mbytes"] * 1e3
    assert mk["intensity_flop_per_byte"] > 4.0 * ln_intensity


def test_unknown_device_kind_is_an_error():
    with pytest.raises(ValueError, match="no published peaks"):
        device_spec("Imaginary Accelerator 9000")
    assert H100.peak_flops_f32 == 67e12 and H100.hbm_bytes_per_s == 3.35e12
