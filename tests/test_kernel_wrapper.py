"""CPU tests of what surrounds the whole-solve kernel: the engine choice,
the device gate, the compile-cache helper, block padding, the lowering
through Triton, and the pytree dataclass helper."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_ros_tpu import device, pytree
from mpc_ros_tpu.config import MPCParams, SolverConfig
from mpc_ros_tpu.engine import make_random_scenarios
from mpc_ros_tpu.kernels import solve_pallas as sp
from mpc_ros_tpu.kernels.backward_pallas import pack_params
from mpc_ros_tpu.solver import batch_lane as bl

F32 = jnp.float32


def _lane_args(B, cfg, seed=0):
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(seed), B, F32)
    p = MPCParams().astype(F32)
    return (jnp.swapaxes(z0s, 0, 1), jnp.swapaxes(coeffs, 0, 1),
            pack_params(p, B, F32),
            jnp.full((2, B), -1.0, F32), jnp.full((2, B), 1.0, F32),
            jnp.zeros((cfg.n_controls, 2, B), F32))


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="refusing"):
        device.require_gpu("a measurement")


def test_device_record_names_platform_kind_count():
    rec = device.device_record()
    assert rec["platform"] == "cpu"
    assert rec["count"] == len(jax.devices())
    assert isinstance(rec["kind"], str)


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = device.enable_compile_cache()
        assert path == device.CACHE_DIR
        assert path.endswith(".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_mega_on_cpu_raises_instead_of_interpreting():
    z0s, coeffs = make_random_scenarios(jax.random.PRNGKey(0), 16, F32)
    cfg = SolverConfig(n_steps=8, backward="mega")
    with pytest.raises(ValueError, match="GPU only"):
        bl.batch_solve_lane(z0s, coeffs, MPCParams().astype(F32), cfg)
    with pytest.raises(ValueError, match="GPU only"):
        sp.solve_pallas(*_lane_args(16, cfg), cfg)


def test_removed_two_kernel_backward_is_refused():
    with pytest.raises(ValueError, match="'auto', 'mega' or 'xla'"):
        SolverConfig(backward="pallas")


def test_engine_choice_in_one_place(monkeypatch):
    cfg = SolverConfig()
    assert not bl._use_kernel(cfg, F32, False)          # CPU: XLA path
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert bl._use_kernel(cfg, F32, False)
    assert not bl._use_kernel(cfg, jnp.float64, False)  # kernel is f32
    assert not bl._use_kernel(cfg, F32, True)           # grids: XLA
    assert not bl._use_kernel(SolverConfig(backward="xla"), F32, False)
    assert bl._use_kernel(SolverConfig(backward="mega"), F32, False)
    with pytest.raises(ValueError, match="grid costmaps"):
        bl._use_kernel(SolverConfig(backward="mega"), F32, True)


@pytest.mark.parametrize("B, block, expect", [
    (1024, 128, 128), (100, 128, 128), (20, 128, 32), (3, 128, 16),
    (524288, 64, 64)])
def test_lane_block_is_a_power_of_two(B, block, expect):
    blk = sp.lane_block(B, block)
    assert blk == expect and blk & (blk - 1) == 0
    assert sp.padded_batch(B, block) % blk == 0
    assert 0 <= sp.padded_batch(B, block) - B < blk


def test_padded_batch_equals_unpadded():
    """96 lanes in 64-lane blocks (padded to 128 with copies of the last
    lane) give bit-identical per-lane results to 32-lane blocks (no
    padding): a done lane stops changing, so blocking is invisible."""
    cfg = SolverConfig(n_steps=10, max_sqp_iters=6, tol_grad=1e-3)
    args = _lane_args(96, cfg, seed=4)
    padded = sp.solve_pallas(*args, cfg, interpret=True, block=64)
    exact = sp.solve_pallas(*args, cfg, interpret=True, block=32)
    assert sp.padded_batch(96, 64) == 128 and sp.padded_batch(96, 32) == 96
    for a, b in zip(padded, exact):
        assert a.shape[-1] == 96
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


_LOWER_CASES = {
    "plain": {}, "bicycle": {"model": "bicycle"}, "exact_trig":
    {"trig": "exact"}, "blobs": {"blobs": 2}, "refs": {"refs": True},
    "resume": {"resume": True}}


@pytest.mark.parametrize("case", sorted(_LOWER_CASES))
def test_kernel_lowers_through_triton(case, monkeypatch):
    """Every kernel specialization lowers to Triton IR for the CUDA
    platform (what the GPU compiler then takes) — no card needed."""
    kw = dict(_LOWER_CASES[case])
    n_blobs = kw.pop("blobs", 0)
    has_refs = kw.pop("refs", False)
    has_resume = kw.pop("resume", False)
    cfg = SolverConfig(n_steps=16, max_sqp_iters=4, ls_iters=3, **kw)
    B, T = 256, cfg.n_controls
    sd = lambda *s: jax.ShapeDtypeStruct(s, F32)
    extra = []
    if has_refs:
        extra.append(sd(T + 1, 3, B))
    if has_resume:
        extra += [sd(B)] * 4
    if n_blobs:
        extra += [sd(n_blobs, B)] * 4

    def fn(zT, cT, pp, lb, ub, u0, *ex):
        ex = list(ex)
        refs = ex.pop(0) if has_refs else None
        resume = tuple(ex[:4]) if has_resume else None
        blobs = tuple(ex[-4:]) if n_blobs else None
        return sp.solve_pallas(zT, cT, pp, lb, ub, u0, cfg, refs=refs,
                               resume=resume, blobs=blobs)

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    args = [sd(6, B), sd(4, B), sd(12, B), sd(2, B), sd(2, B), sd(T, 2, B)]
    text = jax.jit(fn).trace(*args, *extra).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "nmpc_whole_solve" in text


@pytree.dataclass
class _Box:
    lo: jax.Array
    hi: jax.Array
    name: str = pytree.field(pytree_node=False, default="box")


def test_pytree_dataclass_replace_and_static_fields_under_jit():
    b = _Box(jnp.zeros(3), jnp.ones(3))
    assert [x.shape for x in jax.tree.leaves(b)] == [(3,), (3,)]
    b2 = b.replace(hi=2 * jnp.ones(3), name="wide")
    assert b.name == "box" and b2.name == "wide"
    assert dataclasses.is_dataclass(b2)
    with pytest.raises(dataclasses.FrozenInstanceError):
        b.lo = jnp.ones(3)
    traces = []

    @jax.jit
    def width(box):
        traces.append(box.name)              # static: a Python str here
        return jnp.sum(box.hi - box.lo)

    assert float(width(b)) == 3.0
    assert float(width(b.replace(lo=-jnp.ones(3)))) == 6.0
    assert float(width(b2)) == 6.0
    assert traces == ["box", "wide"]         # static field keys the cache
    moved = jax.tree.map(lambda x: x + 1, b2)
    assert moved.name == "wide" and float(moved.lo[0]) == 1.0
