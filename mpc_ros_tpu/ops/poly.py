"""Polynomial fitting/evaluation ops.

JAX replacement for the reference's Eigen householder-QR `polyfit` and
Horner-free `polyeval` (/root/reference/mpc_ros/src/driving_state.cpp:273-300).
Coefficients are stored in ASCENDING order (c0 + c1 x + c2 x^2 + ...), matching
the reference layout so fitted coefficients are interchangeable.

All functions are jit/vmap-friendly: static shapes, no data-dependent control
flow. Batched fitting of thousands of reference paths maps onto batched
matmuls via the normal-equations/QR path inside `jnp.linalg.lstsq`.
"""

from __future__ import annotations

import jax.numpy as jnp


def polyeval(coeffs: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Evaluate sum_i coeffs[..., i] * x^i  (Horner form).

    coeffs: (..., P); x: scalar or broadcastable to coeffs[..., 0].
    """
    acc = jnp.zeros_like(jnp.broadcast_arrays(coeffs[..., 0], x)[0])
    for i in range(coeffs.shape[-1] - 1, -1, -1):
        acc = acc * x + coeffs[..., i]
    return acc


def polyder_eval(coeffs: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Evaluate d/dx of the polynomial at x (Horner form on the derivative).

    Matches the reference's tangent computation
    (/root/reference/mpc_ros/src/mpc_planner.cpp:193-197).
    """
    p = coeffs.shape[-1]
    if p <= 1:
        return jnp.zeros_like(jnp.broadcast_arrays(coeffs[..., 0], x)[0])
    acc = jnp.zeros_like(jnp.broadcast_arrays(coeffs[..., 0], x)[0])
    for i in range(p - 1, 0, -1):
        acc = acc * x + i * coeffs[..., i]
    return acc


def vandermonde(x: jnp.ndarray, order: int) -> jnp.ndarray:
    """Vandermonde matrix (..., n, order+1) with ascending powers."""
    powers = jnp.arange(order + 1, dtype=x.dtype)
    return x[..., :, None] ** powers


def polyfit(x: jnp.ndarray, y: jnp.ndarray, order: int,
            weights: jnp.ndarray | None = None) -> jnp.ndarray:
    """Least-squares polynomial fit, ascending coefficients (..., order+1).

    Solves the same LS problem as the reference's householder-QR fit
    (/root/reference/mpc_ros/src/driving_state.cpp:283-300). Uses the
    normal equations with a Cholesky-style solve: for the small systems here
    ((order+1) <= 6) this is numerically fine in f32 for well-scaled robot
    -frame coordinates and compiles to batched matmuls.

    `weights` (optional, (..., n)) enables masked fits over padded waypoint
    buffers: pass 0 for padding rows, 1 for valid rows. This is how dynamic
    -length reference plans become static-shape device programs.
    """
    A = vandermonde(x, order)                      # (..., n, P)
    if weights is not None:
        # weighted normal equations A'WA c = A'Wy — the weight applies
        # exactly ONCE on each side (Aw carries it; y stays raw). Applying
        # it to y as well would solve A'WA c = A'W^2 y, which is wrong for
        # any non-binary weight.
        Aw = A * weights[..., :, None]
    else:
        Aw = A
    AtA = jnp.einsum("...ni,...nj->...ij", Aw, A)
    Aty = jnp.einsum("...ni,...n->...i", Aw, y)
    # Tikhonov floor keeps padded/degenerate batches solvable.
    eps = jnp.asarray(1e-8, x.dtype)
    AtA = AtA + eps * jnp.eye(order + 1, dtype=x.dtype)
    return jnp.linalg.solve(AtA, Aty[..., None])[..., 0]
