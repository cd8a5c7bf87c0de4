"""Exact small box-constrained QP via active-set enumeration.

The control dimension of this problem family is tiny (m = 2: omega, accel —
the box bounds the reference imposes at
/root/reference/mpc_ros/src/mpc_planner.cpp:313-325), so instead of an
iterative projected-Newton loop we enumerate ALL 3^m active-set combinations
(free / at-lower / at-upper per dim), solve each candidate in closed form,
and select the KKT-consistent one. This is:

* exact (strictly convex QP -> the true active set has zero KKT violation),
* branchless (a static stack of 9 candidates + argmin select), hence
  perfectly vmap/jit-able with no data-dependent control flow, and
* the building block of the control-limited Riccati backward pass.
"""

from __future__ import annotations

import itertools

import numpy as np

import jax.numpy as jnp

# All (state_dim0, state_dim1) combos; 0=free, 1=at lower, 2=at upper.
# Tables are numpy at module scope: creating jnp arrays at import time would
# initialize the default backend before callers can select a platform.
_COMBOS = list(itertools.product(range(3), repeat=2))
_FREE = np.asarray([[1.0 if s == 0 else 0.0 for s in c] for c in _COMBOS])
_AT_LO = np.asarray([[1.0 if s == 1 else 0.0 for s in c] for c in _COMBOS])
_AT_HI = np.asarray([[1.0 if s == 2 else 0.0 for s in c] for c in _COMBOS])


def inv2(M: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of (..., 2, 2) matrices (adjugate / det).

    XLA lowers `jnp.linalg.solve` on tiny systems to generic batched LU —
    pathologically slow inside a scan body. Every 2x2 solve in the hot
    Riccati path goes through this instead (pure elementwise arithmetic).
    """
    a = M[..., 0, 0]
    b = M[..., 0, 1]
    c = M[..., 1, 0]
    d = M[..., 1, 1]
    det = a * d - b * c
    inv = jnp.stack(
        [jnp.stack([d, -b], axis=-1), jnp.stack([-c, a], axis=-1)], axis=-2
    )
    return inv / det[..., None, None]


def solve_boxqp_2d(Q: jnp.ndarray, q: jnp.ndarray,
                   lb: jnp.ndarray, ub: jnp.ndarray):
    """min_d 0.5 d^T Q d + q^T d  s.t. lb <= d <= ub, with Q (2,2) SPD.

    Returns (d, free_mask, Minv) where `free_mask` is the optimal active
    set's free-dimension indicator and `Minv` is the inverse of the masked
    system matrix, such that gain rows for clamped dims come out zero:
    K = Minv @ (-(free * Qus)).
    """
    dtype = Q.dtype
    nc = len(_COMBOS)
    f = jnp.asarray(_FREE, dtype)          # (9, 2)
    at_lo = jnp.asarray(_AT_LO, dtype)
    at_hi = jnp.asarray(_AT_HI, dtype)
    d_clamp = at_lo * lb + at_hi * ub      # (9, 2)

    # Masked system: free rows keep Q on free cols; clamped rows become
    # identity rows pinning d to the bound value.
    M = Q[None] * (f[:, :, None] * f[:, None, :]) + jnp.stack(
        [jnp.diag(1.0 - f[i]) for i in range(nc)]
    )

    rhs = f * (-(q[None] + jnp.einsum("ij,cj->ci", Q, d_clamp))) + (1.0 - f) * d_clamp
    Minv = inv2(M)                                                   # (9, 2, 2)
    d = jnp.einsum("cij,cj->ci", Minv, rhs)                          # (9, 2)
    lam = q[None] + jnp.einsum("ij,cj->ci", Q, d)                    # (9, 2)

    # KKT violations: free dims must stay inside the box; at-lower dims need
    # lam >= 0; at-upper dims need lam <= 0.
    viol = jnp.sum(
        f * (jnp.maximum(lb[None] - d, 0.0) + jnp.maximum(d - ub[None], 0.0))
        + at_lo * jnp.maximum(-lam, 0.0)
        + at_hi * jnp.maximum(lam, 0.0),
        axis=-1,
    )
    # Prefer more-free combos on exact ties (degenerate boundaries): tiny
    # penalty per clamped dim keeps the selection deterministic.
    viol = viol + 1e-12 * jnp.sum(1.0 - f, axis=-1)
    best = jnp.argmin(viol)
    return d[best], f[best], Minv[best]
